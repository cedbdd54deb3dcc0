"""On the card: every control comes out not correct, and the program does.

A control is the precision below the one each configuration states, in
the program's place: for the BA cells the reference computed in TF32,
and the program's own path with the Schur Gram in bfloat16; for the
front end the reference SIFT in TF32 and the reference matcher on 4-bit
descriptors; for the exhaustive matcher the 4-bit descriptors.  At the
cells' own sizes the readings are made by ``benchmark/readings.py
--control`` (PERF.md gives them); here, at sizes a test run holds, three
seeds a cell.  Run on a machine with the card:
``python -m pytest benchmark/tests/test_bench_control.py -q``.
"""

import copy

import pytest
import torch

from benchmark.core import spec as spec_mod
from benchmark.readings import read_seed

pytestmark = pytest.mark.cuda

SMALL = {
    "collection1000.global_ba": dict(num_cameras=200, num_points=40000),
    "sequence300.global_ba": dict(num_cameras=150, num_points=4000,
                                  longest_track=64,
                                  num_observations=120000),
    "sequence300.frontend": dict(num_frames=40),
    "collection1000.exhaustive_match": dict(num_images=60),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("seed", [2 ** 31 + 5, 2 ** 31 + 6, 2 ** 31 + 7])
def test_control_fails_and_program_passes(cuda, workload, seed):
    cell = copy.copy(spec_mod.load_cell(workload))
    cell.config = dict(cell.config, **SMALL[workload])
    units = {"sequence300.frontend": 6,
             "collection1000.exhaustive_match": 400}.get(workload, 1)
    out = read_seed(cell, seed, units, True, cuda)
    limits = cell.limits
    prog = {k: v for k, v in out["program"].items() if k in limits}
    assert set(prog) == set(limits), prog
    assert all(v <= limits[k] for k, v in prog.items()), prog
    want = {"collection1000.global_ba": {"tf32_reference", "bf16_gram"},
            "sequence300.global_ba": {"tf32_reference", "bf16_gram"}}.get(
                workload)
    if want is not None:
        assert set(out["controls"]) == want
    for name, readings in out["controls"].items():
        ctrl = {k: v for k, v in readings.items() if k in limits}
        assert any(v > limits[k] for k, v in ctrl.items()), (name, ctrl)
