"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a chip and drives the rest of a run
(set-up, window, check) at a tiny size on the CPU, on the card's BA route
with the plain kernels, with one fault planted in the program: a step
that returns its state unchanged, half of the batch left out, an answer
altered where it is produced.  (One chip: no exchange between chips.)
"""

import importlib.util
import os
import time

import pytest
import torch

from benchmark.core import spec as spec_mod
from benchmark.tests.tiny import tiny_cell


def _run(workload, seed=2 ** 35 + 1):
    spec = importlib.util.spec_from_file_location(
        "bench_run", os.path.join(spec_mod.ROOT, "benchmark", "run.py"))
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    line, _ = run.run_cell(tiny_cell(workload), seed, 0.5, False,
                           torch.device("cpu"), time.perf_counter(),
                           route_device=("cuda" if "global_ba" in workload
                                         else None))
    return line


BA_CELLS = ["collection1000.global_ba", "sequence300.global_ba"]


def _unchanged(real):
    def solve(problem, camera_model, options=None, **kw):
        q, t, X, s = real(problem, camera_model, options, **kw)
        return problem.qvecs, problem.tvecs, problem.points3d, s
    return solve


def _altered(real):
    def solve(problem, camera_model, options=None, **kw):
        q, t, X, s = real(problem, camera_model, options, **kw)
        return q, t, X + 1e-3, s
    return solve


def _half_left_out(real):
    def convert(problem):
        w = problem.obs_weight.clone()
        w[::2] = 0.0
        return real(problem._replace(obs_weight=w))
    return convert


@pytest.mark.parametrize("workload", BA_CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "altered", "half"])
def test_ba_fault_is_not_correct(monkeypatch, workload, fault):
    from privacy_preserving_sfm_torch.optim import ba_dense, ba_soa

    if fault == "half":
        monkeypatch.setattr(ba_dense, "from_flat_problem",
                            _half_left_out(ba_dense.from_flat_problem))
    else:
        wrap = _unchanged if fault == "unchanged" else _altered
        monkeypatch.setattr(ba_soa, "bundle_adjust_soa",
                            wrap(ba_soa.bundle_adjust_soa))
    line = _run(workload)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", ["half", "altered_match",
                                   "altered_descriptor"])
def test_frontend_fault_is_not_correct(monkeypatch, fault):
    from privacy_preserving_sfm_torch.features import extraction, matching

    if fault == "half":
        real = extraction.extract_and_lift_batch

        def extract(images, *a, **kw):
            lf = real(images, *a, **kw)
            v = lf.valid.clone()
            v[v.shape[0] // 2:] = False
            return lf._replace(valid=v)
        monkeypatch.setattr(extraction, "extract_and_lift_batch", extract)
    elif fault == "altered_match":
        real_m = matching.match_many_pairs

        def match(*a, **kw):
            r = real_m(*a, **kw)
            m = r.matches.clone()
            m[:, 0] = 0
            return r._replace(matches=m)
        monkeypatch.setattr(matching, "match_many_pairs", match)
    else:
        real = extraction.extract_and_lift_batch

        def extract(images, *a, **kw):
            lf = real(images, *a, **kw)
            d = lf.descriptors.clone()
            d[:, :, 0] ^= 0x40
            return lf._replace(descriptors=d)
        monkeypatch.setattr(extraction, "extract_and_lift_batch", extract)
    line = _run("sequence300.frontend")
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", ["half", "altered_match"])
def test_exhaustive_match_fault_is_not_correct(monkeypatch, fault):
    from privacy_preserving_sfm_torch.features import matching

    real = matching.match_many_pairs

    def match(desc, valid, pairs, **kw):
        if fault == "half":  # the second half of the chunk left out
            r = real(desc, valid, pairs[: len(pairs) // 2], **kw)
            m = torch.full((len(pairs), desc.shape[1]), -1,
                           dtype=r.matches.dtype)
            m[: len(pairs) // 2] = r.matches
            return r._replace(matches=m)
        r = real(desc, valid, pairs, **kw)
        m = r.matches.clone()
        m[:, 0] = 0
        return r._replace(matches=m)
    monkeypatch.setattr(matching, "match_many_pairs", match)
    line = _run("collection1000.exhaustive_match")
    assert line["correct"] is False, line["checks"]
