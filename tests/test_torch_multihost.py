"""The port's multi-process runtime (``parallel/multihost.py``), as
``tests/test_multihost.py`` holds the reference's: two processes started
from the ``PPSFM_*`` environment variables form a gloo world; each solves
``tests/test_ba.py``'s problem (and one with line noise) point-sharded and
asserts that its ``gather_points`` and cameras equal the single-process
``ba.bundle_adjust`` (1e-6, float64), then prints ``MULTIHOST_OK``
(``tests/torch_dist_worker.py``).  A world whose ranks hang is killed at
its timeout and fails the test.
"""

import time

import numpy as np
import pytest
from torch_dist_worker import BA_FIELDS, run_world

from test_torch_parallel import problems


def test_two_process_distributed_ba(tmp_path):
    inputs = {f"{name}.{f}": np.asarray(x)
              for name, p in problems().items()
              for f, x in zip(BA_FIELDS, p)}
    np.savez(tmp_path / "inputs.npz", **inputs)
    outs = run_world(2, "multihost", str(tmp_path), timeout=90)
    for rank, out in enumerate(outs):
        assert f"MULTIHOST_OK process={rank} world=2" in out, out
    costs = [np.load(tmp_path / f"multihost_{r}.npz") for r in range(2)]
    for name in problems():
        assert costs[0][f"{name}.cost"] == costs[1][f"{name}.cost"]


def test_a_hanging_world_is_killed_and_fails(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(AssertionError, match="did not end in time"):
        run_world(2, "hang", str(tmp_path), timeout=15)
    assert time.monotonic() - t0 < 30


def test_one_process_starts_no_world_and_a_missing_card_raises(monkeypatch):
    import torch
    import torch.distributed as dist

    from privacy_preserving_sfm_torch.parallel import multihost

    for var in ("PPSFM_COORDINATOR", "PPSFM_NUM_PROCESSES",
                "PPSFM_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert not multihost.initialize_from_env()
    assert not multihost.initialize_from_env("127.0.0.1:1", 1, 0)
    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize_from_env("127.0.0.1:1", 2, 0, device="cuda")
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        multihost.initialize_from_env("127.0.0.1:1", 2, 0, device="meta")
    assert not dist.is_initialized()
