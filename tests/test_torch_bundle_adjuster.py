"""Port parity for the whole slice: the ``bundle_adjuster`` CLI.

A seeded synthetic text model (8 cameras, 200 points, 4 distinct cameras
per point, lines through noisy projections, perturbed poses and points)
goes through the reference CLI and through the port's CLI on the CPU in
float64, under the same BA route: the SoA path (``PPSFM_BA_PATH=soa``,
the solver the TPU ran), the dense-block solver (``PPSFM_BA_PATH=dense``,
implicit, and explicit with ``PPSFM_SCHUR_MODE=explicit``) and the flat
solver (no override: both packages take it on the CPU).  The two output
models agree to 1e-6.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from privacy_preserving_sfm_tpu.exe import ppsfm as jcli
from privacy_preserving_sfm_torch.exe import ppsfm as tcli
from privacy_preserving_sfm_torch.models.reconstruction import Reconstruction
from privacy_preserving_sfm_torch.utils.synthetic import (
    line_error_sum, synthetic_model,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("ba_model")
    synthetic_model(8, 200, 4, seed=0, meas_noise=1e-3).write_text(
        str(path / "in"))
    return path


def _check_cli_matches_reference(model_dir, tag):
    """Run both CLIs under the current environment; returns the port's
    mapper after checking the two output models agree."""
    args = ["bundle_adjuster", "--input_path", str(model_dir / "in"),
            "--max_num_iterations", "10"]
    jcli.main(args + ["--output_path", str(model_dir / f"jax_{tag}")])
    mapper = tcli.main(args + ["--output_path",
                               str(model_dir / f"torch_{tag}"),
                               "--device", "cpu", "--dtype", "float64"])
    a = Reconstruction.read_text(str(model_dir / f"jax_{tag}"))
    b = Reconstruction.read_text(str(model_dir / f"torch_{tag}"))
    start = Reconstruction.read_text(str(model_dir / "in"))
    assert sorted(a.images) == sorted(b.images) == list(range(1, 9))
    assert sorted(a.points3d) == sorted(b.points3d)
    for iid in a.images:
        np.testing.assert_allclose(b.images[iid].qvec, a.images[iid].qvec,
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(b.images[iid].tvec, a.images[iid].tvec,
                                   rtol=0, atol=1e-6)
    for pid in a.points3d:
        np.testing.assert_allclose(b.points3d[pid].xyz, a.points3d[pid].xyz,
                                   rtol=0, atol=1e-6)
    err_a, err_b = line_error_sum(a), line_error_sum(b)
    np.testing.assert_allclose(err_b, err_a, rtol=1e-6)
    assert err_b < 0.5 * line_error_sum(start)
    return mapper


def test_bundle_adjuster_matches_reference(model_dir, monkeypatch, capsys):
    monkeypatch.setenv("PPSFM_BA_PATH", "soa")
    mapper = _check_cli_matches_reference(model_dir, "soa")
    assert "LM iterations=" in capsys.readouterr().out
    assert mapper.last_route.solver == "soa"


@pytest.mark.parametrize("ba_path,schur_mode,route", [
    ("", "", ("flat", False)),
    ("dense", "", ("dense", False)),
    ("dense", "explicit", ("dense", True))],
    ids=["flat", "dense-implicit", "dense-explicit"])
def test_bundle_adjuster_routes_match_reference(model_dir, monkeypatch,
                                                ba_path, schur_mode, route):
    for name, value in (("PPSFM_BA_PATH", ba_path),
                        ("PPSFM_SCHUR_MODE", schur_mode)):
        if value:
            monkeypatch.setenv(name, value)
        else:
            monkeypatch.delenv(name, raising=False)
    mapper = _check_cli_matches_reference(
        model_dir, f"{ba_path or 'none'}_{schur_mode or 'none'}")
    assert tuple(mapper.last_route[:2]) == route


def test_cuda_device_without_gpu_is_an_error(model_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["bundle_adjuster", "--input_path", str(model_dir / "in"),
                   "--output_path", str(model_dir / "never"),
                   "--device", "cuda"])
    assert not (model_dir / "never").exists()


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import privacy_preserving_sfm_torch\n"
        "from privacy_preserving_sfm_torch.exe import ppsfm\n"
        "from privacy_preserving_sfm_torch.kernels import build\n"
        "from privacy_preserving_sfm_torch.optim import (\n"
        "    ba, ba_dense, ba_soa, convert, schur_pcg)\n"
        "from privacy_preserving_sfm_torch.ops import linalg\n"
        "from privacy_preserving_sfm_torch.sfm import incremental_mapper\n"
        "from privacy_preserving_sfm_torch.utils import synthetic\n"
        "from privacy_preserving_sfm_torch.features import (\n"
        "    matching, matching_kernels, schedulers)\n"
        "from privacy_preserving_sfm_torch.models import database\n"
        "from privacy_preserving_sfm_torch.utils import gps\n"
        "assert build._lib is None\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib',\n"
        "                               'privacy_preserving_sfm_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)


def test_port_sources_name_no_jax():
    root = os.path.join(REPO, "privacy_preserving_sfm_torch")
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith((".py", ".cu")):
                with open(os.path.join(dirpath, name)) as f:
                    text = f.read().lower()
                for banned in ("jax", "jnp", "pallas"):
                    assert banned not in text, (name, banned)


def test_failed_kernel_build_raises(tmp_path, monkeypatch):
    """A build that fails raises; nothing falls back to the plain path."""
    from privacy_preserving_sfm_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_nvcc", lambda: sys.executable)
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.library()
    assert build._lib is None
