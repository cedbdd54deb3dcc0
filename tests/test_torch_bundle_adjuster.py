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

import ast
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


@pytest.mark.parametrize("ba_path", ["soa", "flat"])
def test_ba_log_records_each_solve(model_dir, monkeypatch, tmp_path,
                                   ba_path):
    """``PPSFM_BA_LOG``: one line per solve, route first (the reference's
    ``_run_ba`` log, without its compile-cache fields)."""
    log = tmp_path / "ba.log"
    monkeypatch.setenv("PPSFM_BA_LOG", str(log))
    monkeypatch.setenv("PPSFM_BA_PATH", ba_path)
    mapper = tcli.main(["bundle_adjuster", "--input_path",
                        str(model_dir / "in"), "--output_path",
                        str(tmp_path / "out"), "--max_num_iterations", "3",
                        "--device", "cpu", "--dtype", "float64"])
    (line,) = log.read_text().splitlines()
    fields = line.split()
    assert fields[:4] == [ba_path, "C=8", "P=200",
                          "K=4" if ba_path == "soa" else "K=0"]
    assert fields[4] == "O=800" and fields[5].startswith("solve_s=")
    assert fields[6:] == [f"iters={mapper.last_summary.num_iterations}",
                          "nobs=800"]


def test_ba_log_records_intrinsics_solves(model_dir, monkeypatch, tmp_path):
    from privacy_preserving_sfm_torch.optim import ba as tba
    from privacy_preserving_sfm_torch.sfm.incremental_mapper import (
        IncrementalMapper, MapperOptions,
    )

    log = tmp_path / "ba.log"
    monkeypatch.setenv("PPSFM_BA_LOG", str(log))
    mapper = IncrementalMapper(torch.device("cpu"), torch.float64)
    mapper.begin_reconstruction(Reconstruction.read_text(
        str(model_dir / "in")))
    # With no database cache there is no triangulator to tell of a bake.
    monkeypatch.setattr(mapper, "_bake_intrinsics", lambda *a: None)
    assert mapper.adjust_global_bundle(MapperOptions(), tba.BAOptions(
        max_iterations=3, refine_focal_length=True))
    (line,) = log.read_text().splitlines()
    assert line.split()[:4] == ["intrinsics", "C=8", "P=200", "K=0"]


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
        "import chip_smoke\n"
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
        "from privacy_preserving_sfm_torch.features import (\n"
        "    exif_focal, extraction, sensor_db, sift)\n"
        "from privacy_preserving_sfm_torch.ops import cameras, lines\n"
        "from privacy_preserving_sfm_torch.utils import png\n"
        "from privacy_preserving_sfm_torch.init import initializer, sfm2d\n"
        "from privacy_preserving_sfm_torch.solvers import (\n"
        "    ransac, triangulation, triangulation_batch)\n"
        "from privacy_preserving_sfm_torch.models import (\n"
        "    correspondence_graph, database_cache, graph_view,\n"
        "    native_graph)\n"
        "from privacy_preserving_sfm_torch.sfm import (\n"
        "    incremental_triangulator)\n"
        "from privacy_preserving_sfm_torch.ops import (\n"
        "    lie, lines_np, triangulation as tri_ops)\n"
        "from privacy_preserving_sfm_torch.ops import e3q3, polynomial\n"
        "from privacy_preserving_sfm_torch.solvers import p6l\n"
        "from privacy_preserving_sfm_torch.sfm import controller\n"
        "from privacy_preserving_sfm_torch.utils import config\n"
        "from privacy_preserving_sfm_torch.optim import ba_intrinsics\n"
        "from privacy_preserving_sfm_torch.sfm import hierarchical\n"
        "from privacy_preserving_sfm_torch.parallel import (\n"
        "    distributed_ba, multihost, sharded_matching)\n"
        "from privacy_preserving_sfm_torch.viz import (\n"
        "    frustum, interactive, render)\n"
        "from privacy_preserving_sfm_torch.tools import (\n"
        "    evaluate, synth_dataset)\n"
        "import tempfile\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "d = tempfile.mkdtemp()\n"
        "synthetic.render_dataset(d + '/im', 1, 96, 64)\n"
        "ppsfm.main(['feature_extractor', '--database_path', d + '/t.db',\n"
        "            '--image_path', d + '/im', '--device', 'cpu',\n"
        "            '--max_num_features', '64'])\n"
        "synthetic.synthetic_line_database(d + '/s.db', 8, 120, seed=0)\n"
        "m = ppsfm.main(['line_initializer', '--database_path',\n"
        "                d + '/s.db', '--output_path', d + '/init',\n"
        "                '--device', 'cpu'])\n"
        "assert len(m.rec.reg_image_ids) == 4 and m.rec.points3d\n"
        "synthetic.synthetic_line_database(d + '/m.db', 8, 400, seed=2)\n"
        "c = ppsfm.main(['mapper', '--database_path', d + '/m.db',\n"
        "                '--output_path', d + '/sparse', '--device', 'cpu'])\n"
        "assert [r.num_registered() for r in c.reconstructions] == [8]\n"
        "h = ppsfm.main(['hierarchical_mapper', '--database_path',\n"
        "                d + '/m.db', '--output_path', d + '/hier',\n"
        "                '--block_size', '6', '--overlap', '3',\n"
        "                '--device', 'cpu'])\n"
        "assert h['merged'] == 2 and h['model'].num_registered() == 8\n"
        "v = ppsfm.main(['model_viewer', '--input_path', d + '/hier/0',\n"
        "                '--html', d + '/v.html'])\n"
        "assert v == [d + '/v.html']\n"
        "synth_dataset.make_dataset(d + '/sd', 1, 96, 64, f=60.0,\n"
        "                           scene='box', camera='OPENCV',\n"
        "                           degrade=1.0)\n"
        "r = evaluate.report(d + '/hier/0', ref_model=d + '/sparse/0')\n"
        "assert r['num_registered'] == 8, r\n"
        "assert build._lib is None\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'cv2', 'tools',\n"
        "                               'evaluate', 'synth_dataset',\n"
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
    # chip_smoke.py names the reference's files in its kernels line, but
    # imports nothing of JAX or the reference package, at any depth.
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in (
                "jax", "jaxlib", "cv2", "tools", "evaluate", "synth_dataset",
                "privacy_preserving_sfm_tpu"), n


def test_failed_kernel_build_raises(tmp_path, monkeypatch):
    """A build that fails raises; nothing falls back to the plain path."""
    from privacy_preserving_sfm_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_nvcc", lambda: sys.executable)
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.library()
    assert build._lib is None
