"""Port parity: the model viewer (``viz/``, ``model_viewer``) against the
JAX package.

``tests/test_models.py:make_simple_rec`` with points, written as a text
model and read back by each package: ``export_html`` writes byte-identical
files; ``render_model`` and ``render_turntable`` write PNGs whose decoded
pixels are equal, for every ``color_by``; ``model_viewer`` works through
the port's CLI with ``--html`` and for PNGs; the HTML path imports no
matplotlib (a fresh process), and a PNG without matplotlib raises an
error that names it.  The reference's viewer and matplotlib are imported
inside the tests (the reference's ``render.py`` imports matplotlib at
module level), so the file collects where matplotlib is not installed.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from privacy_preserving_sfm_torch.exe import ppsfm as tcli
from privacy_preserving_sfm_torch.models.reconstruction import (
    Reconstruction as TRec,
)
from privacy_preserving_sfm_torch.viz import interactive as tint
from privacy_preserving_sfm_torch.viz import render as trender

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference():
    """(Reconstruction, interactive, render, imread) of the reference."""
    mpimg = pytest.importorskip("matplotlib.image")
    from privacy_preserving_sfm_tpu.models.reconstruction import (
        Reconstruction,
    )
    from privacy_preserving_sfm_tpu.viz import interactive, render

    return Reconstruction, interactive, render, mpimg.imread


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """``tests/test_viz.py``'s model (4 images, 10 points seen by all),
    with per-point errors, as a text model."""
    reference()
    from test_models import make_simple_rec

    rec, pts = make_simple_rec()
    for j in range(len(pts)):
        pid = rec.add_point3d(pts[j], [(iid, j) for iid in range(1, 5)])
        rec.points3d[pid].error = 0.1 * j
    path = str(tmp_path_factory.mktemp("viz") / "sparse")
    os.makedirs(path)
    rec.write_text(path)
    return path


def both(model_dir):
    return reference()[0].read_text(model_dir), TRec.read_text(model_dir)


@pytest.mark.parametrize("max_points", [200_000, 4])
def test_export_html_is_byte_identical(model_dir, tmp_path, max_points):
    _, jint, _, _ = reference()
    jrec, trec = both(model_dir)
    want = jint.export_html(jrec, str(tmp_path / "jax.html"),
                            max_points=max_points)
    got = tint.export_html(trec, str(tmp_path / "torch.html"),
                           max_points=max_points)
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("color_by", ["track", "error", "depth"])
def test_render_model_pixels_equal_the_reference(model_dir, tmp_path,
                                                 color_by):
    _, _, jrender, imread = reference()
    jrec, trec = both(model_dir)
    kw = dict(color_by=color_by, image_size=(320, 240), elev=-40.0,
              azim=-70.0)
    want = jrender.render_model(jrec, str(tmp_path / "j.png"), **kw)
    got = trender.render_model(trec, str(tmp_path / "t.png"), **kw)
    a, b = imread(want), imread(got)
    assert a.shape == (240, 320, 4)
    np.testing.assert_array_equal(b, a)
    assert len(np.unique(a.reshape(-1, 4), axis=0)) > 2  # not blank


def test_render_turntable_pixels_equal_the_reference(model_dir, tmp_path):
    _, _, jrender, imread = reference()
    jrec, trec = both(model_dir)
    kw = dict(num_frames=3, color_by="depth", image_size=(200, 150))
    want = jrender.render_turntable(jrec, str(tmp_path / "j"), **kw)
    got = trender.render_turntable(trec, str(tmp_path / "t"), **kw)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(imread(b), imread(a))


def test_render_empty_model(tmp_path):
    out = trender.render_model(TRec(), str(tmp_path / "empty.png"),
                               title="empty")
    assert os.path.getsize(out) > 100


def test_model_viewer_cli(model_dir, tmp_path):
    JRec, jint, _, _ = reference()
    html = str(tmp_path / "viewer.html")
    assert tcli.main(["model_viewer", "--input_path", model_dir,
                      "--html", html]) == [html]
    jint.export_html(JRec.read_text(model_dir), str(tmp_path / "j.html"))
    with open(html, "rb") as a, open(tmp_path / "j.html", "rb") as b:
        assert a.read() == b.read()
    png = str(tmp_path / "view.png")
    assert tcli.main(["model_viewer", "--input_path", model_dir,
                      "--output_path", png, "--color_by", "error"]) == [png]
    with open(png, "rb") as f:
        assert f.read(4) == b"\x89PNG"
    frames = tcli.main(["model_viewer", "--input_path", model_dir,
                        "--output_path", str(tmp_path / "turn"),
                        "--turntable", "2"])
    assert len(frames) == 2 and all(os.path.getsize(p) > 1000
                                    for p in frames)
    with pytest.raises(SystemExit):
        tcli.main(["model_viewer", "--input_path", model_dir])


def test_a_png_without_matplotlib_names_it(model_dir, tmp_path,
                                           monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        tcli.main(["model_viewer", "--input_path", model_dir,
                   "--output_path", str(tmp_path / "x.png")])


def test_the_html_path_imports_no_matplotlib(model_dir, tmp_path):
    code = (
        "import sys\n"
        "from privacy_preserving_sfm_torch import viz\n"
        "from privacy_preserving_sfm_torch.exe import ppsfm\n"
        "from privacy_preserving_sfm_torch.viz import interactive, frustum\n"
        f"ppsfm.main(['model_viewer', '--input_path', {model_dir!r},\n"
        f"            '--html', {str(tmp_path / 'v.html')!r}])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('matplotlib', 'mpl_toolkits', 'jax',\n"
        "        'privacy_preserving_sfm_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert os.path.getsize(tmp_path / "v.html") > 4000
