"""Port parity: ``tools/synth_dataset.make_dataset`` (OpenCV and JAX)
against the port's ``privacy_preserving_sfm_torch.tools.synth_dataset``
(numpy and torch).

Both render the same seeded scenes into two directories: plane
SIMPLE_PINHOLE, box SIMPLE_PINHOLE, box OPENCV, box OPENCV degraded at
level 1.0, 3 views each.  The port draws the tool's random stream, so:

* every text file (``gt_poses.txt``, the gravity and camera sidecars,
  ``meta.json``) is byte-equal, the tool run its own way: with JAX's
  64-bit mode off, as ``python tools/synth_dataset.py`` runs, so that its
  quaternion arithmetic is float32, as the port's.  With 64-bit mode on
  (this process's default) the tool's poses move by float32 rounding:
  the port's agree with them to 1e-6;
* the OPENCV pixel map agrees with the tool's ``_undistorted_pix_map`` to
  1e-9 px (64-bit mode on: the port's map is float64);
* pixels: OpenCV's SIMD sums are not reproduced bit for bit.  Measured on
  these scenes (4 views, seed 5): 99.93-100 % of pixels equal, all but
  0.005 % within 1 grey level, all within 2, mean |difference| at most
  0.0008 levels.  The bars: at least 99.8 % equal, 99.95 % within 1
  level, 100 % within 2, mean at most 0.003.

The helpers are held against OpenCV directly: cubic upsampling, the
bilinear remap and perspective warp, and the Gaussian blur.  Skipped
where OpenCV is not installed.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

from privacy_preserving_sfm_torch.tools import synth_dataset as port
from privacy_preserving_sfm_torch.utils import png

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import synth_dataset as ref  # noqa: E402  (the repository's tools/)

torch.set_num_threads(2)

SCENES = [("plane", "SIMPLE_PINHOLE", 0.0), ("box", "SIMPLE_PINHOLE", 0.0),
          ("box", "OPENCV", 0.0), ("box", "OPENCV", 1.0)]
VIEWS = 3
SEED = 5


@pytest.fixture(scope="module")
def cv2():
    return pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def rendered(cv2, tmp_path_factory):
    """{scene: (tool's dir, port's dir)} for every scene of SCENES."""
    out = {}
    for scene, camera, degrade in SCENES:
        root = tmp_path_factory.mktemp(f"{scene}_{camera}_{degrade}")
        a, b = str(root / "tool"), str(root / "port")
        with jax.enable_x64(False):
            ref.make_dataset(a, VIEWS, seed=SEED, scene=scene,
                             camera=camera, degrade=degrade)
        port.make_dataset(b, VIEWS, seed=SEED, scene=scene, camera=camera,
                          degrade=degrade)
        out[scene, camera, degrade] = a, b
    return out


def _poses(path):
    rows = {}
    with open(os.path.join(path, "gt_poses.txt")) as f:
        for line in f:
            if not line.startswith("#"):
                parts = line.split()
                rows[parts[0]] = np.array([float(v) for v in parts[1:]])
    return rows


@pytest.mark.parametrize("case", SCENES, ids=lambda c: f"{c}")
def test_files_match_the_tool(rendered, case):
    a, b = rendered[case]
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    texts = [n for n in names if not n.endswith(".png")]
    assert len(texts) == 2 * VIEWS + 2
    for name in texts:
        assert open(os.path.join(a, name)).read() == \
            open(os.path.join(b, name)).read(), name
    assert sorted(_poses(b)) == [f"img{i:03d}.png" for i in range(VIEWS)]
    with open(os.path.join(b, "img000.png.camera_model.txt")) as f:
        assert f.read().startswith(case[1] + ", ")
    assert json.load(open(os.path.join(b, "meta.json")))["degrade"] == \
        case[2]


@pytest.mark.parametrize("case", SCENES, ids=lambda c: f"{c}")
def test_pixels_match_the_tool(rendered, cv2, case):
    a, b = rendered[case]
    for i in range(VIEWS):
        name = f"img{i:03d}.png"
        ia = cv2.imread(os.path.join(a, name), cv2.IMREAD_GRAYSCALE)
        ib = png.read_png_gray(os.path.join(b, name))
        assert ia.shape == ib.shape == (480, 640)
        d = np.abs(ia.astype(np.int64) - ib)
        assert (d == 0).mean() >= 0.998
        assert (d <= 1).mean() >= 0.9995
        assert d.max() <= 2 and d.mean() <= 0.003


def test_poses_match_the_tool_in_float64(tmp_path):
    """The tool with JAX's 64-bit mode on: the same stream, poses within
    float32 rounding of the port's."""
    pytest.importorskip("cv2")
    a, b = str(tmp_path / "tool"), str(tmp_path / "port")
    ref.make_dataset(a, VIEWS, seed=SEED + 1, scene="box")
    port.make_dataset(b, VIEWS, seed=SEED + 1, scene="box")
    pa, pb = _poses(a), _poses(b)
    assert sorted(pa) == sorted(pb)
    for name in pa:
        assert not np.array_equal(pa[name], pb[name])
        np.testing.assert_allclose(pb[name], pa[name], rtol=0, atol=1e-6)


def test_pixel_map_matches_the_tool():
    params = [400.0, 400.0, 320.0, 240.0, -0.16, 0.035, 1e-3, -5e-4]
    got = port._undistorted_pix_map(640, 480, "OPENCV", params)
    want = ref._undistorted_pix_map(640, 480, "OPENCV", params)
    assert got.shape == want.shape == (3, 480, 640)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    # Real distortion: the corners move by ~75 px (barrel, f = 400).
    moved = np.hypot(got[0] - np.arange(640)[None], got[1]
                     - np.arange(480)[:, None])
    assert 50.0 < moved.max() < 100.0


@pytest.mark.parametrize("n, size", [(100, 800), (25, 800), (200, 1600)])
def test_cubic_upsampling_matches_opencv(cv2, n, size):
    grid = np.random.default_rng(n).uniform(0, 1, (n, n)).astype(np.float32)
    want = cv2.resize(grid, (size, size), interpolation=cv2.INTER_CUBIC)
    got = port._resize_cubic(grid, size)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_texture_matches_the_tool(cv2):
    a = ref._make_texture(np.random.default_rng(2), 800, cv2)
    b = port._make_texture(np.random.default_rng(2), 800)
    d = np.abs(a.astype(np.int64) - b)
    # float32 rounding flips a truncated level on ~1e-5 of texels.
    assert d.max() <= 1 and (d > 0).mean() < 1e-4


def test_bilinear_remap_matches_opencv(cv2):
    rng = np.random.default_rng(1)
    tex = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    mx = rng.uniform(-1, 64, (200, 300)).astype(np.float32)
    my = rng.uniform(-1, 64, (200, 300)).astype(np.float32)
    want = cv2.remap(tex, mx, my, cv2.INTER_LINEAR)
    got = port._bilinear_u8(tex, mx, my, replicate=False)
    d = np.abs(want.astype(np.int64) - got)
    assert d.max() <= 1 and (d == 0).mean() >= 0.999


def test_perspective_warp_matches_opencv(cv2):
    tex = np.random.default_rng(1).integers(0, 256, (400, 400)).astype(
        np.uint8)
    H = np.array([[1.3, 0.1, -50], [0.05, 1.2, -30], [1e-4, 2e-4, 1.0]])
    want = cv2.warpPerspective(tex, H, (640, 480), flags=cv2.INTER_LINEAR,
                               borderMode=cv2.BORDER_REPLICATE)
    got = port._warp_perspective(tex, H, 640, 480)
    d = np.abs(want.astype(np.int64) - got)
    assert d.max() <= 1 and (d == 0).mean() >= 0.998


@pytest.mark.parametrize("sigma", [0.06, 0.3, 0.55, 0.79])
def test_gaussian_blur_matches_opencv(cv2, sigma):
    img = np.random.default_rng(3).uniform(0, 1, (480, 640)).astype(
        np.float32)
    want = cv2.GaussianBlur(img, (0, 0), sigma)
    got = port._gaussian_blur(img, sigma)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_cli_writes_a_dataset(tmp_path):
    out = str(tmp_path / "ds")
    assert port.main([out, "2", "box", "OPENCV", "0.5"]) == 0
    meta = json.load(open(os.path.join(out, "meta.json")))
    assert meta["camera"] == "OPENCV" and meta["degrade"] == 0.5
    assert len(_poses(out)) == 2
    with pytest.raises(SystemExit, match="scene=box"):
        port.make_dataset(str(tmp_path / "bad"), 1, scene="plane",
                          camera="OPENCV")
