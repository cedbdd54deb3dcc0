"""Port parity for the front end around SIFT: camera undistortion, the line
lift and the aligned split, the resizes, the image and sidecar readers,
the PNG codec and the EXIF focal cascade.

The same numpy inputs go through the reference package and the port on
the CPU.  Where the reference draws random numbers (``jax.random``), the
test draws them with the reference's own key and hands them to the port's
core, which takes draws as tensors: the two random streams differ by
design, the arithmetic does not.
"""

import os

import numpy as np
import pytest
import torch

from privacy_preserving_sfm_torch.features import extraction as tx
from privacy_preserving_sfm_torch.features import exif_focal as tfocal
from privacy_preserving_sfm_torch.features import sensor_db as tsensor
from privacy_preserving_sfm_torch.features import sift as ts
from privacy_preserving_sfm_torch.ops import cameras as tcam
from privacy_preserving_sfm_torch.ops import lines as tlines
from privacy_preserving_sfm_torch.ops import linalg as tlinalg
from privacy_preserving_sfm_torch.utils import png

torch.set_num_threads(2)

# Parameters of every model: focal 400-ish, principal point near the
# centre of a 640 x 480 image, distortion of a real lens's magnitude.
PARAMS = {
    "SIMPLE_PINHOLE": [410.0, 321.0, 239.0],
    "PINHOLE": [410.0, 395.0, 321.0, 239.0],
    "SIMPLE_RADIAL": [410.0, 321.0, 239.0, -0.08],
    "RADIAL": [410.0, 321.0, 239.0, -0.08, 0.01],
    "OPENCV": [410.0, 395.0, 321.0, 239.0, -0.16, 0.035, 1e-3, -5e-4],
    "OPENCV_FISHEYE": [410.0, 395.0, 321.0, 239.0, 0.05, -0.01, 2e-3, -1e-3],
    "FULL_OPENCV": [410.0, 395.0, 321.0, 239.0, -0.1, 0.02, 1e-3, -5e-4,
                    1e-3, 0.01, -2e-3, 1e-3],
    "FOV": [410.0, 395.0, 321.0, 239.0, 0.9],
    "SIMPLE_RADIAL_FISHEYE": [410.0, 321.0, 239.0, 0.05],
    "RADIAL_FISHEYE": [410.0, 321.0, 239.0, 0.05, -0.01],
    "THIN_PRISM_FISHEYE": [410.0, 395.0, 321.0, 239.0, 0.05, -0.01, 1e-3,
                           -5e-4, 2e-3, -1e-3, 1e-3, -1e-3],
}


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from privacy_preserving_sfm_tpu.features import extraction as jx
    from privacy_preserving_sfm_tpu.ops import cameras as jcam
    from privacy_preserving_sfm_tpu.ops import lines as jlines

    return jax, jnp, jx, jcam, jlines


def _pixels(seed=0, n=400):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, 640, n), rng.uniform(0, 480, n)], -1)


@pytest.mark.parametrize("model", list(PARAMS))
def test_image_to_world_matches_reference(ref, model):
    jax, jnp, jx, jcam, jlines = ref
    params = np.asarray(PARAMS[model])
    xy = _pixels()
    want = np.asarray(jcam.image_to_world(model, jnp.asarray(params),
                                          jnp.asarray(xy)))
    got = tcam.image_to_world(model, torch.from_numpy(params),
                              torch.from_numpy(xy)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    # And the inverse of WorldToImage where Newton converged.
    back = tcam.world_to_image(model, torch.from_numpy(params),
                               torch.from_numpy(got)).numpy()
    assert np.median(np.abs(back - xy)) < 1e-8
    np.testing.assert_allclose(
        tcam.mean_focal_length(model, torch.from_numpy(params)).item(),
        float(jcam.mean_focal_length(model, jnp.asarray(params))), rtol=0,
        atol=0)


def test_solve3_matches_reference(ref):
    jax, jnp, *_ = ref
    from privacy_preserving_sfm_tpu.ops import linalg as jlinalg

    rng = np.random.default_rng(2)
    A = rng.standard_normal((50, 3, 3))
    A[0] = 0.0  # singular: the eps guard
    b = rng.standard_normal((50, 3))
    want = np.asarray(jlinalg.solve3(jnp.asarray(A), jnp.asarray(b)))
    got = tlinalg.solve3(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_lift_matches_reference_given_its_draws(ref):
    jax, jnp, jx, jcam, jlines = ref
    rng = np.random.default_rng(3)
    n = 300
    pts = rng.uniform(-0.8, 0.8, (n, 2))
    g = rng.standard_normal(3)
    g /= np.linalg.norm(g)
    aligned = rng.random(n) < 0.5
    key = jax.random.PRNGKey(7)
    want = np.asarray(jlines.lift_keypoints_to_lines(
        key, jnp.asarray(pts), jnp.asarray(g), jnp.asarray(aligned)))
    rnd = np.array(jax.random.normal(key, (n, 3), dtype=jnp.float64))
    got = tlines.lift_with_directions(
        torch.from_numpy(pts), torch.from_numpy(g), torch.from_numpy(aligned),
        torch.from_numpy(rnd)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(got[:, :2], axis=1), 1.0,
                               atol=1e-12)
    x_hom = np.concatenate([pts, np.ones((n, 1))], 1)
    assert np.abs((got * x_hom).sum(1)).max() < 1e-12  # through the point
    assert np.abs(got[aligned] @ g).max() < 1e-12  # contains gravity
    np.testing.assert_allclose(
        tlines.normalize_lines(torch.from_numpy(rnd)).numpy(),
        np.asarray(jlines.normalize_lines(jnp.asarray(rnd))), rtol=1e-15)
    gen = torch.Generator().manual_seed(0)
    drawn = tlines.lift_keypoints_to_lines(
        torch.from_numpy(pts), torch.from_numpy(g), torch.from_numpy(aligned),
        gen)
    np.testing.assert_allclose(drawn.numpy()[aligned], got[aligned],
                               atol=1e-12)


@pytest.mark.parametrize("ratio", [0.5, 0.3, 1.0, 0.0])
def test_aligned_split_matches_reference_given_its_draws(ref, ratio):
    jax, jnp, jx, jcam, jlines = ref
    rng = np.random.default_rng(4)
    for n_valid in (0, 1, 7, 200):
        valid = np.zeros(257, bool)
        valid[rng.choice(257, n_valid, replace=False)] = True
        key = jax.random.PRNGKey(n_valid)
        want = np.asarray(jx.aligned_split_mask(key, jnp.asarray(valid),
                                                ratio))
        u = np.array(jax.random.uniform(key, (257,)))
        got = tx.aligned_split_from_uniforms(
            torch.from_numpy(valid), torch.from_numpy(u), ratio).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.sum() == int(np.floor(ratio * n_valid))
        assert not got[~valid].any()


def test_lift_features_matches_reference_given_its_draws(ref):
    """``lift_features`` on fixed keypoints (float64, OPENCV): aligned
    flags equal and lines to 1e-12."""
    jax, jnp, jx, jcam, jlines = ref
    from privacy_preserving_sfm_tpu.features import sift as js

    rng = np.random.default_rng(5)
    K = 300
    kp = np.concatenate([_pixels(5, K), rng.uniform(1, 5, (K, 2))], 1)
    valid = rng.random(K) < 0.8
    params = np.asarray(PARAMS["OPENCV"])
    g = np.asarray([0.01, 0.99, -0.05])
    desc = rng.integers(0, 256, (K, 128)).astype(np.uint8)
    key = jax.random.PRNGKey(11)
    want = jx.lift_features(
        key, js.SiftFeatures(jnp.asarray(kp), jnp.asarray(desc),
                             jnp.asarray(valid), jnp.zeros(K)),
        "OPENCV", jnp.asarray(params), jnp.asarray(g), 0.5)
    k_split, k_lift = jax.random.split(key)
    u = np.array(jax.random.uniform(k_split, (K,)))
    rnd = np.array(jax.random.normal(k_lift, (K, 3), dtype=jnp.float64))
    feats = ts.SiftFeatures(torch.from_numpy(kp)[None],
                            torch.from_numpy(desc)[None],
                            torch.from_numpy(valid)[None],
                            torch.zeros(1, K))
    got = tx.lift_features_with_draws(
        feats, "OPENCV", torch.from_numpy(params)[None],
        torch.from_numpy(g)[None], 0.5, torch.from_numpy(u)[None],
        torch.from_numpy(rnd)[None])
    np.testing.assert_array_equal(got.aligned[0].numpy(),
                                  np.asarray(want.aligned))
    np.testing.assert_allclose(got.lines[0].numpy(), np.asarray(want.lines),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.descriptors[0].numpy(), desc)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_mask_drops_keypoints_by_their_rounded_position(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device(device)
    rng = np.random.default_rng(6)
    img = torch.from_numpy(rng.integers(0, 256, (2, 120, 160))
                           .astype(np.uint8)).to(dev)
    opts = ts.SiftOptions(max_num_features=256, num_octaves=2)
    mask = torch.zeros((2, 120, 160), dtype=torch.bool, device=dev)
    mask[:, :, :80] = True
    args = ("SIMPLE_PINHOLE",
            torch.tensor([[150.0, 80.0, 60.0]] * 2, device=dev),
            torch.tensor([[0.0, 1.0, 0.0]] * 2, device=dev))

    def run(masks):
        gens = [torch.Generator().manual_seed(i) for i in range(2)]
        return tx.extract_and_lift_batch(img, *args, gens, opts, 0.5, masks)

    full = run(None)
    half = run(mask)
    feats = ts.extract_sift(tx.normalize_u8(img), opts)
    x = torch.round(feats.keypoints[..., 0]).clamp(0, 159)
    assert torch.equal(half.valid, full.valid & (x < 80))
    assert 0 < half.valid.sum() < full.valid.sum()
    torch.testing.assert_close(half.descriptors, full.descriptors)
    # The split counts each image's own valid keypoints.
    assert torch.equal(half.aligned.sum(1), half.valid.sum(1) // 2)
    one = tx.extract_and_lift(img[1], args[0], args[1][1], args[2][1],
                              torch.Generator().manual_seed(1), opts)
    # One image alone: a convolution over another batch size may sum in
    # another order, so descriptors may move by a quantum.
    torch.testing.assert_close(one.valid[0], full.valid[1])
    torch.testing.assert_close(one.aligned[0], full.aligned[1])
    assert (one.descriptors[0].int() - full.descriptors[1].int()).abs(
        ).max() <= 1
    torch.testing.assert_close(one.lines[0], full.lines[1], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("shape,size", [((300, 417), 200), ((480, 640), 333),
                                        ((97, 55), 96), ((1200, 1600), 1200),
                                        ((120, 80), 200)])
def test_resize_to_max_matches_reference(ref, shape, size):
    """Float images to 1e-6.  uint8 images: the reference rounds its own
    float32 sums, so a value within float32 error of a half rounds either
    way; at most 0.1 % of pixels differ, each by one level."""
    jax, jnp, jx, jcam, jlines = ref
    rng = np.random.default_rng(sum(shape))
    u8 = rng.integers(0, 256, shape).astype(np.uint8)
    want, ws = jx.resize_to_max(u8.astype(np.float32) / 255.0, size)
    got, gs = tx.resize_to_max(u8.astype(np.float32) / 255.0, size)
    assert gs == ws and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    want, _ = jx.resize_to_max(u8, size)
    got, _ = tx.resize_to_max(u8, size)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("src,dst", [((300, 417), (200, 278)),
                                     ((97, 55), (96, 54)),
                                     ((2400, 3200), (1200, 1600)),
                                     ((1000, 1333), (750, 1000))])
def test_mask_resize_matches_reference(ref, src, dst):
    """Masks shrink with their image (``max_image_size``): equal pixels."""
    jax, jnp, jx, jcam, jlines = ref
    mask = np.random.default_rng(0).random(src) < 0.5
    want = np.asarray(jax.image.resize(jnp.asarray(mask, jnp.float32), dst,
                                       "nearest")) > 0.5
    np.testing.assert_array_equal(tx.resize_mask(mask, dst), want)


# ---------------------------------------------------------------------------
# The PNG codec and the readers
# ---------------------------------------------------------------------------


def _pil_files(tmp_path):
    """PNGs written by PIL: every colour type the codec reads, each with
    PIL's default, optimized and uncompressed encodings."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0)
    h, w = 37, 53
    ramp = (np.add.outer(np.arange(h), np.arange(w)) * 3 % 256)
    images = {
        "L": Image.fromarray((ramp + rng.integers(0, 30, (h, w)))
                             .astype(np.uint8), "L"),
        "LA": Image.fromarray(rng.integers(0, 256, (h, w, 2))
                              .astype(np.uint8), "LA"),
        "RGB": Image.fromarray(rng.integers(0, 256, (h, w, 3))
                               .astype(np.uint8), "RGB"),
        "RGBA": Image.fromarray(rng.integers(0, 256, (h, w, 4))
                                .astype(np.uint8), "RGBA"),
        "P": Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
                             "RGB").convert("P", palette=Image.ADAPTIVE,
                                            colors=200),
    }
    paths = []
    for mode, im in images.items():
        for i, opt in enumerate([{}, {"optimize": True},
                                 {"compress_level": 0}]):
            path = str(tmp_path / f"{mode}{i}.png")
            im.save(path, **opt)
            paths.append(path)
    return paths


def _filters(path):
    import zlib

    with open(path, "rb") as fh:
        chunks = list(png._chunks(fh.read()))
    w, h, _, color = np.frombuffer(chunks[0][1][:10], ">u4", 2).tolist() + [
        None, chunks[0][1][9]]
    raw = zlib.decompress(b"".join(b for k, b in chunks if k == b"IDAT"))
    rows = np.frombuffer(raw, np.uint8).reshape(h, -1)
    return set(rows[:, 0].tolist())


def test_png_codec_reads_pil_files_byte_equal(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    seen = set()
    for path in _pil_files(tmp_path):
        with Image.open(path) as im:
            want = np.asarray(im.convert("L"))
            full = np.asarray(im.convert("RGBA" if im.mode in ("RGBA", "P")
                                         else im.mode))
        np.testing.assert_array_equal(png.read_png_gray(path), want)
        got = png.read_png(path)
        if got.ndim == 3 and got.shape[-1] == 3 and full.shape[-1] == 4:
            full = full[..., :3]  # palette images without transparency
        np.testing.assert_array_equal(got, full)
        seen |= _filters(path)
    assert seen == {0, 1, 2, 3, 4}  # all five row filters were exercised


def test_png_writer_round_trips(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    img = np.random.default_rng(1).integers(0, 256, (61, 83)).astype(np.uint8)
    path = str(tmp_path / "w.png")
    png.write_png_gray(path, img)
    with Image.open(path) as im:
        assert im.mode == "L"
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(png.read_png_gray(path), img)


def test_png_codec_refuses_what_it_cannot_read(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    path = str(tmp_path / "i16.png")
    Image.fromarray(np.zeros((4, 4), np.uint16) + 300).save(path)
    with pytest.raises(ValueError, match="bit depth 16"):
        png.read_png(path)
    with open(path, "rb") as fh:
        data = bytearray(fh.read())
    data[40] ^= 0xFF  # inside the first chunk: CRC fails
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as fh:
        fh.write(bytes(data))
    with pytest.raises(ValueError, match="CRC|not a PNG"):
        png.read_png(bad)


def test_loaders_without_pil(tmp_path, monkeypatch):
    """Without PIL, PNGs load through the codec with PIL's bytes and any
    other format raises, naming PIL; EXIF reads fall back as the
    reference's do when they fail."""
    paths = _pil_files(tmp_path)
    want = [tx.load_image_grayscale_u8(p) for p in paths]
    monkeypatch.setattr(tx, "_pil_image", lambda: None)
    for p, w in zip(paths, want):
        np.testing.assert_array_equal(tx.load_image_grayscale_u8(p), w)
    jpg = str(tmp_path / "x.jpg")
    open(jpg, "wb").close()
    with pytest.raises(RuntimeError, match="PIL"):
        tx.load_image_grayscale_u8(jpg)
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    assert tfocal.exif_focal_length(paths[0], 640, 480) == (1.2 * 640, False)
    assert tx.read_exif_gps(paths[0]) is None


def test_sidecar_readers_match_reference(ref, tmp_path):
    jax, jnp, jx, jcam, jlines = ref
    img = str(tmp_path / "a.png")
    png.write_png_gray(img, np.zeros((8, 8), np.uint8))
    with open(img + ".gravity.txt", "w") as f:
        f.write("0.1 -0.9 0.05\n")
    with open(img + ".camera_model.txt", "w") as f:
        f.write("opencv, 400, 401, 320, 240,\n-0.1, 0.01, 0, 0\n")
    with open(img + ".gps.txt", "w") as f:
        f.write("47.37 8.54 408.0\n")
    mask = np.zeros((8, 8), np.uint8)
    mask[2:5] = 255
    png.write_png_gray(img + ".mask.png", mask)
    np.testing.assert_array_equal(tx.read_gravity_file(img),
                                  jx.read_gravity_file(img))
    (m1, p1), (m2, p2) = tx.read_camera_model_file(img), \
        jx.read_camera_model_file(img)
    assert m1 == m2 == "OPENCV"
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(tx.read_exif_gps(img), jx.read_exif_gps(img))
    np.testing.assert_array_equal(tx.read_mask(img), jx.read_mask(img))
    other = str(tmp_path / "b.png")
    assert tx.read_gravity_file(other) is None
    assert tx.read_camera_model_file(other) is None
    assert tx.read_mask(other) is None


def test_exif_focal_and_sensor_db_match_reference(ref, tmp_path):
    from privacy_preserving_sfm_tpu.features import exif_focal as jfocal
    from privacy_preserving_sfm_tpu.features import sensor_db as jsensor

    Image = pytest.importorskip("PIL.Image")
    plain = str(tmp_path / "plain.jpg")
    Image.new("L", (64, 48)).save(plain)
    tagged = str(tmp_path / "tagged.jpg")
    exif = Image.Exif()
    exif[271], exif[272] = "Canon", "Canon EOS 5D Mark III"
    ifd = exif.get_ifd(0x8769)
    ifd[37386] = 24.0
    Image.new("L", (64, 48)).save(tagged, exif=exif)
    for path in (plain, tagged):
        assert tfocal.exif_focal_length(path, 64, 48) == \
            jfocal.exif_focal_length(path, 64, 48)
    assert tsensor.SENSOR_DB == jsensor.SENSOR_DB
    for make, model in [("Canon", "Canon EOS 5D Mark III"),
                        ("Apple", "iPhone 12"), ("GoPro", "HERO9 Black"),
                        ("Nobody", "Nothing")]:
        assert tsensor.query_sensor_width(make, model) == \
            jsensor.query_sensor_width(make, model)
        assert tfocal.query_sensor_width(make, model) == \
            jfocal.query_sensor_width(make, model)
    assert os.path.exists(plain)
