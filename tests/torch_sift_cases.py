"""Shared images, options and checks of the SIFT parity tests
(``test_torch_sift.py``, ``test_torch_sift_modes.py``).

``ref`` imports the reference package inside a fixture, so the ``cuda``
cases of those files run where JAX is not installed.
"""

import math
import os

import numpy as np
import pytest
import torch

from privacy_preserving_sfm_torch.features import sift as ts
from privacy_preserving_sfm_torch.utils.synthetic import _cubic_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Two octaves keep the reference's eager op compiles within a file's time;
# every stage still runs on an upsampled and on a native octave.
SMALL = dict(max_num_features=512, candidates_per_octave=256, num_octaves=2)
MODES = {
    "half_bf16": {},
    "full_bf16": dict(dense_half_res=False),
    "half_f32": dict(dense_bf16=False),
    "full_f32": dict(dense_half_res=False, dense_bf16=False),
    "gather": dict(descriptor_mode="gather"),
    "affine": dict(estimate_affine_shape=True),
    "dsp": dict(domain_size_pooling=True, dsp_num_scales=4),
}


def texture_image(seed=0, h=200, w=240):
    """A random grid at a quarter of the size, cubic-upsampled."""
    grid = np.random.default_rng(seed).uniform(0, 1, (h // 4, w // 4))
    img = _cubic_matrix(h // 4, h) @ grid @ _cubic_matrix(w // 4, w).T
    return ((img - img.min()) / (img.max() - img.min())).astype(np.float32)


def blob_image(seed=0, h=200, w=240, n_blobs=25):
    """Random Gaussian blobs (``tests/test_features.py:10-21``)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w))
    ys, xs = rng.uniform(20, h - 20, n_blobs), rng.uniform(20, w - 20, n_blobs)
    sigs = rng.uniform(2.0, 5.0, n_blobs)
    amps = rng.uniform(0.4, 1.0, n_blobs) * np.sign(
        rng.standard_normal(n_blobs))
    yy, xx = np.mgrid[0:h, 0:w]
    for y, x, s, a in zip(ys, xs, sigs, amps):
        img += a * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * s * s))
    return ((img - img.min()) / (img.max() - img.min() + 1e-9)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from privacy_preserving_sfm_tpu.features import sift as js

    return jax, jnp, js


def opts_pair(ref, **kw):
    js = ref[2]
    jo = js.SiftOptions(**SMALL)._replace(**kw)
    return jo, ts.SiftOptions(**jo._asdict())


def as_batch(a):
    return torch.from_numpy(np.array(a))[None]


def first_octave(ref, img):
    """Both packages' first octave (upsampled, pre-blurred) of ``img``."""
    jax, jnp, js = ref
    sig = math.sqrt(1.6 ** 2 - 1.0)
    bj = js._blur(js._upsample2(jnp.asarray(img)), sig)
    bt = ts._blur(ts._upsample2(torch.from_numpy(img)[None]), sig)
    return bj, bt


@pytest.fixture(scope="module")
def octaves(ref):
    """The reference's octave images of the texture: (octave 0, octave 1)."""
    jax, jnp, js = ref
    bj, _ = first_octave(ref, texture_image())
    o1 = js._downsample2(js._blur(bj, math.sqrt(3 * 1.6 ** 2)))
    return bj, o1


def angle_err(a, b):
    return np.abs((a - b + np.pi) % (2 * np.pi) - np.pi)


def check_octave_features(ref, octaves, mode, octave):
    """The port's orientation and descriptor stage of ``mode`` on the
    reference's own Gaussian levels and DoG of ``octave``: the same
    keypoints, x, y and sigma to 1e-4, thetas to 1e-4 and float
    descriptors to 1e-4 (in the bf16 dense modes, 0.1 % of entries may
    differ by a bf16 step: a value on a rounding boundary may round the
    other way)."""
    jax, jnp, js = ref
    jo, to = opts_pair(ref, **MODES[mode])
    gj, dj = js._octave_pyramid(octaves[octave], jo)
    oj = js._octave_features(octaves[octave], octave, jo, jnp.float32)
    ot = ts._octave_features(as_batch(gj), as_batch(dj), octave, to)
    v = np.asarray(oj[5])
    assert v.sum() >= 20
    np.testing.assert_array_equal(ot[5][0].numpy(), v)
    for i in range(3):  # x, y, sigma
        np.testing.assert_allclose(ot[i][0].numpy()[v], np.asarray(oj[i])[v],
                                   rtol=1e-5, atol=1e-4)
    assert angle_err(ot[3][0].numpy()[v], np.asarray(oj[3])[v]).max() <= 1e-4
    err = np.abs(ot[4][0].numpy()[v] - np.asarray(oj[4])[v])
    if jo.dense_bf16 and jo.descriptor_mode == "dense":
        assert (err > 1e-4).mean() <= 1e-3 and err.max() <= 2e-3
    else:
        assert err.max() <= 1e-4


def match_keypoints(ka, kb, tol_px=0.01, tol_scale=1e-3):
    """For each row of ka (N, 4), the row of kb at the same place and
    scale with the nearest angle, or -1."""
    out = np.full(len(ka), -1)
    for i, k in enumerate(ka):
        near = np.nonzero((np.abs(kb[:, :2] - k[:2]).max(1) <= tol_px)
                          & (np.abs(kb[:, 2] - k[2]) <= tol_scale * k[2]))[0]
        if len(near):
            out[i] = near[np.argmin(angle_err(kb[near, 3], k[3]))]
    return out


# Each image's share of keypoints (both ways) with a counterpart within
# 0.01 px and 1e-3 relative scale, and the share of those whose angle is
# within 0.02 rad and whose uint8 descriptor is within 2 quanta (L-inf).
BARS = dict(matched=0.9, close=0.9)


def check_extract_sift(ref, mode, kind):
    """Both packages' ``extract_sift`` of one image in ``mode``, held as
    keypoint sets by ``BARS``."""
    jax, jnp, js = ref
    img = texture_image(3) if kind == "texture" else blob_image(3)
    jo, to = opts_pair(ref, **MODES[mode])
    fj = js.extract_sift(jnp.asarray(img), jo)
    ft = ts.extract_sift(torch.from_numpy(img)[None], to)
    vj, vt = np.asarray(fj.valid), ft.valid[0].numpy()
    kj, kt = np.asarray(fj.keypoints)[vj], ft.keypoints[0].numpy()[vt]
    dj = np.asarray(fj.descriptors)[vj].astype(int)
    dt = ft.descriptors[0].numpy()[vt].astype(int)
    assert len(kj) >= 20
    assert (match_keypoints(kt, kj) >= 0).mean() >= BARS["matched"]
    m = match_keypoints(kj, kt)
    assert (m >= 0).mean() >= BARS["matched"]
    i = np.nonzero(m >= 0)[0]
    close = ((angle_err(kt[m[i], 3], kj[i, 3]) <= 0.02)
             & (np.abs(dt[m[i]] - dj[i]).max(1) <= 2))
    assert close.mean() >= BARS["close"], close.mean()
    assert ft.descriptors.dtype == torch.uint8
    assert not ft.descriptors[0][~ft.valid[0]].any()
    np.testing.assert_array_equal(ft.scores[0].numpy()[vt], kt[:, 2])
