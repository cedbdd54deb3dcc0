"""Port parity for SIFT, stage by stage: ``features/sift.py`` against the
reference package.

The same numpy images (a textured image and a blob image, 200 x 240) go
through the reference's SIFT (eager, on the CPU) and the port's on the
CPU.  On the reference's own intermediate arrays the port agrees to
float32 rounding: pyramid and DoG to 1e-6, the candidates' validity
exactly and their refined x, y and level to 1e-4, ``top_k``'s order on
ties exactly, orientation peaks to 1e-5, and the dense stage of all four
``dense_half_res`` x ``dense_bf16`` settings as ``check_octave_features``
states.  The gather, affine and DSP stages and the whole ``extract_sift``
are in ``test_torch_sift_modes.py``.

The ``cuda`` cases hold the port on the card against its own CPU run and
against itself; they import no JAX, so they run with ``--noconftest``
where JAX is not installed.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_sift_cases import (  # noqa: F401  (ref, octaves: fixtures)
    MODES, REPO, SMALL, as_batch, blob_image, check_octave_features,
    first_octave, match_keypoints, octaves, opts_pair, ref, texture_image,
)

from privacy_preserving_sfm_torch.features import sift as ts

torch.set_num_threads(2)


def test_options_carry_the_reference_fields(ref):
    js = ref[2]
    assert ts.SiftOptions._fields == js.SiftOptions._fields
    assert ts.SiftOptions._field_defaults == js.SiftOptions._field_defaults
    assert ts.SiftFeatures._fields == js.SiftFeatures._fields


@pytest.mark.parametrize("kind", ["texture", "blob"])
def test_pyramid_and_dog_match_reference(ref, kind):
    jax, jnp, js = ref
    img = texture_image() if kind == "texture" else blob_image()
    jo, to = opts_pair(ref)
    bj, bt = first_octave(ref, img)
    np.testing.assert_allclose(bt[0].numpy(), np.asarray(bj), rtol=0,
                               atol=1e-6)
    for _ in range(2):
        gj, dj = js._octave_pyramid(bj, jo)
        gt, dt = ts._octave_pyramid(bt, to)
        np.testing.assert_allclose(gt[0].numpy(), np.asarray(gj), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(dt[0].numpy(), np.asarray(dj), rtol=0,
                                   atol=1e-6)
        bj = js._downsample2(js._blur(bj, math.sqrt(3 * 1.6 ** 2)))
        bt = ts._blur(bt, math.sqrt(3 * 1.6 ** 2))[:, ::2, ::2]


@pytest.mark.parametrize("octave", [0, 1])
def test_candidates_match_reference(ref, octaves, octave):
    jax, jnp, js = ref
    jo, to = opts_pair(ref)
    _, dj = js._octave_pyramid(octaves[octave], jo)
    budget = js._octave_budget(jo, octave)
    cj = js._octave_candidates(dj, jo, jnp.float32, budget)
    ct = ts._octave_candidates(as_batch(dj), to, budget)
    vj = np.asarray(cj[5])
    assert vj.sum() >= 20
    np.testing.assert_array_equal(ct[5][0].numpy(), vj)
    for i in range(3):  # refined x, y and DoG level
        np.testing.assert_allclose(ct[i][0].numpy()[vj], np.asarray(cj[i])[vj],
                                   rtol=0, atol=1e-4)
    np.testing.assert_allclose(ct[4][0].numpy()[vj], np.asarray(cj[4])[vj],
                               rtol=1e-4, atol=0)


def test_top_k_keeps_the_lower_index_on_ties(ref):
    jax, jnp, js = ref
    rng = np.random.default_rng(0)
    x = rng.integers(-3, 4, (5, 300)).astype(np.float32) * 0.25
    x[0] = 0.0
    x[1, ::7] = -1.0
    for k in (1, 17, 300):
        vj, ij = jax.lax.top_k(jnp.asarray(x), k)
        vt, it = ts.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_orientation_peaks_match_reference(ref):
    jax, jnp, js = ref
    rng = np.random.default_rng(1)
    hists = rng.gamma(1.0, 1.0, (400, 36)).astype(np.float32)
    hists[:40] = np.roll(hists[:40], 18, axis=1) + hists[:40]  # twin peaks
    hists[40:60] = 0.0
    jo, to = opts_pair(ref)
    thj, okj = js._orientation_peaks(jnp.asarray(hists), jo, jnp.float32)
    tht, okt = ts._orientation_peaks(torch.from_numpy(hists), to)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(tht.numpy(), np.asarray(thj), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("mode,octave", [("half_bf16", 0)] + [
    (m, 1) for m in ("half_bf16", "full_bf16", "half_f32", "full_f32")])
def test_dense_stage_matches_reference(ref, octaves, mode, octave):
    """The dense stage in all four settings (the upsampled octave for the
    default one, the native octave for all)."""
    check_octave_features(ref, octaves, mode, octave)


def test_tf32_is_off_inside_sift_and_restored(monkeypatch):
    """Every convolution inside ``extract_sift`` runs with TF32 off and
    cuDNN deterministic, whatever the caller set, and the caller's flags
    return."""
    seen = []
    conv2d = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.deterministic))
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    ts.extract_sift(torch.from_numpy(texture_image())[None],
                    ts.SiftOptions(**SMALL))
    assert seen and set(seen) == {(False, False, True)}
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["half_bf16", "full_f32", "affine"])
def test_cuda_matches_cpu_and_itself(cuda, mode):
    """The card against the CPU (98 % of keypoints within 0.01 px and 1e-4
    relative scale, 99 % of those within 2 descriptor quanta), and two
    runs on the card bit-equal."""
    opts = ts.SiftOptions(**SMALL)._replace(**MODES[mode])
    img = torch.from_numpy(np.stack([texture_image(4), blob_image(4)]))
    cpu = ts.extract_sift(img, opts)
    a = ts.extract_sift(img.to(cuda), opts)
    b = ts.extract_sift(img.to(cuda), opts)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for i in range(2):
        vc, vg = cpu.valid[i].numpy(), a.valid[i].cpu().numpy()
        kc, kg = cpu.keypoints[i].numpy()[vc], a.keypoints[i].cpu().numpy()[vg]
        m = match_keypoints(kc, kg, tol_scale=1e-4)
        assert (m >= 0).mean() >= 0.98
        j = np.nonzero(m >= 0)[0]
        dc = cpu.descriptors[i].numpy()[vc].astype(int)
        dg = a.descriptors[i].cpu().numpy()[vg].astype(int)
        assert (np.abs(dg[m[j]] - dc[j]).max(1) <= 2).mean() >= 0.99


@pytest.mark.cuda
def test_tf32_off_inside_sift_in_a_fresh_process(cuda):
    """A fresh process with torch's default flags (cuDNN TF32 on): every
    convolution inside SIFT sees TF32 off, the flag is on again after, and
    the result equals a run with TF32 off for the whole process."""
    code = (
        "import numpy as np, torch\n"
        "import torch.nn.functional as F\n"
        "from privacy_preserving_sfm_torch.features import sift\n"
        "assert torch.backends.cudnn.allow_tf32\n"
        "seen = []\n"
        "conv = F.conv2d\n"
        "def spy(*a, **k):\n"
        "    seen.append(torch.backends.cudnn.allow_tf32)\n"
        "    return conv(*a, **k)\n"
        "F.conv2d = spy\n"
        "rng = np.random.default_rng(0)\n"
        "img = torch.from_numpy(rng.random((2, 240, 320), np.float32))\n"
        "opts = sift.SiftOptions(max_num_features=1024)\n"
        "a = sift.extract_sift(img.cuda(), opts)\n"
        "assert seen and not any(seen), seen\n"
        "assert torch.backends.cudnn.allow_tf32\n"
        "torch.backends.cudnn.allow_tf32 = False\n"
        "b = sift.extract_sift(img.cuda(), opts)\n"
        "assert all(torch.equal(x, y) for x, y in zip(a, b))\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr
