"""The front end's random draws: CPU generators on every device.

Image k of ``feature_extractor --seed s`` draws its aligned split and then
its line directions from ``torch.Generator().manual_seed(image_seed(s,
k))`` on the CPU, whatever ``--device`` says, and the draws move to the
features' device: the card writes the CPU's split and directions.  A
generator on another device is refused.  uint8 images become the CPU's
float32 levels on every device, so SIFT orders its keypoints, and with
them the draws, as the CPU does.  The ``cuda`` case holds the card's lift
against the CPU's on a rendered image (run on a card with ``python -m
pytest --noconftest -m cuda tests/test_torch_draws.py``).
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

from privacy_preserving_sfm_torch.exe import ppsfm
from privacy_preserving_sfm_torch.features import extraction as tx
from privacy_preserving_sfm_torch.features import sift as ts
from privacy_preserving_sfm_torch.ops import lines as tlines

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _feats(K, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    kp = np.concatenate([rng.uniform(0, 160, (2, K, 2)),
                         rng.uniform(1, 5, (2, K, 2))], -1)
    return ts.SiftFeatures(
        torch.from_numpy(kp).to(dtype),
        torch.from_numpy(rng.integers(0, 256, (2, K, 128)).astype(np.uint8)),
        torch.from_numpy(rng.random((2, K)) < 0.8), torch.zeros(2, K))


def _lift(feats, generators):
    params = torch.tensor([[150.0, 80.0, 60.0]] * 2,
                          dtype=feats.keypoints.dtype)
    grav = torch.tensor([[0.0, 1.0, 0.0]] * 2, dtype=feats.keypoints.dtype)
    return tx.lift_features(feats, "SIMPLE_PINHOLE", params, grav, 0.5,
                            generators)


class _CardGenerator:
    """Stands for a generator on a card, which a CPU-only build of torch
    cannot make: the lift must refuse it before drawing."""

    device = torch.device("cuda", 0)


@pytest.mark.parametrize("seed,positions,dtype", [
    (0, (0, 1), torch.float32), (7, (3, 12), torch.float32),
    (2024, (299, 5), torch.float64)])
def test_front_end_draws_are_the_cpu_generators(monkeypatch, seed,
                                                 positions, dtype):
    """The uniforms (K) and normals (K, 3) that image k's lift uses are
    ``torch.Generator().manual_seed(image_seed(s, k))``'s, in that order
    and in the features' dtype."""
    seen = {}
    inner = tx.lift_features_with_draws

    def keep(feats, model, params, grav, ratio, uniforms, normals):
        seen.update(uniforms=uniforms, normals=normals)
        return inner(feats, model, params, grav, ratio, uniforms, normals)

    monkeypatch.setattr(tx, "lift_features_with_draws", keep)
    K = 97
    seeds = [ppsfm.image_seed(seed, k) for k in positions]
    out = _lift(_feats(K, seed, dtype),
                [torch.Generator().manual_seed(s) for s in seeds])
    for b, s in enumerate(seeds):
        g = torch.Generator().manual_seed(s)
        assert torch.equal(seen["uniforms"][b], torch.rand(K, generator=g))
        assert torch.equal(seen["normals"][b],
                           torch.randn(K, 3, generator=g, dtype=dtype))
    assert seen["normals"].dtype == dtype
    assert torch.equal(out.aligned.sum(1), out.valid.sum(1) // 2)


@pytest.mark.parametrize("where", ["lift_features", "lift_keypoints"])
def test_a_device_generator_is_refused(where):
    rng = np.random.default_rng(1)
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        if where == "lift_features":
            _lift(_feats(16, 1), [torch.Generator(), _CardGenerator()])
        else:
            tlines.lift_keypoints_to_lines(
                torch.from_numpy(rng.uniform(-1, 1, (16, 2))),
                torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64),
                torch.from_numpy(rng.random(16) < 0.5), _CardGenerator())


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cli_batch_hands_cpu_generators_whatever_the_device(monkeypatch,
                                                            device):
    """``feature_extractor``'s batch function builds CPU generators seeded
    from ``image_seed(--seed, k)`` whatever ``--device`` says; "meta" stands
    for a device other than the CPU (it needs no card), its tensors never
    computed."""
    seen = []

    def fake_batch(images, model, params, grav, generators, opts, ratio,
                   masks):
        seen.extend(generators)
        B, K = images.shape[0], 5
        return tx.LiftedFeatures(
            torch.zeros(B, K, 128, dtype=torch.uint8), torch.zeros(B, K, 3),
            torch.zeros(B, K, dtype=torch.bool),
            torch.ones(B, K, dtype=torch.bool), torch.zeros(B, 3))

    monkeypatch.setattr(tx, "extract_and_lift_batch", fake_batch)
    written = []
    db = types.SimpleNamespace(
        write_descriptors=lambda iid, d: written.append(iid),
        write_lines=lambda iid, lines, aligned: None,
        write_gravity=lambda iid, g: None)
    args = types.SimpleNamespace(batch_size=3, aligned_line_ratio=0.5,
                                 seed=11)
    batch = [dict(iid=k + 1, name=f"img{k}", model="SIMPLE_PINHOLE",
                  img=np.zeros((8, 8), np.uint8), mask=None,
                  seed=ppsfm.image_seed(args.seed, k),
                  params=np.asarray([10.0, 4.0, 4.0], np.float32),
                  gravity=np.asarray([0.0, 1.0, 0.0])) for k in (4, 9)]
    ppsfm._flush_extraction_batch(db, batch, ts.SiftOptions(), args,
                                  torch.device(device))
    assert written == [5, 10]
    # Two images and the padding's repeat of the last.
    assert [g.device.type for g in seen] == ["cpu"] * 3
    want = [ppsfm.image_seed(11, k) for k in (4, 9, 9)]
    assert [g.initial_seed() for g in seen] == want


def test_uint8_levels_are_the_cpu_division():
    """Each level i becomes float32(i / 255) correctly rounded, as numpy
    and the CPU divide; the product by a rounded reciprocal, which CUDA
    computes for a division by a host scalar, is off for some levels."""
    levels = torch.arange(256, dtype=torch.uint8).reshape(2, 8, 16)
    got = tx.normalize_u8(levels).reshape(-1).numpy()
    want = np.arange(256, dtype=np.float32) / np.float32(255.0)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32
    assert not np.array_equal(got, np.arange(256, dtype=np.float32)
                              * np.float32(1.0 / 255.0))
    assert torch.equal(tx.normalize_u8(levels), levels.float() / 255.0)


@pytest.mark.cuda
def test_card_lift_draws_the_cpu_samples(tmp_path):
    """The rendered plane image of ``chip_smoke.py``'s phase ``sift``
    through SIFT and ``lift_features`` on the card and on the CPU, each
    from a CPU generator of one seed: at least LIFT_BAR[0] of the CPU's
    keypoints paired within 0.01 px, and on those the aligned flags agree
    on at least LIFT_BAR[0] and the lines within LIFT_BAR[1]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from privacy_preserving_sfm_torch.utils.synthetic import render_dataset

    levels = torch.arange(256, dtype=torch.uint8)
    assert torch.equal(tx.normalize_u8(levels.cuda()).cpu(),
                       tx.normalize_u8(levels))
    render_dataset(str(tmp_path), 7, 640, 480, seed=0, scene="plane")
    got = cs.lift_card_cpu(torch.device("cuda"),
                           os.path.join(tmp_path, "img003.png"))
    print(got)
    assert got["matched"] >= cs.LIFT_BAR[0] * got["keypoints"][0]
    assert got["aligned"] >= cs.LIFT_BAR[0]
    assert got["line_max"] <= cs.LIFT_BAR[1]
