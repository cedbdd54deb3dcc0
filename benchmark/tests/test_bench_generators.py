"""The device generators: deterministic from the seed, and drawing from
the distributions of the port's numpy originals (at small sizes)."""

import numpy as np
import pytest
import torch

from benchmark.core.base import sub_seed
from benchmark.gen import ba_scene, box_frames

CPU = torch.device("cpu")
BA = dict(num_cameras=12, num_points=600, obs_per_point=6, meas_noise=2e-4)


def test_ba_scene_deterministic_and_seeded():
    a = ba_scene.make_scene(BA, sub_seed(2 ** 40 + 3, 0), CPU)
    b = ba_scene.make_scene(BA, sub_seed(2 ** 40 + 3, 0), CPU)
    c = ba_scene.make_scene(BA, sub_seed(2 ** 40 + 4, 0), CPU)
    for x, y in zip(a[:-1], b[:-1]):
        assert torch.equal(x, y)
    assert not torch.equal(a.points, c.points)
    s0 = ba_scene.perturbed_start(a, 11)
    s1 = ba_scene.perturbed_start(a, 11)
    assert all(torch.equal(x, y) for x, y in zip(s0, s1))


def test_ba_scene_matches_synthetic_model():
    from privacy_preserving_sfm_torch.utils import synthetic

    s = ba_scene.make_scene(BA, 5, CPU)
    rec = synthetic.synthetic_model(12, 600, 6, seed=5)
    pts_np = np.array([p.xyz for p in rec.points3d.values()])
    pts = s.points.numpy()
    assert s.obs_cam.shape[0] == 600 * 6
    # Points uniform in the box in front of the cameras, kept where seen.
    for k in range(3):
        assert abs(pts[:, k].mean() - pts_np[:, k].mean()) < 0.25
        assert abs(pts[:, k].std() - pts_np[:, k].std()) < 0.25
    # Observations per camera: the same spread of counts.
    cnt = np.bincount(s.obs_cam.numpy(), minlength=12)
    cnt_np = np.array([len(im.lines) for im in rec.images.values()])
    assert abs(cnt.mean() - cnt_np.mean()) < 1e-9
    assert abs(cnt.std() - cnt_np.std()) < 0.5 * cnt_np.std() + 20
    # Lines pass within the noise of the true projections.
    from benchmark.reference import ba as ref

    prob = ref.to_problem(s.obs_cam, s.obs_pt, s.lines, ba_scene.PARAMS,
                          ba_scene.gauge_mask(12, CPU), 12, 600)
    d = ref.line_distances(prob, s.qvecs, s.tvecs, s.points).abs()
    assert float(d.mean()) == pytest.approx(2e-4 * np.sqrt(2 / np.pi),
                                            rel=0.1)


def test_ba300_lengths_are_the_smokes():
    lengths = ba_scene.ba300_lengths(13409, 128, 755822)
    assert len(lengths) == 13409 and lengths.max() == 128
    assert (lengths == 128).sum() >= 268
    assert abs(int(lengths.sum()) - 755822) < 0.01 * 755822


def test_ba_scene_ragged_tracks():
    cfg = dict(num_cameras=10, num_points=300, longest_track=9,
               num_observations=2000, track_lengths="ba300_model",
               meas_noise=2e-4)
    a = ba_scene.make_scene(cfg, 1, CPU)
    b = ba_scene.make_scene(cfg, 2, CPU)
    # Every seed the same sizes, in another order.
    assert sorted(a.lengths) == sorted(b.lengths)
    assert a.obs_cam.shape == b.obs_cam.shape
    counts = np.bincount(a.obs_pt.numpy(), minlength=300)
    assert (counts == a.lengths).all()


FR = dict(num_frames=6, width=160, height=120, f=100.0, box_texture=128,
          camera_model="SIMPLE_PINHOLE")


def test_box_frames_deterministic():
    a = box_frames.make_frames(FR, 7, CPU)
    b = box_frames.make_frames(FR, 7, CPU)
    c = box_frames.make_frames(FR, 8, CPU)
    assert torch.equal(a.images, b.images)
    assert not torch.equal(a.images, c.images)
    assert a.images.dtype == torch.uint8


def test_box_frames_match_synth_dataset(tmp_path):
    from privacy_preserving_sfm_torch.tools import synth_dataset
    from privacy_preserving_sfm_torch.utils import png

    n = 6
    synth_dataset.make_dataset(str(tmp_path), n, width=160, height=120,
                               f=100.0, seed=3, scene="box")
    ref = np.stack([png.read_png_gray(str(tmp_path / f"img{i:03d}.png"))
                    for i in range(n)]).astype(np.float64)
    cfg = dict(FR, box_texture=800)
    got = box_frames.make_frames(cfg, 3, CPU).images.numpy().astype(
        np.float64)
    # The same share of background, mean level and contrast.
    assert abs((got == 96).mean() - (ref == 96).mean()) < 0.05
    assert abs(got.mean() - ref.mean()) < 12
    assert abs(got.std() - ref.std()) < 12
    g = box_frames.make_frames(cfg, 3, CPU).gravity
    assert torch.allclose(g[:, 1], torch.ones(n), atol=0.01)
