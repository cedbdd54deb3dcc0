"""The BA assembly's track-length cap against the reference package.

A BA problem keeps at most 128 observations of a point: a track longer
than that is thinned to a deterministic stride subset that keeps its
first observation (``sfm/incremental_mapper.py:_cap_track_length``, the
reference's ``_run_ba``).  Tracks that long arise at the reference's
300-view scale, where scene-spanning points are seen by most cameras.  One
hand-built model of 310 images is held by both packages: points whose
tracks hold 129-300 observations beside short ones (or, in the second
case, a longest track of exactly 128, which stays whole).  The port's
``assemble_ba`` must keep exactly the observations the reference's
``_run_ba`` keeps, in the same order (read from the reference's
``PPSFM_BA_DUMP``, before its padding), for a global BA and for a local
BA whose variable points bring in frozen extra cameras.
"""

import glob

import numpy as np
import pytest
import torch

from privacy_preserving_sfm_torch.models import reconstruction as trecon
from privacy_preserving_sfm_torch.sfm import incremental_mapper as tmap
from privacy_preserving_sfm_tpu.models import reconstruction as jrecon
from privacy_preserving_sfm_tpu.optim import ba as jba
from privacy_preserving_sfm_tpu.optim import ba_dense as jbd
from privacy_preserving_sfm_tpu.sfm import incremental_mapper as jmap

NUM_IMAGES = 310
LINES_PER_IMAGE = 12
# Track lengths of the long points: the cap's edge (128 and 129), the
# reference box300 log's scene-spanning tracks (about 300), and between.
LONG = (129, 150, 200, 255, 300, 128)
WHOLE = (128, 128, 100)


def build(pkg, long_lengths, seed=11):
    """One model in the package ``pkg``'s Reconstruction: NUM_IMAGES
    registered images of random lines, points of ``long_lengths``
    observations and 40 of 3-10, each seen once by distinct images."""
    rng = np.random.default_rng(seed)
    rec = pkg.Reconstruction()
    rec.add_camera(pkg.Camera(camera_id=1, model="SIMPLE_PINHOLE",
                              width=640, height=480,
                              params=np.array([500.0, 320.0, 240.0])))
    for iid in range(1, NUM_IMAGES + 1):
        lines = rng.standard_normal((LINES_PER_IMAGE, 3))
        q = rng.standard_normal(4)
        rec.add_image(pkg.Image(
            image_id=iid, name=f"img{iid:03d}.png", camera_id=1,
            qvec=q / np.linalg.norm(q), tvec=rng.normal(0, 1, 3),
            lines=lines / np.linalg.norm(lines[:, :2], axis=1)[:, None],
            aligned=np.zeros(LINES_PER_IMAGE, bool)))
        rec.register_image(iid)
    free = {iid: list(range(LINES_PER_IMAGE))
            for iid in range(1, NUM_IMAGES + 1)}
    lengths = list(long_lengths) + list(rng.integers(3, 11, 40))
    for n in lengths:
        pool = [iid for iid in free if free[iid]]
        images = rng.choice(pool, int(n), replace=False)
        track = [(int(iid), free[int(iid)].pop(0)) for iid in images]
        rec.add_point3d(rng.normal(0, 1, 3) + [0, 0, 8], track)
    return rec


def mappers(long_lengths):
    jm = jmap.IncrementalMapper(None)
    jm.rec = build(jrecon, long_lengths)
    tm = tmap.IncrementalMapper("cpu", torch.float64)
    tm.rec = build(trecon, long_lengths)
    return jm, tm


def configs(rec):
    """A global BA (every image, every point variable) and a local one:
    six images, the first an image of the first (longest) point's track,
    the points of that image variable, every other point of the six
    frozen."""
    reg = list(rec.reg_image_ids)
    centre = rec.points3d[min(rec.points3d)].track[0][0]
    local = [centre] + [iid for iid in reg if iid != centre][:5]
    variable = {int(p) for p in rec.images[centre].point3d_ids if p >= 0}
    return {"global": (reg, {reg[0]}, {reg[1]}, None),
            "local": (local, {local[-1]}, {local[-2]}, variable)}


class Dumped(Exception):
    pass


def reference_obs(jm, config, monkeypatch, tmp_path):
    """The observations of the reference's ``_run_ba`` for ``config``, as
    its ``PPSFM_BA_DUMP`` holds them, unpadded: (obs_cam, obs_point,
    obs_line).  The dump is written before the solve; the SoA route's
    first step then raises, so no solve runs."""
    def stop(*args, **kwargs):
        raise Dumped

    monkeypatch.setenv("PPSFM_BA_DUMP", str(tmp_path / "dump"))
    monkeypatch.setenv("PPSFM_BA_PATH", "soa")
    monkeypatch.setattr(jbd, "from_flat_problem", stop)
    with pytest.raises(Dumped):
        jm._run_ba(*config, jba.BAOptions(max_iterations=1))
    d = np.load(glob.glob(str(tmp_path / "dump*.npz"))[0])
    n = int((d["obs_weight"] > 0).sum())
    assert (d["obs_weight"][:n] > 0).all()
    return d["obs_cam"][:n], d["obs_point"][:n], d["obs_line"][:n]


@pytest.mark.parametrize("kind", ["global", "local"])
@pytest.mark.parametrize("long_lengths", [LONG, WHOLE],
                         ids=["tracks_129_to_300", "longest_128"])
def test_assembly_keeps_the_reference_observations(long_lengths, kind,
                                                   monkeypatch, tmp_path):
    jm, tm = mappers(long_lengths)
    config = configs(tm.rec)[kind]
    assert configs(jm.rec)[kind] == config
    asm = tm.assemble_ba(*config)
    cam, point, line = reference_obs(jm, config, monkeypatch, tmp_path)
    p = asm.problem
    np.testing.assert_array_equal(p.obs_cam.numpy(), cam)
    np.testing.assert_array_equal(p.obs_point.numpy(), point)
    np.testing.assert_array_equal(p.obs_line.numpy(), line)

    # What the cap did: every point at most 128 observations, a point of
    # 128 or fewer whole, a longer one thinned to 128 with its first kept.
    seen = {}
    for iid, li, pid in asm.obs:
        seen.setdefault(pid, []).append((iid, li))
    full = {}
    rec = tm.rec
    config_set = set(config[0])
    for iid in config[0]:
        img = rec.images[iid]
        for li in np.nonzero(img.point3d_ids >= 0)[0]:
            full.setdefault(int(img.point3d_ids[li]), []).append(
                (iid, int(li)))
    if config[3] is not None:
        for pid in config[3]:
            full[pid] += [o for o in rec.points3d[pid].track
                          if o[0] not in config_set]
    assert set(seen) == set(full)
    for pid, obs in full.items():
        kept = seen[pid]
        if len(obs) <= tmap.MAX_OBS_PER_POINT:
            assert kept == obs
        else:
            assert len(kept) == tmap.MAX_OBS_PER_POINT
            assert kept[0] == obs[0] and set(kept) < set(obs)
    longest = max(len(o) for o in full.values())
    if long_lengths is WHOLE:
        assert longest == tmap.MAX_OBS_PER_POINT
        assert len(asm.obs) == sum(len(o) for o in full.values())
    else:
        assert longest > tmap.MAX_OBS_PER_POINT


def test_synthetic_model_takes_track_lengths():
    """``synthetic_model`` with one track length a point (the shape of a
    300-view global BA, scaled down): every point seen by as many cameras
    as asked, and a global BA of it, longest track 128, kept whole."""
    from privacy_preserving_sfm_torch.utils.synthetic import synthetic_model

    lengths = [128, 4, 37, 128, 9, 60] * 5
    rec = synthetic_model(150, len(lengths), 6, seed=5,
                          track_lengths=lengths)
    got = [len(rec.points3d[pid].track) for pid in sorted(rec.points3d)]
    assert got == lengths
    tm = tmap.IncrementalMapper("cpu", torch.float64)
    tm.rec = rec
    reg = list(rec.reg_image_ids)
    asm = tm.assemble_ba(reg, {reg[0]}, {reg[1]})
    assert len(asm.obs) == sum(lengths) == rec.num_observations()
    with pytest.raises(ValueError):
        synthetic_model(10, 3, 6, seed=5, track_lengths=[4, 4])
