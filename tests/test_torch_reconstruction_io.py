"""``Reconstruction.write_ply`` against the reference package's.

One seeded model (``utils.synthetic.synthetic_model``) is written as text
by the port and read back by both packages; each writes its point cloud
as ASCII PLY, and the two files must be byte-identical: as read, with
seeded colors set on every point in both, and with no points at all.
"""

import numpy as np
import pytest

from privacy_preserving_sfm_torch.models.reconstruction import (
    Reconstruction as TorchReconstruction,
)
from privacy_preserving_sfm_torch.utils.synthetic import synthetic_model
from privacy_preserving_sfm_tpu.models.reconstruction import (
    Reconstruction as JaxReconstruction,
)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("model")
    synthetic_model(6, 300, 4, seed=2).write_text(str(path))
    return str(path)


@pytest.mark.parametrize("case", ["as_read", "colored", "empty"])
def test_write_ply_matches_the_reference_byte_for_byte(model_dir, tmp_path,
                                                       case):
    recs = (TorchReconstruction.read_text(model_dir),
            JaxReconstruction.read_text(model_dir))
    assert len(recs[0].points3d) == 300
    if case == "colored":
        rng = np.random.default_rng(4)
        colors = {pid: tuple(int(c) for c in rng.integers(0, 256, 3))
                  for pid in recs[0].points3d}
        for rec in recs:
            for pid, p in rec.points3d.items():
                p.color = colors[pid]
    if case == "empty":
        for rec in recs:
            rec.points3d.clear()
    paths = [str(tmp_path / f"{who}.ply") for who in ("port", "reference")]
    for rec, path in zip(recs, paths):
        rec.write_ply(path)
    got, want = (open(p, "rb").read() for p in paths)
    assert got == want
    assert f"element vertex {len(recs[0].points3d)}\n".encode() in got
