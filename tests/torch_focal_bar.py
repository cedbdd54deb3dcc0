"""The reference package's controller on the focal-search scene of
``tests/test_torch_focal_search.py``, the numbers that test holds the port
to.

    python tests/torch_focal_bar.py

Builds the scene (one prior-less camera an image, lines lifted 12 % off),
runs the reference's ``IncrementalMapperController`` with
``ba_refine_focal_length`` on the CPU in float64 (x64, as its tests run)
and prints the database's digest, the registered count, the images its
``_focal_search`` ran at, every registered camera's focal, the largest
relative focal error and the ATE.  About 90 s on a CPU.
"""

import dataclasses
import os
import sys
import tempfile

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [TESTS, os.path.dirname(TESTS)]

import conftest  # noqa: E402,F401  (JAX on the CPU, x64)
from privacy_preserving_sfm_tpu.sfm import incremental_mapper as jmap  # noqa: E402
from privacy_preserving_sfm_tpu.sfm.controller import (  # noqa: E402
    IncrementalMapperController,
)
from test_e2e_synthetic import FAST, ate_rmse  # noqa: E402
from test_torch_focal_search import (  # noqa: E402
    TRUE_FOCAL, database_digest, per_camera_scene,
)


def main():
    path = os.path.join(tempfile.mkdtemp(), "cameras.db")
    qs, ts, _, image_ids = per_camera_scene(path)
    searched = []
    search = jmap.IncrementalMapper._focal_search

    def counted(self, options, image_id, *args):
        searched.append(image_id)
        return search(self, options, image_id, *args)

    jmap.IncrementalMapper._focal_search = counted
    ctrl = IncrementalMapperController(
        dataclasses.replace(FAST, ba_refine_focal_length=True),
        database_path=path)
    rec = max(ctrl.run(), key=lambda r: r.num_registered())
    focals = {iid: float(rec.cameras[rec.images[iid].camera_id].params[0])
              for iid in sorted(rec.reg_image_ids)}
    err = max(abs(f - TRUE_FOCAL) / TRUE_FOCAL for f in focals.values())
    print(f"database digest {database_digest(path)}; registered "
          f"{rec.num_registered()} of {len(image_ids)}; focal "
          f"searches at images {searched}; focals {focals}; largest "
          f"relative focal error {err!r}; ATE "
          f"{ate_rmse(rec, qs, ts, image_ids)!r}")


if __name__ == "__main__":
    main()
