"""The reference CLI's ``line_initializer`` errors on a rendered dataset,
the bar for the port's.

    python tests/torch_init_bar.py --images N --width W --height H \\
        [--max_num_features F] [--workdir DIR]

Renders N seeded box views (``utils.synthetic.render_dataset``, seed 0),
writes their database with the port's ``feature_extractor`` and
``exhaustive_matcher`` on the CPU, runs the reference package's
``line_initializer`` on it (JAX on the CPU), and prints the registered
images, the number of points, the rotation and translation-direction
errors up to gauge against the rendering's truth, and the bar: twice
those errors, floored at 0.25 and 1 degree.  ``chip_smoke.py`` (16 views
at 1,600 x 1,200, every default) and ``test_torch_line_initializer_cli.py``
(8 at 480 x 360, 2,048 features) hold the port to such bars.  Run from
the repository root; an existing ``DIR/t.db`` is reused.
"""

import argparse
import os
import sys
import tempfile

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, required=True)
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--max_num_features", default="8192")
    ap.add_argument("--batch_size", default="8")
    ap.add_argument("--workdir", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    from privacy_preserving_sfm_torch.exe import ppsfm as tcli
    from privacy_preserving_sfm_torch.models.reconstruction import (
        Reconstruction,
    )
    from privacy_preserving_sfm_torch.utils.synthetic import (
        gauge_align_errors, read_gt_poses, render_dataset,
    )
    from privacy_preserving_sfm_tpu.exe import ppsfm as jcli

    torch.set_num_threads(2)
    work = args.workdir or tempfile.mkdtemp()
    images = os.path.join(work, "images")
    db = os.path.join(work, "t.db")
    if not os.path.exists(db):
        render_dataset(images, args.images, args.width, args.height, seed=0,
                       scene="box")
        tcli.main(["feature_extractor", "--database_path", db,
                   "--image_path", images, "--device", "cpu",
                   "--max_num_features", args.max_num_features,
                   "--batch_size", args.batch_size])
        tcli.main(["exhaustive_matcher", "--database_path", db, "--device",
                   "cpu"])
    out = os.path.join(work, "reference_model")
    jcli.main(["line_initializer", "--database_path", db, "--output_path",
               out])
    gt = read_gt_poses(os.path.join(images, "gt_poses.txt"))
    rec = Reconstruction.read_text(out)
    names = [rec.images[i].name for i in rec.reg_image_ids]
    poses = np.stack([rec.images[i].projection_matrix()
                      for i in rec.reg_image_ids])
    rot, dirn = np.degrees(gauge_align_errors(
        np.stack([gt[n][0] for n in names]),
        np.stack([gt[n][1] for n in names]), poses))
    print(f"reference line_initializer: images {names}, "
          f"{len(rec.points3d)} points; rotation error {rot:.5f} deg, "
          f"translation direction error {dirn:.5f} deg; bar "
          f"({max(2 * rot, 0.25):.5f}, {max(2 * dirn, 1.0):.5f}) deg")


if __name__ == "__main__":
    main()
