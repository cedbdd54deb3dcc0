"""The reference package's ``mapper``, ``automatic_reconstructor``,
``hierarchical_mapper`` and uncalibrated-mapper pose errors on rendered
datasets, the bars for the port's.

    python tests/torch_mapper_bar.py mapper --images N --width W \\
        --height H [--seed S] [--max_num_features F] [--workdir DIR]
    python tests/torch_mapper_bar.py auto --images N --width W \\
        --height H [--seed S] [--workdir DIR]
    python tests/torch_mapper_bar.py hier --images N --width W \\
        --height H [--block_size B] [--overlap V] [--workdir DIR]
    python tests/torch_mapper_bar.py uncal --images N --width W \\
        --height H --focal F [--seed S] [--workdir DIR]

``mapper``: renders N seeded box views (``utils.synthetic.render_dataset``),
writes their database with the port's ``feature_extractor`` and
``exhaustive_matcher`` on the CPU, and runs the reference package's
``mapper`` on it (JAX on the CPU).  ``auto``: runs the reference's
``automatic_reconstructor`` (its own extractor, matcher and mapper) on
the rendering.  ``hier``: as ``mapper``, with the reference CLI's
``hierarchical_mapper --block_size B --overlap V --num_workers 1`` on the
CPU (``PPSFM_PLATFORM=cpu``).  ``uncal``: renders with the true focal F,
deletes the ``.camera_model.txt`` sidecars (so the port's
``feature_extractor`` takes the heuristic 1.2 x max(W, H) focal with no
prior), and runs the reference controller with
``ControllerOptions(ba_refine_focal_length=True)`` (its CLI has no such
flag); it also prints every registered camera's focal and the largest
relative error against F, with its bar (twice that, floored at 3 %).
Each prints the models, the registered images, the
rotation and translation-direction errors of every registered pose
relative to the first, up to gauge, against the rendering's truth
(``gauge_align_errors``), and the bar: twice those errors, floored at
0.25 and 1 degree.  ``chip_smoke.py`` (``MAPPER_BAR``: 16 views at
1,600 x 1,200 with every default; ``AUTO_BAR``: 12 at 640 x 480, seed 1;
``HIER_BAR``: ``MAPPER_BAR``'s rendering with blocks of 8, overlap 3;
``UNCAL_BAR``: 12 at 1,600 x 1,200, seed 2, F = 1,714.3)
and ``test_torch_mapper_cli.py`` (8 at 480 x 360, 2,048 features) hold the
port to such bars.  Run from the repository root; an existing
``DIR/t.db`` is reused.
"""

import argparse
import os
import sys
import tempfile

import numpy as np


def errors(model_dir, gt):
    """(registered names, rotation and direction errors in degrees)."""
    from privacy_preserving_sfm_torch.models.reconstruction import (
        Reconstruction,
    )
    from privacy_preserving_sfm_torch.utils.synthetic import (
        gauge_align_errors,
    )

    rec = Reconstruction.read_text(model_dir)
    ids = sorted(rec.reg_image_ids, key=lambda i: rec.images[i].name)
    names = [rec.images[i].name for i in ids]
    poses = np.stack([rec.images[i].projection_matrix() for i in ids])
    rot, dirn = np.degrees(gauge_align_errors(
        np.stack([gt[n][0] for n in names]),
        np.stack([gt[n][1] for n in names]), poses))
    return rec, names, float(rot), float(dirn)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("command", choices=["mapper", "auto", "hier", "uncal"])
    ap.add_argument("--images", type=int, required=True)
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max_num_features", default="8192")
    ap.add_argument("--batch_size", default="8")
    ap.add_argument("--block_size", default="8")
    ap.add_argument("--overlap", default="3")
    ap.add_argument("--focal", type=float, default=0.0)
    ap.add_argument("--workdir", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    from privacy_preserving_sfm_torch.exe import ppsfm as tcli
    from privacy_preserving_sfm_torch.utils.synthetic import (
        read_gt_poses, render_dataset,
    )
    from privacy_preserving_sfm_tpu.exe import ppsfm as jcli

    torch.set_num_threads(4)
    work = args.workdir or tempfile.mkdtemp()
    images = os.path.join(work, "images")
    if not os.path.exists(os.path.join(images, "gt_poses.txt")):
        render_dataset(images, args.images, args.width, args.height,
                       f=args.focal, seed=args.seed, scene="box")
        if args.command == "uncal":
            for name in os.listdir(images):
                if name.endswith(".camera_model.txt"):
                    os.remove(os.path.join(images, name))
    if args.command != "auto":
        db = os.path.join(work, "t.db")
        if not os.path.exists(db):
            tcli.main(["feature_extractor", "--database_path", db,
                       "--image_path", images, "--device", "cpu",
                       "--max_num_features", args.max_num_features,
                       "--batch_size", args.batch_size])
            tcli.main(["exhaustive_matcher", "--database_path", db,
                       "--device", "cpu"])
    if args.command in ("mapper", "hier"):
        out = os.path.join(work, "reference_sparse")
        if args.command == "mapper":
            jcli.main(["mapper", "--database_path", db, "--output_path", out])
        else:
            os.environ["PPSFM_PLATFORM"] = "cpu"
            jcli.main(["hierarchical_mapper", "--database_path", db,
                       "--output_path", out, "--block_size", args.block_size,
                       "--overlap", args.overlap, "--num_workers", "1"])
    elif args.command == "uncal":
        from privacy_preserving_sfm_tpu.sfm.controller import (
            ControllerOptions, IncrementalMapperController,
        )

        out = os.path.join(work, "reference_sparse")
        recs = IncrementalMapperController(
            ControllerOptions(ba_refine_focal_length=True),
            database_path=db).run()
        for i, rec in enumerate(recs):
            rec.write_text(os.path.join(out, str(i)))
    else:
        ws = os.path.join(work, "reference_workspace")
        jcli.main(["automatic_reconstructor", "--workspace_path", ws,
                   "--image_path", images])
        out = os.path.join(ws, "sparse")
    gt = read_gt_poses(os.path.join(images, "gt_poses.txt"))
    models = sorted(os.listdir(out))
    for m in models:
        rec, names, rot, dirn = errors(os.path.join(out, m), gt)
        print(f"reference {args.command} model {m}: {len(names)} of "
              f"{args.images} images registered, {len(rec.points3d)} "
              f"points; rotation error {rot:.5f} deg, translation "
              f"direction error {dirn:.5f} deg; bar "
              f"({max(2 * rot, 0.25):.5f}, {max(2 * dirn, 1.0):.5f}) deg")
        if args.command == "uncal":
            focals = [float(rec.cameras[rec.images[i].camera_id].params[0])
                      for i in rec.reg_image_ids]
            worst = max(abs(f / args.focal - 1) for f in focals)
            print(f"reference uncal model {m}: focals {sorted(set(focals))}"
                  f" (true {args.focal}); largest relative focal error "
                  f"{worst:.5f}; bar {max(2 * worst, 0.03):.5f}")
    print(f"reference {args.command}: {len(models)} model(s)")


if __name__ == "__main__":
    main()
