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
    python tests/torch_mapper_bar.py box50d [--images N --width W \\
        --height H --seed S --degrade L --camera C] [--port_cpu] \\
        [--workdir DIR]

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
``box50d``: renders N box views with the port's
``tools/synth_dataset.make_dataset`` (defaults: the reference's box50d, 50
views at 640 x 480 through the OPENCV camera, seed 0, ``degrade`` 1.0;
focal 0.625 W; ``--camera SIMPLE_PINHOLE --degrade 0`` is box50), runs the
reference's ``automatic_reconstructor`` on them and scores its model with
the port's ``tools/evaluate`` after checking that every key of its report
equals ``tools/evaluate.py``'s on the same model (1e-12); it prints ATE
RMSE, the mean rotation error and the bar: twice those, floored at 0.005
and 0.25 degree (``chip_smoke.py``'s ``BOX50D_BAR``; its small twin, 8
views at 480 x 360, gives ``test_torch_distorted_e2e.py``'s ATE bar, and
the errors relative to the first pose below its pose bar); with
``--port_cpu`` it also runs and scores the port's
``automatic_reconstructor --device cpu`` on the same images.
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


def score(model_dir, gt_path, who="reference"):
    """The port's evaluator on the model, held against ``tools/
    evaluate.py`` key by key; prints ATE, rotation and their bar."""
    from privacy_preserving_sfm_torch.tools import evaluate as tev

    sys.path.insert(0, os.path.join(os.getcwd(), "tools"))
    import evaluate as jev

    port = tev.report(model_dir, gt=gt_path)
    rec, est = jev.read_model_poses(model_dir)
    ref = jev.evaluate(est, jev.read_gt_poses(gt_path))
    ref["mean_reproj_error_px"] = rec.compute_mean_reprojection_error()
    ref["mean_track_length"] = rec.compute_mean_track_length()
    ref["num_points3d"] = len(rec.points3d)
    same = same_report(port, ref)
    ate, rot = port["ate_rmse"], port["mean_rot_deg"]
    print(f"evaluator ({who}): port equals tools/evaluate.py={same}; "
          f"registered "
          f"{port['num_registered']} of {port['num_ref_images']}, ATE RMSE "
          f"{ate!r}, mean rotation error {rot!r} deg, median "
          f"{port['median_rot_deg']!r} deg, {port['num_points3d']} points, "
          f"mean reprojection error {port['mean_reproj_error_px']!r} px; "
          f"bar (ATE {max(2 * ate, 0.005):.5f}, rotation "
          f"{max(2 * rot, 0.25):.5f} deg)")
    if not same:
        raise SystemExit("the port's evaluator disagrees with "
                         "tools/evaluate.py")


def same_report(a, b, tol=1e-12):
    """Every key of two evaluator reports equal (floats to ``tol``
    relative)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_report(a[k], b[k], tol) for k in a))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or abs(a - b) <= tol * max(abs(a), abs(b))
    return a == b


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("command",
                    choices=["mapper", "auto", "hier", "uncal", "box50d"])
    ap.add_argument("--images", type=int,
                    help="required, except for box50d (default 50)")
    ap.add_argument("--width", type=int,
                    help="required, except for box50d (default 640)")
    ap.add_argument("--height", type=int,
                    help="required, except for box50d (default 480)")
    ap.add_argument("--degrade", type=float, default=1.0)
    ap.add_argument("--camera", default="OPENCV",
                    choices=["OPENCV", "SIMPLE_PINHOLE"])
    ap.add_argument("--port_cpu", action="store_true",
                    help="box50d: also run the port's automatic_"
                    "reconstructor on the CPU (the flat BA route) and score "
                    "it")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max_num_features", default="8192")
    ap.add_argument("--batch_size", default="8")
    ap.add_argument("--block_size", default="8")
    ap.add_argument("--overlap", default="3")
    ap.add_argument("--focal", type=float, default=0.0)
    ap.add_argument("--workdir", default="")
    args = ap.parse_args()
    if args.command == "box50d":
        args.images = args.images or 50
        args.width = args.width or 640
        args.height = args.height or 480
    elif None in (args.images, args.width, args.height):
        ap.error(f"{args.command} needs --images, --width and --height")
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
    if args.command == "box50d":
        from privacy_preserving_sfm_torch.tools.synth_dataset import (
            make_dataset,
        )

        if not os.path.exists(os.path.join(images, "gt_poses.txt")):
            make_dataset(images, args.images, args.width, args.height,
                         f=args.focal or 0.625 * args.width, seed=args.seed,
                         scene="box", camera=args.camera,
                         degrade=args.degrade)
    elif not os.path.exists(os.path.join(images, "gt_poses.txt")):
        render_dataset(images, args.images, args.width, args.height,
                       f=args.focal, seed=args.seed, scene="box")
        if args.command == "uncal":
            for name in os.listdir(images):
                if name.endswith(".camera_model.txt"):
                    os.remove(os.path.join(images, name))
    if args.command not in ("auto", "box50d"):
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
        if args.command == "box50d":
            score(os.path.join(out, m), os.path.join(images, "gt_poses.txt"))
    print(f"reference {args.command}: {len(models)} model(s)")
    if args.port_cpu:
        ws = os.path.join(work, "port_workspace")
        tcli.main(["automatic_reconstructor", "--workspace_path", ws,
                   "--image_path", images, "--device", "cpu"])
        for m in sorted(os.listdir(os.path.join(ws, "sparse"))):
            score(os.path.join(ws, "sparse", m),
                  os.path.join(images, "gt_poses.txt"), who="port, CPU")


if __name__ == "__main__":
    main()
