"""Pose-parity evaluator, the port's ``tools/evaluate.py`` (numpy only).

The reference's MATLAB protocol (``compare_colmap_poses.m:35-77``: per
image, the rotation's axis angle and the position difference, inf for an
image missing from the estimate; ``count_images_below_error_threshold.m``)
after a similarity (Umeyama) alignment of the camera centres, which
removes the gauge against ground truth in another frame; plus ATE RMSE of
the aligned centres and the model's mean reprojection error, mean track
length and point count.

    python -m privacy_preserving_sfm_torch.tools.evaluate MODEL_DIR \\
        --gt GT_POSES_TXT [--no-align] [--json OUT.json]
    python -m privacy_preserving_sfm_torch.tools.evaluate MODEL_DIR \\
        --ref-model OTHER_MODEL_DIR

``gt_poses.txt`` is ``# name qw qx qy qz tx ty tz`` (world -> camera), as
``tools/synth_dataset.make_dataset`` writes it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from privacy_preserving_sfm_torch.models.reconstruction import Reconstruction


def quat_to_R(q):
    q = np.asarray(q, float)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [w*w + x*x - y*y - z*z, 2*(x*y - w*z), 2*(x*z + w*y)],
        [2*(x*y + w*z), w*w - x*x + y*y - z*z, 2*(y*z - w*x)],
        [2*(x*z - w*y), 2*(y*z + w*x), w*w - x*x - y*y + z*z]])


def axis_angle_deg(R):
    """Rotation angle of a rotation matrix, degrees (rotm2axang norm)."""
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(cos)))


def read_gt_poses(path):
    """gt_poses.txt -> {name: (R, t)} world->cam."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            q = [float(v) for v in parts[1:5]]
            t = np.asarray([float(v) for v in parts[5:8]])
            out[parts[0]] = (quat_to_R(q), t)
    return out


def read_model_poses(model_dir):
    """A text model -> (its Reconstruction, {name: (R, t)} of the
    registered images)."""
    rec = Reconstruction.read_text(model_dir)
    out = {}
    for img in rec.images.values():
        if img.registered:
            out[img.name] = (img.rotation_matrix(), np.asarray(img.tvec))
    return rec, out


def similarity_align(src, dst):
    """Umeyama: s, R, t with dst ~= s * R @ src + t."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    cs, cd = src - mu_s, dst - mu_d
    cov = cd.T @ cs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var = (cs ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var)
    t = mu_d - s * R @ mu_s
    return s, R, t


def _centers(poses, names):
    return np.stack([-poses[n][0].T @ poses[n][1] for n in names])


def evaluate(est_poses, ref_poses, align=True):
    """Per-image errors of ``est_poses`` against ``ref_poses`` ({name:
    (R, t)}), after a similarity alignment of the camera centres when
    ``align`` and at least 3 images are common; with the aggregates
    (mean and median rotation, ATE RMSE, mean position error, counts
    below the protocol's two thresholds)."""
    common = sorted(set(est_poses) & set(ref_poses))
    missing = sorted(set(ref_poses) - set(est_poses))

    s, Ra, ta = 1.0, np.eye(3), np.zeros(3)
    if align and len(common) >= 3:
        s, Ra, ta = similarity_align(_centers(est_poses, common),
                                     _centers(ref_poses, common))

    per_image = {}
    rot_errs, pos_errs = [], []
    for name in common:
        R_e, t_e = est_poses[name]
        R_r, t_r = ref_poses[name]
        # world' = s Ra world + ta, so a world->cam pose (R, t) becomes
        # R' = R Ra^T, t' = s t - R' ta.
        R_al = R_e @ Ra.T
        t_al = s * t_e - R_al @ ta
        R_diff = R_al @ R_r.T
        rot = axis_angle_deg(R_diff)
        pos = float(np.linalg.norm(R_diff @ t_r - t_al))
        per_image[name] = {"rot_deg": rot, "pos": pos}
        rot_errs.append(rot)
        pos_errs.append(pos)
    for name in missing:
        per_image[name] = {"rot_deg": float("inf"), "pos": float("inf")}

    centers_err = None
    if align and common:
        est_c = _centers(est_poses, common)
        aligned = (s * (Ra @ est_c.T)).T + ta
        centers_err = np.sqrt(((aligned - _centers(ref_poses, common)) ** 2)
                              .sum(-1))

    def count_below(rot_th, pos_th):
        return sum(1 for v in per_image.values()
                   if v["rot_deg"] <= rot_th and v["pos"] <= pos_th)

    return {
        "num_ref_images": len(ref_poses),
        "num_registered": len(common),
        "num_unregistered": len(missing),
        "mean_rot_deg": float(np.mean(rot_errs)) if rot_errs else None,
        "median_rot_deg": float(np.median(rot_errs)) if rot_errs else None,
        "ate_rmse": (float(np.sqrt((centers_err ** 2).mean()))
                     if centers_err is not None else None),
        "mean_pos_err": float(np.mean(pos_errs)) if pos_errs else None,
        "below_thresholds": {
            "rot2deg_pos0.05": count_below(2.0, 0.05),
            "rot5deg_pos0.20": count_below(5.0, 0.20),
        },
        "per_image": per_image,
    }


def report(model_dir, gt=None, ref_model=None, align=True):
    """The CLI's report of the model in ``model_dir`` against ``gt``
    (a gt_poses.txt) or ``ref_model`` (a model directory)."""
    rec, est = read_model_poses(model_dir)
    if gt:
        ref = read_gt_poses(gt)
    elif ref_model:
        _, ref = read_model_poses(ref_model)
    else:
        raise ValueError("need gt or ref_model")
    out = evaluate(est, ref, align=align)
    out["mean_reproj_error_px"] = rec.compute_mean_reprojection_error()
    out["mean_track_length"] = rec.compute_mean_track_length()
    out["num_points3d"] = len(rec.points3d)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("model_dir")
    ap.add_argument("--gt", help="gt_poses.txt with GT world->cam poses")
    ap.add_argument("--ref-model", help="reference model dir to compare to")
    ap.add_argument("--no-align", action="store_true",
                    help="skip similarity alignment (models share a frame)")
    ap.add_argument("--json", help="write the report to this path")
    args = ap.parse_args(argv)
    if not (args.gt or args.ref_model):
        ap.error("need --gt or --ref-model")
    out = report(args.model_dir, args.gt, args.ref_model,
                 align=not args.no_align)
    brief = {k: v for k, v in out.items() if k != "per_image"}
    print(json.dumps(brief, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
