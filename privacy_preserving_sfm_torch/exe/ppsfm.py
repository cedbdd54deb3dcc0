"""ppsfm CLI of the PyTorch/CUDA port.

Usage: ``python -m privacy_preserving_sfm_torch.exe <subcommand> [args]``.

Ported subcommands, with the flags of the reference CLI
(``privacy_preserving_sfm_tpu/exe/ppsfm.py``) plus ``--device``:

* ``bundle_adjuster`` (reference ``:411-438, 623-627``), plus ``--dtype``
  (default float32, the precision of the accelerator path);
* ``database_creator`` (``:25-30``);
* the matchers ``exhaustive_matcher``, ``sequential_matcher``,
  ``spatial_matcher``, ``transitive_matcher`` and ``matches_importer``
  (``--match_type pairs`` or ``raw``) (``:171-335, 560-606``), which read
  descriptors from the database and write matches back.

Device work runs on ``--device`` (default ``cuda``; asking for CUDA
without a CUDA device is an error, never a silent CPU run).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"--device {name}: expected cpu or cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device


def cmd_bundle_adjuster(args):
    from privacy_preserving_sfm_torch.models.reconstruction import (
        Reconstruction,
    )
    from privacy_preserving_sfm_torch.optim import ba as ba_mod
    from privacy_preserving_sfm_torch.sfm.incremental_mapper import (
        IncrementalMapper,
    )
    from privacy_preserving_sfm_torch.utils.timer import Timer, print_heading1

    device = _device(args.device)
    print_heading1("Global bundle adjustment")
    timer = Timer()
    rec = Reconstruction.read_text(args.input_path)
    rec.filter_observations_with_negative_depth()
    mapper = IncrementalMapper(device, _DTYPES[args.dtype])
    mapper.begin_reconstruction(rec)
    opts = ba_mod.BAOptions(max_iterations=args.max_num_iterations)
    ok = mapper.adjust_global_bundle(opts)
    os.makedirs(args.output_path, exist_ok=True)
    rec.write_text(args.output_path)
    s = mapper.last_summary
    if s is not None:
        print(f"  solved={ok} device={device} dtype={args.dtype} "
              f"LM iterations={s.num_iterations} "
              f"cost {s.initial_cost!r} -> {s.final_cost!r}")
    print(f"  mean reproj error: "
          f"{rec.compute_mean_reprojection_error():.4f}px")
    timer.print_minutes()
    return mapper


def cmd_database_creator(args):
    from privacy_preserving_sfm_torch.models.database import Database

    with Database(args.database_path):
        pass
    print(f"Created database at {args.database_path}")


def _match_and_report(db, ids, pairs, args, device, what="pairs"):
    from privacy_preserving_sfm_torch.features import schedulers

    n = schedulers.match_pair_list(
        db, ids, pairs, min_num_matches=args.min_num_matches, verbose=True,
        device=device)
    print(f"  => {n}/{len(pairs)} {what} above threshold")
    return n


def _run_matcher(args, scheduler: str):
    from privacy_preserving_sfm_torch.features import schedulers
    from privacy_preserving_sfm_torch.models.database import Database
    from privacy_preserving_sfm_torch.utils.timer import Timer, print_heading1

    device = _device(args.device)
    print_heading1(f"{scheduler.capitalize()} feature matching")
    timer = Timer()
    with Database(args.database_path) as db:
        images = db.read_images()
        ids = sorted(images.keys(), key=lambda i: images[i]["name"])
        if scheduler == "exhaustive":
            pairs = schedulers.exhaustive_pairs(ids, args.block_size)
        else:
            pairs = schedulers.sequential_pairs(ids, args.overlap)
        n = _match_and_report(db, ids, pairs, args, device)
    timer.print_minutes()
    return n


def cmd_exhaustive_matcher(args):
    return _run_matcher(args, "exhaustive")


def cmd_sequential_matcher(args):
    return _run_matcher(args, "sequential")


def cmd_spatial_matcher(args):
    """Spatial matcher over prior positions (matching.h:331-360).

    Positions come from the image prior translations in the database (e.g.
    EXIF GPS converted to ENU at import time).
    """
    from privacy_preserving_sfm_torch.features import schedulers
    from privacy_preserving_sfm_torch.models.database import Database
    from privacy_preserving_sfm_torch.utils.timer import Timer, print_heading1

    device = _device(args.device)
    print_heading1("Spatial feature matching")
    timer = Timer()
    with Database(args.database_path) as db:
        rows = db.conn.execute(
            "SELECT image_id, prior_tx, prior_ty, prior_tz FROM images;"
        ).fetchall()
        positions = {r[0]: np.asarray(r[1:4], float) for r in rows
                     if r[1] is not None}
        if args.is_gps and positions:
            # Priors are EXIF (lat, lon, alt): convert to metric ENU
            # around the first image (matching.h:331-360 semantics).
            from privacy_preserving_sfm_torch.utils import gps as gps_mod
            keys_sorted = sorted(positions)
            lats = np.asarray([positions[k][0] for k in keys_sorted])
            lons = np.asarray([positions[k][1] for k in keys_sorted])
            alts = np.asarray([positions[k][2] for k in keys_sorted])
            if np.all(np.abs(lats) <= 90) and np.all(np.abs(lons) <= 180):
                enu = gps_mod.ell_to_enu(lats, lons, alts,
                                         lats[0], lons[0], alts[0])
                positions = {k: np.asarray(enu)[i]
                             for i, k in enumerate(keys_sorted)}
        ids = sorted(db.read_images().keys())
        pairs = schedulers.spatial_pairs(
            ids, positions, args.max_num_neighbors, args.max_distance)
        n = _match_and_report(db, ids, pairs, args, device)
    timer.print_minutes()
    return n


def cmd_transitive_matcher(args):
    """Transitive closure matcher (matching.h:362-381)."""
    from privacy_preserving_sfm_torch.features import schedulers
    from privacy_preserving_sfm_torch.models.database import Database
    from privacy_preserving_sfm_torch.utils.timer import Timer, print_heading1

    device = _device(args.device)
    print_heading1("Transitive feature matching")
    timer = Timer()
    with Database(args.database_path) as db:
        ids = sorted(db.read_images().keys())
        pairs = schedulers.transitive_pairs(
            db, args.num_iterations, args.min_num_matches)
        n = _match_and_report(db, ids, pairs, args, device, "closure pairs")
    timer.print_minutes()
    return n


def _import_raw_feature_pairs(db, match_list_path: str) -> int:
    """FeaturePairsFeatureMatcher (``matching.cc:995-1087``): blocks of

        name1 name2
        idx1 idx2
        ...
        <blank line>

    write explicit feature-index matches straight to the database.
    """
    images = db.read_images()
    by_name = {v["name"]: k for k, v in images.items()}
    num_pairs = 0
    with open(match_list_path) as f:
        lines = iter(f)
        for line in lines:
            header = line.split()
            if not header:
                continue
            if len(header) != 2:
                raise ValueError(f"bad pair header: {line!r}")
            name1, name2 = header
            matches = []
            for mline in lines:
                parts = mline.split()
                if not parts:
                    break
                matches.append((int(parts[0]), int(parts[1])))
            if name1 not in by_name or name2 not in by_name:
                print(f"SKIP: {name1} - {name2} (not in database)")
                continue
            id1, id2 = by_name[name1], by_name[name2]
            if db.exists_matches(id1, id2):
                print(f"SKIP: {name1} - {name2} (matches exist)")
                continue
            db.write_matches(id1, id2,
                             np.asarray(matches, np.uint32).reshape(-1, 2))
            num_pairs += 1
    db.commit()
    return num_pairs


def cmd_matches_importer(args):
    """Match an explicit image-pair list (``ImagePairsFeatureMatcher``) or
    import raw feature-index matches (``FeaturePairsFeatureMatcher``,
    ``--match_type raw``).
    """
    from privacy_preserving_sfm_torch.models.database import Database
    from privacy_preserving_sfm_torch.utils.timer import Timer, print_heading1

    print_heading1("Importing image pair matches")
    timer = Timer()
    if args.match_type == "raw":
        with Database(args.database_path) as db:
            n = _import_raw_feature_pairs(db, args.match_list_path)
            print(f"  => imported {n} pairs")
        timer.print_minutes()
        return n
    device = _device(args.device)
    with Database(args.database_path) as db:
        images = db.read_images()
        by_name = {v["name"]: k for k, v in images.items()}
        pairs = []
        with open(args.match_list_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) != 2:
                    continue
                if parts[0] in by_name and parts[1] in by_name:
                    a, b = by_name[parts[0]], by_name[parts[1]]
                    pairs.append((min(a, b), max(a, b)))
        ids = sorted(images.keys())
        n = _match_and_report(db, ids, pairs, args, device)
    timer.print_minutes()
    return n


def _add_db_arg(p):
    p.add_argument("--database_path", required=True)


def _add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device of the matcher: cuda (default) or cpu")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ppsfm")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("database_creator")
    _add_db_arg(p)
    p.set_defaults(func=cmd_database_creator)

    for name in ("exhaustive_matcher", "sequential_matcher"):
        p = sub.add_parser(name)
        _add_db_arg(p)
        p.add_argument("--min_num_matches", type=int, default=15)
        p.add_argument("--block_size", type=int, default=50)
        p.add_argument("--overlap", type=int, default=10)
        _add_device_arg(p)
        p.set_defaults(func=cmd_exhaustive_matcher
                       if name == "exhaustive_matcher"
                       else cmd_sequential_matcher)

    p = sub.add_parser("spatial_matcher")
    _add_db_arg(p)
    p.add_argument("--min_num_matches", type=int, default=15)
    p.add_argument("--max_num_neighbors", type=int, default=50)
    p.add_argument("--max_distance", type=float, default=100.0)
    p.add_argument("--is_gps", type=int, default=1,
                   help="priors are EXIF lat/lon/alt; convert to ENU")
    _add_device_arg(p)
    p.set_defaults(func=cmd_spatial_matcher)

    p = sub.add_parser("transitive_matcher")
    _add_db_arg(p)
    p.add_argument("--min_num_matches", type=int, default=15)
    p.add_argument("--num_iterations", type=int, default=3)
    _add_device_arg(p)
    p.set_defaults(func=cmd_transitive_matcher)

    p = sub.add_parser("matches_importer")
    _add_db_arg(p)
    p.add_argument("--match_list_path", required=True)
    p.add_argument("--min_num_matches", type=int, default=15)
    p.add_argument("--match_type", choices=["pairs", "raw"],
                   default="pairs")
    _add_device_arg(p)
    p.set_defaults(func=cmd_matches_importer)

    p = sub.add_parser("bundle_adjuster")
    p.add_argument("--input_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--max_num_iterations", type=int, default=100)
    p.add_argument("--device", default="cuda",
                   help="torch device of the solve: cuda (default) or cpu")
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="float32")
    p.set_defaults(func=cmd_bundle_adjuster)

    args = parser.parse_args(argv)
    return args.func(args)
