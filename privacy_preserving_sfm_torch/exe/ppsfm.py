"""ppsfm CLI of the PyTorch/CUDA port.

Usage: ``python -m privacy_preserving_sfm_torch.exe <subcommand> [args]``.

Ported subcommands, with the flags of the reference CLI
(``privacy_preserving_sfm_tpu/exe/ppsfm.py``) plus ``--device``:

* ``bundle_adjuster`` (reference ``:411-438, 623-627``), plus ``--dtype``
  (default float32, the precision of the accelerator path);
* ``database_creator`` (``:25-30``);
* ``feature_extractor`` (``:33-168, 564-573``): SIFT, the aligned split
  and the line lift of every image with a gravity sidecar, written to the
  database as descriptors, lines, aligned flags and gravity.  Images are
  batched by (shape, camera model, number of params, mask); image k of
  the sorted listing draws from a CPU ``torch.Generator`` seeded from
  (``--seed``, k) whatever ``--device`` says, so a rerun with the same
  seed writes the same bytes and the card draws the CPU's split and line
  directions;
* the matchers ``exhaustive_matcher``, ``sequential_matcher``,
  ``spatial_matcher``, ``transitive_matcher`` and ``matches_importer``
  (``--match_type pairs`` or ``raw``) (``:171-335, 560-606``), which read
  descriptors from the database and write matches back;
* ``line_initializer`` (``:453-473, 636-639``): the mapper's 4-view
  initialization on the database (``min_num_matches`` 4), written as a
  text model; it computes in float32 on either device, as the reference
  does on its accelerator;
* ``mapper`` (``:338-374, 608-613``): the incremental mapper controller
  on the database, in float32, resumed from ``--input_path`` when given;
  it prints the phase profile, the images registered per second and, on
  CUDA, the peak device memory, and writes each model with its
  ``project.ini``;
* ``hierarchical_mapper`` (``:377-409, 615-621``): the block-parallel
  mapper (``sfm/hierarchical.py``), blocks of ``--block_size`` images
  sharing ``--overlap``, reconstructed in ``--num_workers`` spawned
  processes on ``--device``, chain-merged and refined together;
* ``image_filterer`` (``:441-450, 629-634``), ``project_generator``
  (``:503-511, 656-661``) and ``model_viewer`` (``:476-500, 641-654``: a
  PNG view or turntable through matplotlib, or with ``--html`` a
  self-contained interactive viewer that needs no matplotlib), host code
  with no ``--device``;
* ``automatic_reconstructor`` (``:514-539, 663-670``): the extractor, the
  matcher and the mapper in one process under a quality preset.

All 15 of the reference's subcommands.  Device work runs on ``--device``
(default ``cuda``; asking for CUDA without a CUDA device is an error,
never a silent CPU run).
"""

from __future__ import annotations

import argparse
import os
import sys

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
        IncrementalMapper, MapperOptions,
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
    ok = mapper.adjust_global_bundle(MapperOptions(), opts)
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


def cmd_line_initializer(args):
    """Standalone 4-view initialization (reference ``ppsfm.cc:510-960``).
    Prints the registered image ids, the number of points, the graph
    kind, the phase times and, on CUDA, the peak device memory."""
    from privacy_preserving_sfm_torch.models.database import Database
    from privacy_preserving_sfm_torch.models.database_cache import (
        DatabaseCache,
    )
    from privacy_preserving_sfm_torch.sfm.incremental_mapper import (
        IncrementalMapper, MapperOptions,
    )
    from privacy_preserving_sfm_torch.utils.timer import Timer, print_heading1

    device = _device(args.device)
    print_heading1("Line initializer")
    timer = Timer()
    with Database(args.database_path) as db:
        cache = DatabaseCache.load(db, min_num_matches=4)
    rec = cache.to_reconstruction()
    mapper = IncrementalMapper(device, torch.float32, cache)
    mapper.begin_reconstruction(rec)
    ok = mapper.register_initial_line_images(MapperOptions(), cache)
    times = " ".join(f"{k}={v:.3f}s" for k, v in
                     list(mapper.phase_times.items())
                     + list(mapper.triangulator.phase_times.items()))
    print(f"  graph={cache.graph_kind} device={device} phase times: {times}")
    if device.type == "cuda":
        print(f"  peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB")
    if not ok:
        print("Initialization failed")
        sys.exit(1)
    os.makedirs(args.output_path, exist_ok=True)
    rec.write_text(args.output_path)
    print(f"Initialized with images {rec.reg_image_ids} "
          f"({len(rec.points3d)} points)")
    timer.print_minutes()
    return mapper


def cmd_database_creator(args):
    from privacy_preserving_sfm_torch.models.database import Database

    with Database(args.database_path):
        pass
    print(f"Created database at {args.database_path}")


_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def image_seed(seed: int, position: int) -> int:
    """The generator seed of the image at ``position`` in the sorted
    listing."""
    return int(np.random.SeedSequence([seed, position]).generate_state(
        1, np.uint64)[0])


def cmd_feature_extractor(args):
    from privacy_preserving_sfm_torch.features import extraction, sift
    from privacy_preserving_sfm_torch.features.exif_focal import (
        exif_focal_length,
    )
    from privacy_preserving_sfm_torch.models.database import Database
    from privacy_preserving_sfm_torch.ops.cameras import MODELS
    from privacy_preserving_sfm_torch.utils.timer import Timer, print_heading1

    device = _device(args.device)
    print_heading1("Feature extraction")
    timer = Timer()
    names = sorted(n for n in os.listdir(args.image_path)
                   if n.lower().endswith(_IMAGE_EXTS))
    sift_opts = sift.SiftOptions(max_num_features=args.max_num_features)

    with Database(args.database_path) as db:
        existing = {v["name"]: k for k, v in db.read_images().items()}
        camera_ids = {}
        groups = {}  # (shape, model, n_params, has_mask) -> pending records
        for idx, name in enumerate(names):
            path = os.path.join(args.image_path, name)
            cam_info = extraction.read_camera_model_file(path)
            gravity = extraction.read_gravity_file(path)
            if gravity is None:
                print(f"  {name}: no .gravity.txt, skipping")
                continue

            img = extraction.load_image_grayscale_u8(path)
            h, w = img.shape
            prior_focal = True
            if cam_info is None:
                # No explicit calibration: the EXIF focal-length cascade
                # (bitmap.cc:286-370 / image_reader.cc:117-139).
                focal, prior_focal = exif_focal_length(path, w, h)
                cam_info = ("SIMPLE_PINHOLE",
                            np.array([focal, w / 2.0, h / 2.0]))
                print(f"  {name}: focal from "
                      f"{'EXIF' if prior_focal else 'heuristic'} "
                      f"({focal:.1f} px)")
            model, params = cam_info
            if model not in MODELS:
                raise ValueError(f"{name}: unknown camera model {model}")
            img_r, scale = extraction.resize_to_max(img, args.max_image_size)
            params_scaled = params.copy()
            if scale != 1.0:
                spec = MODELS[model]
                for i in spec.focal_idxs + spec.principal_idxs:
                    params_scaled[i] *= scale

            cam_key = (model, tuple(params), w, h)
            if cam_key not in camera_ids:
                camera_ids[cam_key] = db.write_camera(
                    model, w, h, params, prior_focal=prior_focal)
            if name in existing:
                iid = existing[name]
            else:
                # EXIF GPS (or a .gps.txt sidecar) -> image prior position
                # (image_reader.cc:252-259).
                iid = db.write_image(name, camera_ids[cam_key],
                                     prior_t=extraction.read_exif_gps(path))
            if db.exists_lines(iid) and db.exists_descriptors(iid):
                continue

            mask = extraction.read_mask(path)
            if mask is not None:
                mask = extraction.resize_mask(mask, img_r.shape)
            gkey = (img_r.shape, model, len(params_scaled), mask is not None)
            groups.setdefault(gkey, []).append(dict(
                iid=iid, name=name, img=img_r, seed=image_seed(args.seed, idx),
                model=model, params=np.asarray(params_scaled, np.float32),
                gravity=gravity, mask=mask))
            if len(groups[gkey]) >= args.batch_size:
                _flush_extraction_batch(db, groups.pop(gkey), sift_opts,
                                        args, device)
        for batch in groups.values():
            _flush_extraction_batch(db, batch, sift_opts, args, device)
        db.commit()
    if device.type == "cuda":
        print(f"  peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB")
    timer.print_minutes()


def _flush_extraction_batch(db, batch, sift_opts, args, device):
    """One batched front-end call for up to ``batch_size`` same-shape
    images; a short tail is padded by repeating its last record and the
    padded outputs are dropped."""
    import time

    from privacy_preserving_sfm_torch.features import extraction

    t0 = time.perf_counter()
    n = len(batch)
    padded = batch + [batch[-1]] * (args.batch_size - n)

    def stack(field, dtype=None):
        return torch.from_numpy(np.stack([r[field] for r in padded])).to(
            device=device, dtype=dtype)

    masks = stack("mask") if batch[0]["mask"] is not None else None
    # CPU generators on every device: the card writes the CPU's draws.
    generators = [torch.Generator().manual_seed(r["seed"]) for r in padded]
    lf = extraction.extract_and_lift_batch(
        stack("img"), batch[0]["model"], stack("params"),
        stack("gravity", torch.float32), generators, sift_opts,
        args.aligned_line_ratio, masks)
    valid, desc, lines, aligned = (t.cpu().numpy() for t in (
        lf.valid, lf.descriptors, lf.lines, lf.aligned))
    t1 = time.perf_counter()
    for i, r in enumerate(batch):
        v = valid[i]
        db.write_descriptors(r["iid"], desc[i][v])
        db.write_lines(r["iid"], lines[i][v], aligned[i][v])
        db.write_gravity(r["iid"], r["gravity"])
        print(f"  {r['name']}: {int(v.sum())} features "
              f"({int(aligned[i][v].sum())} aligned)")
    print(f"  [batch of {n}: device {t1 - t0:.2f}s, "
          f"db {time.perf_counter() - t1:.2f}s]", flush=True)


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


def cmd_mapper(args):
    """The incremental mapper on the database (reference ``ppsfm.py:
    338-374``).  Returns the controller."""
    import time

    from privacy_preserving_sfm_torch.models.reconstruction import (
        Reconstruction,
    )
    from privacy_preserving_sfm_torch.sfm.controller import (
        ControllerOptions, IncrementalMapperController,
    )
    from privacy_preserving_sfm_torch.utils.config import AllOptions
    from privacy_preserving_sfm_torch.utils.timer import Timer

    device = _device(args.device)
    timer = Timer()
    input_rec = None
    if args.input_path:
        input_rec = Reconstruction.read_text(args.input_path)
        print(f"  resuming from {args.input_path} "
              f"({input_rec.num_registered()} images)")
    ctrl = IncrementalMapperController(
        ControllerOptions(), database_path=args.database_path,
        input_reconstruction=input_rec, device=device, dtype=torch.float32)
    t0 = time.perf_counter()
    recs = ctrl.run()
    mapper_wall = time.perf_counter() - t0
    num_reg = sum(r.num_registered() for r in recs)
    print(ctrl.profiler.report())
    print(f"  => images registered/s: {num_reg / max(mapper_wall, 1e-9):.3f}"
          f" ({num_reg} images in {mapper_wall:.1f}s)")
    if device.type == "cuda":
        print(f"  peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB")
    os.makedirs(args.output_path, exist_ok=True)
    for i, rec in enumerate(recs):
        out = os.path.join(args.output_path, str(i))
        rec.write_text(out)
        AllOptions(database_path=args.database_path,
                   image_path=args.image_path).save(
                       os.path.join(out, "project.ini"))
        print(f"  model {i}: {rec.num_registered()} images, "
              f"{len(rec.points3d)} points, "
              f"mean reproj {rec.compute_mean_reprojection_error():.3f}px")
    timer.print_minutes()
    return ctrl


def cmd_hierarchical_mapper(args):
    """The block-parallel mapper (``sfm/hierarchical.py``; reference
    ``ppsfm.py:377-409``) on the database, in float32: blocks in
    ``--num_workers`` spawned processes on ``--device``.  Prints the
    images registered per second and, on CUDA, the peak device memory of
    this process; writes the model to ``OUTPUT/0``.  Returns the stats of
    ``hierarchical_map`` with the model under "model"."""
    import time

    from privacy_preserving_sfm_torch.sfm.controller import ControllerOptions
    from privacy_preserving_sfm_torch.sfm.hierarchical import (
        HierarchicalOptions, hierarchical_map,
    )
    from privacy_preserving_sfm_torch.utils.timer import Timer

    device = _device(args.device)
    timer = Timer()
    opts = HierarchicalOptions(block_size=args.block_size,
                               overlap=args.overlap,
                               num_workers=args.num_workers,
                               controller=ControllerOptions())
    stats = {}
    t0 = time.perf_counter()
    rec = hierarchical_map(args.database_path, opts, device=device,
                           dtype=torch.float32, stats=stats)
    wall = time.perf_counter() - t0
    stats.update(model=rec, wall=wall)
    if rec is None:
        print("  => no model produced")
        return stats
    print(f"  => images registered/s: "
          f"{rec.num_registered() / max(wall, 1e-9):.3f} "
          f"({rec.num_registered()} images in {wall:.1f}s)")
    if device.type == "cuda":
        print(f"  peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB")
    out = os.path.join(args.output_path, "0")
    rec.write_text(out)
    print(f"  model 0: {rec.num_registered()} images, "
          f"{len(rec.points3d)} points, "
          f"mean reproj {rec.compute_mean_reprojection_error():.3f}px")
    timer.print_minutes()
    return stats


def cmd_image_filterer(args):
    """Filter the points, then the images, of a text model (reference
    ``ppsfm.py:441-450``)."""
    from privacy_preserving_sfm_torch.models.reconstruction import (
        Reconstruction,
    )

    rec = Reconstruction.read_text(args.input_path)
    before = rec.num_registered()
    rec.filter_points3d(args.max_reproj_error, args.min_tri_angle)
    filtered = rec.filter_images()
    os.makedirs(args.output_path, exist_ok=True)
    rec.write_text(args.output_path)
    print(f"Filtered {len(filtered)} of {before} images")
    return filtered


def cmd_model_viewer(args):
    """Render a text model to PNG (one view, or ``--turntable`` frames
    into a directory), or with ``--html`` write the interactive viewer
    (reference ``ppsfm.py:476-500``).  Returns the paths written."""
    from privacy_preserving_sfm_torch.models.reconstruction import (
        Reconstruction,
    )

    rec = Reconstruction.read_text(args.input_path)
    if args.html:
        from privacy_preserving_sfm_torch.viz.interactive import export_html

        export_html(rec, args.html)
        print(f"Wrote interactive viewer {args.html}")
        return [args.html]
    if not args.output_path:
        raise SystemExit("model_viewer: need --output_path or --html")
    from privacy_preserving_sfm_torch.viz import render

    if args.turntable > 0:
        paths = render.render_turntable(rec, args.output_path,
                                        num_frames=args.turntable,
                                        elev=args.elev,
                                        color_by=args.color_by)
        print(f"Wrote {len(paths)} frames to {args.output_path}")
        return paths
    render.render_model(rec, args.output_path, elev=args.elev,
                        azim=args.azim, color_by=args.color_by)
    print(f"Wrote {args.output_path}")
    return [args.output_path]


def cmd_project_generator(args):
    """Write a ``project.ini`` with the defaults, under a quality preset
    when given (reference ``ppsfm.py:503-511``)."""
    from privacy_preserving_sfm_torch.utils.config import AllOptions

    opts = AllOptions(database_path=args.database_path,
                      image_path=args.image_path)
    if args.quality:
        opts.apply_quality_preset(args.quality)
    opts.save(args.output_path)
    print(f"Wrote project file to {args.output_path}")
    return opts


def cmd_automatic_reconstructor(args):
    """``feature_extractor``, a matcher and ``mapper`` in one process on
    ``WORKSPACE/database.db``, models under ``WORKSPACE/sparse``
    (reference ``ppsfm.py:514-539``); prints the process's hand-kernel
    launches.  Returns the mapper's controller."""
    from privacy_preserving_sfm_torch.kernels import build
    from privacy_preserving_sfm_torch.utils.config import AllOptions

    _device(args.device)
    opts = AllOptions()
    if args.quality:
        opts.apply_quality_preset(args.quality)
    args.database_path = os.path.join(args.workspace_path, "database.db")
    args.max_image_size = opts.extraction.max_image_size
    args.max_num_features = opts.extraction.sift.max_num_features
    args.aligned_line_ratio = opts.extraction.aligned_line_ratio
    args.seed = 0
    args.min_num_matches = opts.matching.min_num_matches
    args.block_size = opts.matching.block_size
    args.input_path = ""
    args.output_path = os.path.join(args.workspace_path, "sparse")
    os.makedirs(args.workspace_path, exist_ok=True)
    cmd_feature_extractor(args)
    if args.matcher == "sequential":
        cmd_sequential_matcher(args)
    else:
        cmd_exhaustive_matcher(args)
    ctrl = cmd_mapper(args)
    print("  kernel launches: " + " ".join(
        f"{k}={v}" for k, v in build.LAUNCHES.items()))
    return ctrl


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

    p = sub.add_parser("feature_extractor")
    _add_db_arg(p)
    p.add_argument("--image_path", required=True)
    p.add_argument("--max_image_size", type=int, default=3200)
    p.add_argument("--max_num_features", type=int, default=8192)
    p.add_argument("--aligned_line_ratio", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=8,
                   help="images per front-end call")
    p.add_argument("--device", default="cuda",
                   help="torch device of the front end: cuda (default) or "
                   "cpu")
    p.set_defaults(func=cmd_feature_extractor)

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

    p = sub.add_parser("line_initializer")
    _add_db_arg(p)
    p.add_argument("--output_path", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device of the initializer and the "
                   "triangulation: cuda (default) or cpu")
    p.set_defaults(func=cmd_line_initializer)

    p = sub.add_parser("mapper")
    _add_db_arg(p)
    p.add_argument("--image_path", default="")
    p.add_argument("--input_path", default="")
    p.add_argument("--output_path", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device of the mapper: cuda (default) or cpu")
    p.set_defaults(func=cmd_mapper)

    p = sub.add_parser("hierarchical_mapper")
    _add_db_arg(p)
    p.add_argument("--output_path", required=True)
    p.add_argument("--block_size", type=int, default=30)
    p.add_argument("--overlap", type=int, default=5)
    p.add_argument("--num_workers", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device of the blocks and the joint "
                   "refinement: cuda (default) or cpu")
    p.set_defaults(func=cmd_hierarchical_mapper)

    p = sub.add_parser("image_filterer")
    p.add_argument("--input_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--max_reproj_error", type=float, default=4.0)
    p.add_argument("--min_tri_angle", type=float, default=1.5)
    p.set_defaults(func=cmd_image_filterer)

    p = sub.add_parser("model_viewer")
    p.add_argument("--input_path", required=True)
    p.add_argument("--output_path", required=False, default="",
                   help="PNG path (or directory with --turntable)")
    p.add_argument("--html", default="",
                   help="write a self-contained interactive HTML viewer "
                        "(orbit/pan/zoom, color-by, frusta) instead of PNG")
    p.add_argument("--turntable", type=int, default=0,
                   help="render N azimuth frames instead of one view")
    p.add_argument("--elev", type=float, default=-60.0)
    p.add_argument("--azim", type=float, default=-90.0)
    p.add_argument("--color_by", choices=["track", "error", "depth"],
                   default="track")
    p.set_defaults(func=cmd_model_viewer)

    p = sub.add_parser("project_generator")
    p.add_argument("--database_path", default="")
    p.add_argument("--image_path", default="")
    p.add_argument("--output_path", required=True)
    p.add_argument("--quality", default="")
    p.set_defaults(func=cmd_project_generator)

    p = sub.add_parser("automatic_reconstructor")
    p.add_argument("--workspace_path", required=True)
    p.add_argument("--image_path", required=True)
    p.add_argument("--quality", default="high")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--matcher", choices=["exhaustive", "sequential"],
                   default="exhaustive")
    p.add_argument("--overlap", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device of the extractor, the matcher and "
                   "the mapper: cuda (default) or cpu")
    p.set_defaults(func=cmd_automatic_reconstructor)

    args = parser.parse_args(argv)
    return args.func(args)
