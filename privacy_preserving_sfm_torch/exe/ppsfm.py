"""ppsfm CLI of the PyTorch/CUDA port.

Usage: ``python -m privacy_preserving_sfm_torch.exe <subcommand> [args]``.

Ported subcommands: ``bundle_adjuster`` (the flags of the reference CLI,
``privacy_preserving_sfm_tpu/exe/ppsfm.py:411-438, 623-627``, plus
``--device`` and ``--dtype``).  The solve runs on ``--device`` (default
``cuda``; asking for CUDA without a CUDA device is an error, never a
silent CPU run) in ``--dtype`` (default float32, the precision of the
accelerator path).
"""

from __future__ import annotations

import argparse
import os

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


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ppsfm")
    sub = parser.add_subparsers(dest="command", required=True)

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
