"""Tiny configurations of the benchmark's cells for the CPU tests."""

import copy

from benchmark.core import spec as spec_mod

TINY_CONFIG = {
    "collection1000.global_ba": dict(num_cameras=12, num_points=400,
                                     obs_per_point=6, meas_noise=2e-4),
    "sequence300.global_ba": dict(num_cameras=10, num_points=300,
                                  longest_track=9, num_observations=2000,
                                  track_lengths="ba300_model",
                                  meas_noise=2e-4),
    "collection1000.exhaustive_match": dict(num_images=12, num_features=256),
    "sequence300.frontend": dict(num_frames=10, width=128, height=96, f=80.0,
                                 box_texture=64,
                                 camera_model="SIMPLE_PINHOLE"),
}
TINY_MIX = {
    "collection1000.exhaustive_match": dict(chunk=8, max_resident_images=8,
                                            block_size=3),
    "sequence300.frontend": dict(batch=4, chunk=8, overlap=3,
                                 sift_options={"max_num_features": 256},
                                 check_frames=3, check_pairs=6),
}


def tiny_cell(workload: str):
    """The cell as ``BENCHMARK.json`` defines it, at a tiny size."""
    cell = spec_mod.load_cell(workload)
    cell = copy.copy(cell)
    cell.config = dict(TINY_CONFIG[workload])
    cell.mix = dict(cell.mix, **TINY_MIX.get(workload, {}))
    return cell
