"""The port's profiler spans inside the BA solve and the matcher.

Each span is a ``torch.profiler.record_function`` range; the benchmark's
per-layer metrics count them, and time the device operations launched
inside them, in a traced slice.  On the CPU the tests count the ranges in
the profiler's raw events (its parsed event tree takes seconds here) for a
tiny ``bundle_adjust_soa`` solve through ``ba_dense.from_flat_problem`` and
a tiny ``match_many_pairs`` call, and hold the results with the profiler
on bit for bit to those with it off.
"""

import collections
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from privacy_preserving_sfm_torch.features import matching
from privacy_preserving_sfm_torch.ops import lie_np
from privacy_preserving_sfm_torch.optim import ba as tba
from privacy_preserving_sfm_torch.optim import ba_dense as tbd
from privacy_preserving_sfm_torch.optim import ba_soa as tsoa
from privacy_preserving_sfm_torch.optim import convert

torch.set_num_threads(2)

MODEL = "SIMPLE_PINHOLE"
# Reads of the device a solve makes once, whatever its iterations, with
# the default options (PERF.md, section 3): the four problem tensors in
# ``from_flat_problem``, the Gram plan's size, the summary's two costs.
READS_PER_SOLVE = {"ba_dense.host_read": 4, "schur_pcg.host_read": 1,
                   "ba_soa.host_read": 2}


def _fields(seed=3, num_cams=4, num_points=20, obs_per_point=4, noise=1e-2,
            meas_noise=1e-3):
    """Numpy fields of a flat BAProblem: cameras on a row looking at a
    cloud of points, every third point's track one observation short (so
    the dense layout pads), poses and points perturbed by ``noise``."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, (num_points, 3))
    pts[:, 2] += 8.0
    yaw = rng.uniform(-0.4, 0.4, num_cams)
    zero = np.zeros(num_cams)
    qs = np.stack([np.cos(yaw / 2), zero, np.sin(yaw / 2), zero], 1)
    ts = np.stack([rng.uniform(-2, 2, num_cams),
                   rng.uniform(-0.3, 0.3, num_cams),
                   rng.uniform(-0.5, 0.5, num_cams)], 1)
    obs_cam = np.stack([rng.permutation(num_cams)[:obs_per_point]
                        for _ in range(num_points)]).reshape(-1)
    obs_point = np.repeat(np.arange(num_points), obs_per_point)
    Rm = np.stack([lie_np.quat_to_rotmat(q) for q in qs])
    Xc = np.einsum("oij,oj->oi", Rm[obs_cam], pts[obs_point]) + ts[obs_cam]
    uv = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, meas_noise, (len(Xc), 2))
    hom = np.concatenate([uv, np.ones((len(uv), 1))], 1)
    lines = np.cross(rng.standard_normal((len(uv), 3)), hom)
    lines /= np.linalg.norm(lines[:, :2], axis=-1, keepdims=True)
    keep = np.ones(len(obs_cam), bool)
    keep[obs_per_point * np.arange(0, num_points, 3)] = False
    mask = np.ones((num_cams, 6))
    mask[0] = 0.0
    mask[1, 3] = 0.0
    return dict(
        qvecs=qs + rng.normal(0, noise * 0.1, qs.shape),
        tvecs=ts + rng.normal(0, noise, ts.shape),
        cam_params=np.tile([500.0, 320.0, 240.0], (num_cams, 1)),
        points3d=pts + rng.normal(0, noise, pts.shape),
        obs_cam=obs_cam[keep].astype(np.int32),
        obs_point=obs_point[keep].astype(np.int32),
        obs_line=lines[keep], obs_weight=np.ones(int(keep.sum())),
        cam_dof_mask=mask, point_mask=np.ones(num_points))


def _solve(opts, fields=None):
    problem = convert.ba_problem_from_numpy(
        _fields() if fields is None else fields, "cpu", torch.float64)
    return tsoa.bundle_adjust_soa(tbd.from_flat_problem(problem), MODEL,
                                  opts)


def _traced(run):
    """``run()`` under the profiler: its result and the number of host
    ranges of each name, from the profiler's raw events."""
    cpu = torch.autograd.DeviceType.CPU
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    names = collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events()
        if e.device_type() == cpu)
    return out, names


def _rejections(summary, opts) -> int:
    """Rejected steps, from the final damping: each accepted step divides
    lambda by 3, each rejected one multiplies it by 4 (no clamp is
    reached in these solves)."""
    lam0 = tba.DynamicBAOptions.from_options(opts).initial_lambda
    it = summary.num_iterations
    r = (math.log(summary.lam / lam0) + it * math.log(3.0)) / math.log(12.0)
    assert abs(r - round(r)) < 1e-6
    return round(r)


@pytest.mark.parametrize("gradient_tolerance", [0.0, 1e-30])
def test_ba_soa_spans_count_iterations_and_reads(gradient_tolerance):
    """One solve of the default options (and with a gradient tolerance too
    small to stop it, which adds one read an iteration): the spans of
    every LM iteration, every pass of the Jacobians and bin sums, every
    read of the device, and every rejected step."""
    opts = tba.BAOptions(gradient_tolerance=gradient_tolerance)
    (_, _, _, summary), n = _traced(lambda: _solve(opts))
    it = summary.num_iterations
    assert 2 < it <= opts.max_iterations
    assert n["ba_dense.from_flat_problem"] == 1
    assert n["ba_soa.solve_step"] == it
    assert n["ba_soa.build_normal"] == it + 1
    assert n["ba.jacobians"] == it + 1
    assert n["ba.bins"] == 2 * (it + 1)
    per_iter = 3 if gradient_tolerance > 0 else 2
    for name, once in READS_PER_SOLVE.items():
        want = once + (per_iter * it if name == "ba_soa.host_read" else 0)
        assert n[name] == want, name
    reads = sum(v for k, v in n.items() if k.endswith(".host_read"))
    assert reads == per_iter * it + sum(READS_PER_SOLVE.values())
    rejected = _rejections(summary, opts)
    assert 0 < rejected < it
    assert n["ba_soa.rejected_step"] == rejected


def test_rejected_steps_are_counted():
    """A problem with nothing free to move (every camera dof and point held,
    identity rotations, which a zero step leaves bit for bit): each trial
    cost equals the cost, so every step is rejected until the solve gives
    up after ``max_consecutive_rejections``."""
    fields = _fields()
    fields["qvecs"] = np.tile([1.0, 0.0, 0.0, 0.0], (len(fields["qvecs"]), 1))
    fields["cam_dof_mask"] = np.zeros_like(fields["cam_dof_mask"])
    fields["point_mask"] = np.zeros_like(fields["point_mask"])
    opts = tba.BAOptions()
    (_, _, _, summary), n = _traced(lambda: _solve(opts, fields))
    it = summary.num_iterations
    assert it == opts.max_consecutive_rejections
    assert summary.final_cost == summary.initial_cost
    assert n["ba_soa.rejected_step"] == it == n["ba_soa.solve_step"]


def test_ba_soa_solve_is_unchanged_under_the_profiler():
    opts = tba.BAOptions(max_iterations=8)
    q0, t0, X0, s0 = _solve(opts)
    (q1, t1, X1, s1), _ = _traced(lambda: _solve(opts))
    for a, b in ((q0, q1), (t0, t1), (X0, X1)):
        assert torch.equal(a, b)
    assert s0 == s1


def _match_inputs(seed=5, images=4, n=24):
    """Descriptors quantized as SIFT's are (non-negative, norm 512), image
    1 sharing half of image 0's; about a tenth of the rows padding."""
    g = torch.Generator().manual_seed(seed)
    v = torch.rand(images, n, 128, generator=g) ** 4
    v = 512.0 * v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    desc = v.round().clamp(0, 255).to(torch.uint8)
    desc[1, :12] = desc[0, :12]
    valid = torch.rand(images, n, generator=g) < 0.9
    pairs = torch.tensor([[0, 1], [0, 2], [1, 3]])
    return desc, valid, pairs


@pytest.mark.parametrize("cross_check", [True, False])
def test_match_many_pairs_spans(cross_check):
    """One ``matching.gather``, ``matching.top2`` and ``matching.gate``
    range a call, and the matches the same with the profiler on."""
    desc, valid, pairs = _match_inputs()
    want = matching.match_many_pairs(desc, valid, pairs,
                                     cross_check=cross_check)
    assert int(want.num_matches[0]) > 0

    def run():
        return [matching.match_many_pairs(desc, valid, p,
                                          cross_check=cross_check)
                for p in (pairs, pairs[:1])]

    (got, _), n = _traced(run)
    for name in ("matching.gather", "matching.top2", "matching.gate"):
        assert n[name] == 2, name
    for a, b in zip(want, got):
        assert torch.equal(a, b)
