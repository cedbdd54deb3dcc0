"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (and nvcc to build the kernels on
first use); without one they skip.  Run them on a GPU machine with
``python -m pytest tests/test_torch_kernels.py -q``.  ``chip_smoke.py``
makes the same checks at the main path's full sizes.
"""

import numpy as np
import pytest
import torch

from privacy_preserving_sfm_torch.features import matching as tm
from privacy_preserving_sfm_torch.features import matching_kernels as tmk
from privacy_preserving_sfm_torch.kernels import build as kernels
from privacy_preserving_sfm_torch.optim import ba as tba
from privacy_preserving_sfm_torch.optim import ba_dense as tbd
from privacy_preserving_sfm_torch.optim import ba_soa as tsoa
from privacy_preserving_sfm_torch.optim import convert
from privacy_preserving_sfm_torch.optim import schur_pcg as tsp

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gram_inputs(seed, K, P, C, dtype, device, repeat=False):
    rng = np.random.default_rng(seed)
    lh = torch.tensor(rng.standard_normal((18 * K, P)), dtype=dtype,
                      device=device)
    gl = torch.tensor(rng.standard_normal((3, P)), dtype=dtype,
                      device=device)
    cam = rng.integers(0, C, (K, P)).astype(np.int32)
    if repeat:  # repeated cameras within a point, and empty slots
        cam[1] = cam[0]
        cam[-1, ::3] = -1
    return lh, gl, torch.tensor(cam, device=device)


# K of the main path (6), a track of two, a long ragged track and a global
# BA's K = 128; C above the strip width (64 cameras in float32, 32 in
# float64), so a camera's columns span several strips, and below it,
# where a camera's observations are split over several CTAs.
GRAM_CASES = [(4, 37, 9, False), (6, 900, 40, True), (32, 300, 300, False),
              (2, 700, 150, True), (6, 2000, 150, True),
              (32, 400, 150, True), (128, 300, 150, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K,P,C,repeat", GRAM_CASES)
def test_gram_kernel_matches_plain(cuda, dtype, K, P, C, repeat):
    lh, gl, cam = _gram_inputs(1, K, P, C, dtype, cuda, repeat)
    S_ref, r_ref = tsp.gram_soa_plain(lh.double(), gl.double(), cam, C)
    n0 = kernels.LAUNCHES["schur_gram"]
    S, r = tsp.gram_soa(lh, gl, cam, C)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["schur_gram"] == n0 + 1
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    scale = S_ref.abs().max()
    assert (S.double() - S_ref).abs().max() <= tol * scale
    assert (r.double() - r_ref).abs().max() <= tol * r_ref.abs().max()
    assert torch.equal(S, S.T)
    S2, r2 = tsp.gram_soa(lh, gl, cam, C)
    assert torch.equal(S, S2) and torch.equal(r, r2)


def _aos(lh, gl, cam):
    """The same Gram inputs in the AoS layout of ``gram_aos``."""
    K, P = cam.shape
    LH = lh.reshape(3, 6, K, P).permute(3, 2, 0, 1).contiguous()
    return LH, gl.T.contiguous(), cam.T.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K,P,C,repeat", GRAM_CASES)
def test_gram_aos_kernel_matches_plain(cuda, dtype, K, P, C, repeat):
    LH, gl, cam = _aos(*_gram_inputs(5, K, P, C, dtype, cuda, repeat))
    S_ref, r_ref = tsp.gram_aos_plain(LH.double(), gl.double(), cam, C)
    n0 = kernels.LAUNCHES["schur_gram_aos"]
    S, r = tsp.gram_aos(LH, gl, cam, C)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["schur_gram_aos"] == n0 + 1
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    assert (S.double() - S_ref).abs().max() <= tol * S_ref.abs().max()
    assert (r.double() - r_ref).abs().max() <= tol * r_ref.abs().max()
    assert torch.equal(S, S.T)
    S2, r2 = tsp.gram_aos(LH, gl, cam, C)
    assert torch.equal(S, S2) and torch.equal(r, r2)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K,C", [(2, 150), (6, 30), (32, 150), (128, 150)])
def test_gram_aos_kernel_equals_soa_kernel(cuda, K, C, dtype, precision):
    """Two stagings, one compacted V and one strip pass: the same sums in
    the same order."""
    lh, gl, cam = _gram_inputs(6, K, 500, C, dtype, cuda, True)
    S, r = tsp.gram_soa(lh, gl, cam, C, precision)
    S2, r2 = tsp.gram_aos(*_aos(lh, gl, cam), C, precision)
    assert torch.equal(S, S2) and torch.equal(r, r2)


@pytest.mark.parametrize("layout", ["soa", "aos"])
def test_gram_kernel_with_plan_does_not_sync(cuda, layout):
    """Given the solve's plan, the launch reads nothing back to the host,
    and gives what a plan built per call gives."""
    lh, gl, cam = _gram_inputs(8, 6, 2000, 150, torch.float32, cuda, True)
    args = (lh, gl, cam) if layout == "soa" else _aos(lh, gl, cam)
    gram = tsp.gram_soa if layout == "soa" else tsp.gram_aos
    plan = tsp.gram_plan(args[2], 150, layout)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        S, r = gram(*args, 150, plan=plan)
        S16, r16 = gram(*args, 150, "bf16", plan=plan)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    S2, r2 = gram(*args, 150)
    assert torch.equal(S, S2) and torch.equal(r, r2)
    S3, r3 = gram(*args, 150, "bf16")
    assert torch.equal(S16, S3) and torch.equal(r16, r3)


@pytest.mark.parametrize("layout", ["soa", "aos"])
def test_gram_kernel_plan_of_other_layout_raises(cuda, layout):
    lh, gl, cam = _gram_inputs(8, 6, 50, 10, torch.float32, cuda)
    other = "aos" if layout == "soa" else "soa"
    if layout == "soa":
        args, gram, plan = (lh, gl, cam), tsp.gram_soa, tsp.gram_plan(
            cam.T.contiguous(), 10, other)
    else:
        args, gram, plan = _aos(lh, gl, cam), tsp.gram_aos, tsp.gram_plan(
            cam, 10, other)
    with pytest.raises(ValueError, match="plan"):
        gram(*args, 10, plan=plan)


@pytest.mark.parametrize("layout", ["soa", "aos"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [6, 128])
def test_gram_bf16_kernel_matches_plain(cuda, layout, dtype, K):
    """bf16 mode with repeated cameras in points: both sides round V's
    entries (sums of a point's slots in one camera), so only the sum
    order differs (1e-4 of max|S| in float32)."""
    lh, gl, cam = _gram_inputs(7, K, 900, 40, dtype, cuda, True)
    if layout == "aos":
        args = _aos(lh, gl, cam)
        kernel, plain = tsp.gram_aos, tsp.gram_aos_plain
    else:
        args = (lh, gl, cam)
        kernel, plain = tsp.gram_soa, tsp.gram_soa_plain
    S_ref, r_ref = plain(*args, 40, "bf16")
    S, r = kernel(*args, 40, "bf16")
    torch.cuda.synchronize()
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    assert (S - S_ref).abs().max() <= tol * S_ref.abs().max()
    assert (r - r_ref).abs().max() <= tol * r_ref.abs().max()
    S32, r32 = kernel(*args, 40)
    assert torch.equal(r32, r)
    assert (S32 - S).abs().max() > 1e-4 * S_ref.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C", [9, 100])
def test_pcg_kernel_matches_plain(cuda, dtype, C):
    rng = np.random.default_rng(2)
    N = tsp.padded_dim(C)
    A = rng.standard_normal((N, N))
    S = torch.tensor(A @ A.T + N * np.eye(N), dtype=dtype, device=cuda)
    Minv = torch.diag(1.0 / torch.diagonal(S))
    rhs = torch.tensor(rng.standard_normal(N), dtype=dtype, device=cuda)
    x_ref = tsp.pcg_plain(S.double(), Minv.double(), rhs.double(), 30)
    n0 = kernels.LAUNCHES["schur_pcg"]
    x = tsp.pcg(S, Minv, rhs, 30)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["schur_pcg"] == n0 + 1
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    assert float((x.double() - x_ref).norm() / x_ref.norm()) <= tol


def test_bundle_adjust_soa_kernels_match_plain(cuda):
    rng = np.random.default_rng(3)
    C, P, K = 12, 300, 5
    pts = rng.uniform(-2, 2, (P, 3)) + np.array([0, 0, 8.0])
    qs = np.tile([1.0, 0, 0, 0], (C, 1)) + rng.normal(0, 1e-3, (C, 4))
    ts = np.stack([rng.uniform(-2, 2, C), rng.uniform(-0.3, 0.3, C),
                   rng.uniform(-0.5, 0.5, C)], 1)
    obs_cam = np.stack([rng.permutation(C)[:K] for _ in range(P)])
    lines = rng.standard_normal((P * K, 3))
    lines /= np.linalg.norm(lines[:, :2], axis=-1, keepdims=True)
    mask = np.ones((C, 6))
    mask[0] = 0.0
    mask[1, 3] = 0.0
    fields = dict(qvecs=qs, tvecs=ts, cam_params=np.tile([500.0, 320, 240],
                                                         (C, 1)),
                  points3d=pts, obs_cam=obs_cam.reshape(-1),
                  obs_point=np.repeat(np.arange(P), K), obs_line=lines,
                  obs_weight=np.ones(P * K), cam_dof_mask=mask,
                  point_mask=np.ones(P))
    dense = tbd.from_flat_problem(
        convert.ba_problem_from_numpy(fields, cuda, torch.float64))
    opts = tba.BAOptions(max_iterations=3, cg_iterations=20)
    ref = tsoa.bundle_adjust_soa(dense, "SIMPLE_PINHOLE", opts, plain=True)
    got = tsoa.bundle_adjust_soa(dense, "SIMPLE_PINHOLE", opts)
    assert got[3].num_iterations == ref[3].num_iterations
    np.testing.assert_allclose(got[3].final_cost, ref[3].final_cost,
                               rtol=1e-9)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=0, atol=1e-8)


@pytest.mark.parametrize("mode", ["explicit", "implicit"])
def test_bundle_adjust_dense_kernels_match_plain(cuda, mode):
    """Ragged tracks (padding slots) through the dense solver: the AoS Gram
    and PCG kernels against their plain versions, float64."""
    rng = np.random.default_rng(4)
    C, P = 12, 300
    pts = rng.uniform(-2, 2, (P, 3)) + np.array([0, 0, 8.0])
    qs = np.tile([1.0, 0, 0, 0], (C, 1)) + rng.normal(0, 1e-3, (C, 4))
    ts = np.stack([rng.uniform(-2, 2, C), rng.uniform(-0.3, 0.3, C),
                   rng.uniform(-0.5, 0.5, C)], 1)
    lens = rng.integers(2, 7, P)
    obs_cam = np.concatenate([rng.permutation(C)[:n] for n in lens])
    lines = rng.standard_normal((len(obs_cam), 3))
    lines /= np.linalg.norm(lines[:, :2], axis=-1, keepdims=True)
    mask = np.ones((C, 6))
    mask[0] = 0.0
    mask[1, 3] = 0.0
    fields = dict(qvecs=qs, tvecs=ts, cam_params=np.tile([500.0, 320, 240],
                                                         (C, 1)),
                  points3d=pts, obs_cam=obs_cam,
                  obs_point=np.repeat(np.arange(P), lens), obs_line=lines,
                  obs_weight=np.ones(len(obs_cam)), cam_dof_mask=mask,
                  point_mask=np.ones(P))
    dense = tbd.from_flat_problem(
        convert.ba_problem_from_numpy(fields, cuda, torch.float64))
    opts = tba.BAOptions(max_iterations=3, cg_iterations=20, schur_mode=mode)
    n0 = dict(kernels.LAUNCHES)
    ref = tbd.bundle_adjust_dense(dense, "SIMPLE_PINHOLE", opts, plain=True)
    assert kernels.LAUNCHES == n0
    got = tbd.bundle_adjust_dense(dense, "SIMPLE_PINHOLE", opts)
    launched = kernels.LAUNCHES["schur_gram_aos"] - n0["schur_gram_aos"]
    assert launched == (got[3].num_iterations if mode == "explicit" else 0)
    assert got[3].num_iterations == ref[3].num_iterations
    np.testing.assert_allclose(got[3].final_cost, ref[3].final_cost,
                               rtol=1e-9)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=0, atol=1e-8)


def _match_inputs(seed, b, n1, n2, device):
    """Seeded SIFT-convention descriptors with ties along a row and a
    column (exact duplicates), padding on both sides in pair 1, and a
    single valid candidate per row in pair 2."""
    rng = np.random.default_rng(seed)
    p1 = rng.dirichlet(np.full(128, 0.2), (b, n1))
    p2 = rng.dirichlet(np.full(128, 0.2), (b, n2))
    d1 = np.clip(np.round(512 * np.sqrt(p1)), 0, 255).astype(np.uint8)
    d2 = np.clip(np.round(512 * np.sqrt(p2)), 0, 255).astype(np.uint8)
    d2[0, n2 // 3] = d2[0, n2 - 1] = d1[0, n1 // 2]
    d1[0, n1 - 1] = d1[0, n1 // 2]
    v1 = np.ones((b, n1), bool)
    v2 = np.ones((b, n2), bool)
    if b > 1:
        v1[1, (2 * n1) // 3:] = False
        v2[1, n2 // 2:] = False
    if b > 2:
        v2[2, 1:] = False
    return [torch.from_numpy(a).to(device) for a in (d1, d2, v1, v2)]


@pytest.mark.parametrize("b,n1,n2", [(3, 384, 512), (2, 1000, 300),
                                     (1, 1, 7), (3, 129, 2000)])
def test_match_kernel_matches_plain(cuda, b, n1, n2):
    d1, d2, v1, v2 = _match_inputs(n1 + n2, b, n1, n2, cuda)
    ref = tm._top2_both_batched_plain(d1, d2, v1, v2)
    n0 = kernels.LAUNCHES["match_top2"]
    got = tmk.top2_scores_bidir(d1, d2, v1, v2)
    again = tmk.top2_scores_bidir(d1, d2, v1, v2)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["match_top2"] == n0 + 2
    for r, g, h in zip(ref, got, again):
        assert g.dtype == r.dtype and torch.equal(g, r)
        assert torch.equal(g, h)
    ones = torch.ones_like(v1)
    ref_rows = tm._top2_both_batched_plain(d1, d2, ones, v2)[:3]
    for r, g in zip(ref_rows, tmk.top2_scores(d1, d2, v2)):
        assert torch.equal(g, r)


def test_match_kernel_takes_only_128_byte_descriptors(cuda):
    d = torch.zeros(1, 16, 64, dtype=torch.uint8, device=cuda)
    v = torch.ones(1, 16, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="D = 128"):
        tmk.top2_scores_bidir(d, d, v, v)


def test_match_many_pairs_kernel_matches_plain(cuda):
    d1, d2, v1, v2 = _match_inputs(11, 3, 700, 700, cuda)
    desc = torch.cat([d1, d2])
    valid = torch.cat([v1, v2])
    pairs = torch.tensor([[0, 3], [1, 4], [2, 5], [3, 0], [1, 1]],
                         device=cuda)
    ref = tm.match_many_pairs(desc, valid, pairs, plain=True)
    got = tm.match_many_pairs(desc, valid, pairs)
    for r, g in zip(ref, got):
        assert torch.equal(g, r)
