"""Port parity: the Schur Gram's plan, its compaction pass and bf16 mode.

``gram_plan`` is checked against its definition, and ``compact_v_plain``
(the plain version of the Gram kernel's pass 1) against the V of the
reference's ``build_u_matrix`` on the same blocks, with padding slots at
camera -1, repeated cameras within a point, ragged tracks and a camera
that no point sees (float64, 1e-12 of max|V|).  In bf16 mode with
repeated cameras the port's Gram is held against the reference's Pallas
kernels ``gram_soa`` and ``gram_fused`` in interpret mode, which round V's
entries (sums of a point's slots in one camera): S to 1e-5 of max|S| in
both port layouts, and rhs equal to the float32 rhs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from privacy_preserving_sfm_tpu.optim import schur_pcg as jsp
from privacy_preserving_sfm_torch.optim import schur_pcg as tsp

torch.set_num_threads(2)


def _blocks(seed, P, K, C, dtype=np.float64):
    """LH (P, K, 3, 6), gL (P, 3) and cams (P, K): tracks of 1..K slots
    (the rest at -1 with zero blocks), repeated cameras in a third of the
    points, and camera C - 1 seen by no point."""
    rng = np.random.default_rng(seed)
    LH = rng.standard_normal((P, K, 3, 6)).astype(dtype)
    gL = rng.standard_normal((P, 3)).astype(dtype)
    cams = rng.integers(0, C - 1, (P, K))
    cams[::3, 1] = cams[::3, 0]
    cams[1::3, K - 1] = cams[1::3, 0]
    lens = rng.integers(1, K + 1, P)
    pad = np.arange(K)[None, :] >= lens[:, None]
    cams[pad] = -1
    LH[pad] = 0.0
    return LH, gL, cams.astype(np.int32)


def _soa(LH, gL, cams):
    P, K = cams.shape
    return (LH.transpose(2, 3, 1, 0).reshape(18 * K, P), gL.T.copy(),
            cams.T.copy())


@pytest.mark.parametrize("layout", ["soa", "aos"])
@pytest.mark.parametrize("P,K,C", [(60, 5, 9), (40, 12, 30), (7, 3, 4)])
def test_gram_plan_matches_its_definition(layout, P, K, C):
    _, _, cams = _blocks(P + K, P, K, C)
    if P == 7:
        cams[:] = -1  # no observation at all: M = 0
    cam_in = cams.T.copy() if layout == "soa" else cams
    plan = tsp.gram_plan(torch.tensor(cam_in), C, layout)
    assert plan.layout == layout and plan.num_cams == C
    slot_d = plan.slot_d.numpy()
    assert slot_d.shape == cam_in.shape
    slot_d = slot_d.T if layout == "soa" else slot_d
    dcam, count = plan.dcam.numpy(), plan.count.numpy()
    M = dcam.shape[1]
    rows = []
    for p in range(P):
        want = sorted(set(cams[p][cams[p] >= 0].tolist()))
        assert count[p] == len(want)
        assert dcam[p].tolist() == want + [-1] * (M - len(want))
        for k in range(K):
            c = cams[p, k]
            assert slot_d[p, k] == (want.index(c) if c >= 0 else -1)
        rows += [(c, p, p * M + j) for j, c in enumerate(want)]
    assert M == max((r for r in count), default=0)
    offsets, obs = plan.offsets.numpy(), plan.obs.numpy()
    assert offsets[0] == 0 and offsets[-1] == len(rows)
    assert obs.shape == (P * M,)
    rows.sort()
    np.testing.assert_array_equal(obs[:len(rows)], [r[2] for r in rows])
    for c in range(C):
        assert offsets[c + 1] - offsets[c] == sum(r[0] == c for r in rows)
    assert offsets[C] - offsets[C - 1] == 0  # camera C - 1 is unseen


def test_compact_v_matches_build_u_matrix():
    P, K, C = 80, 7, 11
    LH, gL, cams = _blocks(3, P, K, C)
    U = np.asarray(jsp.build_u_matrix(
        jnp.asarray(LH.transpose(0, 1, 3, 2)), jnp.asarray(cams), C))
    U = U.reshape(P, 3, C, 6)
    plan = tsp.gram_plan(torch.tensor(cams), C, "aos")
    Vc, rc = tsp.compact_v_plain(torch.tensor(LH), torch.tensor(gL), plan)
    Vc, rc = Vc.numpy(), rc.numpy()
    dcam, count = plan.dcam.numpy(), plan.count.numpy()
    assert Vc.shape == (P, dcam.shape[1], 3, 6)
    scale = np.abs(U).max()
    V_dense = np.zeros_like(U)
    for p in range(P):
        for j in range(count[p]):
            V_dense[p, :, dcam[p, j]] = Vc[p, j]
    np.testing.assert_allclose(V_dense, U, rtol=0, atol=1e-12 * scale)
    assert not U[:, :, C - 1].any()
    rc_ref = np.einsum("pacj,pa->pcj", U, gL)
    for p in range(P):
        m = count[p]
        np.testing.assert_allclose(rc[p, :m], rc_ref[p, dcam[p, :m]], rtol=0,
                                   atol=1e-12 * np.abs(rc_ref).max())


def test_compact_v_bf16_rounds_the_sums_and_keeps_rhs():
    LH, gL, cams = _blocks(4, 50, 6, 8, np.float32)
    plan = tsp.gram_plan(torch.tensor(cams), 8, "aos")
    args = (torch.tensor(LH), torch.tensor(gL), plan)
    V32, r32 = tsp.compact_v_plain(*args)
    V16, r16 = tsp.compact_v_plain(*args, precision="bf16")
    assert torch.equal(V16, V32.to(torch.bfloat16).float())
    assert torch.equal(r16, r32)
    # The SoA plan gives the same compaction.
    plan_soa = tsp.gram_plan(torch.tensor(cams.T.copy()), 8, "soa")
    V_s, r_s = tsp.compact_v_plain(*args[:2], plan_soa)
    assert torch.equal(V_s, V32) and torch.equal(r_s, r32)


@pytest.mark.parametrize("layout", ["soa", "aos"])
def test_gram_with_given_plan_equals_plan_per_call(layout):
    LH, gL, cams = _blocks(5, 70, 6, 12)
    args = tuple(torch.tensor(a) for a in (
        _soa(LH, gL, cams) if layout == "soa" else (LH, gL, cams)))
    gram = tsp.gram_soa if layout == "soa" else tsp.gram_aos
    plan = tsp.gram_plan(args[2], 12, layout)
    for precision in ("f32", "bf16"):
        S, r = gram(*args, 12, precision, plan=plan)
        S2, r2 = gram(*args, 12, precision)
        assert torch.equal(S, S2) and torch.equal(r, r2)
    other = tsp.gram_plan(args[2], 13, layout)
    with pytest.raises(ValueError, match="plan"):
        gram(*args, 12, plan=other)


@pytest.mark.parametrize("reference", ["gram_soa", "gram_fused"])
@pytest.mark.parametrize("layout", ["soa", "aos"])
def test_gram_bf16_repeated_cameras_matches_pallas_interpret(layout,
                                                             reference):
    """A point with two slots in one camera: the reference rounds their
    sum (V's entry), and so does the port."""
    P, K, C = 300, 6, 23
    LH, gL, cams = _blocks(9, P, K, C, np.float32)
    assert any(len(set(r[r >= 0])) < (r >= 0).sum() for r in cams)
    lh_s, gl_s, cam_s = _soa(LH, gL, cams)
    if reference == "gram_soa":
        S_k, r_k = jsp.gram_soa(jnp.asarray(lh_s), jnp.asarray(gl_s),
                                jnp.asarray(cam_s), C, precision="bf16",
                                interpret=True)
    else:
        S_k, r_k = jsp.gram_fused(jnp.asarray(LH), jnp.asarray(gL),
                                  jnp.asarray(cams), C, precision="bf16",
                                  interpret=True)
    S_k, r_k = np.asarray(S_k), np.asarray(r_k)
    if layout == "soa":
        args = tuple(torch.tensor(a) for a in (lh_s, gl_s, cam_s))
        gram = tsp.gram_soa
    else:
        args = tuple(torch.tensor(a) for a in (LH, gL, cams))
        gram = tsp.gram_aos
    S_t, r_t = gram(*args, C, "bf16")
    np.testing.assert_allclose(S_t.numpy(), S_k, rtol=0,
                               atol=1e-5 * np.abs(S_k).max())
    np.testing.assert_allclose(r_t.numpy(), r_k, rtol=0,
                               atol=1e-5 * np.abs(r_k).max())
    _, r_f32 = gram(*args, C)
    np.testing.assert_array_equal(r_t.numpy(), r_f32.numpy())
