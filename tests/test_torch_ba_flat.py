"""Port parity: the flat BA solver, the mapper's BA routing, and the
memory-bounded synthetic model.

The flat implicit-Schur ``bundle_adjust`` is held against the reference's
as ``tests/test_torch_ba_soa.py`` holds the SoA solver (float64): one LM
step to float64 rounding, 12 steps to the same iteration count and final
cost to rtol 1e-6.  ``choose_ba_route`` is held against a truth table
read off the reference mapper (``incremental_mapper.py:980-993``, with
``ba_dense.py:235-244`` for the dense solver's Schur mode).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from privacy_preserving_sfm_tpu.optim import ba as jba
from privacy_preserving_sfm_torch.optim import ba as tba
from privacy_preserving_sfm_torch.optim import convert
from privacy_preserving_sfm_torch.sfm.incremental_mapper import (
    choose_ba_route,
)
from privacy_preserving_sfm_torch.utils import synthetic

from test_torch_ba_soa import MODEL, _make_fields

torch.set_num_threads(2)


def _both(fields, **kw):
    jflat = jba.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()})
    jopts = jba.BAOptions(**kw)
    j = jax.jit(lambda p: jba.bundle_adjust(p, MODEL, jopts))(jflat)
    t = tba.bundle_adjust(
        convert.ba_problem_from_numpy(fields, "cpu", torch.float64), MODEL,
        tba.BAOptions(**kw))
    return j, t


@pytest.mark.parametrize("loss", ["trivial", "cauchy"])
def test_one_lm_step_matches_reference(loss):
    fields = _make_fields(np.random.default_rng(3))
    (qj, tj, Xj, sj), (qt, tt, Xt, st) = _both(
        fields, max_iterations=1, cg_iterations=20, loss=loss,
        function_tolerance=0.0)
    assert st.num_iterations == int(sj.num_iterations) == 1
    np.testing.assert_allclose(st.initial_cost, float(sj.initial_cost),
                               rtol=1e-9)
    np.testing.assert_allclose(st.final_cost, float(sj.final_cost),
                               rtol=1e-9)
    assert st.final_cost < st.initial_cost
    for a, b in ((qt, qj), (tt, tj), (Xt, Xj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-8)


@pytest.mark.parametrize("loss", ["trivial", "cauchy"])
def test_twelve_lm_steps_match_reference(loss):
    fields = _make_fields(np.random.default_rng(8), meas_noise=1e-3)
    (_, _, _, sj), (_, _, _, st) = _both(
        fields, max_iterations=12, cg_iterations=20, loss=loss)
    assert st.num_iterations == int(sj.num_iterations)
    np.testing.assert_allclose(st.final_cost, float(sj.final_cost),
                               rtol=1e-6)
    np.testing.assert_allclose(st.lam, float(sj.lam), rtol=1e-6)
    assert st.final_cost < 0.5 * st.initial_cost


def test_gradient_tolerance_stop_matches_reference():
    fields = _make_fields(np.random.default_rng(9), meas_noise=1e-3)
    (_, _, _, sj), (_, _, _, st) = _both(
        fields, max_iterations=30, gradient_tolerance=1.0)
    assert st.num_iterations == int(sj.num_iterations) < 30
    np.testing.assert_allclose(st.final_cost, float(sj.final_cost),
                               rtol=1e-6)


def test_flat_respects_weights_and_gauge():
    """Weight-0 observations add nothing; the held camera stays put."""
    fields = _make_fields(np.random.default_rng(5))
    problem = convert.ba_problem_from_numpy(fields, "cpu", torch.float64)
    opts = tba.BAOptions(max_iterations=5)
    q, t, X, s = tba.bundle_adjust(problem, MODEL, opts)
    assert s.final_cost < s.initial_cost
    np.testing.assert_allclose(t[0].numpy(), fields["tvecs"][0], atol=1e-12)
    np.testing.assert_allclose(float(t[1, 0]), fields["tvecs"][1, 0],
                               atol=1e-12)
    # One extra observation of weight 0 with a wild line changes nothing.
    extra = {k: np.asarray(v) for k, v in fields.items()}
    for k, v in (("obs_cam", 2), ("obs_point", 0), ("obs_weight", 0.0)):
        extra[k] = np.append(extra[k], v)
    extra["obs_line"] = np.vstack([extra["obs_line"], [[0.6, 0.8, 50.0]]])
    q2, t2, X2, s2 = tba.bundle_adjust(
        convert.ba_problem_from_numpy(extra, "cpu", torch.float64), MODEL,
        opts)
    assert s2.num_iterations == s.num_iterations
    np.testing.assert_allclose(s2.final_cost, s.final_cost, rtol=1e-12)
    np.testing.assert_allclose(X2.numpy(), X.numpy(), rtol=0, atol=1e-12)


# device, C, PPSFM_BA_PATH, PPSFM_SCHUR_MODE ("-" = unset) -> route, read
# off incremental_mapper.py:980-993 and ba_dense.py:235-244 of the
# reference with "on an accelerator" = a CUDA device.
ROUTES = """
cpu  100  -     -        flat
cpu  1100 -     -        flat
cpu  100  -     explicit flat
cpu  100  -     implicit flat
cuda 100  -     -        soa
cuda 100  -     auto     soa
cuda 100  -     explicit soa
cuda 100  -     implicit dense-implicit
cuda 1100 -     -        dense-implicit
cuda 1100 -     auto     dense-implicit
cuda 1100 -     explicit dense-explicit
cuda 1100 -     implicit dense-implicit
cpu  100  soa   -        soa
cpu  1100 soa   implicit soa
cuda 100  soa   implicit soa
cuda 1100 soa   -        soa
cpu  100  dense -        dense-implicit
cpu  100  dense auto     dense-implicit
cpu  100  dense explicit dense-explicit
cpu  1100 dense explicit dense-explicit
cuda 100  dense -        dense-explicit
cuda 100  dense implicit dense-implicit
cuda 1100 dense -        dense-implicit
cuda 1100 dense explicit dense-explicit
cpu  100  flat  -        flat
cpu  100  flat  explicit flat
cuda 100  flat  -        flat
cuda 100  flat  explicit flat
cuda 1100 flat  -        flat
"""


@pytest.mark.parametrize("row", ROUTES.strip().splitlines())
def test_route_matches_reference_truth_table(row):
    device, C, path, mode, expect = row.split()
    route = choose_ba_route(device, int(C), "auto",
                            "" if path == "-" else path,
                            "" if mode == "-" else mode)
    got = route.solver
    if route.solver == "dense":
        got += "-explicit" if route.explicit else "-implicit"
    assert got == expect


def test_route_reads_the_options_schur_mode():
    """Without the override, BAOptions.schur_mode steers the route."""
    assert choose_ba_route("cuda", 100, "implicit") == ("dense", False)
    assert choose_ba_route("cuda", 1100, "explicit") == ("dense", True)
    assert choose_ba_route("cuda", 100, "implicit", "", "auto").solver \
        == "soa"


def test_synthetic_model_is_the_same_in_blocks(tmp_path, monkeypatch):
    """Visibility in blocks of candidates draws the same numbers as in one
    block (the whole candidate set at once): the written model is
    byte-identical."""
    texts = []
    for block in (1 << 30, synthetic.VIS_BLOCK, 37):
        monkeypatch.setattr(synthetic, "VIS_BLOCK", block)
        out = tmp_path / str(block)
        synthetic.synthetic_model(8, 200, 4, seed=0,
                                  meas_noise=1e-3).write_text(str(out))
        texts.append({f.name: f.read_bytes() for f in out.iterdir()})
    assert texts[0] == texts[1] == texts[2]
    assert sorted(texts[0]) == ["cameras.txt", "images.txt", "points3D.txt"]
