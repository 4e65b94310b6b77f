"""The port's normal equations, Schur step, LM step and optimize() against
the JAX package on __graft_entry__._make_problem()'s problem and on a
small discrete-point problem, in float64 on the CPU."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mrcal_tpu
from mrcal_tpu.optimize import solver as jsolver
from mrcal_tpu_torch import convert, problems as tproblems
from mrcal_tpu_torch import optimize as t_optimize
from mrcal_tpu_torch.optimize import solver as tsolver

from test_torch_residuals import point_problem_oi


def _copy(oi):
    return {k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in oi.items()}


def _close(a, b, tol):
    """|a - b| <= tol * max(1, max|b|)."""
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if b.size:
        scale = max(1.0, float(np.abs(b).max()))
        assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max()


class _Problem:
    def __init__(self, oi):
        from mrcal_tpu.optimize.layout import spec_from_inputs
        from mrcal_tpu.optimize.residuals import (arrays_from_inputs,
                                                  pack_params,
                                                  params_from_arrays)
        self.oi = oi
        self.spec = spec_from_inputs(**oi)
        self.arrays = arrays_from_inputs(**oi)
        self.b0 = np.asarray(pack_params(params_from_arrays(self.arrays),
                                         self.spec))
        self.static_idx = dict(board=np.asarray(self.arrays["indices_board"]),
                               point=np.asarray(self.arrays["indices_point"]))
        self.tspec, self.tarrays, self.tb0 = convert.from_reference(
            oi, self.b0, device="cpu")
        ne = jax.jit(jsolver.build_normal_equations(
            self.spec, self.arrays, self.static_idx))(jnp.asarray(self.b0),
                                                      self.arrays)
        self.ne_jax = {k: np.asarray(v) for k, v in ne.items()}


@pytest.fixture(scope="module")
def problems():
    # the port's builder gives __graft_entry__._make_problem()'s inputs
    # (test_torch_residuals.py holds it to them) without JAX's eager cost
    return dict(board=_Problem(tproblems.make_problem(device="cpu")[0]),
                point=_Problem(point_problem_oi()))


@pytest.mark.parametrize("which", ["board", "point"])
def test_normal_equations_match_jax(problems, which):
    p = problems[which]
    ne = tsolver.build_normal_equations(p.tspec, p.tarrays, p.static_idx)(
        p.tb0, p.tarrays)
    assert set(ne) == set(p.ne_jax)
    for k, v in ne.items():
        _close(v.numpy(), p.ne_jax[k], 1e-10)


@pytest.mark.parametrize("which", ["board", "point"])
def test_schur_step_matches_jax(problems, which):
    p = problems[which]
    ne_t = {k: torch.tensor(v) for k, v in p.ne_jax.items()}
    out_j = jax.jit(partial(jsolver.schur_step, spec=p.spec))(
        {k: jnp.asarray(v) for k, v in p.ne_jax.items()}, 1e-4)
    out_t = tsolver.schur_step(ne_t, 1e-4, p.tspec)
    for a, b in zip(out_t, out_j):
        _close(a.numpy(), b, 1e-9)


def test_schur_step_matches_jax_past_a_warp_of_columns():
    """On a 4-camera problem the frame blocks are solved against the
    Nc = 68 columns of the coupling block and the gradient in one launch,
    more columns than a warp has lanes.  Both Schur steps take the port's
    normal equations."""
    from mrcal_tpu.optimize.layout import spec_from_inputs
    oi, tspec, tarrays, tb0 = tproblems.make_problem(Ncameras=4,
                                                     device="cpu")
    static_idx = dict(board=oi["indices_frame_camintrinsics_camextrinsics"],
                      point=np.zeros((0, 3), np.int64))
    ne = tsolver.build_normal_equations(tspec, tarrays, static_idx)(
        tb0, tarrays)
    assert ne["Cf"].shape[-1] == 68
    out_j = jax.jit(partial(jsolver.schur_step,
                            spec=spec_from_inputs(**oi)))(
        {k: jnp.asarray(v.numpy()) for k, v in ne.items()}, 1e-4)
    out_t = tsolver.schur_step(ne, 1e-4, tspec)
    for a, b in zip(out_t, out_j):
        _close(a.numpy(), b, 1e-10)


def test_block_eliminate_splits_coupling_and_gradient():
    """The Schur step's one fused solve per block type gives the factor,
    A^-1 C and A^-1 g, as numpy's solves do."""
    rng = np.random.default_rng(3)
    M = rng.normal(size=(7, 6, 6))
    A = np.einsum("bij,bkj->bik", M, M) + 6 * np.eye(6)
    C, g = rng.normal(size=(7, 6, 5)), rng.normal(size=(7, 6))
    L, AinvC, Ainvg = tsolver._block_eliminate(
        torch.as_tensor(A), torch.as_tensor(C), torch.as_tensor(g))
    _close(L.numpy(), np.linalg.cholesky(A), 1e-12)
    _close(AinvC.numpy(), np.linalg.solve(A, C), 1e-12)
    _close(Ainvg.numpy(), np.linalg.solve(A, g[..., None])[..., 0], 1e-12)


def test_rig16cam_is_the_bench_configuration():
    """problems.rig16cam() has the bench's board poses and shape."""
    import bench
    oi = tproblems.rig16cam()
    spec = tsolver.spec_from_inputs(**oi)
    assert (spec.Nmeasurements, spec.Nstate) == (251040, 524)
    assert np.array_equal(oi["frames_rt_toref"], bench._rig16_frames(40))
    assert oi["do_apply_outlier_rejection"] is False


def test_one_lm_step_matches_entry(problems):
    """One LM step as __graft_entry__.entry() takes it: normal equations
    at b0, schur_step at lambda=1e-4, b0 + _delta_to_b."""
    p = problems["board"]
    step_j = jax.jit(partial(jsolver.schur_step, spec=p.spec))(
        {k: jnp.asarray(v) for k, v in p.ne_jax.items()}, 1e-4)
    b1_j = p.b0 + np.asarray(jsolver._delta_to_b(*step_j[:3], p.spec))

    ne = tsolver.build_normal_equations(p.tspec, p.tarrays, p.static_idx)(
        p.tb0, p.tarrays)
    dc, df, dp, _ = tsolver.schur_step(ne, 1e-4, p.tspec)
    b1_t = p.tb0 + tsolver._delta_to_b(dc, df, dp, p.tspec)
    _close(ne["E"].numpy(), p.ne_jax["E"], 1e-10)
    _close(b1_t.numpy(), b1_j, 1e-10)


@pytest.fixture(scope="module")
def f64_solves(problems):
    p = problems["board"]
    stats_j = mrcal_tpu.optimize(precision="f64", **_copy(p.oi))
    oi_t = _copy(p.oi)
    stats_t = t_optimize(device="cpu", **oi_t)
    return p, stats_j, stats_t, oi_t


def test_lm_trajectory_matches_jax(problems):
    """Ten iterations of the device-resident JAX loop and of the port's
    loop, from the same state: same accepts, same steps."""
    p = problems["board"]
    b_j, E_j, n_j, _ = jsolver.lm_solve_device(
        p.spec, p.arrays, jnp.asarray(p.b0), max_iterations=10)
    b_t, E_t, n_t, _ = tsolver.lm_solve(p.tspec, p.tarrays, p.tb0,
                                        p.static_idx, max_iterations=10)
    assert n_t == n_j == 10
    assert abs(float(E_t) - float(E_j)) <= 1e-12 * float(E_j)
    assert np.abs(b_t.numpy() - np.asarray(b_j)).max() < 1e-8


def test_optimize_f64_matches_jax(f64_solves):
    """Converged rms to 1e-10.  The last iterations of either solver run
    at roundoff: E agrees to ~1e-14 relative, and accept and stop
    decisions there follow the summation order.  Steps of up to ~1e-6
    (packed units) are still accepted in that regime, so the iteration
    counts may differ, and the final state is held to 1e-5 and the
    residuals to 1e-3 px, where the trajectory test holds b to 1e-8."""
    p, stats_j, stats_t, oi_t = f64_solves
    rms_j = stats_j["rms_reproj_error__pixels"]
    rms_t = stats_t["rms_reproj_error__pixels"]
    assert abs(rms_t - rms_j) <= 1e-10 * rms_j
    assert np.abs(stats_t["b_packed"] - stats_j["b_packed"]).max() < 1e-5
    assert stats_t["niterations"] >= 10
    assert stats_t["Noutliers"] == stats_j["Noutliers"]
    _close(stats_t["x"], stats_j["x"], 1e-3)
    # the caller's arrays carry the solution
    spec = p.tspec
    i0 = spec.state_index_frames0
    frames = (stats_t["b_packed"] * spec.scales())[
        i0:i0 + spec.num_states_frames]
    assert np.allclose(oi_t["frames_rt_toref"].ravel(), frames, rtol=0,
                       atol=1e-12)
    assert set(stats_t) >= {"rms_reproj_error__pixels", "Noutliers",
                            "Noutliers_board", "niterations",
                            "niterations_polish", "time_s", "b_packed", "x"}


@pytest.mark.parametrize("precision", ["f32", "mixed"])
def test_optimize_f32_and_mixed_reach_the_f64_optimum(f64_solves, precision):
    p, stats_j, _, _ = f64_solves
    stats = t_optimize(device="cpu", precision=precision, **_copy(p.oi))
    rms_j = stats_j["rms_reproj_error__pixels"]
    assert abs(stats["rms_reproj_error__pixels"] - rms_j) <= 1e-4 * rms_j
    if precision == "mixed":
        assert stats["niterations_polish"] > 0


def test_optimize_without_device_needs_a_card(problems):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_optimize(**_copy(problems["board"].oi))


@pytest.mark.parametrize("option", [
    dict(lensmodel="LENSMODEL_CAHVORE_linearity=0.00"),
    dict(verbose=True),
    dict(lensmodel="LENSMODEL_CAHVOR")])
def test_optimize_raises_on_what_the_slice_does_not_cover(problems, option):
    oi = _copy(problems["board"].oi)
    if "lensmodel" in option:
        oi["intrinsics"] = np.zeros((2, 9))
    oi.update(option)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_optimize(device="cpu", **oi)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsolver.optimize_batch([oi])
