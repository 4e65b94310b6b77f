"""The port's splined-model path against the JAX package, in float64 on
the CPU: the B-spline basis, window and projection, the splined
regularization, the spline-window normal equations (against both the JAX
window assembly and the JAX generic path), the Schur step with float32 H
under a float64 gradient, the lazy-Hessian loop, optimize(),
optimizer_callback and check_gradient; on small knot grids (order 3
Nx=9 Ny=7 and an order-2 grid) and 5 frames of an 8x6 board.

Every JAX reference is jitted (an eager JAX op costs a compile of its
own), and the problems and the one JAX solve are module fixtures."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrcal_tpu import lensmodels as jlm
from mrcal_tpu.optimize import residuals as jres
from mrcal_tpu.optimize import solver as jsolver
from mrcal_tpu.optimize.layout import spec_from_inputs as j_spec_from_inputs
from mrcal_tpu_torch import convert, lensmodels as tlm, problems as tproblems
from mrcal_tpu_torch import optimize as t_optimize
from mrcal_tpu_torch import optimizer_callback as t_optimizer_callback
from mrcal_tpu_torch.optimize import residuals as tres
from mrcal_tpu_torch.optimize import solver as tsolver

from test_torch_residuals import torch_threads  # noqa: F401

MODEL3 = "LENSMODEL_SPLINED_STEREOGRAPHIC_order=3_Nx=9_Ny=7_fov_x_deg=120"
MODEL2 = "LENSMODEL_SPLINED_STEREOGRAPHIC_order=2_Nx=8_Ny=6_fov_x_deg=100"
MODELS = [MODEL3, MODEL2]

j_project = jax.jit(jlm.project_core, static_argnums=2)
j_unproject = jax.jit(jlm.unproject_core, static_argnums=2)


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


def _intrinsics(model, rng, scale=2e-3):
    n = tlm.lensmodel_num_params(model)
    return np.concatenate([[420.0, 419.0, 399.5, 299.5],
                           rng.normal(size=n - 4) * scale])


def _points(rng, N=60):
    """Rays across the field of view, the first few far off the knot
    grid (extrapolated windows)."""
    v = np.concatenate([rng.normal(size=(N, 2)) * 0.6,
                        1.0 + rng.uniform(size=(N, 1))], axis=-1)
    v[0] = [5.0, 3.0, 0.2]
    v[1] = [-4.0, 6.0, 0.3]
    v[2] = [0.0, -9.0, 0.1]
    return v


def splined_oi(model=MODEL3, Ncameras=1, Nframes=5, W=8, H=6, seed=0,
               core=False):
    """A small splined board problem, as
    tests/test_splined_calibration.py builds its sparse-assembly case, with
    an outlier corner and a down-weighted one; Ncameras > 1 adds cameras
    with extrinsics."""
    rng = np.random.default_rng(seed)
    intr = np.stack([_intrinsics(model, rng) for _ in range(Ncameras)])
    intr[:, :2] += 10.0 * np.arange(Ncameras)[:, None]
    frames = np.concatenate(
        [rng.normal(size=(Nframes, 3)) * 0.3,
         np.array([[0.02, -0.03, 0.9]]) + rng.normal(size=(Nframes, 3)) * 0.1],
        axis=1)
    ext = np.array([[0.01 * i, -0.01 * i, 0.0, -0.1 * i, 0.0, 0.0]
                    for i in range(1, Ncameras)]).reshape(-1, 6)
    oi = dict(intrinsics=intr, extrinsics_rt_fromref=ext,
              frames_rt_toref=frames,
              observations_board=np.zeros((Nframes * Ncameras, H, W, 3)),
              indices_frame_camintrinsics_camextrinsics=np.array(
                  [[f, c, c - 1] for f in range(Nframes)
                   for c in range(Ncameras)], np.int32),
              lensmodel=model,
              imagersizes=np.tile([[800, 600]], (Ncameras, 1)),
              calobject_warp=np.array([0.002, -0.001]),
              calibration_object_spacing=0.08,
              do_optimize_intrinsics_core=core,
              do_apply_outlier_rejection=False)
    oi["observations_board"][..., 2] = 1.0
    np.random.seed(seed)
    tproblems.make_perfect_observations(oi, observed_pixel_uncertainty=0.3,
                                        device="cpu")
    oi["observations_board"][0, 0, 0, 2] = -1.0      # outlier
    oi["observations_board"][2, 3, 4, 2] = 0.5       # down-weighted
    return oi


class _Problem:
    """One problem in both packages: the JAX spec, arrays, packed state
    and static indices, the port's, and the JAX normal equations at b0
    (the window assembly and the generic path, each jitted once)."""

    def __init__(self, oi, window=True, generic=True):
        from mrcal_tpu.optimize.residuals import (arrays_from_inputs,
                                                  pack_params,
                                                  params_from_arrays)
        self.oi = oi
        self.spec = j_spec_from_inputs(**oi)
        self.arrays = arrays_from_inputs(**oi)
        self.b0 = np.asarray(pack_params(params_from_arrays(self.arrays),
                                         self.spec))
        self.static_idx = dict(board=np.asarray(self.arrays["indices_board"]),
                               point=np.asarray(self.arrays["indices_point"]))
        self.tspec, self.tarrays, self.tb0 = convert.from_reference(
            oi, self.b0, device="cpu")

        def ne(build):
            out = jax.jit(build(self.spec, self.arrays, self.static_idx))(
                jnp.asarray(self.b0), self.arrays)
            return {k: np.asarray(v) for k, v in out.items()}
        self.ne_generic = (ne(jsolver.build_normal_equations)
                           if generic else None)
        self.ne_window = (ne(jsolver.build_normal_equations_splined)
                          if window else None)

    def ne_port(self, **kw):
        return tsolver.build_normal_equations(
            self.tspec, self.tarrays, self.static_idx, **kw)


@pytest.fixture(scope="module")
def problems():
    return dict(one=_Problem(splined_oi()),
                two=_Problem(splined_oi(Ncameras=2, Nframes=3, seed=1),
                             generic=False),
                core=_Problem(splined_oi(Nframes=3, seed=2, core=True),
                              window=False))


# ----------------------------------------------------------------------------
# projection
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("model", MODELS)
def test_basis_window_and_deltau_match_jax(model):
    rng = np.random.default_rng(1)
    lm_t, lm_j = tlm.parse_lensmodel(model), jlm.parse_lensmodel(model)
    assert lm_t.segments_per_u == lm_j.segments_per_u
    for a, b in zip(tlm.knots_for_splined_models(model),
                    jlm.knots_for_splined_models(model)):
        _close(a.numpy(), b, 1e-12)
    t = np.linspace(-0.7, 1.7, 25)
    for name in ("_bspline_weights_cubic", "_bspline_weights_quadratic"):
        _close(getattr(tlm, name)(torch.as_tensor(t)).numpy(),
               getattr(jlm, name)(jnp.asarray(t)), 1e-12)

    v = _points(rng)
    u_j = jlm.stereographic_uv(jnp.asarray(v))
    u = torch.tensor(np.asarray(u_j))
    out_t = tlm.splined_window_index(u, lm_t)
    out_j = jax.jit(jlm.splined_window_index, static_argnums=1)(u_j, lm_j)
    for a, b in zip(out_t[:2], out_j[:2]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(out_t[2:], out_j[2:]):
        _close(a.numpy(), b, 1e-12)
    # the points off the grid keep an edge window and extrapolate
    t_all = np.concatenate([out_t[2].numpy(), out_t[3].numpy()])
    assert (t_all > 1.0).any() or (t_all < -0.5).any()

    intr = _intrinsics(model, rng, scale=0.05)
    coeffs = intr[4:].reshape(lm_t.Ny, lm_t.Nx, 2)
    j_deltau = jax.jit(jlm.splined_deltau, static_argnums=2)
    _close(tlm.splined_deltau(u, torch.as_tensor(coeffs), lm_t).numpy(),
           j_deltau(u_j, coeffs, lm_j), 1e-12)
    # one set of control points per point
    cb = coeffs[None] + rng.normal(size=(len(v),) + coeffs.shape) * 0.01
    _close(tlm.splined_deltau(u, torch.as_tensor(cb), lm_t).numpy(),
           j_deltau(u_j, cb, lm_j), 1e-12)


@pytest.mark.parametrize("model", MODELS)
def test_project_core_values_and_jacobians(model):
    rng = np.random.default_rng(2)
    v = _points(rng)
    intr = _intrinsics(model, rng, scale=0.05)
    q_t = tlm.project_core(torch.as_tensor(v), torch.as_tensor(intr), model)
    _close(q_t.numpy(), j_project(v, intr, model), 1e-12)
    # per-point intrinsics broadcast against the points
    ib = intr[None] + rng.normal(size=(len(v), len(intr))) * 1e-3
    _close(tlm.project_core(torch.as_tensor(v), torch.as_tensor(ib),
                            model).numpy(), j_project(v, ib, model), 1e-12)

    # one projection's Jacobian, off the grid and inside it
    Jj = jax.jit(jax.vmap(jax.jacrev(
        lambda vv, ii: jlm.project_core(vv, ii, model), argnums=(0, 1)),
        in_axes=(0, None)))(v[[0, 7]], intr)
    for i, vi in enumerate(v[[0, 7]]):
        Jt = torch.autograd.functional.jacobian(
            lambda vv, ii: tlm.project_core(vv, ii, model),
            (torch.as_tensor(vi), torch.as_tensor(intr)))
        for a, b in zip(Jt, Jj):
            _close(a.numpy(), b[i], 1e-12)


@pytest.mark.parametrize("model", MODELS)
def test_unproject_core_matches_jax(model):
    rng = np.random.default_rng(3)
    intr = _intrinsics(model, rng, scale=0.02)
    v = _points(rng)[3:]
    q = np.asarray(j_project(v, intr, model))
    v_t = tlm.unproject_core(torch.as_tensor(q), torch.as_tensor(intr), model)
    _close(v_t.numpy(), j_unproject(q, intr, model), 1e-10)
    # and it inverts the projection
    _close(tlm.project_core(v_t, torch.as_tensor(intr), model).numpy(), q,
           1e-9)


def test_splined_regularization_matches_jax(problems):
    for which in ("one", "two"):
        p = problems[which]
        rng = np.random.default_rng(4)
        intr = p.oi["intrinsics"] + rng.normal(
            size=p.oi["intrinsics"].shape) * 0.01
        params_j = dict(jres.params_from_arrays(p.arrays),
                        intrinsics=jnp.asarray(intr))
        params_t = dict(tres.params_from_arrays(p.tarrays),
                        intrinsics=torch.as_tensor(intr))
        x_t = tres.residuals_regularization(params_t, p.tarrays, p.tspec)
        x_j = jax.jit(lambda pj: jres.residuals_regularization(
            pj, p.arrays, p.spec))(params_j)
        assert x_t.shape == (p.tspec.num_measurements_regularization,)
        _close(x_t.numpy(), x_j, 1e-12)


def test_bench_shape_has_one_regularization_row_per_knot_component():
    """splined_30x18: the core is locked, so no center-pixel rows."""
    spec = tsolver.spec_from_inputs(**tproblems.splined_30x18())
    assert spec.num_measurements_regularization == 1080
    assert spec.num_measurements_boards == 32928


# ----------------------------------------------------------------------------
# normal equations
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("which,reference", [
    ("one", "window"), ("one", "generic"), ("two", "window")])
def test_window_normal_equations_match_jax(problems, which, reference):
    p = problems[which]
    assert tsolver._splined_fast_path_ok(p.tspec)
    ne_j = p.ne_window if reference == "window" else p.ne_generic
    ne = p.ne_port()(p.tb0, p.tarrays)
    assert set(ne) == set(ne_j)
    for k, v in ne.items():
        _close(v.numpy(), ne_j[k], 1e-10)


def test_generic_path_of_a_core_optimized_splined_problem(problems):
    p = problems["core"]
    assert not tsolver._splined_fast_path_ok(p.tspec)
    ne = p.ne_port()(p.tb0, p.tarrays)
    for k, v in ne.items():
        _close(v.numpy(), p.ne_generic[k], 1e-10)


@pytest.mark.parametrize("which", ["one", "two"])
def test_gradient_only_and_h32_evaluations(problems, which):
    """The lazy-Hessian mode's evaluation (one backward pass, no H) gives
    the full one's E, gradient and residuals; the float32-H assembly keeps
    the float64 gradient exactly and its H and C agree with float64's to
    float32's precision."""
    p = problems[which]
    full = p.ne_port()(p.tb0, p.tarrays)
    grad = p.ne_port().gradient(p.tb0, p.tarrays)
    h32 = p.ne_port(h32=True)(p.tb0, p.tarrays)
    assert "Hcc" not in grad
    for k in tsolver._LAZY_H_GRAD_KEYS:
        _close(grad[k].numpy(), full[k].numpy(), 1e-12)
        assert torch.equal(h32[k], full[k]), k
    for k in ("Hcc", "Hff", "Cf"):
        assert h32[k].dtype == torch.float32
        _close(h32[k].double().numpy(), full[k].numpy(), 1e-6)
    # the one-reverse-pass gradient of the other paths gives the same
    g1 = tsolver._make_grad_fn(p.tspec)(p.tb0, p.tarrays)
    for k in tsolver._LAZY_H_GRAD_KEYS:
        _close(g1[k].numpy(), full[k].numpy(), 1e-10)


def test_h32_applies_to_the_window_assembly_only(problems):
    with pytest.raises(ValueError, match="h32"):
        problems["core"].ne_port(h32=True)


@pytest.mark.parametrize("which", ["one", "two"])
def test_schur_step_with_f32_h_matches_jax(problems, which):
    """At lambda = 1: at 1e-4, the float32 Hcc's roundoff (its condition
    is ~5e10) puts either package's float32 step ~1e-4 from the float64
    one, and so from each other."""
    p = problems[which]
    ne = {k: (v.astype(np.float32) if k[0] in "HC" else v)
          for k, v in p.ne_window.items()}
    out_j = jax.jit(partial(jsolver.schur_step, spec=p.spec))(
        {k: jnp.asarray(v) for k, v in ne.items()}, 1.0)
    out_t = tsolver.schur_step({k: torch.as_tensor(v) for k, v in ne.items()},
                               1.0, p.tspec)
    for a, b in zip(out_t, out_j):
        assert a.dtype == torch.float64
        _close(a.numpy(), b, 1e-6)


# ----------------------------------------------------------------------------
# solves and entry points
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_solve(problems):
    """The JAX device loop's converged E with the lazy Hessian, K = 4, set
    before its solver is built.  It stops at the same optimum as the eager
    loop (E within 1e-13 relative on this problem), so it is also the f64
    reference: one JAX solve compiled instead of two."""
    p = problems["one"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MRCAL_TPU_LAZY_H", "4")
        jsolver._DEVICE_SOLVER_CACHE.clear()
        _, E, niter, _ = jsolver.lm_solve_device(p.spec, p.arrays,
                                                 jnp.asarray(p.b0))
    jsolver._DEVICE_SOLVER_CACHE.clear()
    return float(E), int(niter)


def _rms(p, E):
    return np.sqrt(float(E) / p.tspec.Nmeasurements)


def test_lazy_h_solve_matches_jax(problems, jax_solve):
    """lm_solve(lazy_K=4) against the JAX loop with the same refresh
    interval: the same converged rms."""
    p = problems["one"]
    E_j, n_j = jax_solve
    _, E_t, n_t, _ = tsolver.lm_solve(p.tspec, p.tarrays, p.tb0,
                                      p.static_idx, lazy_K=4)
    assert abs(_rms(p, E_t) - _rms(p, E_j)) <= 1e-10 * _rms(p, E_j)
    assert n_t > 16 and n_j > 16


def test_lazy_h_default_is_off_on_the_cpu(problems):
    spec = problems["one"].tspec
    assert tsolver._lazy_h_K(spec, torch.float32, "cpu") == 0
    assert tsolver._lazy_h_K(spec, torch.float32, "cuda") == 4
    assert tsolver._lazy_h_K(spec, torch.float64, "cuda") == 0


def test_optimize_f64_matches_jax(problems, jax_solve):
    p = problems["one"]
    rms_j = _rms(p, jax_solve[0])
    oi_t = _copy(p.oi)
    stats_t = t_optimize(device="cpu", precision="f64", **oi_t)
    assert abs(stats_t["rms_reproj_error__pixels"] - rms_j) <= 1e-10 * rms_j
    assert stats_t["x"].shape == (p.tspec.Nmeasurements,)
    # the caller's intrinsics carry the solution; the core stayed put
    assert np.array_equal(oi_t["intrinsics"][:, :4], p.oi["intrinsics"][:, :4])
    assert np.allclose(oi_t["intrinsics"][0, 4:],
                       stats_t["b_packed"][:p.tspec.num_states_intrinsics],
                       rtol=0, atol=1e-15)


@pytest.mark.parametrize("h32", [False, True])
def test_mixed_optimize_and_h32_polish_reach_the_f64_optimum(problems,
                                                             jax_solve, h32):
    p = problems["one"]
    rms_j = _rms(p, jax_solve[0])
    if not h32:
        stats = t_optimize(device="cpu", precision="mixed", **_copy(p.oi))
        assert stats["niterations_polish"] > 0
        assert abs(stats["rms_reproj_error__pixels"] - rms_j) <= 1e-6 * rms_j
    else:
        _, E, _, ne = tsolver.lm_solve(p.tspec, p.tarrays, p.tb0,
                                       p.static_idx, h32=True)
        assert ne["Hcc"].dtype == torch.float32 and E.dtype == torch.float64
        assert abs(_rms(p, E) - rms_j) <= 1e-6 * rms_j


@pytest.fixture(scope="module")
def jax_jacobian(problems):
    """The JAX residual function (jitted) and its dense Jacobian at b0."""
    p = problems["one"]
    resid = jax.jit(lambda bb: jres.residuals_from_packed(bb, p.arrays,
                                                          p.spec))
    J = np.asarray(jax.jit(jax.jacfwd(
        lambda bb: jres.residuals_from_packed(bb, p.arrays, p.spec)))(
            jnp.asarray(p.b0)))
    return resid, J


def test_optimizer_callback_matches_jax(problems, jax_jacobian):
    """Values against the JAX Jacobian, and the JAX package's sparse
    structure: a board row stores its spline window (both surfaces of
    every knot of it), its frame and the warp; a regularization row its
    nonzero entries."""
    p = problems["one"]
    resid, J_j = jax_jacobian
    b_t, x_t, J_t = t_optimizer_callback(device="cpu", **_copy(p.oi))
    _close(b_t, p.b0, 1e-12)
    _close(x_t, resid(jnp.asarray(p.b0)), 1e-12)
    assert J_t.shape == J_j.shape
    _close(J_t.toarray(), J_j, 1e-12)
    stored = J_t.copy()
    stored.data[:] = 1.0
    stored = stored.toarray() > 0
    assert not (J_j[~stored] != 0).any()
    spec = p.tspec
    R = spec.lensmodel.order + 1
    nb = spec.num_measurements_boards
    i_f0 = spec.state_index_frames0
    for row in range(nb):
        cols = J_t.indices[J_t.indptr[row]:J_t.indptr[row + 1]]
        win = cols[cols < spec.num_states_intrinsics]
        assert len(cols) == 2 * R * R + 6 + 2
        assert np.array_equal(win[::2] + 1, win[1::2])
        iframe = p.oi["indices_frame_camintrinsics_camextrinsics"][
            row // (2 * spec.calibration_object_width_n
                    * spec.calibration_object_height_n), 0]
        assert np.array_equal(cols[len(win):len(win) + 6],
                              i_f0 + 6 * iframe + np.arange(6))
    assert np.array_equal(np.diff(J_t.indptr)[nb:],
                          (J_j[nb:] != 0).sum(axis=1))


def test_check_gradient_matches_jax(problems, jax_jacobian):
    """The port's report against the same check of the JAX Jacobian:
    central differences of the JAX residuals on every state column."""
    from mrcal_tpu_torch.optimize.jacobian import FD_STEP
    p = problems["one"]
    resid, J_j = jax_jacobian
    s_t = t_optimize(device="cpu", check_gradient=True, **_copy(p.oi))
    assert s_t["ncols_checked"] == p.tspec.Nstate
    worst = 0.0
    for j in range(p.tspec.Nstate):
        db = np.zeros_like(p.b0)
        db[j] = FD_STEP
        dnum = np.asarray(resid(jnp.asarray(p.b0 + db))
                          - resid(jnp.asarray(p.b0 - db))) / (2 * FD_STEP)
        worst = max(worst, np.abs(dnum - J_j[:, j]).max()
                    / (1.0 + np.abs(dnum).max()))
    assert s_t["worst_relative_error"] < 1e-6
    assert abs(s_t["worst_relative_error"] - worst) <= 1e-9


def test_splined_30x18_is_the_bench_configuration():
    """problems.splined_30x18() builds the bench's inputs, array for
    array; no solve."""
    import bench
    oi = tproblems.splined_30x18()
    ref = dict(bench._CONFIG_THUNKS)["splined_30x18"]()["oi"]
    assert set(oi) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(np.asarray(oi[k]), v), k
        else:
            assert oi[k] == v, k
    spec = tsolver.spec_from_inputs(**oi)
    assert (spec.Nmeasurements, spec.Nstate) == (34008, 1586)
    assert tsolver._splined_fast_path_ok(spec)
