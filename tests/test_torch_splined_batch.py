"""The port's batched spline-window assembly against the JAX package, in
float64 on the CPU: the normal equations of P splined problems (core
locked, boards only) with a problem axis against jax.vmap of the JAX
package's build_normal_equations_splined, each problem's slice against
the port's own single-problem assembly, the gradient-only and float32-H
modes per problem, lm_solve_batch's lazy Hessian against lm_solve's, and
optimize_batch against each unit's own optimize().

The problems are tests/test_torch_splined.py's small splined board
(order 3, 9 x 7 knots, 5 frames of an 8 x 6 board, with an outlier and a
down-weighted corner), perturbed per problem from a numpy seed; the JAX
normal equations are jitted once, in a module fixture."""

from functools import cached_property

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrcal_tpu.optimize import residuals as jres
from mrcal_tpu.optimize import solver as jsolver
from mrcal_tpu.optimize.layout import spec_from_inputs as j_spec_from_inputs
from mrcal_tpu_torch import optimize as t_optimize
from mrcal_tpu_torch import optimize_batch as t_optimize_batch
from mrcal_tpu_torch import problems as tproblems
from mrcal_tpu_torch.optimize import residuals as tres
from mrcal_tpu_torch.optimize import solver as tsolver

from test_torch_splined import MODEL3, splined_oi

from test_torch_residuals import torch_threads  # noqa: F401

# the batch's units: P problems of one structure
P = 3
NE_KEYS = ("E", "g_c", "g_f", "Hcc", "Hff", "Cf")


def _copy(oi):
    return {k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in oi.items()}


def _close(a, b, tol):
    """|a - b| <= tol * max|b| (the largest entry's scale)."""
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if b.size:
        scale = max(float(np.abs(b).max()), 1e-300)
        assert np.abs(a - b).max() <= tol * scale, \
            (np.abs(a - b).max(), scale)


def _units(P=P, Ncameras=1):
    """Unit 0 is the small splined board; unit i >= 1 its perturbed_oi
    with seed 1 + i and 0.2 px of board noise, as a fleet's units."""
    base = splined_oi(Ncameras=Ncameras)
    units = []
    for i in range(P):
        oi = tproblems.perturbed_oi(base, seed=1 + i) if i else _copy(base)
        if i:
            obs = oi["observations_board"]
            obs[..., :2] += np.random.default_rng(1000 + i).normal(
                0.0, 0.2, obs[..., :2].shape)
        units.append(oi)
    return units


class _Batch:
    """The units in both packages: the JAX stacked arrays and packed
    states, the port's, and the JAX spline-window normal equations of the
    batch (jax.vmap of build_normal_equations_splined)."""

    def __init__(self, ois):
        self.ois = ois
        self.spec = j_spec_from_inputs(**ois[0])
        arrays = [jres.arrays_from_inputs(**oi) for oi in ois]
        self.arrays = {k: (jnp.stack([a[k] for a in arrays])
                           if jnp.issubdtype(v.dtype, jnp.floating) else v)
                       for k, v in arrays[0].items()}
        self.b0 = np.stack([np.asarray(jres.pack_params(
            jres.params_from_arrays(a), self.spec)) for a in arrays])
        self.static_idx = tsolver._static_idx(ois[0])
        self.tspec = tsolver.spec_from_inputs(**ois[0])
        self.tarrays = tsolver._stack_arrays(
            [tres.arrays_from_inputs(oi, device="cpu") for oi in ois])
        self.tb0 = tres.pack_params(tres.params_from_arrays(self.tarrays),
                                    self.tspec)

    @cached_property
    def ne(self):
        f = jsolver.build_normal_equations_splined(self.spec, None,
                                                   self.static_idx)
        ne = jax.jit(jax.vmap(f, in_axes=(0, jsolver._float_axes(
            self.arrays))))(jnp.asarray(self.b0), self.arrays)
        return {k: np.asarray(v) for k, v in ne.items()}

    def port_ne(self, **kw):
        return tsolver.build_normal_equations(self.tspec, self.tarrays,
                                              self.static_idx, **kw)


@pytest.fixture(scope="module")
def batch():
    return _Batch(_units())


@pytest.fixture(scope="module")
def batch_2cam():
    """Two cameras: a camera with extrinsics, so the extrinsics columns of
    the rows and the per-camera knot gradient are exercised."""
    return _Batch(_units(P=2, Ncameras=2))


@pytest.fixture(scope="module")
def batch_2cam_unity():
    """batch_2cam with unity_cam01, which the JAX package's window
    assembly leaves out (its generic path has it): held to the port's
    single-problem assembly only."""
    units = _units(P=2, Ncameras=2)
    for oi in units:
        oi["do_apply_regularization_unity_cam01"] = True
    return _Batch(units)


@pytest.mark.parametrize("which", ["batch", "batch_2cam"])
def test_splined_ne_batch_match_jax_vmap(request, which):
    """E, g, Hcc, Hff and Cf with their problem axis against jax.vmap of
    the JAX package's window assembly, within 1e-10 of each leaf's
    largest entry; every problem's assembly takes the window path."""
    bt = request.getfixturevalue(which)
    assert tsolver._splined_fast_path_ok(bt.tspec)
    assert torch.equal(bt.tb0, torch.as_tensor(bt.b0))
    with torch.no_grad():
        ne = bt.port_ne()(bt.tb0, bt.tarrays)
    Nf = bt.tspec.Nframes
    want = dict(bt.ne)
    for k in NE_KEYS:
        got = ne[k].numpy()
        if k in ("g_f", "Hff", "Cf"):
            got = got[:, :Nf]
            want[k] = want[k][:, :Nf]
        assert got.shape[0] == len(bt.ois)
        _close(got, want[k], 1e-10)


@pytest.mark.parametrize("which", ["batch", "batch_2cam",
                                   "batch_2cam_unity"])
def test_splined_ne_batch_slices_equal_single(request, which):
    """Each problem's slice of the batched assembly equals the
    single-problem assembly of that problem alone, every leaf the solver
    reads, to 1e-12 of its largest entry."""
    bt = request.getfixturevalue(which)
    with torch.no_grad():
        ne = bt.port_ne()(bt.tb0, bt.tarrays)
        for i, oi in enumerate(bt.ois):
            arrays = tres.arrays_from_inputs(oi, device="cpu")
            one = tsolver.build_normal_equations(
                bt.tspec, arrays, bt.static_idx)(bt.tb0[i], arrays)
            for k in tsolver._STEP_KEYS + ("E", "x_board", "x_reg"):
                _close(ne[k][i].numpy(), one[k].numpy(), 1e-12)


def test_splined_ne_batch_of_one_equals_single(batch):
    """A batch of one equals the single-problem call of the same problem
    to 1e-12."""
    f = batch.port_ne()
    with torch.no_grad():
        arrays1 = {k: (v[:1] if v.is_floating_point() else v)
                   for k, v in batch.tarrays.items()}
        one_b = f(batch.tb0[:1], arrays1)
        arrays = tres.arrays_from_inputs(batch.ois[0], device="cpu")
        one = f(batch.tb0[0], arrays)
    for k in tsolver._STEP_KEYS + ("E", "x_board", "x_reg"):
        _close(one_b[k][0].numpy(), one[k].numpy(), 1e-12)


@pytest.mark.parametrize("mode", ["gradient", "h32"])
def test_splined_ne_batch_modes_per_problem(batch, mode):
    """The gradient-only mode gives each problem the full assembly's E,
    gradient and residuals (1e-12); h32 gives float32 H and C blocks
    within float32 roundoff of the float64 ones and the float64
    gradient, per problem."""
    with torch.no_grad():
        full = batch.port_ne()(batch.tb0, batch.tarrays)
        if mode == "gradient":
            got = batch.port_ne().gradient(batch.tb0, batch.tarrays)
            assert "Hcc" not in got
            for k in tsolver._LAZY_H_GRAD_KEYS:
                _close(got[k].numpy(), full[k].numpy(), 1e-12)
            return
        got = batch.port_ne(h32=True)(batch.tb0, batch.tarrays)
    for k in ("Hcc", "Hff", "Cf"):
        assert got[k].dtype == torch.float32
        for i in range(P):
            _close(got[k][i].double().numpy(), full[k][i].numpy(), 1e-6)
    for k in ("E", "g_c", "g_f"):
        assert got[k].dtype == torch.float64
        _close(got[k].numpy(), full[k].numpy(), 1e-12)


def test_splined_schur_step_batch_matches_single(batch):
    """The Schur step of the batch: one fused and one back-substitution
    call for all P problems' frame blocks, each problem's step equal to
    its own step to 1e-10."""
    calls = []
    saved = (tsolver.cholesky_factor_solve, tsolver.cholesky_solve_factored)

    def rec(fn):
        def call(A, rhs):
            calls.append((fn.__name__, tuple(rhs.shape)))
            return fn(A, rhs)
        return call
    with torch.no_grad():
        ne = batch.port_ne()(batch.tb0, batch.tarrays)
        lam = torch.tensor([1e-3, 1e-4, 1e-2], dtype=torch.float64)
        tsolver.cholesky_factor_solve, tsolver.cholesky_solve_factored = \
            (rec(f) for f in saved)
        try:
            step = tsolver.schur_step(ne, lam, batch.tspec)
        finally:
            tsolver.cholesky_factor_solve, \
                tsolver.cholesky_solve_factored = saved
        Nf, Nc = batch.tspec.Nframes, ne["g_c"].shape[1]
        assert calls == [("cholesky_factor_solve", (P * Nf, 6, Nc + 1)),
                         ("cholesky_solve_factored", (P * Nf, 6, 1))]
        for i in range(P):
            one = tsolver.schur_step({k: ne[k][i] for k in ne}, lam[i],
                                     batch.tspec)
            for a, b in zip(step, one):
                _close(a[i].numpy(), b.numpy(), 1e-10)


@pytest.mark.parametrize("lazy_K", [0, 2])
def test_lm_solve_batch_splined_matches_lm_solve(batch, lazy_K):
    """Ten lockstep iterations of lm_solve_batch on the splined units,
    exact H and with a lazy Hessian (K = 2, each problem counting its own
    accepted steps since its refresh), against ten of lm_solve per unit:
    E at 1e-10, b at 1e-8, the same iteration counts."""
    kw = dict(max_iterations=10, lazy_K=lazy_K)
    b, E, niter, ne = tsolver.lm_solve_batch(
        batch.tspec, batch.tarrays, batch.tb0, batch.static_idx, **kw)
    assert ne["Hcc"].shape[0] == P and niter.shape == (P,)
    for i, oi in enumerate(batch.ois):
        arrays = tres.arrays_from_inputs(oi, device="cpu")
        b1, E1, n1, _ = tsolver.lm_solve(batch.tspec, arrays, batch.tb0[i],
                                         batch.static_idx, **kw)
        assert int(niter[i]) == n1
        assert abs(float(E[i]) - float(E1)) <= 1e-10 * float(E1)
        assert np.abs(b[i].numpy() - b1.numpy()).max() < 1e-8


def test_optimize_batch_splined_matches_optimize(batch):
    """optimize_batch of the splined units (ftol 1e-10) against each
    unit's own optimize(): E = sum x^2 within 1e-9 relative, b_packed
    within 1e-5; the written-back intrinsics and frames likewise."""
    kw = dict(update_threshold=1e-7, ftol=1e-10, max_iterations=200)
    units = [_copy(oi) for oi in batch.ois]
    stats = t_optimize_batch(units, device="cpu", **kw)
    assert len(stats) == P
    for i, oi in enumerate(batch.ois):
        alone = _copy(oi)
        s = t_optimize(device="cpu", **kw, **alone)
        E_b = float(np.sum(stats[i]["x"] ** 2))
        E_1 = float(np.sum(s["x"] ** 2))
        assert abs(E_b - E_1) <= 1e-9 * E_1
        assert np.abs(stats[i]["b_packed"] - s["b_packed"]).max() <= 1e-5
        np.testing.assert_allclose(units[i]["intrinsics"],
                                   alone["intrinsics"], atol=1e-5)
        np.testing.assert_allclose(units[i]["frames_rt_toref"],
                                   alone["frames_rt_toref"], atol=1e-5)
