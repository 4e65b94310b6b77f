"""The port's normal equations, Schur step, LM step and optimize() against
the JAX package on __graft_entry__._make_problem()'s problem and on a
small discrete-point problem, in float64 on the CPU; optimizer_callback
takes no_factorization as the JAX package does."""

import re
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mrcal_tpu
from mrcal_tpu.optimize import solver as jsolver
from mrcal_tpu_torch import (convert, lensmodel_num_params,
                             problems as tproblems)
from mrcal_tpu_torch import optimize as t_optimize
from mrcal_tpu_torch.optimize import solver as tsolver

from test_torch_residuals import point_problem_oi
from test_torch_residuals import torch_threads  # noqa: F401


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


@pytest.fixture(scope="module")
def host_loop_solve(problems):
    """optimization_inputs that ask for the host loop, as
    tests/test_uncertainty_matrix.py builds them, and the JAX package's
    solve of them (f64 on its CPU backend)."""
    oi = _copy(problems["board"].oi)
    oi["device_loop"] = False
    oi_j = _copy(oi)
    return oi, mrcal_tpu.optimize(**oi_j), oi_j


@pytest.mark.parametrize("entry", ["optimize", "optimize_batch"])
def test_device_loop_false_matches_the_jax_host_loop(host_loop_solve,
                                                     entry):
    """device_loop=False runs the port's one LM loop: optimize() and
    optimize_batch() give the JAX package's host-loop solve, and write it
    into the caller's arrays."""
    oi, stats_j, oi_j = host_loop_solve
    oi_t = _copy(oi)
    stats_t = (t_optimize(device="cpu", **oi_t) if entry == "optimize"
               else tsolver.optimize_batch([oi_t], device="cpu")[0])
    rms_j = stats_j["rms_reproj_error__pixels"]
    assert abs(stats_t["rms_reproj_error__pixels"] - rms_j) <= 1e-10 * rms_j
    assert np.abs(stats_t["b_packed"] - np.asarray(stats_j["b_packed"])
                  ).max() < 1e-5
    for k in ("intrinsics", "extrinsics_rt_fromref", "frames_rt_toref"):
        _close(oi_t[k], oi_j[k], 1e-5)


@pytest.mark.parametrize("no_jacobian", [True, False])
def test_optimizer_callback_takes_no_factorization(problems, no_jacobian,
                                                   monkeypatch):
    """no_factorization, by position or by keyword, as the JAX package
    takes it: the keyword-free call's (b, x) and J exactly, and the
    argument never reaches the inputs' normalization or the spec."""
    from mrcal_tpu_torch import optimizer_callback
    from mrcal_tpu_torch.optimize import jacobian
    seen = []
    for name in ("normalize_inputs", "spec_from_inputs"):
        def recording(*args, _f=getattr(jacobian, name), **kw):
            seen.append({*kw, *(k for a in args if isinstance(a, dict)
                                for k in a)})
            return _f(*args, **kw)
        monkeypatch.setattr(jacobian, name, recording)
    oi = problems["board"].oi
    want = optimizer_callback(no_jacobian=no_jacobian, device="cpu",
                              **_copy(oi))
    for got in (optimizer_callback(no_jacobian, False, device="cpu",
                                   **_copy(oi)),
                optimizer_callback(no_jacobian=no_jacobian,
                                   no_factorization=False, device="cpu",
                                   **_copy(oi))):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        if no_jacobian:
            assert got[2] is None and want[2] is None
        else:
            assert (got[2] != want[2]).nnz == 0
            np.testing.assert_array_equal(got[2].indptr, want[2].indptr)
            np.testing.assert_array_equal(got[2].indices, want[2].indices)
    assert len(seen) == 6
    assert not any("no_factorization" in keys for keys in seen)


def test_optimize_without_device_needs_a_card(problems):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_optimize(**_copy(problems["board"].oi))


@pytest.mark.parametrize("option", [
    dict(lensmodel="LENSMODEL_CAHVORE_linearity=0.00"),
    dict(verbose=True),
    dict(lensmodel="LENSMODEL_CAHVOR")])
def test_optimize_raises_on_what_the_slice_does_not_cover(problems, option,
                                                          capsys):
    """What optimize() and optimize_batch() used to refuse now runs:
    CAHVORE and CAHVOR (from a pinhole-equivalent start: axis and radial
    terms 0) solve to a finite optimum, optimize() and a batch of one
    agreeing on E to 1e-10; verbose=True prints optimize()'s iteration
    lines (optimize_batch, as the JAX package's, prints none)."""
    oi = _copy(problems["board"].oi)
    if "lensmodel" in option:
        n = lensmodel_num_params(option["lensmodel"])
        oi["intrinsics"] = np.concatenate(
            [oi["intrinsics"][:, :4], np.zeros((2, n - 4))], axis=1)
    oi.update(option)
    kw = dict(update_threshold=1e-7, max_iterations=8)
    alone = t_optimize(device="cpu", **kw, **_copy(oi))
    lines = capsys.readouterr().out.splitlines()
    batch = tsolver.optimize_batch([_copy(oi)], device="cpu", **kw)[0]
    assert capsys.readouterr().out == ""
    assert np.isfinite(alone["x"]).all()
    E_1, E_b = (float(np.sum(s["x"] ** 2)) for s in (alone, batch))
    assert abs(E_b - E_1) <= 1e-10 * E_1
    if option.get("verbose"):
        assert len(lines) >= alone["niterations"]
        assert all(l.startswith(f"iter {i}: E=")
                   for i, l in enumerate(lines[:alone["niterations"]]))
    else:
        assert lines == []


ITER_LINE = re.compile(r"iter (\d+): E=(\S+) Enew=(\S+) lam=(\S+) rho=(\S+) "
                       r"\|db\|=(\S+)$")


def _recorded_E(monkeypatch):
    """Every normal-equation E the JAX package's host loop evaluates, in
    order (the starting point's, then each trial's): a debug callback in
    its jitted normal equations."""
    seen = []
    build = jsolver.build_normal_equations

    def recording(*args, **kw):
        f = build(*args, **kw)

        def g(b, arrays):
            out = f(b, arrays)
            jax.debug.callback(lambda e: seen.append(float(e)), out["E"])
            return out
        return g
    monkeypatch.setattr(jsolver, "build_normal_equations", recording)
    return seen


@pytest.mark.parametrize("outliers", [False, True])
def test_verbose_prints_the_jax_lines(problems, outliers, capsys,
                                      monkeypatch):
    """optimize(verbose=True) prints the JAX host loop's lines in its
    format: one per iteration, whose first 10 E and trial E agree with the
    JAX package's at 1e-8, and (with four corners moved 30 px) one per
    outlier pass that marks something, the same counts.  Without verbose
    the loop reads the device once per iteration, and prints nothing."""
    oi = _copy(problems["board"].oi)
    if outliers:
        oi["observations_board"][[1, 3, 5, 6], 2, 3, :2] += 30.0
    port_E = []
    print_iteration = tsolver._print_iteration
    monkeypatch.setattr(tsolver, "_print_iteration", lambda it, E, E_try,
                        *a: (port_E.append((float(E), float(E_try))),
                             print_iteration(it, E, E_try, *a)))
    s_t = t_optimize(device="cpu", verbose=True, **_copy(oi))
    out_t = capsys.readouterr().out.splitlines()
    jax_E = _recorded_E(monkeypatch)
    s_j = mrcal_tpu.optimize(verbose=True, precision="f64", **_copy(oi))
    out_j = capsys.readouterr().out.splitlines()

    its_t = [l for l in out_t if l.startswith("iter ")]
    its_j = [l for l in out_j if l.startswith("iter ")]
    assert all(ITER_LINE.match(l) for l in its_t) and len(its_t) >= 10
    assert len(its_t) == s_t["niterations"]
    assert [l.split(":")[0] for l in its_t[:10]] == \
        [f"iter {i}" for i in range(10)]
    # the JAX loop evaluates E at its start, then each iteration's trial
    _close(port_E[0][0], jax_E[0], 1e-8)
    _close(np.array([e for _, e in port_E[:10]]), np.array(jax_E[1:11]),
           1e-8)
    for lt, lj in zip(its_t[:10], its_j[:10]):
        mt, mj = ITER_LINE.match(lt), ITER_LINE.match(lj)
        _close(float(mt[2]), float(mj[2]), 1e-6)
        _close(float(mt[3]), float(mj[3]), 1e-6)
    marks_t = [l for l in out_t if l.startswith("marked")]
    marks_j = [l for l in out_j if l.startswith("marked")]
    assert marks_t == marks_j
    assert bool(marks_t) == outliers
    assert s_t["Noutliers"] == s_j["Noutliers"] == (4 if outliers else 0)

    # one host read per iteration without verbose
    reads = []
    item = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda t: (reads.append(1), item(t))[1])
    s_q = t_optimize(device="cpu", **_copy(oi))
    assert capsys.readouterr().out == ""
    assert len(reads) == s_q["niterations"]


def test_check_gradient_verbose_prints_each_column(capsys):
    """optimize(check_gradient=True, verbose=True) prints the JAX
    package's line for every column it checks; the worst line is the
    report's."""
    oi = tproblems.make_problem(Ncameras=1, Nframes=3, W=4, H=3,
                                device="cpu")[0]
    report = t_optimize(device="cpu", check_gradient=True, verbose=True,
                        **oi)
    lines = capsys.readouterr().out.splitlines()
    pat = re.compile(r"check_gradient: ivar (\d+): max \|J_ad - J_num\| = "
                     r"(\S+) \(relative (\S+)\)$")
    got = [pat.match(l) for l in lines]
    assert all(got) and len(got) == report["ncols_checked"]
    worst = max(got, key=lambda m: float(m[3]))
    assert int(worst[1]) == report["worst_ivar"]
    assert float(worst[3]) == pytest.approx(report["worst_relative_error"],
                                            rel=1e-3)
