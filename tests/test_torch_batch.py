"""The port's batched solves against the JAX package, in float64 on the CPU:
the normal equations and the Schur step with a problem axis against
jax.vmap of the JAX references, lm_solve_batch against the port's own
single-problem loop, and optimize_batch and
pad_problems_to_common_structure against the JAX package's.

The board problems are tests/test_optimize_batch.py's (OPENCV4, 8 frames
of a 6x5 board, 0.2 px noise); the point problem is
test_torch_residuals.point_problem_oi()'s, the triangulated one
problems.sfm_triangulated() cut to 4 cameras and 60 points, each with
per-problem perturbations from a numpy seed."""

import copy
from functools import cached_property, partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mrcal_tpu
from mrcal_tpu.optimize import layout as jlayout
from mrcal_tpu.optimize import residuals as jres
from mrcal_tpu.optimize import solver as jsolver
import mrcal_tpu_torch
from mrcal_tpu_torch import problems as tproblems
from mrcal_tpu_torch.optimize import residuals as tres
from mrcal_tpu_torch.optimize import solver as tsolver

from test_optimize_batch import _problems
from test_torch_residuals import point_problem_oi
from test_torch_residuals import torch_threads  # noqa: F401

STATS_KEYS = {"rms_reproj_error__pixels", "Noutliers", "Noutliers_board",
              "Noutliers_triangulated_point", "niterations",
              "niterations_polish", "time_s", "b_packed", "x"}


def _close(a, b, tol):
    """|a - b| <= tol * max(1, max|b|)."""
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if b.size:
        scale = max(1.0, float(np.abs(b).max()))
        assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max()


def _rms(stats):
    return np.array([s["rms_reproj_error__pixels"] for s in stats])


def _point_problems(P=3):
    out = []
    for i in range(P):
        oi = point_problem_oi()
        rng = np.random.default_rng(20 + i)
        nvar = len(oi["points"]) - oi["Npoints_fixed"]
        oi["points"][:nvar] += rng.normal(size=(nvar, 3)) * 0.01
        oi["extrinsics_rt_fromref"] += \
            rng.normal(size=oi["extrinsics_rt_fromref"].shape) * 0.002
        out.append(oi)
    return out


def _tri_problems(P=2):
    return [tproblems.perturbed_oi(
        tproblems.sfm_triangulated(Ncameras=4, Npoints=60), seed=1 + i)
        for i in range(P)]


class _Batch:
    """P problems of one structure on both sides: the JAX package's
    stacked arrays and packed states, the port's, and the JAX normal
    equations of the batch (jax.vmap)."""

    def __init__(self, ois):
        self.ois = ois
        self.spec = jlayout.spec_from_inputs(**ois[0])
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
        f = jsolver.build_normal_equations(self.spec, None, self.static_idx)
        ne = jax.jit(jax.vmap(f, in_axes=(0, jsolver._float_axes(
            self.arrays))))(jnp.asarray(self.b0), self.arrays)
        return {k: np.asarray(v) for k, v in ne.items()}


@pytest.fixture(scope="module")
def batches():
    return dict(board=_Batch(_problems(B=3)), point=_Batch(_point_problems()),
                tri=_Batch(_tri_problems()))


@pytest.mark.parametrize("which", ["board", "point", "tri"])
def test_normal_equations_batch_match_jax_vmap(batches, which):
    """Every leaf with its problem axis, boards (with the regularization),
    discrete points and triangulated pairs (with unity_cam01), at 1e-10,
    and each problem's slice equal to the port's own single-problem
    evaluation at 1e-13.  One exception: the triangulated Hcc is held to
    the JAX package at 1e-8.  Its small-angle Jacobian has a relative
    error of ~eps/th^2, and the second problem has pairs at 3.4e-6 rad
    (ROADMAP queue 3); the JAX package's own jit and vmap evaluations of
    that Hcc differ by 5.6e-9."""
    bt = batches[which]
    assert torch.equal(bt.tb0, torch.as_tensor(bt.b0))
    ne_fn = tsolver.build_normal_equations(bt.tspec, bt.tarrays,
                                           bt.static_idx)
    ne = ne_fn(bt.tb0, bt.tarrays)
    assert set(ne) == set(bt.ne)
    for k, v in ne.items():
        _close(v.numpy(), bt.ne[k],
               1e-8 if (which, k) == ("tri", "Hcc") else 1e-10)
    for i in range(len(bt.ois)):
        arrays_i = {k: (v[i] if v.is_floating_point() else v)
                    for k, v in bt.tarrays.items()}
        for k, v in ne_fn(bt.tb0[i], arrays_i).items():
            _close(ne[k][i].numpy(), v.numpy(), 1e-13)


@pytest.mark.parametrize("which", ["board", "point", "tri"])
def test_schur_step_batch_matches_jax_vmap(batches, which):
    """A different lambda per problem; the frame (and point) blocks of
    all problems through one block solve (its plain twin here)."""
    bt = batches[which]
    lam = np.array([1e-4, 3e-2, 1e-7])[:len(bt.ois)]
    out_j = jax.jit(jax.vmap(partial(jsolver.schur_step, spec=bt.spec)))(
        {k: jnp.asarray(v) for k, v in bt.ne.items()}, jnp.asarray(lam))
    out_t = tsolver.schur_step({k: torch.tensor(v)
                                for k, v in bt.ne.items()},
                               torch.as_tensor(lam), bt.tspec)
    for a, b in zip(out_t, out_j):
        _close(a.numpy(), np.asarray(b), 1e-10)


def _weighted_problems(seed0, scale=100.0):
    """Two board problems, the second with its weights times `scale`:
    its H is scale^2 times the first's."""
    ps = _problems(B=2, seed0=seed0)
    ps[1]["observations_board"][..., 2] *= scale
    return ps


def test_lm_solve_batch_matches_single_loops(monkeypatch):
    """Ten lockstep iterations against ten of lm_solve per problem, on
    problems whose H differ in scale by 1e4 (a reduction taken over the
    batch in place of per problem shows here): b at 1e-8, E at 1e-10, the
    same iteration counts.  The frame blocks of both problems go through
    one fused solve and one back-substitution per iteration."""
    bt = _Batch(_weighted_problems(seed0=130))
    calls = []
    for name in ("cholesky_factor_solve", "cholesky_solve_factored"):
        fn = getattr(tsolver, name)
        monkeypatch.setattr(tsolver, name, lambda *a, _fn=fn, _n=name: (
            calls.append((_n, tuple(a[1].shape))), _fn(*a))[1])
    b, E, niter, ne = tsolver.lm_solve_batch(
        bt.tspec, bt.tarrays, bt.tb0, bt.static_idx, max_iterations=10)
    Nf, K = bt.tspec.Nframes, ne["Cf"].shape[-1] + 1
    assert calls == [("cholesky_factor_solve", (2 * Nf, 6, K)),
                     ("cholesky_solve_factored", (2 * Nf, 6, 1))] * 10
    assert b.shape == (2, bt.tspec.Nstate) and ne["Hcc"].shape[0] == 2
    for i in range(2):
        arrays_i = {k: (v[i] if v.is_floating_point() else v)
                    for k, v in bt.tarrays.items()}
        b_i, E_i, n_i, _ = tsolver.lm_solve(bt.tspec, arrays_i, bt.tb0[i],
                                            bt.static_idx, max_iterations=10)
        assert int(niter[i]) == n_i
        assert abs(float(E[i]) - float(E_i)) <= 1e-10 * float(E_i)
        assert np.abs(b[i].numpy() - b_i.numpy()).max() < 1e-8


def test_per_problem_reductions():
    """A batch whose problems' weights differ by 1e2 (H by 1e4) gives
    each problem's own single optimize(): rms at 1e-10.  A batch of one
    gives optimize()'s E at 1e-12."""
    ps = _weighted_problems(seed0=150)
    singles = [tsolver.optimize(device="cpu", **copy.deepcopy(p))
               for p in ps]
    stats = tsolver.optimize_batch(copy.deepcopy(ps), device="cpu")
    _close(_rms(stats), _rms(singles), 1e-10 * _rms(singles).min())
    for sb, ss in zip(stats, singles):
        assert sb["Noutliers"] == ss["Noutliers"]
    one = tsolver.optimize_batch(copy.deepcopy(ps[:1]), device="cpu")[0]
    E1, E0 = (float(np.sum(s["x"] ** 2)) for s in (one, singles[0]))
    assert abs(E1 - E0) <= 1e-12 * E0
    assert one["niterations"] == singles[0]["niterations"]


@pytest.mark.parametrize("precision", ["f32", "mixed"])
def test_batch_precisions_reach_the_f64_batch(precision):
    ps = _problems(B=2, seed0=90)
    f64 = tsolver.optimize_batch(copy.deepcopy(ps), device="cpu")
    low = tsolver.optimize_batch(copy.deepcopy(ps), device="cpu",
                                 precision=precision)
    assert np.abs(_rms(low) - _rms(f64)).max() <= 1e-5
    if precision == "mixed":
        assert all(s["niterations_polish"] > 0 for s in low)


# ----------------------------------------------------------------------------
# optimize_batch against the JAX package's
# ----------------------------------------------------------------------------

def _drop(p, which):
    keep = np.ones(len(p["indices_frame_camintrinsics_camextrinsics"]), bool)
    keep[which] = False
    p["observations_board"] = p["observations_board"][keep]
    p["indices_frame_camintrinsics_camextrinsics"] = \
        p["indices_frame_camintrinsics_camextrinsics"][keep]


@pytest.fixture(scope="module")
def fleet():
    """A padded fleet of four units solved by both packages'
    optimize_batch: unit 1 misses views 2 and 5, unit 2 has a gross
    outlier, unit 3 starts at its own optimum (so it freezes while the
    others iterate)."""
    ps = _problems(B=4, seed0=110)
    _drop(ps[1], [2, 5])
    ps[2]["observations_board"][0, 1, 1, :2] += 40.0
    tsolver.optimize(device="cpu", **ps[3])       # writes its optimum back
    padded_t = tsolver.pad_problems_to_common_structure(copy.deepcopy(ps))
    padded_j = mrcal_tpu.pad_problems_to_common_structure(copy.deepcopy(ps))
    singles = [tsolver.optimize(device="cpu", **copy.deepcopy(p))
               for p in ps]
    stats_j = mrcal_tpu.optimize_batch(copy.deepcopy(padded_j))
    solved_t = copy.deepcopy(padded_t)
    stats_t = tsolver.optimize_batch(solved_t, device="cpu")
    return dict(ps=ps, padded_t=padded_t, padded_j=padded_j, stats_j=stats_j,
                stats_t=stats_t, solved_t=solved_t, singles=singles)


def test_optimize_batch_matches_jax(fleet):
    """rms at 1e-10, b_packed at 1e-5, Noutliers equal, optimize()'s stats
    keys, and each unit's solution written back into its arrays."""
    for st, sj, oi in zip(fleet["stats_t"], fleet["stats_j"],
                          fleet["solved_t"]):
        assert set(st) >= STATS_KEYS
        assert st["time_s"]
        rms_j = sj["rms_reproj_error__pixels"]
        assert abs(st["rms_reproj_error__pixels"] - rms_j) <= 1e-10 * rms_j
        assert np.abs(st["b_packed"] - np.asarray(sj["b_packed"])).max() \
            < 1e-5
        assert st["x"].shape == sj["x"].shape
        for key in ("Noutliers", "Noutliers_board",
                    "Noutliers_triangulated_point"):
            assert st[key] == sj[key], key
        spec = tsolver.spec_from_inputs(**oi)
        i0 = spec.state_index_frames0
        frames = (st["b_packed"] * spec.scales())[
            i0:i0 + spec.num_states_frames]
        assert np.allclose(oi["frames_rt_toref"].ravel(), frames, rtol=0,
                           atol=1e-12)


def test_batch_outlier_rejection_matches_jax(fleet):
    """The unit with the injected outlier marks it (and the others are
    solved again with it); as many outliers as the JAX package finds, and
    as the unit's single optimize()."""
    st, sj = fleet["stats_t"][2], fleet["stats_j"][2]
    assert st["Noutliers"] >= 1
    assert st["Noutliers"] == sj["Noutliers"] == \
        fleet["singles"][2]["Noutliers"]
    rms_s = fleet["singles"][2]["rms_reproj_error__pixels"]
    assert abs(st["rms_reproj_error__pixels"] - rms_s) <= 1e-6 * rms_s


def test_batch_heterogeneous_visibility_matches_jax(fleet):
    """pad_problems_to_common_structure gives the JAX package's arrays
    exactly; padding rows count as outliers and add nothing to E, so a
    unit's E equals its unpadded single solve's."""
    for pt, pj in zip(fleet["padded_t"], fleet["padded_j"]):
        assert set(pt) == set(pj)
        for k, v in pj.items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(pt[k], v), k
                assert pt[k].dtype == v.dtype, k
            else:
                assert pt[k] == v, k
    ncorners = 6 * 5
    for i, npad in ((0, 0), (1, 2 * ncorners)):
        st, ss = fleet["stats_t"][i], fleet["singles"][i]
        assert st["Noutliers"] - npad == ss["Noutliers"]
        E_b, E_s = (float(np.sum(s["x"] ** 2)) for s in (st, ss))
        assert abs(E_b - E_s) <= 1e-10 * E_s


def test_batch_freezes_a_converged_problem(fleet):
    """The unit that starts at its optimum stops while the others iterate
    on, and its solution does not move.  Its count is not held to the
    JAX package's: at an optimum the accept and stop decisions follow
    roundoff in E (ROADMAP queue 3; on these problems the two packages'
    single solves already differ, 10 against 19 iterations on unit 0),
    and the rms test holds the result."""
    st = fleet["stats_t"]
    n = [s["niterations"] for s in st]
    assert n[3] < max(n)
    b0 = tres.pack_params(tres.params_from_arrays(tres.arrays_from_inputs(
        fleet["padded_t"][3], device="cpu")),
        tsolver.spec_from_inputs(**fleet["padded_t"][3])).numpy()
    assert np.abs(st[3]["b_packed"] - b0).max() < 1e-6


def test_batch_rejects_mismatched_structure():
    """As the JAX package: a differing frame count raises ValueError, and
    so do differing board indices."""
    problems = _problems(B=2)
    p2 = copy.deepcopy(problems[1])
    p2["frames_rt_toref"] = p2["frames_rt_toref"][:5]
    p2["observations_board"] = p2["observations_board"][:5]
    p2["indices_frame_camintrinsics_camextrinsics"] = \
        p2["indices_frame_camintrinsics_camextrinsics"][:5]
    for fn in (mrcal_tpu.optimize_batch,
               partial(tsolver.optimize_batch, device="cpu")):
        with pytest.raises(ValueError):
            fn([copy.deepcopy(problems[0]), copy.deepcopy(p2)])
    p3 = copy.deepcopy(problems[1])
    p3["indices_frame_camintrinsics_camextrinsics"] = \
        p3["indices_frame_camintrinsics_camextrinsics"][::-1].copy()
    with pytest.raises(ValueError, match="indices"):
        tsolver.optimize_batch([problems[0], p3], device="cpu")


def test_batch_triangulated_outlier_rejection_matches_jax():
    """tests/test_optimize_batch.py's triangulated batch: a corrupted pair
    in problem 0, the divergent-pair and sigma rules per problem.  The JAX
    package's small-angle measurement is noisy at its optimum (ROADMAP
    queue 3), so the rms against it is held as that test holds its batch
    against its singles; against the port's own single solves at 1e-9."""
    import test_sfm_triangulated as tst
    scene = tst.make_scene(Ncameras=4, Npoints=60, sigma_px=0.05, seed=3)
    base = dict(
        intrinsics=scene["intrinsics"],
        extrinsics_rt_fromref=scene["rt_true"][1:].copy(),
        observations_point_triangulated=scene["observations"],
        indices_point_triangulated_camintrinsics_camextrinsics=scene[
            "indices"],
        lensmodel=scene["lensmodel"],
        imagersizes=scene["imagersizes"],
        do_optimize_intrinsics_core=False,
        do_optimize_intrinsics_distortions=False,
        do_apply_regularization_unity_cam01=True,
        do_apply_outlier_rejection=True,
    )
    problems = []
    for k in range(2):
        p = copy.deepcopy(base)
        rng = np.random.default_rng(k)
        p["extrinsics_rt_fromref"] = np.asarray(
            p["extrinsics_rt_fromref"]) + rng.normal(0, 1e-3, (3, 6))
        problems.append(p)
    problems[0]["observations_point_triangulated"][4, :2] += 80.0
    stats_j = mrcal_tpu.optimize_batch(copy.deepcopy(problems))
    singles = [tsolver.optimize(device="cpu", **copy.deepcopy(p))
               for p in problems]
    stats_t = tsolver.optimize_batch(copy.deepcopy(problems), device="cpu")
    assert stats_t[0]["Noutliers_triangulated_point"] >= 1
    for st, sj, ss in zip(stats_t, stats_j, singles):
        assert st["Noutliers_triangulated_point"] == \
            sj["Noutliers_triangulated_point"] == \
            ss["Noutliers_triangulated_point"]
        rms = st["rms_reproj_error__pixels"]
        assert np.isclose(rms, sj["rms_reproj_error__pixels"], rtol=1e-5,
                          atol=1e-7)
        assert abs(rms - ss["rms_reproj_error__pixels"]) <= 1e-9 * rms


def test_batch_raises_on_what_the_slice_does_not_cover():
    """A splined model with its core locked (the spline-window assembly,
    raised on before it had a problem axis) now solves as a batch: two
    units of a small 30x18-knot problem through three lockstep
    iterations, each equal to its own three iterations of optimize() (E
    at 1e-10, b_packed at 1e-8).  Without a card the default device
    raises as optimize() does."""
    oi = tproblems.make_problem(
        device="cpu", Ncameras=1, Nframes=6, W=8, H=6,
        model=tproblems.SPLINED_30X18["model"],
        do_optimize_intrinsics_core=False)[0]
    units = [oi, tproblems.perturbed_oi(oi, seed=2)]
    kw = dict(max_iterations=3, update_threshold=1e-7)
    stats = tsolver.optimize_batch(copy.deepcopy(units), device="cpu", **kw)
    for st, unit in zip(stats, units):
        alone = tsolver.optimize(device="cpu", **kw, **copy.deepcopy(unit))
        assert st["niterations"] == alone["niterations"] == 3
        E_b, E_1 = (float(np.sum(s["x"] ** 2)) for s in (st, alone))
        assert abs(E_b - E_1) <= 1e-10 * E_1
        assert np.abs(st["b_packed"] - alone["b_packed"]).max() <= 1e-8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mrcal_tpu_torch.optimize_batch(_problems(B=1))


def test_batch_entry_points_are_exported():
    from mrcal_tpu_torch.optimize import (optimize_batch,
                                          pad_problems_to_common_structure)
    for f in (mrcal_tpu_torch.optimize_batch, optimize_batch):
        assert f is tsolver.optimize_batch
    for f in (mrcal_tpu_torch.pad_problems_to_common_structure,
              pad_problems_to_common_structure):
        assert f is tsolver.pad_problems_to_common_structure
