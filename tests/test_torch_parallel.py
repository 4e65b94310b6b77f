"""The port's sharded solves (mrcal_tpu_torch.parallel) on the CPU over
gloo, at world sizes 2 and 3 (3: uneven shards and padding), against the
port's unsharded solver and the JAX package's mesh at 2 devices.

Every rank-side case runs inside one spawn per world size (_rank_cases),
and the parent holds the ranks' results to the references.  The
tolerances are tests/test_sharding.py's: the normal equations at 1e-9;
a solve against the unsharded one at E 1e-10 relative, b 1e-9 (1e-8
splined and triangulated), the residuals at 1e-9; optimize(mesh=...)
rms against the JAX package at 1e-9 (1e-7 splined).  Against the JAX
package's device loop a converged solve is held where the port's earlier
tests hold one (rms 1e-10, b 1e-5): two implementations stop at
different points of the roundoff regime.

The JAX references are computed in a process of their own (_jax_refs),
while the ranks and the parent's own references run: the spawned
processes import this module to find their function, so it imports no
JAX at the top."""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import pytest
import torch

from mrcal_tpu_torch import convert, problems as tproblems
from mrcal_tpu_torch import optimize as t_optimize
from mrcal_tpu_torch.optimize import solver as tsolver
from mrcal_tpu_torch.parallel import (make_mesh,
                                      collective_bytes_per_iteration,
                                      dryrun_multichip,
                                      sharded_lm_solve,
                                      sharded_lm_solve_device,
                                      sharded_lm_step,
                                      sharded_normal_equations, spawn)
from mrcal_tpu_torch.parallel.sharding import BLOCK_KEYS, _dryrun_rank

from test_torch_residuals import torch_threads  # noqa: F401

SPLINED = "LENSMODEL_SPLINED_STEREOGRAPHIC_order=3_Nx=9_Ny=7_fov_x_deg=120"
X_KEYS = ("x_board", "x_point", "x_tri", "x_reg")
WORLDS = (2, 3)


def _copy(oi):
    return {k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in oi.items()}


def _np(d):
    return {k: v.detach().cpu().numpy() for k, v in d.items()
            if torch.is_tensor(v)}


def board_oi():
    """2 cameras, 8 frames (16 observations: 8 per rank at world 2; 6, 6
    and 4 + 2 padding at world 3), perturbed."""
    return tproblems.perturbed_oi(tproblems.make_problem(device="cpu")[0],
                                  seed=1)


def board_outliers_oi():
    """board_oi with gross errors on six corners, for the outlier loop."""
    oi = board_oi()
    oi["observations_board"][[1, 5, 9, 14], 2, 3, :2] += 25.0
    oi["observations_board"][[3, 11], 0, 0, :2] -= 30.0
    return oi


def splined_oi():
    """A 9x7-knot splined model, core locked, 6 frames of an 8x6 board, as
    tests/test_sharding.py builds its splined problem: observations of
    random control points with noise, solved from control points at 0 and
    perturbed frames."""
    oi = tproblems.make_problem(device="cpu", Ncameras=1, Nframes=6, W=8,
                                H=6, model=SPLINED,
                                do_optimize_intrinsics_core=False)[0]
    rng = np.random.default_rng(7)
    oi["intrinsics"][:, 4:] = rng.normal(size=oi["intrinsics"][:, 4:].shape
                                         ) * 2e-3
    np.random.seed(8)
    tproblems.make_perfect_observations(oi, observed_pixel_uncertainty=0.2,
                                        device="cpu")
    oi["intrinsics"][:, 4:] = 0.0
    oi["frames_rt_toref"] += rng.normal(size=oi["frames_rt_toref"].shape
                                        ) * 0.01
    return oi


def tri_oi():
    return tproblems.perturbed_oi(
        tproblems.sfm_triangulated(Ncameras=4, Npoints=25), seed=1)


def point_oi():
    from test_torch_residuals import point_problem_oi
    return point_problem_oi()


def problem_set():
    return dict(board=board_oi(), board_outliers=board_outliers_oi(),
                splined=splined_oi(), tri=tri_oi(), point=point_oi())


# the device solves of every world and of the references.  The sharded and
# the unsharded loop are held to each other over a trajectory that ends
# before the roundoff regime: there, where a solve stops follows roundoff
# (the board problem run to the end stops after 16-22 iterations on 1-3
# ranks, E within 4e-15 relative and b within 1e-6; the triangulated one
# after 6-9, its last accepts predicting decreases below E's roundoff, see
# ROADMAP queue 3).  board_converged runs
# to the end, against the JAX package's converged solve.
SOLVES = dict(board=("board", dict(max_iterations=12)),
              board_converged=("board", dict()),
              splined=("splined", dict(max_iterations=12, lazy_K=0)),
              splined_lazy=("splined", dict(max_iterations=10, lazy_K=4)),
              tri=("tri", dict(max_iterations=4)))


def _rank_cases(mesh, oi):
    """Every rank-side case on one mesh of CPU ranks -> numpy results."""
    out = dict(rank=mesh.rank, ne={}, solve={}, optimize={})
    for name in ("board", "point", "tri", "splined"):
        spec, arrays, b0 = convert.from_reference(oi[name], device="cpu")
        out["ne"][name] = _np(sharded_normal_equations(spec, mesh)(arrays)(
            b0))
    for name, (which, kw) in SOLVES.items():
        spec, arrays, b0 = convert.from_reference(oi[which], device="cpu")
        mesh.reset_counts()
        b, E, niter, ne = sharded_lm_solve_device(spec, arrays, b0, mesh,
                                                  **kw)
        out["solve"][name] = dict(b=b.numpy(), E=float(E), niter=niter,
                                  ne=_np(ne), counts=dict(mesh.counts),
                                  bytes=mesh.bytes_reduced)
    # the float32-H solve of the splined window assembly: H/C in float32,
    # E and g in float64, one buffer each
    spec, arrays, b0 = convert.from_reference(oi["splined"], device="cpu")
    mesh.reset_counts()
    E = sharded_lm_solve_device(spec, arrays, b0, mesh, max_iterations=3,
                                lazy_K=0, h32=True)[1]
    out["h32"] = dict(E=float(E), counts=dict(mesh.counts),
                      bytes=mesh.bytes_reduced)
    spec, arrays, b0 = convert.from_reference(oi["board"], device="cpu")
    out["legacy"] = sharded_lm_solve(spec, arrays, b0, mesh,
                                     max_iterations=300)[1].item()
    out["step"] = sharded_lm_step(spec, mesh)(arrays)(b0, 1e-4)[0].numpy()
    for name in OPTIMIZED:
        oi_r = _copy(oi[name])
        stats = t_optimize(device="cpu", mesh=mesh.size, **oi_r)
        stats.pop("time_s")
        out["optimize"][name] = dict(stats=stats, oi=oi_r)
    out["mixed"] = t_optimize(device="cpu", mesh=mesh, precision="mixed",
                              **_copy(oi["board"]))["rms_reproj_error__pixels"]
    out["dryrun"] = _dryrun_rank(mesh)
    return out


OPTIMIZED = ("board_outliers", "splined")


@pytest.fixture(scope="module")
def oi():
    return problem_set()


@pytest.fixture(scope="module", autouse=True)
def spawned(oi):
    """One spawn per world size and the JAX references' process, all
    started before the first test: they run while the parent builds the
    port's unsharded references."""
    threads_before = torch.get_num_threads()
    # the parent's small solves share the cores with five ranks and JAX
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(len(WORLDS)) as threads, \
                ProcessPoolExecutor(2, mp_context=multiprocessing.get_context(
                    "spawn")) as jax_procs:
            out = {w: threads.submit(spawn, _rank_cases, w, oi,
                                     device="cpu")
                   for w in WORLDS}
            out["jax"] = [jax_procs.submit(_jax_refs, oi, part)
                          for part in ("board", "splined")]
            yield out
    finally:
        torch.set_num_threads(threads_before)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def world(request, spawned):
    """(world size, each rank's results)."""
    return request.param, spawned[request.param].result(timeout=600)


@pytest.fixture(scope="module")
def jax_ref(spawned):
    board, splined = (f.result(timeout=600) for f in spawned["jax"])
    for k in ("optimize", "bytes"):
        board[k].update(splined[k])
    return board


@pytest.fixture(scope="module")
def port(oi):
    """The port's unsharded normal equations, solves and optimize()."""
    out = dict(ne={}, solve={}, optimize={})
    for name in ("board", "point", "tri", "splined"):
        spec, arrays, b0 = convert.from_reference(oi[name], device="cpu")
        static_idx = tsolver._static_idx(oi[name])
        out["ne"][name] = _np(tsolver.build_normal_equations(
            spec, arrays, static_idx)(b0, arrays))
    for name, (which, kw) in SOLVES.items():
        spec, arrays, b0 = convert.from_reference(oi[which], device="cpu")
        b, E, niter, ne = tsolver.lm_solve(spec, arrays, b0,
                                           tsolver._static_idx(oi[which]),
                                           **kw)
        out["solve"][name] = dict(b=b.numpy(), E=float(E), niter=niter,
                                  ne=_np(ne))
    for name in OPTIMIZED:
        oi_r = _copy(oi[name])
        out["optimize"][name] = dict(
            stats=t_optimize(device="cpu", **oi_r), oi=oi_r)
    return out


def _jax_refs(oi, part):
    """The JAX package at make_mesh(2), in a fresh process on the CPU, in
    two parts that run side by side.  "board": the board problem's
    sharded normal equations at b0 (its production sharded evaluation:
    sharded_lm_solve_device with no iteration, whose compiled solver the
    later board solves reuse) and optimize(mesh=2) of the board problem
    (one device solve) and of the board problem with outliers.
    "splined": optimize(mesh=2) of the splined problem (through its
    spline-window assembly, as tests/test_sharding.py sets it).  Both:
    collective_bytes_per_iteration of their specs."""
    import os
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)
    os.environ["MRCAL_TPU_SPLINED_SPARSE"] = "1"
    import mrcal_tpu
    from mrcal_tpu.optimize.layout import spec_from_inputs
    from mrcal_tpu.optimize.residuals import (arrays_from_inputs,
                                              pack_params,
                                              params_from_arrays)
    from mrcal_tpu.parallel import make_mesh as j_make_mesh
    from mrcal_tpu.parallel import sharded_lm_solve_device as j_solve
    from mrcal_tpu.parallel.sharding import (
        collective_bytes_per_iteration as j_bytes)
    out = dict(optimize={}, bytes={})
    names = ("board", "board_outliers") if part == "board" else (part,)
    if part == "board":
        spec = spec_from_inputs(**oi["board"])
        arrays = arrays_from_inputs(**oi["board"])
        b0 = pack_params(params_from_arrays(arrays), spec)
        ne = j_solve(spec, arrays, b0, j_make_mesh(2), max_iterations=0)[3]
        out["ne"] = {k: np.asarray(ne[k]) for k in BLOCK_KEYS}
    for name in names:
        out["optimize"][name] = mrcal_tpu.optimize(**_copy(oi[name]),
                                                   mesh=2)
    for dt in (np.float64, np.float32):
        out["bytes"][part, dt] = j_bytes(spec_from_inputs(**oi[part]), dt)
    return out


def _allclose(a, b, tol):
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.allclose(a, b, rtol=tol, atol=tol), np.abs(a - b).max()


def _close_ne(ne, ref, tol):
    """The blocks of two normal equations at states tol apart in b: each
    to tol of its largest entry, a gradient block to tol of its Hessian
    block's (g moves by H db), at least tol."""
    for k in BLOCK_KEYS:
        a, b = ne[k], ref[k]
        assert a.shape == b.shape, (k, a.shape, b.shape)
        like = ref["H" + k[2:] * 2] if k.startswith("g_") else b
        scale = max(1.0, float(np.abs(like).max()))
        assert np.abs(a - b).max() <= tol * scale, (k, np.abs(a - b).max())


def _rms(E, spec_oi):
    spec = convert.from_reference(spec_oi, device="cpu")[0]
    return np.sqrt(E / spec.Nmeasurements)


# ----------------------------------------------------------------------------
# the mesh and its spawned ranks
# ----------------------------------------------------------------------------

def test_make_mesh_without_a_group():
    """A mesh of one without a process group; more ranks need a group, the
    default device needs a card, and optimize(mesh=2) raises alike."""
    mesh = make_mesh(1, device="cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    assert make_mesh("auto", device="cpu").size == 1
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError):
        make_mesh("all", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(1)
        # no quiet CPU fallback: the ranks' default device is a card
        with pytest.raises(RuntimeError, match="CUDA"):
            dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="init_process_group"):
        t_optimize(device="cpu", mesh=2, **board_oi())


def test_mesh_of_one_is_the_unsharded_solve(oi, port):
    """A mesh of one runs the sharded path with identity collectives: the
    same bits as the unsharded loop, and one flat all-reduce per
    normal-equation evaluation."""
    for name, (which, kw) in SOLVES.items():
        spec, arrays, b0 = convert.from_reference(oi[which], device="cpu")
        mesh = make_mesh(1, device="cpu")
        b, E, niter, ne = sharded_lm_solve_device(spec, arrays, b0, mesh,
                                                  **kw)
        ref = port["solve"][name]
        assert np.array_equal(b.numpy(), ref["b"]), name
        assert (float(E), niter) == (ref["E"], ref["niter"]), name
        for k in X_KEYS:
            assert np.array_equal(ne[k].numpy(), ref["ne"][k]), (name, k)
        # lazy-H: the gradient-only evaluations reduce too
        assert mesh.counts["all_reduce"] == \
            mesh.counts["normal_equations"] + mesh.counts["gradients"]
        assert mesh.counts["all_gather"] == 1


def test_ranks_agree_bit_for_bit(world):
    """Every rank reads the same reduced E, takes the same steps and stops
    at the same iteration: b, E, the gathered residuals, the collective
    counts and optimize()'s results are identical across ranks."""
    size, res = world
    assert [r["rank"] for r in res] == list(range(size))
    for r in res[1:]:
        for name, s in r["solve"].items():
            s0 = res[0]["solve"][name]
            assert np.array_equal(s["b"], s0["b"]), name
            assert (s["E"], s["niter"], s["counts"]) == \
                (s0["E"], s0["niter"], s0["counts"]), name
            for k in X_KEYS:
                assert np.array_equal(s["ne"][k], s0["ne"][k]), (name, k)
        for name, o in r["optimize"].items():
            o0 = res[0]["optimize"][name]
            assert np.array_equal(o["stats"]["b_packed"],
                                  o0["stats"]["b_packed"]), name
            assert np.array_equal(o["oi"]["observations_board"],
                                  o0["oi"]["observations_board"]), name
        assert r["legacy"] == res[0]["legacy"]
        assert np.array_equal(r["step"], res[0]["step"])


# ----------------------------------------------------------------------------
# the normal equations
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["board", "point", "tri", "splined"])
def test_sharded_normal_equations_match_unsharded(world, port, name):
    """The reduced blocks, regularization counted once (board, point and
    splined problems have one), padding rows contributing nothing (world
    3 pads every kind), against the port's unsharded normal equations."""
    _, res = world
    ne = res[0]["ne"][name]
    assert sorted(ne) == sorted(BLOCK_KEYS)
    for k in BLOCK_KEYS:
        _allclose(ne[k], port["ne"][name][k], 1e-9)


def test_sharded_normal_equations_match_jax(world, jax_ref):
    _, res = world
    for k in BLOCK_KEYS:
        _allclose(res[0]["ne"]["board"][k], jax_ref["ne"][k], 1e-9)


def test_collective_bytes_match_jax(oi, jax_ref):
    """The same arithmetic as the JAX package's, on an OPENCV8 and a
    splined spec, whose splined solves keep H/C in float32 (h32)."""
    for name in ("board", "splined"):
        tspec = convert.from_reference(oi[name], device="cpu")[0]
        for dt in (np.float64, np.float32):
            assert collective_bytes_per_iteration(
                tspec, dt, h32=tspec.is_splined) == \
                jax_ref["bytes"][name, dt], (name, dt)


def test_all_reduce_moves_the_blocks(world, oi):
    """One flat all-reduce per dtype per evaluation (the lazy Hessian's
    gradient-only ones included), carrying exactly the blocks, as
    collective_bytes_per_iteration counts them: in f64 (h32=False), or H/C
    in float32 and E, g in f64 for the float32-H solve (h32=True)."""
    _, res = world
    for name, (which, kw) in SOLVES.items():
        s = res[0]["solve"][name]
        c = s["counts"]
        assert c["all_reduce"] == c["normal_equations"] + c["gradients"]
        assert c["all_gather"] == 1
        ne = s["ne"]
        blocks = sum(ne[k].size for k in BLOCK_KEYS)
        grads = sum(ne[k].size for k in ("E", "g_c", "g_f", "g_p"))
        assert s["bytes"] == 8 * (c["normal_equations"] * blocks
                                  + c["gradients"] * grads), name
        if not c["gradients"]:
            spec = convert.from_reference(oi[which], device="cpu")[0]
            assert s["bytes"] == c["normal_equations"] * \
                collective_bytes_per_iteration(spec)[0], name
    assert res[0]["solve"]["splined_lazy"]["counts"]["gradients"] > 0
    h = res[0]["h32"]
    spec = convert.from_reference(oi["splined"], device="cpu")[0]
    assert h["counts"]["all_reduce"] == 2 * h["counts"]["normal_equations"]
    assert h["bytes"] == h["counts"]["normal_equations"] * \
        collective_bytes_per_iteration(spec, h32=True)[0]
    assert collective_bytes_per_iteration(spec, h32=True)[0] < \
        collective_bytes_per_iteration(spec)[0]
    assert np.isfinite(h["E"]) and all(r["h32"] == h for r in res)


# ----------------------------------------------------------------------------
# solves
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name,b_tol", [("board", 1e-9), ("splined", 1e-8),
                                        ("splined_lazy", 1e-8),
                                        ("tri", 1e-8)])
def test_sharded_solve_matches_unsharded(world, port, name, b_tol):
    """sharded_lm_solve_device against the port's lm_solve on the same
    problem: the iterations, E, b, the residual vectors (unpadded, in the
    unsharded order) and the normal equations at b.  splined_lazy is the
    lazy Hessian (K = 4): its gradient-only steps reduce too."""
    _, res = world
    s, ref = res[0]["solve"][name], port["solve"][name]
    assert s["niter"] == ref["niter"]
    assert np.isclose(s["E"], ref["E"], rtol=1e-10, atol=0)
    _allclose(s["b"], ref["b"], b_tol)
    for k in X_KEYS:
        _allclose(s["ne"][k], ref["ne"][k], 1e-9)
    _close_ne(s["ne"], ref["ne"], 1e-9)


def test_converged_sharded_solve_matches_unsharded_and_jax(world, oi, port,
                                                           jax_ref):
    """The board solve run to the end: E as the unsharded loop's (1e-10
    relative), and the JAX package's optimize(mesh=2), which runs its
    sharded device loop once (no outliers here): rms 1e-10, b 1e-5."""
    _, res = world
    s = res[0]["solve"]["board_converged"]
    assert np.isclose(s["E"], port["solve"]["board_converged"]["E"],
                      rtol=1e-10, atol=0)
    _allclose(s["b"], port["solve"]["board_converged"]["b"], 1e-5)
    ref = jax_ref["optimize"]["board"]
    assert ref["Noutliers"] == 0
    rms = _rms(s["E"], oi["board"])
    rms_j = ref["rms_reproj_error__pixels"]
    assert abs(rms - rms_j) <= 1e-10 * rms_j
    _allclose(s["b"], ref["b_packed"], 1e-5)


def test_legacy_solve_and_step(world, port, oi):
    """sharded_lm_solve is the same loop (E as the device solve's, to
    rtol 1e-10; the JAX package holds its legacy loop to 1e-3), and
    sharded_lm_step's step equals the unsharded Schur step's."""
    _, res = world
    for E in (port["solve"]["board_converged"]["E"],
              res[0]["solve"]["board_converged"]["E"]):
        assert np.isclose(res[0]["legacy"], E, rtol=1e-10, atol=0)
    spec, arrays, b0 = convert.from_reference(oi["board"], device="cpu")
    ne = tsolver.build_normal_equations(
        spec, arrays, tsolver._static_idx(oi["board"]))(b0, arrays)
    step = tsolver._delta_to_b(*tsolver.schur_step(ne, 1e-4, spec)[:3],
                               spec)
    _allclose(res[0]["step"], (b0 + step).numpy(), 1e-9)


# ----------------------------------------------------------------------------
# optimize(mesh=...)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name,tol", [("board_outliers", 1e-9),
                                      ("splined", 1e-7)])
def test_optimize_mesh_matches_jax_and_unsharded(world, port, jax_ref, name,
                                                 tol):
    """optimize(mesh=size) on every rank: the JAX package's optimize(mesh=2)
    rms, and the unsharded optimize()'s outliers (six gross corners;
    padding rows never count), marks and solution (b 1e-5, as a
    converged solve against the JAX package's)."""
    _, res = world
    o, ref = res[0]["optimize"][name], port["optimize"][name]
    rms = o["stats"]["rms_reproj_error__pixels"]
    rms_j = jax_ref["optimize"][name]["rms_reproj_error__pixels"]
    assert abs(rms - rms_j) <= tol * rms_j
    for k in ("Noutliers", "Noutliers_triangulated_point"):
        assert o["stats"][k] == ref["stats"][k] == \
            jax_ref["optimize"][name][k], k
    if name == "board_outliers":
        assert o["stats"]["Noutliers"] >= 6
    assert np.array_equal(o["oi"]["observations_board"][..., 2],
                          ref["oi"]["observations_board"][..., 2])
    _allclose(o["stats"]["b_packed"], ref["stats"]["b_packed"], 1e-5)


def test_optimize_mesh_mixed_precision(world, port):
    """The mixed pipeline through the mesh (an f32 solve, then the f64
    polish, both sharded) reaches the unsharded f64 solve's rms (1e-9)."""
    _, res = world
    rms = np.sqrt(port["solve"]["board_converged"]["E"]
                  / convert.from_reference(
                      board_oi(), device="cpu")[0].Nmeasurements)
    assert abs(res[0]["mixed"] - rms) <= 1e-9 * rms
    for r in res[1:]:
        assert r["mixed"] == res[0]["mixed"]


def test_dryrun_ranks(world):
    """dryrun_multichip's rank: 3 iterations of an OPENCV8 and a splined
    problem, finite, the same on every rank."""
    _, res = world
    for r in res:
        assert r["dryrun"] == res[0]["dryrun"]
        for name in ("opencv8", "splined"):
            assert r["dryrun"][name]["niterations"] >= 1
            assert np.isfinite(r["dryrun"][name]["E"])
