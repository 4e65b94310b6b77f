"""SfM with the points in the state (sfm_points) on the CPU: the port's
builder, its normal equations, optimize() and optimizer_callback against
the JAX package's, in float64.

The problems: ``problems.sfm_points`` at 400 observations (6 frames of
camera 0 of stereo_opencv8_2cam flying over 100 ground features, the last
4 of them fixed), and tests/test_sfm_points.py's two scenes (3 PINHOLE
cameras, 40 points; noiseless and with 0.2 px of noise).  The JAX
package's solves run in spawned processes (jax_reference_pool), one per
problem, all started when the module's fixture is first used.
"""

import copy

import numpy as np
import pytest

from mrcal_tpu_torch import convert
from mrcal_tpu_torch import optimize as t_optimize
from mrcal_tpu_torch import optimizer_callback as t_callback
from mrcal_tpu_torch import R_from_r, problems
from mrcal_tpu_torch.optimize import solver as tsolver
from mrcal_tpu_torch.optimize import spec_from_inputs

from jax_references import jax_reference_pool, sfm_points_reference
from test_torch_residuals import torch_threads  # noqa: F401

# the builder at the size of the CPU tests
SMALL = dict(Nobservations_total=400, Nobservations_image=40)
SCENES = ("sfm_points_400", "noisy", "noiseless")


@pytest.fixture(scope="module")
def references():
    """Each scene's inputs, and the JAX package's normal equations at them
    and solve of them (the 400-observation scene's optimizer_callback
    too); "noisy_core", the noisy scene with the intrinsics core
    optimized, only the normal equations."""
    oi, truth = problems.sfm_points(**SMALL, device="cpu")
    with jax_reference_pool(len(SCENES) + 1) as pool:
        futures = dict(
            sfm_points_400=pool.submit(sfm_points_reference, oi, True),
            noisy_core=pool.submit(sfm_points_reference, "noisy_core",
                                   solve=False),
            **{name: pool.submit(sfm_points_reference, name)
               for name in SCENES[1:]})
        return {name: f.result() for name, f in futures.items()}


def _close(a, b, tol):
    """|a - b| <= tol * max(1, max|b|)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max()))
    assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max()


@pytest.mark.parametrize("scene", SCENES + ("noisy_core",))
def test_normal_equations_match_jax(references, scene):
    """The point rows' one scatter per block kind against the JAX
    package's normal equations, each entry to 1e-12 of its array's
    largest."""
    oi, ref = references[scene]
    spec, arrays, b0 = convert.from_reference(oi, device="cpu")
    static_idx = dict(
        board=np.zeros((0, 3), np.int64),
        point=oi["indices_point_camintrinsics_camextrinsics"])
    ne = tsolver.build_normal_equations(spec, arrays, static_idx)(b0,
                                                                  arrays)
    assert set(ne) == set(ref["ne"])
    for k, v in ne.items():
        r = ref["ne"][k]
        assert v.shape == r.shape, k
        if r.size:
            assert np.abs(v.numpy() - r).max() <= \
                1e-12 * max(np.abs(r).max(), 1e-300), k
    if scene == "noisy_core":
        assert spec.Nintrinsics_state_per_cam == 4


@pytest.mark.parametrize("scene", SCENES)
def test_optimize_f64_matches_jax(references, scene):
    """The whole point solve against the JAX package's, with
    test_torch_solver.py's gates: rms 1e-10 relative (1e-10 px on the
    noiseless scene, whose rms is roundoff), b_packed 1e-5 (the roundoff
    tail's steps), the residuals 1e-3 px; the fixed points unmoved."""
    oi, ref = references[scene]
    oi_t = copy.deepcopy(oi)
    stats = t_optimize(device="cpu", precision="f64", **oi_t)
    rms_t = stats["rms_reproj_error__pixels"]
    if scene == "noiseless":
        assert abs(rms_t - ref["rms"]) <= 1e-10
        assert rms_t < 1e-6
    else:
        assert abs(rms_t - ref["rms"]) <= 1e-10 * ref["rms"]
    assert np.abs(stats["b_packed"] - ref["b_packed"]).max() < 1e-5
    _close(stats["x"], ref["x"], 1e-3)
    Nfix = oi["Npoints_fixed"]
    assert np.array_equal(oi_t["points"][-Nfix:], oi["points"][-Nfix:])
    assert not np.array_equal(oi_t["points"][:-Nfix], oi["points"][:-Nfix])
    _close(oi_t["points"], ref["points"], 1e-5)
    _close(oi_t["extrinsics_rt_fromref"], ref["extrinsics_rt_fromref"],
           1e-5)


def test_optimizer_callback_matches_jax(references):
    """b, x and J (the point columns too) against the JAX package's
    optimizer_callback on the 400-observation scene: the same sparse
    structure, the values to 1e-12 of the largest entry."""
    oi, ref = references["sfm_points_400"]
    cb = ref["callback"]
    b, x, J = t_callback(device="cpu", **copy.deepcopy(oi))
    J = J.tocsr()
    J.sort_indices()
    spec = spec_from_inputs(**oi)
    assert J.shape == cb["shape"] == (spec.Nmeasurements, spec.Nstate)
    assert np.array_equal(J.indptr, cb["indptr"])
    assert np.array_equal(J.indices, cb["indices"])
    for a, r in ((b, cb["b"]), (x, cb["x"]), (J.data, cb["data"])):
        assert np.abs(a - r).max() <= 1e-12 * np.abs(r).max()
    # every observation's row has its 3 point columns, unless the point is
    # fixed, and its 6 extrinsics columns, unless its frame is the
    # reference
    ip, _, ie = oi["indices_point_camintrinsics_camextrinsics"].T
    per_row = np.diff(J.indptr).reshape(-1, 2)
    want = 3 * (ip < spec.Npoints_variable) + 6 * (ie >= 0)
    assert np.array_equal(per_row, np.stack([want, want], axis=1))


def test_builder_invariants():
    """problems.sfm_points at 400 observations: 6 frames and 100 points,
    every kept frame and point observed, the fixed points last and at the
    truth, the variable ones perturbed, and zero residuals at the truth
    before the noise."""
    oi, truth = problems.sfm_points(**SMALL, device="cpu")
    idx = oi["indices_point_camintrinsics_camextrinsics"]
    Npoints, Nframes = len(oi["points"]), len(oi["extrinsics_rt_fromref"]) + 1
    assert (Nframes, Npoints) == (6, 100)
    assert np.array_equal(np.unique(idx[:, 0]), np.arange(Npoints))
    assert np.array_equal(np.unique(idx[:, 2]), np.arange(-1, Nframes - 1))
    assert (idx[:, 1] == 0).all()
    assert np.array_equal(np.diff(idx[:, 0]) >= 0, np.ones(len(idx) - 1,
                                                           bool))
    Nfix = oi["Npoints_fixed"]
    assert Nfix == problems.SFM_POINTS["Npoints_fixed"] == 4
    assert np.array_equal(oi["points"][-Nfix:], truth["points"][-Nfix:])
    assert (oi["points"][:-Nfix] != truth["points"][:-Nfix]).all()
    # the poses are perturbed about each frame's own center: the centers
    # move by perturbed_oi's 1e-2 m draws, not by their distance from the
    # reference times the rotation draws
    centers = [-np.einsum("nji,nj->ni",
                          np.asarray(R_from_r(rt[:, :3], device="cpu")),
                          rt[:, 3:])
               for rt in (oi["extrinsics_rt_fromref"],
                          truth["extrinsics_rt_fromref"])]
    moved = np.linalg.norm(centers[0] - centers[1], axis=-1)
    assert 0 < moved.max() < 0.06
    assert oi["do_optimize_intrinsics_core"] is False
    assert oi["do_optimize_intrinsics_distortions"] is False
    assert oi["do_apply_outlier_rejection"] is False
    spec = spec_from_inputs(**oi)
    assert (spec.Nmeasurements, spec.Nstate) == (
        2 * len(idx), 6 * (Nframes - 1) + 3 * (Npoints - Nfix))

    exact, _ = problems.sfm_points(**SMALL, noise_px=0.0, device="cpu")
    exact.update(points=truth["points"],
                 extrinsics_rt_fromref=truth["extrinsics_rt_fromref"])
    _, x, _ = t_callback(device="cpu", no_jacobian=True, **exact)
    assert np.abs(x).max() < 1e-8
    # the noise: N(0, noise_px) on every coordinate, and nothing else
    assert np.array_equal(oi["observations_point"][:, 2], np.ones(len(idx)))
    d = oi["observations_point"][:, :2] - exact["observations_point"][:, :2]
    assert 0.25 < np.std(d) < 0.35
