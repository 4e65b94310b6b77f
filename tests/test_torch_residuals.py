"""The port's layout, packing and residual vector against the JAX package,
on __graft_entry__._make_problem() (boards) and on a small discrete-point
problem: index values exactly, residuals at 1e-12.  Also: the port's
problem builder reproduces the JAX one."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__
from mrcal_tpu.optimize import layout as jlayout
from mrcal_tpu.optimize import residuals as jres
from mrcal_tpu_torch.optimize import layout as tlayout
from mrcal_tpu_torch.optimize import residuals as tres
from mrcal_tpu_torch import convert, problems

from test_sfm_points import make_sfm_scene
# the JAX references' helpers, which other port test modules import from
# here too
from jax_references import (compile_jax_transforms,  # noqa: F401
                            jax_reference_pool, share_jax_evaluations)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """torch on one thread for the port's CPU tests (every port test
    module imports this fixture).  The suite runs in parallel worker
    processes, about one per core, and torch's default of a thread per
    core in each of them oversubscribes the cores: the small solves ran
    up to 10x slower in the suite than in one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def point_problem_oi():
    """A discrete-point problem as tests/test_sfm_points.py builds it,
    with noise, fixed points and the intrinsics core optimized."""
    scene = make_sfm_scene(sigma=0.2, seed=2)
    rng = np.random.default_rng(3)
    pts = scene["points_true"].copy()
    Nfix = scene["Npoints_fixed"]
    pts[:len(pts) - Nfix] += rng.normal(size=(len(pts) - Nfix, 3)) * 0.03
    ext = scene["extrinsics_true"] + \
        rng.normal(size=scene["extrinsics_true"].shape) * 0.005
    return dict(
        intrinsics=scene["intrinsics"].copy(),
        extrinsics_rt_fromref=ext,
        points=pts,
        observations_point=scene["observations_point"].copy(),
        indices_point_camintrinsics_camextrinsics=scene["indices_point"],
        lensmodel=scene["lensmodel"],
        imagersizes=scene["imagersizes"],
        Npoints_fixed=Nfix,
        do_optimize_intrinsics_core=True,
        do_optimize_intrinsics_distortions=False,
        do_apply_outlier_rejection=False,
    )


@pytest.fixture(scope="module")
def board_oi():
    return __graft_entry__._make_problem()[0]


@pytest.fixture(scope="module")
def point_oi():
    return point_problem_oi()


@pytest.fixture(scope="module")
def problems_oi(board_oi, point_oi):
    return dict(board=board_oi, point=point_oi)


def test_problem_builder_matches_jax(board_oi):
    oi_t = problems.make_problem(device="cpu")[0]
    assert set(oi_t) == set(board_oi)
    for k, v in board_oi.items():
        if isinstance(v, np.ndarray):
            assert v.shape == oi_t[k].shape, k
            assert np.allclose(oi_t[k], v, rtol=1e-12, atol=1e-12), k
        else:
            assert oi_t[k] == v, k


INDEX_FNS = ["num_states", "num_states_intrinsics", "num_states_extrinsics",
             "num_states_frames", "num_states_points",
             "num_states_calobject_warp", "num_measurements",
             "num_measurements_boards", "num_measurements_points",
             "num_measurements_regularization",
             "state_index_calobject_warp",
             "measurement_index_regularization"]
INDEXED_FNS = ["state_index_intrinsics", "state_index_extrinsics",
               "state_index_frames", "state_index_points",
               "measurement_index_boards", "measurement_index_points"]


@pytest.mark.parametrize("which", ["board", "point"])
def test_spec_and_indices_match_jax(problems_oi, which):
    oi = problems_oi[which]
    sj = jlayout.spec_from_inputs(**oi)
    st = tlayout.spec_from_inputs(**oi)
    for attr in ("Nstate", "Nmeasurements", "Nintrinsics_state_per_cam",
                 "Npoints_variable", "num_measurements_regularization"):
        assert getattr(st, attr) == getattr(sj, attr), attr
    assert np.array_equal(st.scales(), sj.scales())
    for name in INDEX_FNS:
        assert getattr(tlayout, name)(**oi) == getattr(jlayout, name)(**oi), \
            name
    for name in INDEXED_FNS:
        for i in range(3):
            assert getattr(tlayout, name)(i, **oi) == \
                getattr(jlayout, name)(i, **oi), (name, i)


@pytest.mark.parametrize("which", ["board", "point"])
def test_pack_split_and_residuals_match_jax(problems_oi, which):
    oi = problems_oi[which]
    sj = jlayout.spec_from_inputs(**oi)
    arr_j = jres.arrays_from_inputs(**oi)
    b_j = np.asarray(jres.pack_params(jres.params_from_arrays(arr_j), sj))

    st, arr_t, b_t = convert.from_reference(oi, device="cpu")
    assert np.abs(b_t.numpy() - b_j).max() <= 1e-12 * np.abs(b_j).max()

    # a state away from the inputs, fed to both
    b = b_j + np.random.default_rng(5).normal(size=b_j.shape) * 1e-3
    pj = jres.split_packed_state(jnp.asarray(b), arr_j, sj)
    pt = tres.split_packed_state(torch.as_tensor(b), arr_t, st)
    for k in pt:
        assert np.allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=1e-14,
                           atol=0), k
    assert np.allclose(tres.pack_params(pt, st).numpy(), b, rtol=1e-14,
                       atol=1e-14)

    xj = np.asarray(jres.residuals_from_packed(jnp.asarray(b), arr_j, sj))
    xt = tres.residuals_from_packed(torch.as_tensor(b), arr_t, st).numpy()
    assert xt.shape == (st.Nmeasurements,)
    assert np.abs(xt - xj).max() <= 1e-12 * max(1.0, np.abs(xj).max())


def test_triangulated_inputs_raise(board_oi):
    """A triangulated point must be observed at least twice: point 1 of
    these is seen once, and both layouts refuse it."""
    oi = dict(board_oi,
              observations_point_triangulated=np.zeros((3, 3)),
              indices_point_triangulated_camintrinsics_camextrinsics=np.array(
                  [[0, 0, -1], [0, 0, 0], [1, 0, 0]], np.int32))
    for layout in (tlayout, jlayout):
        with pytest.raises(ValueError, match="at least twice"):
            layout.spec_from_inputs(**oi)
