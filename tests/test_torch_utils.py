"""The rest of the port's utils against the JAX package's, on the CPU:
sorted_eig, apply_homography, ingest_packed_state,
hypothesis_board_corner_positions, the measurements_* and residuals_*
views of a problem's measurement vector at 1e-12; close_contour,
_splined_stereographic_domain, the plotoptions_* helpers and
mapping_file_framenocameraindex exactly; write_point_cloud_as_ply
byte for byte; polygon_difference without shapely raising
NotImplementedError as the JAX package's does."""

import numpy as np
import pytest

import mrcal_tpu
from mrcal_tpu import utils as jutils
import mrcal_tpu_torch
from mrcal_tpu_torch import problems as tproblems
from mrcal_tpu_torch.optimize.layout import spec_from_inputs
from mrcal_tpu_torch import utils as tutils

from test_torch_residuals import point_problem_oi
from test_torch_residuals import torch_threads  # noqa: F401


def _copy(oi):
    return {k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in oi.items()}


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if b.size:
        assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max())


@pytest.fixture(scope="module")
def board_oi():
    """Two cameras, 4 frames of a 6 x 5 board, a few outliers."""
    oi = tproblems.make_problem(Ncameras=2, Nframes=4, W=6, H=5,
                                model="LENSMODEL_OPENCV4", device="cpu")[0]
    oi["observations_board"][1, 2, 3, 2] = -1.0
    return oi


def test_sorted_eig_matches_jax():
    """Ascending eigenvalues at 1e-12, and the same eigenvectors up to
    sign, of a batch of symmetric matrices."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(3, 5, 5))
    M = A + A.transpose(0, 2, 1)
    l_t, v_t = tutils.sorted_eig(M, device="cpu")
    l_j, v_j = jutils.sorted_eig(M)
    _close(l_t.numpy(), l_j)
    assert np.all(np.diff(l_t.numpy(), axis=-1) > 0)
    _close(np.abs(np.einsum("bij,bij->bj", v_t.numpy(), np.asarray(v_j))),
           np.ones((3, 5)))


def test_apply_homography_matches_jax():
    """Broadcasting over both arguments."""
    rng = np.random.default_rng(1)
    H = np.eye(3) + rng.normal(size=(2, 1, 3, 3)) * 0.05
    v = rng.uniform(0, 800, size=(4, 2))
    got = tutils.apply_homography(H, v, device="cpu")
    assert got.shape == (2, 4, 2)
    _close(got.numpy(), jutils.apply_homography(H, v))


def test_ingest_packed_state_matches_jax(board_oi):
    """A packed state written into copies of the inputs: every array the
    same as the JAX package writes (1e-12)."""
    spec = spec_from_inputs(**board_oi)
    b = np.random.default_rng(2).normal(size=spec.Nstate) * 0.1
    oi_t, oi_j = _copy(board_oi), _copy(board_oi)
    tutils.ingest_packed_state(b, device="cpu", **oi_t)
    jutils.ingest_packed_state(b, **oi_j)
    for k in ("intrinsics", "extrinsics_rt_fromref", "frames_rt_toref",
              "calobject_warp"):
        _close(oi_t[k], oi_j[k])
        assert not np.array_equal(oi_t[k], board_oi[k])


@pytest.mark.parametrize("icam", [None, 1])
def test_hypothesis_board_corner_positions_matches_jax(board_oi, icam):
    got = tutils.hypothesis_board_corner_positions(icam, device="cpu",
                                                   **board_oi)
    want = jutils.hypothesis_board_corner_positions(icam, **board_oi)
    for a, b in zip(got[:2], want[:2]):
        assert a.device.type == "cpu"
        _close(a.numpy(), b)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("what", ["board", "point"])
def test_measurements_match_jax(board_oi, what):
    """measurements_* and residuals_* from the problem's own measurement
    vector (x=None) and from a given x, with and without the
    observations."""
    oi = board_oi if what == "board" else point_problem_oi()
    fns = [(getattr(tutils, f"{k}_{what}"), getattr(jutils, f"{k}_{what}"))
           for k in ("measurements", "residuals")]
    want = fns[0][1](_copy(oi))
    _close(fns[0][0](_copy(oi), device="cpu"), want)
    x = np.arange(spec_from_inputs(
        **oi).Nmeasurements, dtype=float)
    for t, j in fns:
        got, obs = t(oi, x=x, return_observations=True)
        want, obs_j = j(oi, x=x, return_observations=True)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(obs, obs_j)


def test_contours_domain_and_plot_helpers_match_jax(board_oi):
    c = np.array([[0., 0.], [1., 0.], [1., 1.]])
    for contour in (c, np.vstack([c, c[:1]]), np.zeros((0, 2)), None):
        got, want = tutils.close_contour(contour), jutils.close_contour(
            contour)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    for model in ("LENSMODEL_SPLINED_STEREOGRAPHIC_order=3_Nx=30_Ny=18_"
                  "fov_x_deg=150",
                  "LENSMODEL_SPLINED_STEREOGRAPHIC_order=2_Nx=8_Ny=6_"
                  "fov_x_deg=100"):
        _close(tutils._splined_stereographic_domain(model),
               jutils._splined_stereographic_domain(model), 1e-15)
    for oi in (board_oi, point_problem_oi()):
        for k in ("plotoptions_state_boundaries",
                  "plotoptions_measurement_boundaries"):
            assert getattr(tutils, k)(**oi) == getattr(jutils, k)(**oi)
    files = (["cam0/frame001.png", "cam0/frame17.png", "none.png"],
             ["left-0003.jpg"])
    assert tutils.mapping_file_framenocameraindex(*files) == \
        jutils.mapping_file_framenocameraindex(*files)
    with pytest.raises(NotImplementedError, match="shapely"):
        tutils.polygon_difference(c, c * 0.5)
    with pytest.raises(NotImplementedError, match="shapely"):
        jutils.polygon_difference(c, c * 0.5)


@pytest.mark.parametrize("binary,color", [(True, False), (True, True),
                                          (False, False)])
def test_write_point_cloud_as_ply_matches_jax(tmp_path, binary, color):
    rng = np.random.default_rng(3)
    points = rng.normal(size=(2, 5, 3))
    rgb = rng.integers(0, 256, size=(10, 3)) if color else None
    paths = [str(tmp_path / f"{n}.ply") for n in ("t", "j")]
    tutils.write_point_cloud_as_ply(paths[0], points, color=rgb,
                                    binary=binary)
    jutils.write_point_cloud_as_ply(paths[1], points, color=rgb,
                                    binary=binary)
    t, j = (open(p, "rb").read() for p in paths)
    assert t == j and len(t) > 100


def test_utils_names_are_exported():
    for name in ("sorted_eig", "apply_homography", "ingest_packed_state",
                 "hypothesis_board_corner_positions", "measurements_board",
                 "residuals_board", "measurements_point", "residuals_point",
                 "close_contour", "polygon_difference",
                 "write_point_cloud_as_ply", "plotoptions_state_boundaries",
                 "plotoptions_measurement_boundaries",
                 "mapping_file_framenocameraindex"):
        assert getattr(mrcal_tpu_torch, name) is getattr(tutils, name)
        assert hasattr(mrcal_tpu, name)
