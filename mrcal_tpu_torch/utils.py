"""General geometry and analysis helpers, in PyTorch: Procrustes fits,
imager sampling, eigendecomposition, homographies, a solution's board
corners and measurements, and the host-side helpers of the tools.

Counterpart of ``mrcal_tpu/utils.py``.  The functions of tensors take
numpy arrays or tensors, run on the card unless given ``device="cpu"``,
and return tensors; so do the ones that evaluate a problem
(``ingest_packed_state``, ``hypothesis_board_corner_positions``,
``measurements_*``).  The file, plotting and polygon helpers are numpy.
"""

import re

import numpy as np
import torch

from ._config import resolve_device
from .poseutils import _as_tensors


def _proper_rotation(M):
    """The rotation nearest M (...,3,3) in the Frobenius sense: U D Vt from
    M's SVD, with D = diag(1, 1, det(U Vt)) so that det(R) = +1."""
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.cat([torch.ones(det.shape + (2,), dtype=M.dtype,
                              device=M.device), det[..., None]], dim=-1)
    return torch.einsum("...ik,...k,...kj->...ij", U, D, Vt)


def _align_procrustes_points_Rt01(p0, p1, weights):
    w = (weights / torch.sum(weights, dim=-1, keepdim=True))[..., None]
    c0 = torch.sum(p0 * w, dim=-2)
    c1 = torch.sum(p1 * w, dim=-2)
    M = torch.einsum("...ni,...nj,...n->...ij", p0 - c0[..., None, :],
                     p1 - c1[..., None, :], weights)
    R = _proper_rotation(M)
    t = c0 - torch.einsum("...ij,...j->...i", R, c1)
    return torch.cat([R, t[..., None, :]], dim=-2)


def _align_procrustes_vectors_R01(v0, v1, weights):
    v0 = v0 / torch.linalg.vector_norm(v0, dim=-1, keepdim=True)
    v1 = v1 / torch.linalg.vector_norm(v1, dim=-1, keepdim=True)
    return _proper_rotation(torch.einsum("...ni,...nj,...n->...ij", v0, v1,
                                         weights))


def align_procrustes_points_Rt01(p0, p1, weights=None, *, device=None):
    """Rt01 (...,4,3) minimizing sum w_i |p0_i - (R p1_i + t)|^2 over the
    points (...,N,3): the Kabsch fit, without scale."""
    p0, p1, weights = _as_tensors(device, p0, p1, weights)
    if weights is None:
        weights = torch.ones(p0.shape[:-1], dtype=p0.dtype, device=p0.device)
    return _align_procrustes_points_Rt01(p0, p1, weights)


def align_procrustes_vectors_R01(v0, v1, weights=None, *, device=None):
    """The rotation R01 (...,3,3) that best maps the directions v1 onto v0
    (...,N,3)."""
    v0, v1, weights = _as_tensors(device, v0, v1, weights)
    if weights is None:
        weights = torch.ones(v0.shape[:-1], dtype=v0.dtype, device=v0.device)
    return _align_procrustes_vectors_R01(v0, v1, weights)


def sample_imager(gridn_width, gridn_height, imager_width, imager_height, *,
                  device=None):
    """A regular pixel grid over the imager: (gridn_height, gridn_width,
    2), corner pixels included.  gridn_height None: the imager's aspect
    ratio, rounded."""
    if gridn_height is None:
        gridn_height = int(round(imager_height / imager_width * gridn_width))
    x = np.linspace(0, imager_width - 1, gridn_width)
    y = np.linspace(0, imager_height - 1, gridn_height)
    (q,) = _as_tensors(device, np.stack(np.meshgrid(x, y), axis=-1))
    return q


def sample_imager_unproject(gridn_width, gridn_height, imager_width,
                            imager_height, lensmodel, intrinsics_data,
                            normalize=False, *, device=None):
    """The sample_imager grid q and its unprojection v: returns (v, q)."""
    from .projections import unproject
    q = sample_imager(gridn_width, gridn_height, imager_width, imager_height,
                      device=device)
    return unproject(q, lensmodel, intrinsics_data, normalize=normalize,
                     device=q.device), q


def sorted_eig(M, *, device=None):
    """The eigenvalues (ascending) and eigenvectors of the symmetric M
    (..., n, n)."""
    (M,) = _as_tensors(device, M)
    return torch.linalg.eigh(M)


def apply_homography(H, v, *, device=None):
    """The 3x3 homography H (..., 3, 3) applied to the 2D points v (...,
    2), broadcasting over both -> (..., 2)."""
    H, v = _as_tensors(device, H, v)
    xyz = torch.einsum("...ij,...j->...i", H[..., :, :2], v) + H[..., :, 2]
    return xyz[..., :2] / xyz[..., 2:3]


def _problem(optimization_inputs, device):
    """(normalized inputs, spec, arrays on device, parameter dict)."""
    from .optimize.layout import normalize_inputs, spec_from_inputs
    from .optimize.residuals import arrays_from_inputs, params_from_arrays
    kw = normalize_inputs(optimization_inputs)
    spec = spec_from_inputs(**kw)
    arrays = arrays_from_inputs(kw, device=resolve_device(device))
    return kw, spec, arrays, params_from_arrays(arrays)


def ingest_packed_state(b_packed, *, device=None, **optimization_inputs):
    """Write the packed state b_packed into the optimization_inputs'
    arrays (intrinsics, extrinsics, frames, points and, if it is state,
    the board warp), in place.  The unpacking runs on `device`."""
    from .optimize.residuals import split_packed_state
    _, spec, arrays, _ = _problem(optimization_inputs, device)
    (b,) = _as_tensors(arrays["intrinsics"].device,
                       np.asarray(b_packed, np.float64))
    params = split_packed_state(b, arrays, spec)

    def put(name, key):
        a = optimization_inputs.get(name)
        if a is not None and np.asarray(a).size:
            np.copyto(np.asarray(a), params[key].cpu().numpy())

    put("intrinsics", "intrinsics")
    put("extrinsics_rt_fromref", "extrinsics")
    put("frames_rt_toref", "frames")
    put("points", "points")
    if optimization_inputs.get("calobject_warp") is not None \
            and spec.has_calobject_warp:
        np.copyto(np.asarray(optimization_inputs["calobject_warp"]),
                  params["calobject_warp"].cpu().numpy())


def hypothesis_board_corner_positions(icam_intrinsics=None,
                                      idx_inliers=None, *, device=None,
                                      **optimization_inputs):
    """The board corners that the solution in optimization_inputs implies,
    for the observations of camera icam_intrinsics (None: every
    observation): returns (p_cam (Nobs, H, W, 3) in each observation's
    camera, p_ref (Nobs, H, W, 3) in the reference frame, tensors on
    `device`; weights (Nobs, H, W) and the observations' indices (Nobs,
    3), numpy).  idx_inliers is not used."""
    from .optimize.residuals import board_points_ref
    from .poseutils import _compose_rt2, _transform_point_rt
    _, spec, arrays, params = _problem(optimization_inputs, device)
    idx = arrays["indices_board"].cpu().numpy()
    obs = arrays["observations_board"].cpu().numpy()
    sel = (np.ones(len(idx), bool) if icam_intrinsics is None
           else idx[:, 1] == icam_intrinsics)
    idx, obs = idx[sel], obs[sel]
    ifr, ici, ice = (torch.as_tensor(idx[:, i], device=params[
        "frames"].device) for i in range(3))
    ext_pad = torch.cat([params["extrinsics"].new_zeros((1, 6)),
                         params["extrinsics"]], dim=0)
    pts = board_points_ref(spec, params["calobject_warp"])[None]
    p_ref = _transform_point_rt(params["frames"][ifr][:, None, None, :], pts)
    rt_joint = _compose_rt2(ext_pad[ice + 1], params["frames"][ifr])
    p_cam = _transform_point_rt(rt_joint[:, None, None, :], pts)
    return p_cam, p_ref, obs[..., 2], idx


def _measurements(optimization_inputs, x, device, what):
    """A block of the measurement vector x (None: optimizer_callback's x
    at the inputs' state, evaluated on `device`) and the inputs' spec."""
    from .optimize.jacobian import optimizer_callback
    from .optimize.layout import normalize_inputs, spec_from_inputs
    kw = normalize_inputs(optimization_inputs)
    spec = spec_from_inputs(**kw)
    if x is None:
        _, x, _ = optimizer_callback(no_jacobian=True, device=device, **kw)
    x = np.asarray(x)
    if what == "board":
        i0, n = 0, spec.num_measurements_boards
    else:
        i0, n = spec.measurement_index_points0, spec.num_measurements_points
    return kw, spec, x[i0:i0 + n]


def measurements_board(optimization_inputs, *, x=None,
                       return_observations=False, device=None):
    """The board measurements (Nobs, H, W, 2) of the measurement vector x
    (None: the inputs' own, evaluated on `device`), numpy; and the
    observations with return_observations."""
    kw, spec, xb = _measurements(optimization_inputs, x, device, "board")
    xb = xb.reshape(-1, spec.calibration_object_height_n,
                    spec.calibration_object_width_n, 2)
    if return_observations:
        return xb, np.asarray(kw["observations_board"])
    return xb


def residuals_board(optimization_inputs, *, x=None,
                    return_observations=False, device=None):
    """measurements_board: the measurements are the weighted residuals."""
    return measurements_board(optimization_inputs, x=x,
                              return_observations=return_observations,
                              device=device)


def measurements_point(optimization_inputs, *, x=None,
                       return_observations=False, device=None):
    """The point measurements (Nobs, 2) of the measurement vector x, as
    measurements_board."""
    kw, _, xp = _measurements(optimization_inputs, x, device, "point")
    xp = xp.reshape(-1, 2)
    if return_observations:
        return xp, np.asarray(kw["observations_point"])
    return xp


def residuals_point(optimization_inputs, *, x=None,
                    return_observations=False, device=None):
    """measurements_point."""
    return measurements_point(optimization_inputs, x=x,
                              return_observations=return_observations,
                              device=device)


def close_contour(c):
    """The polyline c (N, 2) closed: its first point appended unless it
    already ends there."""
    if c is None:
        return None
    c = np.asarray(c)
    if len(c) == 0 or np.linalg.norm(c[0] - c[-1]) < 1e-12:
        return c
    return np.concatenate([c, c[:1]], axis=0)


def polygon_difference(positive, negative):
    """The polygon positive less negative, as a list of polygons (N, 2):
    shapely's difference; without shapely this raises
    NotImplementedError."""
    try:
        from shapely.geometry import Polygon
    except ImportError:
        raise NotImplementedError(
            "polygon_difference requires shapely in this build")
    d = Polygon(np.asarray(positive)).difference(
        Polygon(np.asarray(negative)))
    return [np.asarray(g.exterior.coords) for g in getattr(d, "geoms", [d])
            if g.exterior is not None]


def _splined_stereographic_domain(lensmodel):
    """The closed boundary (5, 2) of a splined model's valid domain in
    normalized stereographic coordinates: half a knot interval in from
    the edge knots for order 2, one knot in for order 3."""
    from .lensmodels import knots_for_splined_models, parse_lensmodel
    lm = parse_lensmodel(lensmodel)
    ux, uy = (u.numpy() for u in knots_for_splined_models(lm))
    if lm.order == 2:
        x0, x1 = (ux[0] + ux[1]) / 2, (ux[-2] + ux[-1]) / 2
        y0, y1 = (uy[0] + uy[1]) / 2, (uy[-2] + uy[-1]) / 2
    else:
        x0, x1 = ux[1], ux[-2]
        y0, y1 = uy[1], uy[-2]
    return np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1], [x0, y0]])


def write_point_cloud_as_ply(filename, points, *, color=None,
                             binary=True):
    """Write the points (..., 3) as a .ply point cloud, float32 xyz with
    uchar rgb if color (..., 3) is given; binary little-endian or
    ascii."""
    points = np.asarray(points).reshape(-1, 3)
    n = len(points)
    hdr = ["ply",
           "format binary_little_endian 1.0" if binary
           else "format ascii 1.0",
           f"element vertex {n}",
           "property float x", "property float y", "property float z"]
    if color is not None:
        hdr += ["property uchar red", "property uchar green",
                "property uchar blue"]
    header = "\n".join(hdr + ["end_header"]) + "\n"
    with open(filename, "wb" if binary else "w") as f:
        if not binary:
            f.write(header)
            for p in points:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
            return
        f.write(header.encode())
        if color is None:
            points.astype(np.float32).tofile(f)
            return
        rec = np.zeros(n, dtype=[("xyz", np.float32, 3),
                                 ("rgb", np.uint8, 3)])
        rec["xyz"] = points.astype(np.float32)
        rec["rgb"] = np.asarray(color).reshape(-1, 3)
        rec.tofile(f)


def plotoptions_state_boundaries(**optimization_inputs):
    """The first state index of each block of the state vector, for
    marking plots: {'boundaries', 'labels', 'Nstate'}."""
    from .optimize.layout import spec_from_inputs
    spec = spec_from_inputs(**optimization_inputs)
    labels = ["intrinsics", "extrinsics", "frames", "points",
              "calobject_warp"]
    return dict(boundaries=[getattr(spec, f"state_index_{k}0")
                            for k in labels],
                labels=labels, Nstate=spec.Nstate)


def plotoptions_measurement_boundaries(**optimization_inputs):
    """The first measurement index of each block of the measurement
    vector: {'boundaries', 'labels', 'Nmeasurements'}."""
    from .optimize.layout import spec_from_inputs
    spec = spec_from_inputs(**optimization_inputs)
    return dict(
        boundaries=[spec.measurement_index_boards0,
                    spec.measurement_index_points0,
                    spec.measurement_index_points_triangulated0,
                    spec.measurement_index_regularization0],
        labels=["boards", "points", "triangulated", "regularization"],
        Nmeasurements=spec.Nmeasurements)


def mapping_file_framenocameraindex(*files_per_camera):
    """{image file name: (frame number, camera index)} for one list of
    file names per camera; the frame number is the first run of digits in
    the name (0 without one)."""
    mapping = {}
    for icam, files in enumerate(files_per_camera):
        for f in files:
            m = re.search(r"[0-9]+", f)
            mapping[f] = (int(m.group(0)) if m else 0, icam)
    return mapping
