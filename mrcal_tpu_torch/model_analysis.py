"""Uncertainty of a calibration, and differences between models, in
PyTorch.

Counterpart of ``mrcal_tpu/model_analysis.py``.  The public functions run
on the card unless given ``device="cpu"``, and return tensors there.

The uncertainty of a projection F(b) propagates the pixel noise sigma of
the observations through the solve:

    Var(F) = sigma^2 dF/db inv(JtJ) Jobs^T Jobs inv(JtJ) dF/db^T

All of it runs on the device in float64: the measurement Jacobian J (its
COO triplets from ``optimize.jacobian._jacobian_coo``, scattered into a
dense matrix), the Cholesky factor of JtJ (``CHOLMOD_factorization``,
from J's QR: JtJ itself is numerically indefinite on the bench's
opencv8_1cam), the solve against dF/db, Jobs @ A and the per-point 2x2
products.  J is
dense for Nstate <= 4096 (the JAX package's threshold): the bench
problems' J is 136 MB (opencv8_1cam) to 431 MB (splined_30x18), and the
dense products are single GEMMs.  Larger problems keep J sparse and
factor on the host with SuperLU, as the JAX package does.

The three methods differ in dF/db:

  - mean-pcam: the query point rides every frame of the perturbed solve,
    and the perturbed camera-frame points are averaged.  The dependence
    on the intrinsics and extrinsics comes from forward mode over the
    whole packed state (through ``split_packed_state``); each frame
    carries the point by its own pose only, so the frames' columns come
    from per-frame 3x6 Jacobians and the chain rule, never an
    Nstate x Nframes x Npoints tangent.
  - cross-reprojection-rrp-Jfp: the perturbation moves the reference by
    rt_ref_ref* = Kpacked_rrp db (``_drt_cross`` with icam < 0).
  - cross-reprojection-ccp: dq/db = dq/dintrinsics + dq/drt_cam*_cam*
    Kpacked_ccp.
"""

import functools
import sys

import numpy as np
import torch

from ._config import resolve_device
from .factorization import _DENSE_NSTATE_MAX, CHOLMOD_factorization
from .lensmodels import project_core, require_ported
from .optimize.jacobian import _csr, _jacobian_coo
from .optimize.layout import (camera_extrinsics_indices, normalize_inputs,
                              spec_from_inputs)
from .optimize.residuals import (_drt_cross, arrays_from_inputs,
                                 pack_params, params_from_arrays,
                                 residuals_from_packed, split_packed_state)
from .optimize.solver import _intr_scales
from .poseutils import (_as_tensors, _compose_Rt2, _Rt_from_rt,
                        _rotate_point_r, _transform_point_Rt,
                        _transform_point_rt, skew_symmetric)
from .projections import _project, _unproject
from .utils import _align_procrustes_vectors_R01, sample_imager

METHODS = ("mean-pcam", "cross-reprojection-rrp-Jfp",
           "cross-reprojection-ccp")
WHATS = ("covariance", "worstdirection-stdev", "rms-stdev")


# ----------------------------------------------------------------------------
# a solved problem on a device
# ----------------------------------------------------------------------------

class _Solved:
    """A problem at its state on one device: spec, arrays, the packed
    state b, and, each computed once on first use, its residuals x, its
    Jacobian's COO triplets, J (a dense tensor for Nstate <= 4096, else a
    scipy CSR matrix on the host) and the factorization of JtJ."""

    def __init__(self, optimization_inputs, device):
        if optimization_inputs is None:
            raise LookupError("The model has no optimization_inputs; "
                              "cannot compute uncertainty")
        self.kw = normalize_inputs(optimization_inputs)
        self.spec = spec_from_inputs(**self.kw)
        require_ported(self.spec.lensmodel)
        self.arrays = arrays_from_inputs(self.kw, device=device)
        self.b = pack_params(params_from_arrays(self.arrays), self.spec)
        self.dense = self.spec.Nstate <= _DENSE_NSTATE_MAX

    @functools.cached_property
    def x(self):
        with torch.no_grad():
            return residuals_from_packed(self.b, self.arrays, self.spec)

    @functools.cached_property
    def coo(self):
        return _jacobian_coo(self.b, self.arrays, self.spec)

    @functools.cached_property
    def J(self):
        if not self.dense:
            return _csr(self.coo, self.spec)
        rows, cols, vals = self.coo
        return self.b.new_zeros((self.spec.Nmeasurements, self.spec.Nstate)
                                ).index_put_((rows, cols), vals,
                                             accumulate=True)

    @functools.cached_property
    def factorization(self):
        return CHOLMOD_factorization(J=self.J, force_dense=self.dense,
                                     device=self.b.device)


# ----------------------------------------------------------------------------
# noise and propagation
# ----------------------------------------------------------------------------

def _observed_pixel_uncertainty(prob):
    """sigma = sqrt(E[x^2]) over the inlier board and point measurements
    at the state of the problem (a float)."""
    spec, arrays, x = prob.spec, prob.arrays, prob.x
    num = x.new_zeros(())
    cnt = x.new_zeros(())
    for n, i0, w in (
            (spec.num_measurements_boards, spec.measurement_index_boards0,
             arrays["observations_board"][..., 2]),
            (spec.num_measurements_points, spec.measurement_index_points0,
             arrays["observations_point"][..., 2])):
        if n:
            inlier = (w.reshape(-1) > 0).to(x.dtype).repeat_interleave(2)
            num = num + torch.sum(inlier * x[i0:i0 + n] ** 2)
            cnt = cnt + torch.sum(inlier)
    if float(cnt) == 0:
        raise Exception("No inlier measurements; cannot estimate noise")
    return float(torch.sqrt(num / cnt))


def _observed_pixel_uncertainty_from_inputs(optimization_inputs, x=None, *,
                                            device=None):
    """The pixel-observation noise estimated from the residuals at the
    state of optimization_inputs (x: those residuals, if known)."""
    prob = _Solved(optimization_inputs, resolve_device(device))
    if x is not None:
        (prob.x,) = _as_tensors(prob.b.device, x)
    return _observed_pixel_uncertainty(prob)


def _propagate(prob, dF, sigma):
    """Var(F) (..., n, n) from dF/db (..., n, Nstate), a tensor on the
    problem's device."""
    spec = prob.spec
    n = dF.shape[-2]
    dF2 = dF.reshape(-1, spec.Nstate)
    Nobs = spec.measurement_index_regularization0
    A = prob.factorization.solve_xt_JtJ_bt(dF2)        # (M n, Nstate)
    if prob.dense:
        M = prob.J[:Nobs] @ A.T                        # (Nobs, M n)
    else:
        M = torch.as_tensor(prob.J[:Nobs] @ A.T.cpu().numpy(),
                            device=A.device)
    M = M.reshape(Nobs, -1, n)
    Var = torch.einsum("mia,mib->iab", M, M) * sigma ** 2
    return Var.reshape(dF.shape[:-2] + (n, n))


def _check_what(what):
    if what not in WHATS:
        raise Exception(f"Unknown what='{what}'")


def _reduce(Var, what):
    """The covariance, or a scalar of it per point."""
    if what == "covariance":
        return Var
    l = torch.linalg.eigvalsh(Var)
    if what == "worstdirection-stdev":
        return torch.sqrt(torch.clamp_min(l[..., -1], 0))
    return torch.sqrt(torch.clamp_min(torch.mean(l, dim=-1), 0))


def _propagate_calibration_uncertainty(dF_dbpacked=None, x=None, J=None,
                                       factorization=None,
                                       optimization_inputs=None,
                                       observed_pixel_uncertainty=None,
                                       what="covariance", *, device=None):
    """Var(F) = sigma^2 dF/db inv(JtJ) Jobs^T Jobs inv(JtJ) dF/db^T.
    dF_dbpacked: (..., N, Nstate) -> (..., N, N) covariances, or per
    `what` a scalar of each.  x, J: the residuals and the Jacobian at the
    inputs' state, if known (J: a scipy matrix, an array or a tensor);
    factorization is accepted for the reference's signature and unused,
    as in the JAX package."""
    if optimization_inputs is None:
        raise Exception("optimization_inputs is required")
    _check_what(what)
    device = resolve_device(device)
    prob = _Solved(optimization_inputs, device)
    if x is not None:
        (prob.x,) = _as_tensors(device, x)
    if J is not None:
        if not prob.dense:
            prob.J = J.tocsr()
        else:
            (prob.J,) = _as_tensors(device, J.toarray()
                                    if hasattr(J, "toarray") else J)
    (dF,) = _as_tensors(device, dF_dbpacked)
    if dF.dim() == 1:
        dF = dF[None]
    if observed_pixel_uncertainty is None:
        observed_pixel_uncertainty = _observed_pixel_uncertainty(prob)
    return _reduce(_propagate(prob, dF, observed_pixel_uncertainty), what)


def worst_direction_stdev(cov, *, device=None):
    """sqrt of the largest eigenvalue of each (...,2,2) or (...,3,3)
    covariance."""
    (cov,) = _as_tensors(device, cov)
    return _reduce(cov, "worstdirection-stdev")


# ----------------------------------------------------------------------------
# dF/db of each method
# ----------------------------------------------------------------------------

def _dq_db(prob, p, icam, method, atinfinity):
    """dq/db (N, 2, Nstate) of the projections of the camera-frame points
    p (N, 3) of camera icam, by `method`."""
    if method == "cross-reprojection-ccp":
        return _dq_db_ccp(prob, p, icam, atinfinity)
    try:
        ices = camera_extrinsics_indices(icam, **prob.kw)
    except ValueError:
        ices = np.array([-1])
    Kp = None
    if method == "cross-reprojection-rrp-Jfp":
        if ices.size != 1:
            raise NotImplementedError(
                "cross-reprojection-rrp-Jfp handles stationary cameras "
                "only; use method='mean-pcam'")
        Kp = _drt_cross(prob.spec, prob.arrays, prob.b, -1, prob.coo)
    return _dq_db_mean_pcam(prob, p, icam, ices, atinfinity, Kp)


def _dq_db_mean_pcam(prob, p, icam, ices, atinfinity, Kp):
    """mean-pcam (Kp None) and rrp (Kp = Kpacked_rrp).  The query point
    is carried to the reference through each of the camera's Ne
    extrinsics; under mean-pcam through every frame of the perturbed
    solve (averaged over the frames), under rrp through the reference's
    implied motion; then back through the perturbed extrinsics, averaged
    over them, and projected with the perturbed intrinsics."""
    spec, arrays, b = prob.spec, prob.arrays, prob.b
    lm = spec.lensmodel

    def tx(rt, x, inverted=False):
        # at infinity only directions matter: rotate, do not translate
        if atinfinity:
            return _rotate_point_r(rt[..., :3], x, inverted)
        return _transform_point_rt(rt, x, inverted)

    at_ref = torch.as_tensor((ices < 0)[:, None], dtype=b.dtype,
                             device=b.device)
    ice = torch.as_tensor(np.maximum(ices, 0), device=b.device)

    def rt_cam_ref(params):                              # (Ne, 6)
        if not spec.Ncameras_extrinsics:
            return b.new_zeros((len(ices), 6))
        return params["extrinsics"][ice] * (1.0 - at_ref)

    params0 = params_from_arrays(arrays)
    ext0 = rt_cam_ref(params0)
    p_ref0 = tx(ext0[:, None], p[None], inverted=True)   # (Ne, N, 3)
    carry = Kp is None and spec.Nframes > 0
    P0 = p_ref0
    if carry:
        rt_f0 = params0["frames"]                        # (Nf, 6)
        p_frames = tx(rt_f0[:, None, None], p_ref0[None], inverted=True)
        P0 = torch.mean(tx(rt_f0[:, None, None], p_frames), dim=0)

    def project_from(P, ext, intr):
        """The projection of the reference-frame points P (Ne, ..., 3)
        through the extrinsics ext (Ne, 6), averaged over Ne."""
        ext = ext.reshape(ext.shape[:1] + (1,) * (P.dim() - 2) + (6,))
        return project_core(torch.mean(tx(ext, P), dim=0), intr, lm)

    def F(delta):
        """q of the packed-state perturbation delta, the frames held at
        b (their columns come below)."""
        params = split_packed_state(b + delta, arrays, spec)
        P = P0 if Kp is None else tx((Kp @ delta).expand(p_ref0.shape[:-1]
                                                         + (6,)),
                                     p_ref0, inverted=True)
        return project_from(P, rt_cam_ref(params), params["intrinsics"][icam])

    dq_db = torch.func.jacfwd(F)(torch.zeros_like(b))   # (N, 2, Nstate)
    if not (carry and spec.num_states_frames):
        return dq_db

    # the frames' columns: frame f carries the point by its own pose, so
    # dq/dframe_f = dq/dP (dP/dframe_f)/Nf with per-frame 3x6 Jacobians
    intr0 = params0["intrinsics"][icam]
    dq_dP = torch.func.vmap(torch.func.jacfwd(
        lambda Pq: project_from(Pq, ext0, intr0)), in_dims=1)(P0)
    dP_dframe = torch.func.vmap(torch.func.jacfwd(
        lambda rt, x: tx(rt, x)))(rt_f0, p_frames)        # (Nf,Ne,N,3,6)
    Nf = spec.Nframes
    i0 = spec.state_index_frames0
    scales = torch.as_tensor(spec.scales()[i0:i0 + 6 * Nf], dtype=b.dtype,
                             device=b.device)
    dq_dframes = torch.einsum("naej,fenjk->nafk", dq_dP, dP_dframe) / Nf
    dq_db[..., i0:i0 + 6 * Nf] += dq_dframes.reshape(
        dq_dframes.shape[:2] + (-1,)) * scales
    return dq_db


def _dq_db_ccp(prob, p, icam, atinfinity):
    """cross-reprojection-ccp: dq/db = dq/dintrinsics (the camera's own
    columns, packed) + dq/d(rt_cam*_cam*) Kpacked_ccp."""
    spec = prob.spec
    Kp = _drt_cross(spec, prob.arrays, prob.b, icam, prob.coo)
    _, dq_dp, dq_di = _project(p, prob.arrays["intrinsics"][icam],
                               spec.lensmodel, True)
    dq_db = p.new_zeros(p.shape[:-1] + (2, spec.Nstate))
    Nip = spec.Nintrinsics_state_per_cam
    if Nip:
        i0 = spec.state_index_intrinsics0 + icam * Nip
        cols = []
        if spec.Ncore_state:
            cols.append(dq_di[..., :4])
        if spec.selections.do_optimize_intrinsics_distortions:
            cols.append(dq_di[..., spec.Ncore:])
        dq_db[..., i0:i0 + Nip] = torch.cat(cols, dim=-1) * torch.as_tensor(
            _intr_scales(spec), dtype=p.dtype, device=p.device)
    dq_db = dq_db + dq_dp @ skew_symmetric(p) @ Kp[:3]
    if not atinfinity:
        dq_db = dq_db - dq_dp @ Kp[3:]
    return dq_db


def projection_uncertainty(p_cam, model, *, method="mean-pcam",
                           atinfinity=False, what="covariance",
                           observed_pixel_uncertainty=None, device=None):
    """The uncertainty of the projection of the camera-frame points p_cam
    (..., 3) of the model's camera, from the calibration-time noise.
    method: mean-pcam, cross-reprojection-rrp-Jfp (stationary cameras) or
    cross-reprojection-ccp.  what: covariance (..., 2, 2),
    worstdirection-stdev or rms-stdev (...).  The model must hold its
    optimization_inputs.  Runs on the card unless device says
    otherwise."""
    if method not in METHODS:
        raise NotImplementedError(
            f"projection_uncertainty method='{method}' (have: "
            f"{', '.join(METHODS)})")
    _check_what(what)
    (p_cam,) = _as_tensors(device, p_cam)
    prob = _Solved(model.optimization_inputs(), p_cam.device)
    icam = model.icam_intrinsics() or 0
    dq_db = _dq_db(prob, p_cam.reshape(-1, 3), icam, method, atinfinity)
    if observed_pixel_uncertainty is None:
        observed_pixel_uncertainty = _observed_pixel_uncertainty(prob)
    Var = _propagate(prob, dq_db, observed_pixel_uncertainty)
    return _reduce(Var.reshape(p_cam.shape[:-1] + (2, 2)), what)


# ----------------------------------------------------------------------------
# model diffs
# ----------------------------------------------------------------------------

def implied_Rt10__from_unprojections(q0, p0, v1, *, weights=None,
                                     atinfinity=True, focus_center=None,
                                     focus_radius=1e8, device=None):
    """The transform Rt10 (4, 3) that best maps the unprojections p0 of
    camera 0 onto the observation directions v1 of camera 1: a Procrustes
    fit of the directions at infinity, else an angular least-squares fit
    (_fit_implied_rt_finite).  focus_center: only the points q0 within
    focus_radius of it count."""
    q0, p0, v1, weights = _as_tensors(device, q0, p0, v1, weights)
    if weights is None:
        weights = torch.ones(p0.shape[:-1], dtype=p0.dtype, device=p0.device)
    if focus_center is not None:
        fc = torch.as_tensor(np.asarray(focus_center), dtype=q0.dtype,
                             device=q0.device)
        weights = weights * (torch.sum((q0 - fc) ** 2, dim=-1)
                             <= focus_radius ** 2)
    if atinfinity:
        R10 = _align_procrustes_vectors_R01(v1.reshape(-1, 3),
                                            p0.reshape(-1, 3),
                                            weights.reshape(-1))
        return torch.cat([R10, R10.new_zeros((1, 3))])
    return _fit_implied_rt_finite(p0.reshape(-1, 3), v1.reshape(-1, 3),
                                  weights.reshape(-1))


def _fit_implied_rt_finite(p0, v1, weights, niter=200):
    """Levenberg-Marquardt fit of the camera-0 -> camera-1 transform at a
    finite distance: residual w th2, th2 = 2(1 - cos) of the angle between
    transform(rt, p0) and v1, with a Huber weight (f_scale (5 deg)^2) held
    fixed within a step, from the identity.  th2 is computed as |u - v1|^2
    for the unit vector u along transform(rt, p0) (equal for a unit v1),
    which keeps the precision that 2(1 - cos) loses to cancellation at the
    small angles between two models of one camera.  Weights are normalized to
    mean 1 and clipped at 1e3: only their ratios matter, and extreme ratios
    make the normal equations rank-deficient.  Accept/reject damping keeps
    the poorly observed directions stable.  Stops after niter steps, at
    lambda >= 1e8, or when an accepted step improves the cost by less than
    1e-12 relative and moves rt by less than 1e-10; one host read per
    step."""
    finite = (torch.isfinite(p0).all(dim=-1) & torch.isfinite(v1).all(dim=-1)
              & torch.isfinite(weights))
    w = torch.where(finite, weights, 0.0)
    p0 = torch.nan_to_num(p0)
    v1 = torch.nan_to_num(v1)
    nnz = torch.clamp_min(torch.sum(w > 0), 1)
    w = torch.clamp_max(w / torch.clamp_min(torch.sum(w) / nnz, 1e-300), 1e3)
    f_scale = (5.0 * np.pi / 180.0) ** 2

    def th2_of(rt):
        p = _transform_point_rt(rt, p0)
        mag = torch.linalg.vector_norm(p, dim=-1, keepdim=True)
        return torch.sum((p / torch.clamp_min(mag, 1e-30) - v1) ** 2, dim=-1)

    def huber(th2):
        return w * torch.clamp_max(
            f_scale / torch.clamp_min(torch.abs(th2), 1e-30), 1.0) ** 0.5

    def cost(rt):
        th2 = th2_of(rt)
        return torch.sum((th2 * huber(th2)) ** 2)

    eye = torch.eye(6, dtype=p0.dtype, device=p0.device)
    rt = p0.new_zeros(6)
    lam = p0.new_tensor(1e-6)
    E = cost(rt)
    for _ in range(niter):
        th2 = th2_of(rt)
        w_h = huber(th2)
        J = torch.func.jacfwd(lambda r: th2_of(r) * w_h)(rt)
        H = J.T @ J
        step = torch.linalg.solve(
            H + (lam * torch.trace(H) / 6.0 + 1e-300) * eye, J.T @ (th2 * w_h))
        rt_new = torch.nan_to_num(rt - step)
        E_new = cost(rt_new)
        accept = E_new <= E
        stalled = (accept & ((E - E_new) / torch.clamp_min(E, 1e-300) < 1e-12)
                   & (torch.max(torch.abs(step)) < 1e-10))
        rt = torch.where(accept, rt_new, rt)
        E = torch.where(accept, E_new, E)
        lam = torch.where(accept, torch.clamp_min(lam * 0.3, 1e-12),
                          lam * 10.0)
        if torch.stack([stalled, lam >= 1e8]).any():
            break
    return _Rt_from_rt(rt)


def _intrinsics(model, device):
    """The model's (intrinsics as a float64 tensor on device, lens
    model)."""
    lens, intr = model.intrinsics()
    return (torch.as_tensor(intr, dtype=torch.float64, device=device),
            require_ported(lens))


def _warn(what, e):
    print(f"WARNING: projection_diff() couldn't use uncertainties{what}; "
          f"falling back on the unweighted fit: {e}", file=sys.stderr)


def projection_diff(models, *, gridn_width=60, gridn_height=None,
                    distance=None, use_uncertainties=False,
                    intrinsics_only=False, focus_center=None,
                    focus_radius=-1, implied_Rt10=None, device=None):
    """The difference in projection between models, over a grid on model
    0's imager.  Returns (difflen, diff, q0, implied_Rt10).

    2 models: difflen and diff are the length and the vector of q1 - q0
    after the implied transform.  More: each model i > 0 against model 0,
    difflen the RMS over the pairs, diff None, and the (N-1) implied
    transforms stacked.  distance None: at infinity.  use_uncertainties:
    the fit weighs each grid point by 1/(stdev0 stdev1)^2 (the
    worstdirection-stdev of mean-pcam).  intrinsics_only: no fit, the
    identity.  Runs on the card unless device says otherwise."""
    if len(models) < 2:
        raise Exception("projection_diff needs at least 2 models")
    if len(models) > 2 and implied_Rt10 is not None:
        raise Exception("implied_Rt10 may be given only with 2 models")
    device = resolve_device(device)
    W, H = models[0].imagersize()
    q0 = sample_imager(gridn_width, gridn_height, W, H, device=device)

    v0 = _unproject(q0, *_intrinsics(models[0], device), True, False)
    atinfinity = distance is None
    d = 1.0 if atinfinity else distance
    p0 = v0 * d

    def stdev_grid(m):
        v = _unproject(q0, *_intrinsics(m, device), True, False)
        return projection_uncertainty(v * d, m, atinfinity=atinfinity,
                                      what="worstdirection-stdev",
                                      device=device)

    unc0 = None
    if use_uncertainties and not intrinsics_only:
        try:
            unc0 = stdev_grid(models[0])
        except LookupError as e:
            _warn("", e)

    def pair_Rt10_q1(m1, Rt10=None):
        intr1, lm1 = _intrinsics(m1, device)
        if Rt10 is not None:
            (Rt10,) = _as_tensors(device, Rt10)
        elif intrinsics_only:
            Rt10 = torch.cat([torch.eye(3, dtype=p0.dtype, device=device),
                              p0.new_zeros((1, 3))])
        else:
            weights = None
            if unc0 is not None:
                try:
                    weights = (1.0 / (unc0 * stdev_grid(m1))) ** 2
                except LookupError as e:
                    _warn(" for this pair", e)
            Rt10 = implied_Rt10__from_unprojections(
                q0, p0, _unproject(q0, intr1, lm1, True, False),
                atinfinity=atinfinity, weights=weights,
                focus_center=focus_center,
                focus_radius=focus_radius if focus_radius >= 0 else 1e8,
                device=device)
        return Rt10, _project(_transform_point_Rt(Rt10, p0), intr1, lm1,
                              False)

    if len(models) == 2:
        Rt10, q1 = pair_Rt10_q1(models[1], implied_Rt10)
        diff = q1 - q0
        return torch.linalg.vector_norm(diff, dim=-1), diff, q0, Rt10

    pairs = [pair_Rt10_q1(m) for m in models[1:]]
    norm2 = torch.stack([torch.sum((q1 - q0) ** 2, dim=-1)
                         for _, q1 in pairs])
    return (torch.sqrt(torch.mean(norm2, dim=0)), None, q0,
            torch.stack([Rt10 for Rt10, _ in pairs]))


def stereo_pair_diff(model_pairs, *, gridn_width=60, gridn_height=None,
                     distance=None, device=None):
    """The mismatch of the camera-0 -> camera-1 reprojection between two
    pairs of models (m0, m1): returns (difflen, diff, q0).  distance None:
    at infinity, where only the pair's relative rotation counts."""
    if len(model_pairs) != 2 or any(len(p) != 2 for p in model_pairs):
        raise Exception("model_pairs must be 2 pairs of 2 models")
    device = resolve_device(device)
    W, H = model_pairs[0][0].imagersize()
    atinfinity = distance is None
    d = 1.0 if atinfinity else distance
    q0 = sample_imager(gridn_width, gridn_height, W, H, device=device)
    q1s = []
    for m0, m1 in model_pairs:
        p0 = _unproject(q0, *_intrinsics(m0, device), True, False) * d
        Rt_cam_ref, Rt_ref_cam = _as_tensors(device, m1.Rt_cam_ref(),
                                             m0.Rt_ref_cam())
        Rt10 = _compose_Rt2(Rt_cam_ref, Rt_ref_cam)
        if atinfinity:
            Rt10 = torch.cat([Rt10[:3], Rt10.new_zeros((1, 3))])
        q1s.append(_project(_transform_point_Rt(Rt10, p0),
                            *_intrinsics(m1, device), False))
    diff = q1s[1] - q1s[0]
    return torch.linalg.vector_norm(diff, dim=-1), diff, q0


def is_within_valid_intrinsics_region(q, model, *, device=None):
    """Which pixels q (..., 2) lie inside the model's valid-intrinsics
    region (a polygon), by the even-odd rule; None if the model has no
    region."""
    region = model.valid_intrinsics_region()
    if region is None:
        return None
    q, region = _as_tensors(device, q, region)
    x, y = q.reshape(-1, 1, 2).unbind(-1)                # (N, 1)
    x0, y0 = region.unbind(-1)                           # (Nv,)
    x1, y1 = torch.roll(region, -1, dims=0).unbind(-1)
    # the ray from (x, y) towards +x crosses the edges that straddle y
    # left of where they cross y
    straddles = (y0 > y) != (y1 > y)
    dy = torch.where(y1 == y0, 1.0, y1 - y0)
    crosses = straddles & (x < x0 + (y - y0) * (x1 - x0) / dy)
    return (torch.sum(crosses, dim=-1) % 2 == 1).reshape(q.shape[:-1])


def model_resolution__deg_pixel(model, gridn_width=40, gridn_height=None,
                                *, device=None):
    """The angular resolution over the imager: the largest singular value
    of dv/dq at each grid point, in degrees per pixel."""
    device = resolve_device(device)
    W, H = model.imagersize()
    q = sample_imager(gridn_width, gridn_height, W, H, device=device)
    _, dv_dq, _ = _unproject(q, *_intrinsics(model, device), True, True)
    return torch.linalg.svdvals(dv_dq)[..., 0] * 180.0 / np.pi
