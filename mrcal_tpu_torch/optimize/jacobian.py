"""The measurement Jacobian: optimizer_callback and the check_gradient
mode of optimize().

Counterpart of ``_sparse_jacobian``/``optimizer_callback`` in
``mrcal_tpu/optimize/residuals.py`` and ``_fd_column_errors``/
``_check_gradient_report`` in ``mrcal_tpu/optimize/solver.py``.  The
packed-coordinate Jacobian is assembled as a scipy CSR matrix from
per-observation autograd blocks (per corner, per point observation, per
triangulated pair, per camera of regularization) and the state layout's
column indices; the dense (Nmeasurements, Nstate) matrix is never formed.
Each measurement row carries only its own observation's intrinsics,
extrinsics, frame or point, and warp blocks; with a splined model whose
core is locked, a board row's intrinsics block is its spline window, the
2(order+1)^2 control points it depends on.
"""

import numpy as np
import scipy.sparse
import torch

from .._config import resolve_device
from .layout import ProblemSpec, normalize_inputs, spec_from_inputs
from .residuals import (arrays_from_inputs, pack_params, params_from_arrays,
                        residuals_from_packed, split_packed_state)
from .solver import _ObservationRows, _batch_of_one, _splined_fast_path_ok

# check_gradient: the central-difference step (packed units), and the
# number of state columns checked at most (a random subset beyond it)
FD_STEP = 1e-5
FD_COLUMNS_MAX = 250


def _np(t):
    return t.detach().cpu().numpy()


def _jacobian_coo(b, arrays, spec: ProblemSpec):
    """The packed-coordinate measurement Jacobian at the packed state b (a
    tensor on the device of `arrays`) as COO triplets (rows, cols, vals),
    tensors on that device: int64, int64 and b's dtype.  Entries of an
    observation's blocks that are 0 are kept; the regularization rows keep
    their nonzeros only."""
    s = spec.selections
    dev = b.device
    rows_of = _ObservationRows(spec, arrays)
    # the rows take a batch of problems: this one as a batch of one
    arrays1 = _batch_of_one(arrays)
    pk1 = rows_of.packed(split_packed_state(b[None], arrays1, spec,
                                            scales=rows_of.consts.state))

    def one(t):
        return t[0]

    def arange(n):
        return torch.arange(n, device=dev)

    Nip = spec.Nintrinsics_state_per_cam
    Npv = spec.Npoints_variable
    i_intr0 = spec.state_index_intrinsics0
    i_ext0 = spec.state_index_extrinsics0

    ROWS, COLS, VALS = [], [], []

    def emit(rows, cols, vals):
        """rows/cols/vals broadcastable tensors -> COO triplets."""
        rows, cols, vals = torch.broadcast_tensors(rows, cols, vals)
        ROWS.append(rows.reshape(-1))
        COLS.append(cols.reshape(-1))
        VALS.append(vals.reshape(-1))

    def emit_blocks(rows, col0, width, index, J, have=None):
        """Block `index` (per row) of a state slice of `width`-wide blocks
        starting at col0, for the rows where `have` holds."""
        if have is not None:
            rows, index, J = rows[have], index[have], J[have]
        emit(rows, (col0 + width * index)[:, None, None] + arange(width), J)

    # ---------------- board observations: one row pair per corner --------
    if spec.Nobservations_board:
        idx = arrays["indices_board"].repeat_interleave(rows_of.HW, dim=0)
        rows = arange(len(idx) * 2).reshape(-1, 2, 1)
        if _splined_fast_path_ok(spec):
            _, J, Jw, wincols, _ = rows_of.splined_board(pk1, arrays1)
            J = {k: one(v) for k, v in J.items()}          # (N, 2, n)
            emit(rows, i_intr0 + one(wincols)[:, None, :], one(Jw))
        else:
            _, J = rows_of.board(pk1, arrays1)
            J = {k: one(v) for k, v in J.items()}          # (N, 2, n)
            if Nip:
                emit_blocks(rows, i_intr0, Nip, idx[:, 1], J["intr"])
        if s.do_optimize_extrinsics:
            emit_blocks(rows, i_ext0, 6, idx[:, 2], J["ext"], idx[:, 2] >= 0)
        if s.do_optimize_frames:
            emit_blocks(rows, spec.state_index_frames0, 6, idx[:, 0],
                        J["frame"])
        if spec.has_calobject_warp:
            emit(rows, spec.state_index_calobject_warp0 + arange(2),
                 J["warp"])

    # ---------------- point observations ----------------
    if spec.Nobservations_point:
        idx = arrays["indices_point"]
        _, J = rows_of.point(pk1, arrays1)
        J = {k: one(v) for k, v in J.items()}
        rows = spec.measurement_index_points0 + \
            arange(len(idx) * 2).reshape(-1, 2, 1)
        if Nip:
            emit_blocks(rows, i_intr0, Nip, idx[:, 1], J["intr"])
        if s.do_optimize_extrinsics:
            emit_blocks(rows, i_ext0, 6, idx[:, 2], J["ext"], idx[:, 2] >= 0)
        if s.do_optimize_frames and Npv:
            emit_blocks(rows, spec.state_index_points0, 3, idx[:, 0],
                        J["point"], idx[:, 0] < Npv)

    # ---------------- triangulated pairs ----------------
    Ntri = spec.num_measurements_points_triangulated
    if Ntri and s.do_optimize_extrinsics and spec.Ncameras_extrinsics:
        _, J0, J1 = rows_of.tri(pk1, arrays1)
        rows = spec.measurement_index_points_triangulated0 + \
            arange(Ntri).reshape(-1, 1, 1)
        for ie, Jk in ((rows_of.ie0, J0), (rows_of.ie1, J1)):
            ice = ie - 1
            emit_blocks(rows, i_ext0, 6, ice, one(Jk)[:, None, :], ice >= 0)

    # ---------------- regularization: nonzero entries only -------------
    if spec.num_measurements_regularization:
        r0 = spec.measurement_index_regularization0
        _, Jreg = rows_of.regularization(pk1)
        if Jreg is not None:
            Jreg = one(Jreg)                               # (Nci, nterms, Nip)
            ndist = (spec.Ndistortions
                     if (s.do_apply_regularization
                         and s.do_optimize_intrinsics_distortions) else 0)
            Nci, nterms = Jreg.shape[:2]
            # the distortion rows of every camera, then the center pixels
            ci = arange(Nci)[:, None]
            k = arange(nterms)[None, :]
            rows = torch.where(k < ndist, r0 + ci * ndist + k,
                               r0 + Nci * ndist + ci * (nterms - ndist)
                               + k - ndist)
            cols = i_intr0 + Nip * ci[..., None] + arange(Nip)
            nz = Jreg != 0
            emit(rows[..., None].expand(Jreg.shape)[nz],
                 cols.expand(Jreg.shape)[nz], Jreg[nz])
        if (s.do_apply_regularization_unity_cam01
                and s.do_optimize_extrinsics
                and spec.Ncameras_extrinsics > 0):
            Ju = one(rows_of.unity_cam01(pk1)[1])
            nz = Ju != 0
            emit(torch.full((), spec.Nmeasurements - 1, device=dev),
                 i_ext0 + arange(6)[nz], Ju[nz])

    if not ROWS:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return empty, empty, b.new_zeros(0)
    return tuple(torch.cat(a) for a in (ROWS, COLS, VALS))


def _sparse_jacobian(b, arrays, spec: ProblemSpec):
    """The packed-coordinate measurement Jacobian at the packed state b as
    a scipy CSR matrix of shape (Nmeasurements, Nstate): the triplets of
    _jacobian_coo, copied to the host once."""
    return _csr(_jacobian_coo(b, arrays, spec), spec)


def _csr(coo, spec: ProblemSpec):
    """COO triplets on any device -> a scipy CSR matrix of shape
    (Nmeasurements, Nstate), with sorted indices and no duplicates."""
    rows, cols, vals = (_np(t) for t in coo)
    J = scipy.sparse.coo_matrix(
        (vals, (rows, cols)),
        shape=(spec.Nmeasurements, spec.Nstate)).tocsr()
    J.sum_duplicates()
    J.sort_indices()
    return J


def optimizer_callback(no_jacobian=False, no_factorization=True, *,
                       device=None, **kw):
    """One cost evaluation at the state in the inputs: returns (b_packed,
    x, J) as numpy arrays, with J a scipy CSR matrix of shape
    (Nmeasurements, Nstate) in packed coordinates (None with
    no_jacobian=True), as mrcal.optimizer_callback does.  no_factorization
    is accepted, by position or by keyword, and has no effect: no
    factorization is returned, as in the JAX package.  The evaluation
    runs on `device`: None means the CUDA card, "cpu" the CPU."""
    device = resolve_device(device)
    kw = normalize_inputs(kw)
    spec = spec_from_inputs(**kw)
    arrays = arrays_from_inputs(kw, device=device)
    b = pack_params(params_from_arrays(arrays), spec)
    with torch.no_grad():
        x = residuals_from_packed(b, arrays, spec)
    if no_jacobian:
        return _np(b), _np(x), None
    return _np(b), _np(x), _sparse_jacobian(b, arrays, spec)


def _fd_column_errors(spec, arrays, b, cols):
    """Autograd-Jacobian column against the central finite difference, per
    state column.  b: the packed state (numpy).  Yields (j, err, scale):
    err = max |J_ad - J_fd| in column j, scale the 1+max|J_fd|
    normalizer.  Columns come from the CSC form; no dense matrix is
    formed."""
    dt = arrays["intrinsics"].dtype
    dev = arrays["intrinsics"].device
    b = np.asarray(b, np.float64)
    J = _sparse_jacobian(torch.as_tensor(b, dtype=dt, device=dev), arrays,
                         spec).tocsc()

    def resid(bb):
        with torch.no_grad():
            return _np(residuals_from_packed(
                torch.as_tensor(bb, dtype=dt, device=dev), arrays, spec))

    for j in cols:
        bp = b.copy()
        bp[j] += FD_STEP
        bm = b.copy()
        bm[j] -= FD_STEP
        dnum = (resid(bp) - resid(bm)) / (2 * FD_STEP)
        Jcol = J[:, [int(j)]].toarray().ravel()
        err = float(np.max(np.abs(dnum - Jcol)))
        scale = 1.0 + float(np.max(np.abs(dnum)))
        yield int(j), err, scale


def _check_gradient_report(spec, arrays, b, verbose=False):
    """optimize(check_gradient=True): the Jacobian against central finite
    differences on every state column (a random FD_COLUMNS_MAX of them on
    larger problems).  b: the packed state (a tensor).  Returns a stats
    dict with the worst per-column relative error; verbose prints each
    column's error as the JAX package does."""
    cols = np.arange(spec.Nstate)
    if spec.Nstate > FD_COLUMNS_MAX:
        cols = np.random.default_rng(0).permutation(
            spec.Nstate)[:FD_COLUMNS_MAX]
    worst = 0.0
    worst_col = -1
    for j, err, scale in _fd_column_errors(spec, arrays, _np(b), cols):
        if verbose:
            print(f"check_gradient: ivar {j}: max |J_ad - J_num| = "
                  f"{err:.3e} (relative {err / scale:.3e})")
        if err / scale > worst:
            worst, worst_col = err / scale, j
    return dict(check_gradient=True,
                ncols_checked=len(cols),
                worst_relative_error=worst,
                worst_ivar=worst_col)
