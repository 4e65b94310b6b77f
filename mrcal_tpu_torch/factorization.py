"""Factorization of JtJ with reusable solves: mrcal's
CHOLMOD_factorization, in PyTorch.

Counterpart of ``mrcal_tpu/factorization.py``:

  - calibration-scale problems (Nstate <= 4096, or any dense J) factor
    dense on the card (or the device asked for) in float64: from J's QR
    (R^T R = JtJ) when J is given, else by ``torch.linalg.cholesky`` of
    JtJ, and solve with ``solve_triangular``; there is no fill-reducing
    permutation, so P, Pt and D are the identity;
  - larger problems with a scipy-sparse J keep JtJ sparse and factor it on
    the host with SuperLU in symmetric mode (a fill-reducing symmetric
    permutation, diagonal pivot threshold 0): for an SPD matrix that is
    P JtJ P' = L_unit D L_unit', a sparse Cholesky factor L_unit sqrt(D),
    so every split solve (L/Lt/LD/DLt/P/Pt) exists at O(nnz) memory.
"""

import numpy as np
import torch

from ._config import DEFAULT_DTYPE, resolve_device

_DENSE_NSTATE_MAX = 4096


def _cholesky_factor_of_JtJ(J):
    """L, lower triangular with L L^T = J^T J and a positive diagonal (the
    Cholesky factor of JtJ, unique), from the QR of J, without forming
    JtJ, whose condition number is J's squared (10^21 on the bench's
    opencv8_1cam, where the rows of its steepest corners swamp k3 and k6,
    and a Cholesky of JtJ breaks down).  J's columns are scaled to unit
    norm first and R's columns scaled back, so that the QR's normwise
    rounding is relative to each column and not to the steepest one.
    None if JtJ is singular."""
    m, n = J.shape
    c = torch.linalg.vector_norm(J, dim=0)
    if m < n or not bool(torch.all(c > 0)):
        return None
    R = torch.linalg.qr(J / c, mode="r")[1] * c
    d = torch.diagonal(R)
    L = (R * torch.where(d < 0, -1.0, 1.0)[:, None]).T
    if not bool(torch.all(d != 0) and torch.all(torch.isfinite(L))):
        return None
    return L


class CHOLMOD_factorization:
    """Factorize JtJ once, solve many times.

    J: a scipy sparse matrix, a numpy array or a tensor; or JtJ given
    instead.  force_dense: None picks the dense path for Nstate <= 4096
    or a dense J, the sparse one otherwise.  device: where the dense
    factor lives (the card unless told otherwise; the sparse factor lives
    on the host, but device is checked all the same)."""

    def __init__(self, J=None, JtJ=None, *, force_dense=None, device=None):
        self._lu = None
        self._L = None
        sparse_in = J is not None and hasattr(J, "tocsc")
        n = J.shape[1] if J is not None else JtJ.shape[-1]
        use_dense = (n <= _DENSE_NSTATE_MAX or not sparse_in) \
            if force_dense is None else force_dense
        self._n = n
        device = resolve_device(device)

        if not use_dense:
            import scipy.sparse
            import scipy.sparse.linalg
            Jc = J.tocsc()
            # symmetric mode and no numerical pivoting: for SPD input
            # P A P' = L_unit U with U = D L_unit', a Cholesky factorization
            self._lu = scipy.sparse.linalg.splu(
                (Jc.T @ Jc).tocsc(), permc_spec="MMD_AT_PLUS_A",
                diag_pivot_thresh=0.0, options=dict(SymmetricMode=True))
            d = self._lu.U.diagonal()
            if np.any(d <= 0) or not np.all(np.isfinite(d)):
                raise Exception("JtJ is not positive definite")
            self._d = np.asarray(d)
            self._Lc = (self._lu.L @ scipy.sparse.diags(np.sqrt(self._d))
                        ).tocsr()
            self._LcT = self._Lc.T.tocsr()
            # rows and columns are permuted alike: Lc Lc' == JtJ[pi, pi]
            # with pi = argsort(perm_c), so the factorization's P maps
            # through the inverse of SuperLU's perm_c
            self._perm = np.argsort(np.asarray(self._lu.perm_c))
            self._perm_inv = np.asarray(self._lu.perm_c)
            return

        device = resolve_device(device)

        def tensor(a):
            if hasattr(a, "toarray"):
                a = a.toarray()
            return torch.as_tensor(a, dtype=DEFAULT_DTYPE, device=device)
        if JtJ is not None:
            L, info = torch.linalg.cholesky_ex(tensor(JtJ))
            if int(info) != 0:
                L = None
        elif J is None:
            raise Exception("need J or JtJ")
        else:
            L = _cholesky_factor_of_JtJ(tensor(J))
        if L is None:
            raise Exception("JtJ is not positive definite")
        self._L = L

    def solve_xt_JtJ_bt(self, bt, mode="A", sys=None):
        """Solve xt JtJ = bt for xt, over the leading dimensions of bt
        (..., Nstate).  mode (or sys): the cholmod_solve2 system, with or
        without the CHOLMOD_ prefix: A, LDLt, LD, DLt, L, Lt, D, P, Pt.
        A numpy bt gives a numpy result; a tensor gives a tensor, on the
        factor's device on the dense path.

        Dense path: P == Pt == D == I, so LD == L and DLt == Lt.  Sparse
        path: solve(P), solve(L), solve(Lt), solve(Pt) compose to
        solve(A), as chaining the cholmod_solve2 systems does."""
        if sys is not None:
            mode = sys
        mode = mode.replace("CHOLMOD_", "")
        if mode not in ("A", "LDLt", "LD", "DLt", "L", "Lt", "D", "P",
                        "Pt"):
            raise Exception(f"Unknown solve mode '{mode}'")
        as_tensor = torch.is_tensor(bt)

        if self._lu is not None:
            import scipy.sparse.linalg as spla
            b = (bt.detach().cpu().numpy() if as_tensor
                 else np.asarray(bt, dtype=np.float64))
            rhs = np.atleast_2d(b).reshape(-1, self._n)
            if mode in ("A", "LDLt"):
                x = self._lu.solve(rhs.T).T
            elif mode in ("L", "LD"):
                x = spla.spsolve_triangular(self._Lc, rhs.T, lower=True).T
            elif mode in ("Lt", "DLt"):
                x = spla.spsolve_triangular(self._LcT, rhs.T,
                                            lower=False).T
            elif mode == "P":
                x = rhs[:, self._perm]
            elif mode == "Pt":
                x = rhs[:, self._perm_inv]
            else:
                x = rhs
            x = x.reshape(b.shape)
            return torch.as_tensor(x, device=bt.device) if as_tensor else x

        L = self._L
        b = torch.as_tensor(bt, dtype=L.dtype, device=L.device)
        rhs = b.reshape(-1, self._n).T                     # columns
        if mode in ("A", "LDLt", "L", "LD"):
            rhs = torch.linalg.solve_triangular(L, rhs, upper=False)
        if mode in ("A", "LDLt", "Lt", "DLt"):
            rhs = torch.linalg.solve_triangular(L.T, rhs, upper=True)
        x = rhs.T.reshape(b.shape)
        return x if as_tensor else x.cpu().numpy()

    def rcond(self):
        """Reciprocal condition number estimate: min/max of the factor's
        squared diagonal (dense), of the LDLt's D (sparse)."""
        if self._lu is not None:
            return float(self._d.min() / self._d.max())
        d = torch.diagonal(self._L) ** 2
        return float(torch.min(d) / torch.max(d))
