"""Batched Cholesky factor and solves of small SPD blocks.

Counterpart of ``mrcal_tpu/ops/batched_cholesky.py``.  The Schur step
factors B independent n x n SPD blocks (n = 6 for frame poses, 3 for
points) once per iteration and solves each against K right-hand sides,
in one launch of ``cholesky_factor_solve`` (the TPU kernel's contract);
it keeps L for the back-substitution, one ``cholesky_solve_factored``.

Each wrapper takes a tensor on a CUDA card to the hand-written Hopper
kernel in ``csrc/batched_cholesky.cu`` and a tensor on the CPU to the
plain PyTorch version in this module (the unrolled factor and solves of
the JAX package).  There is no fallback between the two: a CUDA tensor
the kernel cannot take raises.  ``launches`` counts the kernel launches
of each wrapper.

No pivoting and no jitter: a block that is not SPD gives NaN.
"""

import ctypes

import torch

from . import _build

# kernel launches, by wrapper
launches = {"cholesky_factor": 0, "cholesky_solve_factored": 0,
            "cholesky_factor_solve": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


# ----------------------------------------------------------------------------
# plain PyTorch version
# ----------------------------------------------------------------------------

def cholesky_factor_plain(A):
    """Unrolled batched Cholesky: A (B, n, n) SPD -> L (B, n, n), lower
    triangular, zeros above the diagonal."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    zero = A.new_zeros(A.shape[:-2])
    for i in range(n):
        for j in range(i + 1):
            s = A[:, i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(s)
            else:
                L[i][j] = s / L[j][j]
    return torch.stack([torch.stack([L[i][j] if j <= i else zero
                                     for j in range(n)], dim=-1)
                        for i in range(n)], dim=-2)


def cholesky_solve_factored_plain(L, rhs):
    """Forward and back solves against a factor from cholesky_factor:
    rhs (B, n, K) -> x (B, n, K)."""
    n = L.shape[-1]
    y = [None] * n
    for i in range(n):
        s = rhs[:, i, :]
        for k in range(i):
            s = s - L[:, i, k, None] * y[k]
        y[i] = s / L[:, i, i, None]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[:, k, i, None] * x[k]
        x[i] = s / L[:, i, i, None]
    return torch.stack(x, dim=1)


def cholesky_factor_solve_plain(A, rhs):
    """cholesky_factor_plain, then cholesky_solve_factored_plain:
    A (B, n, n), rhs (B, n, K) -> (L, x)."""
    L = cholesky_factor_plain(A)
    return L, cholesky_solve_factored_plain(L, rhs)


# ----------------------------------------------------------------------------
# CUDA kernel wrappers
# ----------------------------------------------------------------------------

_lib = None


def kernel_library():
    """The built kernel library (built at first use)."""
    global _lib
    if _lib is None:
        built = _build.load("batched_cholesky")
        lib = built.lib
        lib.mrcal_cholesky_factor.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.mrcal_cholesky_factor.restype = ctypes.c_int
        lib.mrcal_cholesky_solve_factored.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.mrcal_cholesky_solve_factored.restype = ctypes.c_int
        lib.mrcal_cholesky_factor_solve.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.mrcal_cholesky_factor_solve.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_cuda(t, name, n=None):
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {t.dtype} is not float32/float64")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensor is on {t.device}, the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    if n is not None and n not in (3, 6):
        raise ValueError(f"{name}: block size n={n}; the kernel takes 3 or 6")


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def cholesky_factor(A):
    """A (B, n, n) SPD -> L (B, n, n) lower triangular (zeros above)."""
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"cholesky_factor: A has shape {tuple(A.shape)}, "
                         "expected (B, n, n)")
    if A.device.type == "cpu":
        return cholesky_factor_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"cholesky_factor: no kernel for {A.device}")
    B, n, _ = A.shape
    _check_cuda(A, "cholesky_factor", n)
    L = torch.empty_like(A)
    if B == 0:
        return L
    lib = kernel_library()
    err = lib.mrcal_cholesky_factor(
        ctypes.c_void_p(A.data_ptr()), ctypes.c_void_p(L.data_ptr()),
        B, n, int(A.dtype == torch.float64), _stream())
    _raise_on(err, "cholesky_factor")
    launches["cholesky_factor"] += 1
    return L


def _check_pair(M, rhs, name):
    """M (B, n, n) and rhs (B, n, K), of one dtype on one device."""
    if M.dim() != 3 or rhs.dim() != 3 or M.shape[1] != M.shape[2] \
            or rhs.shape[:2] != M.shape[:2]:
        raise ValueError(f"{name}: shapes {tuple(M.shape)} and "
                         f"{tuple(rhs.shape)}, expected (B, n, n) and "
                         "(B, n, K)")
    if M.dtype != rhs.dtype or M.device != rhs.device:
        raise ValueError(f"{name}: the blocks and rhs differ in dtype or "
                         "device")
    if M.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {M.device}")


def cholesky_solve_factored(L, rhs):
    """Solve (L L^T) x = rhs for each block.  L (B, n, n) from
    cholesky_factor or cholesky_factor_solve, rhs (B, n, K) -> x (B, n, K)."""
    _check_pair(L, rhs, "cholesky_solve_factored")
    if L.device.type == "cpu":
        return cholesky_solve_factored_plain(L, rhs)
    B, n, K = rhs.shape
    _check_cuda(L, "cholesky_solve_factored", n)
    _check_cuda(rhs, "cholesky_solve_factored")
    x = torch.empty_like(rhs)
    if B == 0 or K == 0:
        return x
    lib = kernel_library()
    err = lib.mrcal_cholesky_solve_factored(
        ctypes.c_void_p(L.data_ptr()), ctypes.c_void_p(rhs.data_ptr()),
        ctypes.c_void_p(x.data_ptr()), B, n, K,
        int(L.dtype == torch.float64), _stream())
    _raise_on(err, "cholesky_solve_factored")
    launches["cholesky_solve_factored"] += 1
    return x


def cholesky_factor_solve(A, rhs):
    """Factor each block and solve it against every column of rhs, in one
    launch.  A (B, n, n) SPD, rhs (B, n, K) -> (L, x): L (B, n, n) lower
    triangular (zeros above), for later cholesky_solve_factored calls, and
    x (B, n, K)."""
    _check_pair(A, rhs, "cholesky_factor_solve")
    if A.device.type == "cpu":
        return cholesky_factor_solve_plain(A, rhs)
    B, n, K = rhs.shape
    _check_cuda(A, "cholesky_factor_solve", n)
    _check_cuda(rhs, "cholesky_factor_solve")
    L = torch.empty_like(A)
    x = torch.empty_like(rhs)
    if B == 0:
        return L, x
    lib = kernel_library()
    err = lib.mrcal_cholesky_factor_solve(
        ctypes.c_void_p(A.data_ptr()), ctypes.c_void_p(rhs.data_ptr()),
        ctypes.c_void_p(L.data_ptr()), ctypes.c_void_p(x.data_ptr()),
        B, n, K, int(A.dtype == torch.float64), _stream())
    _raise_on(err, "cholesky_factor_solve")
    launches["cholesky_factor_solve"] += 1
    return L, x


def batched_cholesky_solve(A, rhs):
    """solve(A, rhs) for a batch of small SPD blocks, in one launch.
    A (B, n, n), rhs (B, n, K) -> (B, n, K)."""
    return cholesky_factor_solve(A, rhs)[1]
