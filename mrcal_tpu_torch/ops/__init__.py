"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (see batched_cholesky.py)."""

from .batched_cholesky import (  # noqa: F401
    batched_cholesky_solve,
    cholesky_factor,
    cholesky_factor_solve,
    cholesky_solve_factored,
)
