"""The port's batched Cholesky (mrcal_tpu_torch.ops.batched_cholesky)
against the JAX package's unrolled solve and numpy.

On the CPU the wrappers take the plain PyTorch version; the CUDA kernel
is held against that plain version in the one gpu-marked test, which
skips without a card.  The JAX package is imported inside the test that
uses it, so that the gpu test also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_ops.py
"""

import numpy as np
import pytest
import torch

from mrcal_tpu_torch.ops import batched_cholesky as bc


def _spd(rng, B, n, K):
    M = rng.normal(size=(B, n, n))
    A = np.einsum("bij,bkj->bik", M, M) + 3 * np.eye(n)
    return A, rng.normal(size=(B, n, K))


@pytest.mark.parametrize("n,K,B", [(6, 7, 40), (3, 5, 17), (6, 1, 3),
                                   (6, 14, 84)])
def test_plain_cholesky_solve_matches_jax(n, K, B):
    from mrcal_tpu.ops.batched_cholesky import _unrolled_cholesky_solve
    A, rhs = _spd(np.random.default_rng(n * 100 + K), B, n, K)
    x = bc.batched_cholesky_solve(torch.as_tensor(A),
                                  torch.as_tensor(rhs)).numpy()
    x_jax = np.asarray(_unrolled_cholesky_solve(A, rhs, n))
    assert np.abs(x - x_jax).max() < 1e-9
    assert np.abs(x - np.linalg.solve(A, rhs)).max() < 1e-9


def test_plain_factor_is_lower_triangular_cholesky():
    A, _ = _spd(np.random.default_rng(5), 11, 6, 1)
    L = bc.cholesky_factor(torch.as_tensor(A)).numpy()
    assert np.all(np.triu(L, 1) == 0.0)
    assert np.abs(L - np.linalg.cholesky(A)).max() < 1e-12


def test_plain_cholesky_solve_near_singular_f32():
    """cond=1e6 SPD blocks in f32 stay finite and track the f64 solution
    to f32-conditioning accuracy."""
    rng = np.random.default_rng(3)
    n, K, B = 6, 7, 64
    U = np.linalg.qr(rng.normal(size=(B, n, n)))[0]
    eig = np.stack([np.logspace(0, -6, n)] * B)
    A = ((U * eig[:, None, :]) @ U.transpose(0, 2, 1)).astype(np.float32)
    rhs = rng.normal(size=(B, n, K)).astype(np.float32)
    x = bc.batched_cholesky_solve(torch.as_tensor(A),
                                  torch.as_tensor(rhs)).numpy()
    x_ref = np.linalg.solve(A.astype(np.float64), rhs.astype(np.float64))
    assert x.dtype == np.float32
    assert np.isfinite(x).all()
    assert np.abs(x - x_ref).max() / np.abs(x_ref).max() < 0.1


def test_plain_cholesky_non_spd_block_gives_nan():
    A, rhs = _spd(np.random.default_rng(7), 5, 6, 3)
    A[2] = -A[2]
    x = bc.batched_cholesky_solve(torch.as_tensor(A),
                                  torch.as_tensor(rhs)).numpy()
    assert np.isnan(x[2]).all()
    ok = [0, 1, 3, 4]
    assert np.isfinite(x[ok]).all()
    assert np.abs(x[ok] - np.linalg.solve(A[ok], rhs[ok])).max() < 1e-9


def _jax_factor_solve(A, rhs):
    """The JAX package's unrolled factor and solves: (L, x) as numpy."""
    from mrcal_tpu.ops.batched_cholesky import (
        unrolled_cholesky_factor, unrolled_cholesky_solve_factored)
    n = A.shape[-1]
    Lf = unrolled_cholesky_factor(A, n)
    zero = np.zeros(A.shape[0])
    L = np.stack([np.stack([np.asarray(Lf[i][j]) if j <= i else zero
                            for j in range(n)], axis=-1)
                  for i in range(n)], axis=-2)
    return L, np.asarray(unrolled_cholesky_solve_factored(Lf, rhs, n))


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300) \
        if b.size else 0.0


@pytest.mark.parametrize("B,n,K", [(84, 6, 15), (40, 6, 285), (17, 3, 5),
                                   (0, 6, 15)])
def test_plain_factor_solve_matches_jax(B, n, K):
    """The fused entry point's plain twin against the JAX package's
    unrolled factor + solve, and L against numpy's Cholesky."""
    A, rhs = _spd(np.random.default_rng(B + n + K), B, n, K)
    L, x = bc.cholesky_factor_solve_plain(torch.as_tensor(A),
                                          torch.as_tensor(rhs))
    L, x = L.numpy(), x.numpy()
    L_jax, x_jax = _jax_factor_solve(A, rhs)
    assert L.shape == (B, n, n) and x.shape == (B, n, K)
    assert _rel(L, L_jax) < 1e-10
    assert _rel(x, x_jax) < 1e-10
    if B:
        assert _rel(L, np.linalg.cholesky(A)) < 1e-10
        assert np.all(np.triu(L, 1) == 0.0)


def test_factor_solve_cpu_route_is_the_plain_version():
    """On CPU tensors the fused wrapper (and batched_cholesky_solve) take
    the plain version and launch nothing."""
    A, rhs = _spd(np.random.default_rng(11), 84, 6, 15)
    A_t, rhs_t = torch.as_tensor(A), torch.as_tensor(rhs)
    before = dict(bc.launches)
    L, x = bc.cholesky_factor_solve(A_t, rhs_t)
    L_p, x_p = bc.cholesky_factor_solve_plain(A_t, rhs_t)
    assert torch.equal(L, L_p) and torch.equal(x, x_p)
    assert torch.equal(bc.batched_cholesky_solve(A_t, rhs_t), x_p)
    assert torch.equal(bc.cholesky_solve_factored(L, rhs_t), x_p)
    assert bc.launches == before
    with pytest.raises(ValueError):
        bc.cholesky_factor_solve(A_t, rhs_t[:, :3])
    with pytest.raises(ValueError):
        bc.cholesky_factor_solve(A_t, rhs_t.float())


def test_factor_solve_with_no_columns():
    """K = 0: the fused entry still returns the factor, and an empty x."""
    A, rhs = _spd(np.random.default_rng(12), 9, 6, 0)
    L, x = bc.cholesky_factor_solve(torch.as_tensor(A), torch.as_tensor(rhs))
    assert x.shape == (9, 6, 0)
    assert torch.equal(L, bc.cholesky_factor(torch.as_tensor(A)))


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        bc.cholesky_factor(torch.zeros(4, 6, 5, dtype=torch.float64))
    with pytest.raises(ValueError):
        bc.cholesky_solve_factored(torch.zeros(4, 6, 6, dtype=torch.float64),
                                   torch.zeros(4, 3, 2, dtype=torch.float64))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kernel_matches_plain_on_card(dtype):
    """The CUDA kernel against the plain version, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    tol = 1e-12 if dt == torch.float64 else 1e-5
    rng = np.random.default_rng(0)
    for B, n, K in [(84, 6, 14), (84, 6, 1), (500, 3, 4), (1000, 6, 3),
                    (5376, 6, 15), (320, 6, 285)]:
        A, rhs = _spd(rng, B, n, K)
        A_d = torch.as_tensor(A, dtype=dt, device="cuda")
        rhs_d = torch.as_tensor(rhs, dtype=dt, device="cuda")
        before = dict(bc.launches)
        L = bc.cholesky_factor(A_d)
        x = bc.cholesky_solve_factored(L, rhs_d)
        torch.cuda.synchronize()
        assert bc.launches["cholesky_factor"] == before["cholesky_factor"] + 1
        L_p = bc.cholesky_factor_plain(A_d)
        x_p = bc.cholesky_solve_factored_plain(L_p, rhs_d)
        assert ((L - L_p).abs().max() / L_p.abs().max()).item() < tol
        assert ((x - x_p).abs().max() / x_p.abs().max()).item() < tol


# (B, n, K): the Schur step's shapes on opencv8_1cam and rig16cam, and on
# batches of them (64 opencv8_1cam units, 8 rig16cam units: every unit's
# frame blocks in one launch), a ragged B, K just past a warp, many blocks
# (K = 0: the fused entry with no right-hand side) and B = 0
_CARD_SHAPES = [(84, 6, 15), (84, 6, 1), (40, 6, 285), (40, 6, 1),
                (5376, 6, 15), (5376, 6, 1), (320, 6, 285), (320, 6, 1),
                (131, 6, 33), (131, 3, 4), (70000, 6, 15), (70001, 6, 1),
                (70001, 3, 1), (70000, 6, 0), (0, 6, 15)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fused_and_solve_kernels_match_plain_on_card(dtype):
    """cholesky_factor_solve and cholesky_solve_factored against their
    plain versions on the card; each call adds one to its count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    tol = 1e-12 if dt == torch.float64 else 1e-5
    rng = np.random.default_rng(1)
    for B, n, K in _CARD_SHAPES:
        A, rhs = _spd(rng, B, n, K)
        A_d = torch.as_tensor(A, dtype=dt, device="cuda")
        rhs_d = torch.as_tensor(rhs, dtype=dt, device="cuda")
        L_p, x_p = bc.cholesky_factor_solve_plain(A_d, rhs_d)
        before = dict(bc.launches)
        L, x = bc.cholesky_factor_solve(A_d, rhs_d)
        x_s = bc.cholesky_solve_factored(L_p, rhs_d)
        torch.cuda.synchronize()
        assert bc.launches["cholesky_factor_solve"] == \
            before["cholesky_factor_solve"] + int(B > 0)
        assert bc.launches["cholesky_solve_factored"] == \
            before["cholesky_solve_factored"] + int(B > 0 and K > 0)
        assert L.shape == (B, n, n) and x.shape == (B, n, K)
        for got, want in ((L, L_p), (x, x_p), (x_s, x_p)):
            if want.numel():
                err = ((got - want).abs().max() / want.abs().max()).item()
                assert err < tol, (B, n, K, err)


@pytest.mark.gpu
@pytest.mark.parametrize("B,K", [(84, 15), (70001, 1)])
def test_fused_kernel_non_spd_block_on_card(B, K):
    """A block that is not SPD gives a non-finite result in that block
    alone, among few blocks and many."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A, rhs = _spd(np.random.default_rng(2), B, 6, K)
    A[5] = -A[5]
    A_d = torch.as_tensor(A, device="cuda")
    rhs_d = torch.as_tensor(rhs, device="cuda")
    _, x = bc.cholesky_factor_solve(A_d, rhs_d)
    x_s = bc.cholesky_solve_factored(bc.cholesky_factor(A_d), rhs_d)
    for out in (x, x_s):
        assert not torch.isfinite(out[5]).any()
        assert torch.isfinite(out[:5]).all() and torch.isfinite(out[6:]).all()
