"""Port parity: the block-tridiagonal solve
(``geconpy_torch/ops/block_tridiag.py`` against
``geconpy_tpu/ops/block_tridiag.py``).

The reference's tests (``tests/ops/test_block_tridiag.py``, the dense
oracle of ``tests/analysis/test_perfect_foresight.py``) on numpy-seeded
systems: the port equals the reference's solve within 1e-10 and the dense
solve within 1e-8; one block is a plain solve; the residual is zero; a
batch of systems (the reference ``vmap``\\ s) equals each one solved alone
and the reference's ``vmap``; the gradient equals ``jax.grad`` of the same
loss within 1e-10; a singular pivot block gives NaN, not an exception.
CPU, float64, one thread.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geconpy_torch.ops.block_tridiag import solve_block_tridiagonal as port
from geconpy_tpu.ops.block_tridiag import solve_block_tridiagonal as ref


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_system(seed, T, n, batch=()):
    rng = np.random.default_rng(seed)
    A = 0.3 * rng.normal(size=batch + (T, n, n))
    C = 0.3 * rng.normal(size=batch + (T, n, n))
    B = rng.normal(size=batch + (T, n, n)) + 4.0 * np.eye(n)
    d = rng.normal(size=batch + (T, n))
    return A, B, C, d


def dense_solve(A, B, C, d):
    T, n, _ = B.shape
    M = np.zeros((T * n, T * n))
    for t in range(T):
        M[t * n:(t + 1) * n, t * n:(t + 1) * n] = B[t]
        if t > 0:
            M[t * n:(t + 1) * n, (t - 1) * n:t * n] = A[t]
        if t < T - 1:
            M[t * n:(t + 1) * n, (t + 1) * n:(t + 2) * n] = C[t]
    return np.linalg.solve(M, d.ravel()).reshape(T, n)


def _port(*arrays):
    return port(*(torch.tensor(a) for a in arrays)).numpy()


@pytest.mark.parametrize("T,n", [(3, 2), (10, 4), (12, 4), (50, 3)])
def test_matches_reference_and_dense(T, n):
    A, B, C, d = make_system(T * 100 + n, T, n)
    x = _port(A, B, C, d)
    np.testing.assert_allclose(
        x, np.asarray(ref(*(jnp.asarray(a) for a in (A, B, C, d)))),
        rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(x, dense_solve(A, B, C, d), rtol=1e-8,
                               atol=1e-10)


def test_single_block_is_plain_solve():
    _, B, _, d = make_system(0, 1, 5)
    x = _port(np.zeros_like(B), B, np.zeros_like(B), d)
    np.testing.assert_allclose(x[0], np.linalg.solve(B[0], d[0]), rtol=1e-10)


def test_residual_is_zero():
    T = 20
    A, B, C, d = make_system(5, T, 3)
    x = _port(A, B, C, d)
    resid = []
    for t in range(T):
        r = B[t] @ x[t] - d[t]
        if t > 0:
            r = r + A[t] @ x[t - 1]
        if t < T - 1:
            r = r + C[t] @ x[t + 1]
        resid.append(r)
    assert np.max(np.abs(resid)) < 1e-9


def test_batch_equals_each_system_and_reference_vmap():
    A, B, C, d = make_system(9, 8, 3, batch=(4,))
    xs = _port(A, B, C, d)
    want = np.asarray(jax.vmap(ref)(*(jnp.asarray(a) for a in (A, B, C, d))))
    np.testing.assert_allclose(xs, want, rtol=1e-10, atol=1e-12)
    for i in range(4):
        np.testing.assert_allclose(xs[i], _port(A[i], B[i], C[i], d[i]),
                                   rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(xs[i], dense_solve(A[i], B[i], C[i], d[i]),
                                   rtol=1e-8, atol=1e-10)


def test_gradient_matches_jax_grad():
    A, B, C, d = make_system(11, 6, 2)
    want = [np.asarray(g) for g in jax.grad(
        lambda *a: jnp.sum(ref(*a) ** 2), argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (A, B, C, d)))]
    ts = [torch.tensor(a, requires_grad=True) for a in (A, B, C, d)]
    (port(*ts) ** 2).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-10, atol=1e-12)


def test_singular_pivot_is_nan_not_an_exception():
    A, B, C, d = make_system(13, 4, 2)
    B[2] = 0.0
    A[2] = 0.0
    x = _port(A, B, C, d)
    assert np.isnan(x[:3]).any()
