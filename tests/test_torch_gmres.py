"""Port parity: the batched GMRES (``geconpy_torch/ops/gmres.py``) against
``jax.scipy.sparse.linalg.gmres(..., solve_method="batched")``, and the
Newton-Krylov solver built on it (``geconpy_torch/ops/newton.py::
newton_krylov_solve``) on the reference's Krylov tests
(``tests/ops/test_newton.py:149-194``).

GMRES returns its iterate after ``maxiter`` restarts, so with ``maxiter``
1, 2 and 3 the iterate after each restart is held to JAX's within 1e-10
(relative to its largest entry), on numpy-seeded well-conditioned
(diagonally dominant) and ill-conditioned (singular values over 8 decades)
systems, without and with a Jacobi preconditioner.  A batch whose draws
stop at different restarts (one at the start, one after an Arnoldi
breakdown, one ill-conditioned, one ordinary) equals each draw run alone
bit for bit, and each equals JAX's.  Then Newton-Krylov: the reference's
banded fixtures reach the dense Newton root, and a 3,000-unknown system
converges matrix-free.  CPU, float64, one thread.
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

from geconpy_torch.ops import newton as port_newton
from geconpy_torch.ops.gmres import gmres


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _system(kind: str, N: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "well":
        A = 3.0 * np.eye(N) + 0.3 * rng.normal(size=(N, N))
    else:
        U, _ = np.linalg.qr(rng.normal(size=(N, N)))
        V, _ = np.linalg.qr(rng.normal(size=(N, N)))
        A = U @ np.diag(np.logspace(0, 8, N)) @ V.T
    return A, rng.normal(size=N)


def _jax(A, b, M, **kw):
    Mj = None if M is None else (lambda v, M=jnp.asarray(M): M @ v)
    x, _ = jax.scipy.sparse.linalg.gmres(
        lambda v, A=jnp.asarray(A): A @ v, jnp.asarray(b), M=Mj,
        solve_method="batched", **kw)
    return np.asarray(x)


def _port(A, b, M, **kw):
    At = torch.tensor(A)
    Mt = None if M is None else torch.tensor(M)
    return gmres(lambda v: (At @ v[..., None])[..., 0], torch.tensor(b), M=(
        None if Mt is None else lambda v: (Mt @ v[..., None])[..., 0]),
        **kw).numpy()


@pytest.mark.parametrize("kind,N", [("well", 30), ("ill", 40), ("well", 6)])
@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("maxiter", [1, 2, 3])
def test_iterate_after_each_restart_matches_jax(kind, N, precond, maxiter):
    A, b = _system(kind, N, N + maxiter)
    M = np.diag(1.0 / np.diag(A)) if precond else None
    kw = dict(tol=1e-8, restart=10, maxiter=maxiter)
    want = _jax(A, b, M, **kw)
    got = _port(A[None], b[None], None if M is None else M[None], **kw)[0]
    assert np.max(np.abs(got - want)) <= 1e-10 * np.max(np.abs(want))


def test_defaults_match_jax():
    """tol 1e-5, restart 20, maxiter 10 x size (run to the tolerance)."""
    A, b = _system("well", 50, 7)
    want = _jax(A, b, None)
    got = _port(A[None], b[None], None)[0]
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_mixed_batch_equals_solo_runs_and_jax():
    """Draw 0: b = 0, done before the first restart.  Draw 1: A = I, the
    Arnoldi process breaks down after one step.  Draw 2: ill-conditioned,
    every restart runs.  Draw 3: well-conditioned, done early."""
    N = 12
    A_ill, b_ill = _system("ill", N, 3)
    A_well, b_well = _system("well", N, 4)
    A = np.stack([A_well, np.eye(N), A_ill, A_well])
    b = np.stack([np.zeros(N), b_well, b_ill, b_well])
    kw = dict(tol=1e-9, restart=5, maxiter=6)
    batch = _port(A, b, None, **kw)
    for i in range(4):
        solo = _port(A[i:i + 1], b[i:i + 1], None, **kw)
        np.testing.assert_array_equal(batch[i:i + 1], solo)
        want = _jax(A[i], b[i], None, **kw)
        np.testing.assert_allclose(batch[i], want, rtol=1e-10,
                                   atol=1e-10 * max(np.abs(want).max(), 1.0))
    np.testing.assert_array_equal(batch[0], 0.0)
    np.testing.assert_allclose(batch[1], b_well, rtol=1e-14)


def _banded(kind, x):
    zero = torch.zeros_like(x[..., :1])
    xm = torch.cat([zero, x[..., :-1]], -1)
    if kind == "broyden_tridiag":
        xn = torch.cat([x[..., 1:], zero], -1)
        return (3.0 - 2.0 * x) * x - xm - 2.0 * xn + 1.0
    return x - 0.4 * torch.tanh(xm) + 0.2 * torch.exp(-x) - 0.5


@pytest.mark.parametrize("kind,x0", [("broyden_tridiag", -np.ones(30)),
                                     ("exp_coupled", np.zeros(24))])
def test_newton_krylov_matches_newton(kind, x0):
    def f(x):
        return _banded(kind, x)

    x0 = torch.tensor(x0)[None]
    dense = port_newton.newton_solve(f, x0, tol=1e-10)
    got = port_newton.newton_krylov_solve(f, x0, tol=1e-10)
    assert bool(dense.success[0]) and bool(got.success[0])
    np.testing.assert_allclose(got.x.numpy(), dense.x.numpy(), rtol=1e-7,
                               atol=1e-9)


def test_newton_krylov_never_materializes_jacobian():
    d = 3000

    def f(x):
        zero = torch.zeros_like(x[..., :1])
        xm = torch.cat([zero, x[..., :-1]], -1)
        xp = torch.cat([x[..., 1:], zero], -1)
        return 3 * x - 0.5 * xm - 0.5 * xp + 0.1 * torch.exp(-x) - 0.05

    res = port_newton.newton_krylov_solve(
        f, torch.zeros(1, d, dtype=torch.float64), tol=1e-9,
        gmres_maxiter=40)
    assert bool(res.success[0]), float(res.norm[0])
    assert float(res.norm[0]) < 1e-8
