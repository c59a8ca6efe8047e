"""Port parity: the discrete Lyapunov solve and its adjoint
(``geconpy_torch/ops/lyapunov.py::solve_discrete_lyapunov``).

Against ``geconpy_tpu/ops/lyapunov.py`` under ``jax.jit``, on random
stable systems from a numpy seed (spectral radii 0.3 to 0.999): P at
1e-10 of max|P|, and the VJP (T̄, Q̄ for a random cotangent P̄) at 1e-10
against ``jax.vjp``.  A batch that mixes draws with different numbers of
doublings and a NaN draw gives every finite draw exactly its solo result,
and the NaN draw NaN.  CPU, float64, one thread.
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

from geconpy_torch.ops.lyapunov import solve_discrete_lyapunov
from geconpy_tpu.ops import lyapunov as ref_lyapunov

RHOS = (0.3, 0.9, 0.97, 0.999)


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _stable_system(n: int, rho: float, rng):
    """T with spectral radius ``rho`` and a PSD Q."""
    M = rng.standard_normal((n, n))
    T = rho * M / np.max(np.abs(np.linalg.eigvals(M)))
    L = rng.standard_normal((n, 2))
    return T, L @ L.T + 0.1 * np.eye(n)


def _batch(n=5, seed=0):
    rng = np.random.default_rng(seed)
    Ts, Qs = zip(*(_stable_system(n, rho, rng) for rho in RHOS))
    return np.stack(Ts), np.stack(Qs)


_ref_solve = jax.jit(jax.vmap(ref_lyapunov.solve_discrete_lyapunov))


def _close(got, want, tol):
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) <= tol * scale, \
        np.max(np.abs(got - want)) / scale


@pytest.mark.parametrize("n", [3, 8])
def test_solve_matches_reference(n):
    T, Q = _batch(n, seed=n)
    P_ref = np.asarray(_ref_solve(T, Q))
    P = solve_discrete_lyapunov(torch.tensor(T), torch.tensor(Q)).numpy()
    for b in range(len(RHOS)):
        _close(P[b], P_ref[b], 1e-10)
    # a fixed point of the equation
    resid = P - T @ P @ T.transpose(0, 2, 1) - Q
    assert np.max(np.abs(resid)) <= 1e-9 * np.max(np.abs(P))


@pytest.mark.parametrize("n", [3, 8])
def test_vjp_matches_reference(n):
    T, Q = _batch(n, seed=10 + n)
    P_bar = np.random.default_rng(n).standard_normal(T.shape)
    _, vjp = jax.vjp(_ref_solve, jnp.asarray(T), jnp.asarray(Q))
    T_bar_ref, Q_bar_ref = (np.asarray(x) for x in vjp(jnp.asarray(P_bar)))
    Tt = torch.tensor(T, requires_grad=True)
    Qt = torch.tensor(Q, requires_grad=True)
    P = solve_discrete_lyapunov(Tt, Qt)
    T_bar, Q_bar = torch.autograd.grad(P, (Tt, Qt), torch.tensor(P_bar))
    for b in range(len(RHOS)):
        _close(T_bar[b].numpy(), T_bar_ref[b], 1e-10)
        _close(Q_bar[b].numpy(), Q_bar_ref[b], 1e-10)


def test_mixed_batch_gives_each_draw_its_solo_result():
    T, Q = _batch(4, seed=3)
    T = np.concatenate([T, T[:1]])
    Q = np.concatenate([Q, Q[:1]])
    T[-1, 0, 0] = np.nan
    Tt, Qt = torch.tensor(T), torch.tensor(Q)
    P = solve_discrete_lyapunov(Tt, Qt)
    for b in range(len(RHOS)):
        solo = solve_discrete_lyapunov(Tt[b:b + 1], Qt[b:b + 1])[0]
        assert torch.equal(P[b], solo), b
    assert torch.isnan(P[-1]).any()
    assert torch.isfinite(P[:-1]).all()
    # the draws took different numbers of doublings: the slowest draw's
    # batch-mates would move if they were not frozen
    P_ref = np.asarray(_ref_solve(T[:-1], Q[:-1]))
    for b in range(len(RHOS)):
        _close(P[b].numpy(), P_ref[b], 1e-10)


def test_gradient_of_a_nan_draw_stays_in_its_draw():
    T, Q = _batch(4, seed=5)
    T[1, 2, 2] = np.nan
    Tt = torch.tensor(T, requires_grad=True)
    Qt = torch.tensor(Q, requires_grad=True)
    P = solve_discrete_lyapunov(Tt, Qt)
    T_bar, Q_bar = torch.autograd.grad(P.sum(), (Tt, Qt))
    keep = [0, 2, 3]
    assert torch.isfinite(T_bar[keep]).all() and torch.isfinite(Q_bar[keep]).all()
    T_bar0, _ = torch.autograd.grad(
        solve_discrete_lyapunov(Tt[:1], Qt[:1]).sum(), (Tt, Qt))
    assert torch.equal(T_bar[0], T_bar0[0])
