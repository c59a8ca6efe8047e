"""The filters' start: ``x0`` and ``P0`` of the five filter functions that
take them in the reference.

``stationary_kalman_loglik``, ``stationary_loglik_from_P``,
``steady_state_kalman_loglik``, ``steady_state_filter_parts`` and
``cyclostationary_kalman_loglik`` are held to the reference's at a nonzero
start (``x0`` from a seed; ``P0`` a random SPD matrix where the reference
takes one): the value at rel 1e-8 and the gradient with respect to every
input, the start included, at rel 1e-6 of its largest entry, against
``jax.value_and_grad`` under ``vmap``.  A zero start equals the default.
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

from geconpy_torch.ops import cyclo_kalman as port_cyclo
from geconpy_torch.ops import kalman as port
from geconpy_tpu.ops import cyclo_kalman as ref_cyclo
from geconpy_tpu.ops import kalman as ref

N, K, M, BATCH, PERIODS, N_SETTLE = 6, 3, 3, 3, 60, 20
PATTERN = np.array([[True, True, False], [True, True, True]])


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _orthogonal(rng, n):
    q, r = np.linalg.qr(rng.standard_normal((n, n)))
    return q * np.sign(np.diag(r))


@pytest.fixture(scope="module")
def systems():
    """Stable systems with measurement error, one shared data path, and a
    nonzero start per draw: x0 from the seed, P0 random SPD."""
    rng = np.random.default_rng(11)
    T = np.stack([0.85 * _orthogonal(rng, N) for _ in range(BATCH)])
    R = rng.standard_normal((BATCH, N, M)) / np.sqrt(M)
    Q = np.stack([np.diag(0.05 + rng.uniform(size=M)) for _ in range(BATCH)])
    Z = rng.standard_normal((BATCH, K, N)) / np.sqrt(N)
    H = np.stack([np.diag(0.01 + 0.05 * rng.uniform(size=K))
                  for _ in range(BATCH)])
    d = 0.1 * rng.standard_normal((BATCH, K))
    x0 = 0.5 * rng.standard_normal((BATCH, N))
    A = rng.standard_normal((BATCH, N, N))
    P0 = A @ np.swapaxes(A, -1, -2) / N + 0.1 * np.eye(N)
    x = np.zeros(N)
    ys = []
    for _ in range(PERIODS):
        x = T[0] @ x + R[0] @ (np.sqrt(np.diag(Q[0])) * rng.standard_normal(M))
        ys.append(Z[0] @ x + 0.1 * rng.standard_normal(K))
    y = np.stack(ys)
    y_cyclo = y.copy()
    y_cyclo[~PATTERN[np.arange(PERIODS) % 2]] = np.nan
    return dict(T=T, R=R, Q=Q, Z=Z, H=H, d=d, x0=x0, P0=P0, y=y,
                y_cyclo=y_cyclo)


def _check(port_fn, ref_fn, arrays):
    """Value (rel 1e-8) and gradient of every input (rel 1e-6 of its
    largest entry) of ``port_fn`` (batched torch) against ``ref_fn``
    (one draw, vmapped); both return a scalar per draw."""
    vals_r, grads_r = jax.vmap(jax.value_and_grad(
        ref_fn, argnums=tuple(range(len(arrays)))))(
        *(jnp.asarray(a) for a in arrays))
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in arrays]
    vals = port_fn(*leaves)
    # a primal-only input (the fixed point P) gets no gradient: zero
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
        leaves, torch.autograd.grad(vals.sum(), leaves, allow_unused=True))]
    vals_r = np.asarray(vals_r)
    assert np.isfinite(vals_r).all()
    np.testing.assert_allclose(vals.detach().numpy(), vals_r, rtol=1e-8)
    for g, g_r in zip(grads, grads_r):
        g_r = np.asarray(g_r)
        np.testing.assert_allclose(g.numpy(), g_r, rtol=1e-6,
                                   atol=1e-6 * np.abs(g_r).max() + 1e-300)
    return vals.detach()


def test_stationary_kalman_loglik(systems):
    s = systems
    y = s["y"]

    def ref_fn(T, R, Q, Z, H, d, x0):
        return ref.stationary_kalman_loglik(jnp.asarray(y), T, R, Q, Z, H,
                                            d=d, x0=x0, n_settle=32)

    def port_fn(T, R, Q, Z, H, d, x0):
        return port.stationary_kalman_loglik(torch.as_tensor(y), T, R, Q, Z,
                                             H, d=d, x0=x0, n_settle=32)

    arrays = [s[k] for k in ("T", "R", "Q", "Z", "H", "d", "x0")]
    got = _check(port_fn, ref_fn, arrays)
    zero = port.stationary_kalman_loglik(
        torch.as_tensor(y), *(torch.as_tensor(a) for a in arrays[:5]),
        d=torch.as_tensor(s["d"]), n_settle=32)
    assert torch.equal(zero, port.stationary_kalman_loglik(
        torch.as_tensor(y), *(torch.as_tensor(a) for a in arrays[:5]),
        d=torch.as_tensor(s["d"]), x0=torch.zeros(BATCH, N), n_settle=32))
    assert not torch.allclose(zero, got)


def test_stationary_loglik_from_P(systems):
    s = systems
    y = s["y"]
    RQR = s["R"] @ s["Q"] @ np.swapaxes(s["R"], -1, -2)
    P, settled = port._hewer_settle(
        *(torch.as_tensor(a) for a in (s["T"], RQR, s["Z"], s["H"])), 32)
    assert settled.all()
    P = P.numpy()

    def ref_fn(T, RQR_, Z, H, d, x0, P_):
        return ref.stationary_loglik_from_P(jnp.asarray(y), T, RQR_, Z, H, d,
                                            x0, P_)

    def port_fn(T, RQR_, Z, H, d, x0, P_):
        return port.stationary_loglik_from_P(torch.as_tensor(y), T, RQR_, Z,
                                             H, d, x0, P_)

    _check(port_fn, ref_fn, [s["T"], RQR, s["Z"], s["H"], s["d"], s["x0"], P])


def test_steady_state_kalman_loglik(systems):
    s = systems
    y = s["y"]

    def ref_fn(T, R, Q, Z, H, d, x0, P0):
        return ref.steady_state_kalman_loglik(jnp.asarray(y), T, R, Q, Z, H,
                                              d=d, x0=x0, P0=P0,
                                              n_settle=N_SETTLE)

    def port_fn(T, R, Q, Z, H, d, x0, P0):
        return port.steady_state_kalman_loglik(torch.as_tensor(y), T, R, Q, Z,
                                               H, d=d, x0=x0, P0=P0,
                                               n_settle=N_SETTLE)

    _check(port_fn, ref_fn,
           [s[k] for k in ("T", "R", "Q", "Z", "H", "d", "x0", "P0")])


def test_steady_state_filter_parts(systems):
    """Every part at rel 1e-8, and the gradient of their sum."""
    s = systems
    y_head = s["y"][:N_SETTLE]
    names = ("T", "R", "Q", "Z", "H", "d", "x0", "P0")

    def ref_parts(*a):
        return ref.steady_state_filter_parts(jnp.asarray(y_head), *a[:5],
                                             d=a[5], x0=a[6], P0=a[7])

    def port_parts(*a):
        return port.steady_state_filter_parts(torch.as_tensor(y_head), *a[:5],
                                              d=a[5], x0=a[6], P0=a[7])

    arrays = [s[k] for k in names]
    want = jax.vmap(ref_parts)(*(jnp.asarray(a) for a in arrays))
    got = port_parts(*(torch.as_tensor(a) for a in arrays))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-8,
                                   atol=1e-10 * np.abs(w).max())
    _check(lambda *a: sum(p.sum(dim=tuple(range(1, p.ndim))) if p.ndim > 1
                          else p for p in port_parts(*a)),
           lambda *a: sum(jnp.sum(p) for p in ref_parts(*a)), arrays)


def test_cyclostationary_kalman_loglik(systems):
    s = systems
    y = s["y_cyclo"]

    def ref_fn(T, R, Q, Z, H, d, x0):
        return ref_cyclo.cyclostationary_kalman_loglik(
            jnp.asarray(y), T, R, Q, Z, H, d=d, x0=x0, mask_pattern=PATTERN)

    def port_fn(T, R, Q, Z, H, d, x0):
        return port_cyclo.cyclostationary_kalman_loglik(
            torch.as_tensor(y), T, R, Q, Z, H, d=d, x0=x0,
            mask_pattern=PATTERN)

    _check(port_fn, ref_fn,
           [s[k] for k in ("T", "R", "Q", "Z", "H", "d", "x0")])
