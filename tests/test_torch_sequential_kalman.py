"""Port parity: the sequential Kalman filter with missing data
(``geconpy_torch/ops/kalman.py::kalman_filter``, ``kalman_loglik``).

Against ``geconpy_tpu/ops/kalman.py`` under ``jax.jit`` (vmapped over the
draws), on random stable systems from a numpy seed (n = 4 states, m = 2
shocks, k = 3 observables, 30 periods, 3 draws): every field of
``KalmanFilterResult`` at 1e-10 of its largest entry, on fully observed
data, on random NaN patterns, with a period that observes nothing and with
a series missing in every period, from an explicit x0/P0 and from the
Lyapunov default.  The gradients of the log-likelihood with respect to T,
R, Q, Z, H and d at 1e-8 against ``jax.grad``.  A draw whose F is not
positive definite gets -inf from ``kalman_loglik``, never an exception,
and leaves its batch-mates as they were.  The unmasked step of the sweep's
settle is not touched (``tests/test_torch_kalman.py``).  CPU, float64,
one thread.
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

from geconpy_torch.ops import kalman as port
from geconpy_tpu.ops import kalman as ref

N, M, K, PERIODS, DRAWS = 4, 2, 3, 30, 3


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _systems(seed=0):
    rng = np.random.default_rng(seed)
    T, R, Q, Z, H, d = [], [], [], [], [], []
    for rho in (0.5, 0.9, 0.98)[:DRAWS]:
        A = rng.standard_normal((N, N))
        T.append(rho * A / np.max(np.abs(np.linalg.eigvals(A))))
        R.append(rng.standard_normal((N, M)))
        Lq = rng.standard_normal((M, M))
        Q.append(Lq @ Lq.T + 0.5 * np.eye(M))
        Z.append(rng.standard_normal((K, N)))
        H.append(np.diag(rng.uniform(0.05, 0.2, K)))
        d.append(rng.standard_normal(K))
    return tuple(np.stack(x) for x in (T, R, Q, Z, H, d))


def _data(pattern: str, seed=1):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((PERIODS, K))
    if pattern == "nan":
        y[rng.uniform(size=y.shape) < 0.3] = np.nan
    elif pattern == "empty_period":
        y[rng.uniform(size=y.shape) < 0.2] = np.nan
        y[7] = np.nan
    elif pattern == "missing_series":
        y[:, 1] = np.nan
    return y


def _x0_P0(seed=2):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((DRAWS, N))
    L = rng.standard_normal((DRAWS, N, N))
    return x0, L @ L.transpose(0, 2, 1) + np.eye(N)


def _ref_filter(y, mats, x0=None, P0=None):
    def one(T, R, Q, Z, H, d, x0_, P0_):
        return ref.kalman_filter(y, T, R, Q, Z, H, d=d, x0=x0_, P0=P0_)

    if x0 is None:
        fn = jax.vmap(lambda T, R, Q, Z, H, d: one(T, R, Q, Z, H, d, None,
                                                    None))
        return jax.jit(fn)(*mats)
    return jax.jit(jax.vmap(one))(*mats, x0, P0)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.max(np.abs(want)), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("explicit_init", [False, True])
@pytest.mark.parametrize("pattern", ["full", "nan", "empty_period",
                                     "missing_series"])
def test_every_field_matches_reference(pattern, explicit_init):
    mats = _systems()
    y = _data(pattern)
    x0, P0 = _x0_P0() if explicit_init else (None, None)
    want = _ref_filter(y, mats, x0, P0)
    got = port.kalman_filter(
        torch.tensor(y), *(torch.tensor(x) for x in mats[:5]),
        d=torch.tensor(mats[5]),
        x0=None if x0 is None else torch.tensor(x0),
        P0=None if P0 is None else torch.tensor(P0))
    assert got._fields == want._fields
    for field in got._fields:
        _close(getattr(got, field).numpy(), getattr(want, field), 1e-10)
    assert np.isfinite(got.loglik.numpy()).all()
    loglik = port.kalman_loglik(torch.tensor(y),
                                *(torch.tensor(x) for x in mats[:5]),
                                d=torch.tensor(mats[5]),
                                x0=None if x0 is None else torch.tensor(x0),
                                P0=None if P0 is None else torch.tensor(P0))
    _close(loglik.numpy(), want.loglik, 1e-10)


def test_a_period_without_observations_only_predicts():
    mats = _systems()
    y = _data("empty_period")
    got = port.kalman_filter(torch.tensor(y),
                             *(torch.tensor(x) for x in mats[:5]),
                             d=torch.tensor(mats[5]))
    assert torch.equal(got.loglik_t[:, 7], torch.zeros(DRAWS))
    assert torch.allclose(got.filtered_mean[:, 7], got.predicted_mean[:, 7],
                          rtol=0, atol=1e-14)


@pytest.mark.parametrize("pattern", ["full", "nan"])
def test_gradients_match_reference(pattern):
    mats = _systems(seed=4)
    y = _data(pattern, seed=5)

    def ref_ll(T, R, Q, Z, H, d):
        return ref.kalman_loglik(y, T, R, Q, Z, H, d=d)

    want = jax.jit(jax.vmap(jax.grad(ref_ll, argnums=tuple(range(6)))))(
        *mats)
    leaves = [torch.tensor(x, requires_grad=True) for x in mats]
    ll = port.kalman_loglik(torch.tensor(y), *leaves[:5], d=leaves[5])
    got = torch.autograd.grad(ll.sum(), leaves)
    for name, g, w in zip("T R Q Z H d".split(), got, want):
        scale = max(np.max(np.abs(np.asarray(w))), 1.0)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-8 * scale, err_msg=name)


def test_non_positive_definite_F_is_minus_inf():
    T, R, Q, Z, H, d = _systems(seed=6)
    y = _data("nan", seed=7)
    clean = port.kalman_loglik(torch.tensor(y), *(torch.tensor(x) for x in
                                                  (T, R, Q, Z, H)),
                               d=torch.tensor(d))
    H_bad = H.copy()
    H_bad[1] = -1e3 * np.eye(K)
    got = port.kalman_loglik(torch.tensor(y), *(torch.tensor(x) for x in
                                                (T, R, Q, Z, H_bad)),
                             d=torch.tensor(d))
    assert got[1].item() == -np.inf
    assert torch.equal(got[[0, 2]], clean[[0, 2]])
    want = np.asarray(jax.jit(jax.vmap(
        lambda *a: ref.kalman_loglik(y, *a[:5], d=a[5])))(T, R, Q, Z, H_bad,
                                                           d))
    assert want[1] == -np.inf
