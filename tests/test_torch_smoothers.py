"""Port parity: the smoothers and the masked steady-state settle.

- ``disturbance_smoother`` (shocks, measurement errors, smoothed states)
  and ``kalman_smoother`` (smoothed means and covariances) equal the
  reference's within 1e-10, on fully observed data and with scattered NaN,
  over a batch of three systems against the reference's per-draw calls.
- The disturbance smoother's identities on the port (the reference's
  ``tests/ops/test_disturbance_smoother.py`` and
  ``test_kalman_missing_patterns.py:165``): x_t = T x_{t-1} + R e_t, and
  y_t = Z x_t + d + u_t on every observed entry, within 1e-10; its states
  equal the RTS smoother's up to the latter's ridge.
- ``steady_state_kalman_loglik`` with NaN in its settle head (the masked
  settle) equals the reference's in value (1e-8) and gradient (1e-6); a
  NaN in the constant-gain tail gives -inf on both sides.
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


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _t(*xs):
    return tuple(torch.as_tensor(np.asarray(x)) for x in xs)


def _systems(seed=0, n=5, k=3, m=2, batch=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batch):
        M = rng.normal(size=(n, n))
        T = 0.85 * M / np.max(np.abs(np.linalg.eigvals(M)))
        R = rng.normal(size=(n, m))
        Q = np.diag(rng.uniform(0.5, 1.5, m) * 0.01)
        Z = rng.normal(size=(k, n))
        H = np.diag(rng.uniform(0.5, 1.5, k) * 0.001)
        d = rng.normal(size=(k,)) * 0.1
        out.append((T, R, Q, Z, H, d))
    return tuple(np.stack(x) for x in zip(*out))


def _data(T, R, Q, Z, H, d, periods, seed=1, missing=0.0):
    rng = np.random.default_rng(seed)
    x = np.zeros(T.shape[-1])
    ys = []
    cq, ch = np.linalg.cholesky(Q), np.linalg.cholesky(H)
    for _ in range(periods):
        x = T @ x + R @ (cq @ rng.normal(size=R.shape[1]))
        ys.append(Z @ x + d + ch @ rng.normal(size=Z.shape[0]))
    y = np.asarray(ys)
    if missing:
        y = np.where(rng.random(y.shape) > missing, y, np.nan)
    return y


@pytest.mark.parametrize("missing", [0.0, 0.25])
def test_smoothers_match_reference(missing):
    sys_ = _systems()
    y = _data(*(x[0] for x in sys_), periods=30, missing=missing)

    def one(T, R, Q, Z, H, d):
        a = (jnp.asarray(y), T, R, Q, Z, H)
        return (ref.disturbance_smoother(*a, d=d),
                ref.kalman_smoother(*a, d=d))

    dsm_r, ks_r = jax.jit(jax.vmap(one))(*(jnp.asarray(x) for x in sys_))
    T, R, Q, Z, H, d = _t(*sys_)
    dsm = port.disturbance_smoother(torch.as_tensor(y), T, R, Q, Z, H, d=d)
    ks = port.kalman_smoother(torch.as_tensor(y), T, R, Q, Z, H, d=d)
    for name, got, want in (("shocks", dsm.shocks, dsm_r.shocks),
                            ("obs_noise", dsm.obs_noise, dsm_r.obs_noise),
                            ("smoothed_mean", dsm.smoothed_mean,
                             dsm_r.smoothed_mean),
                            ("rts mean", ks.smoothed_mean, ks_r.smoothed_mean),
                            ("rts cov", ks.smoothed_cov, ks_r.smoothed_cov)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-10 * float(np.abs(want).max()),
                                   err_msg=name)


@pytest.mark.parametrize("missing", [0.0, 0.25])
def test_disturbance_smoother_identities(missing):
    sys_ = _systems(seed=11)
    y = _data(*(x[0] for x in sys_), periods=40, seed=12, missing=missing)
    T, R, Q, Z, H, d = _t(*sys_)
    res = port.disturbance_smoother(torch.as_tensor(y), T, R, Q, Z, H, d=d)
    xs, es, us = res.smoothed_mean, res.shocks, res.obs_noise
    recon = xs[:, :-1] @ T.mT + es[:, 1:] @ R.mT
    np.testing.assert_allclose(xs[:, 1:].numpy(), recon.numpy(), rtol=0,
                               atol=1e-10)
    fitted = (xs @ Z.mT + d[:, None, :] + us).numpy()
    obs = np.broadcast_to(np.isfinite(y), fitted.shape)
    np.testing.assert_allclose(fitted[obs], np.broadcast_to(y, fitted.shape)
                               [obs], rtol=0, atol=1e-10)
    # the RTS smoother's ridge (1e-9 tr P / n on a P_pred of rank 2 in 5
    # states) moves its states by ~1e-5 of their scale
    rts = port.kalman_smoother(torch.as_tensor(y), T, R, Q, Z, H, d=d)
    np.testing.assert_allclose(xs.numpy(), rts.smoothed_mean.numpy(),
                               rtol=0, atol=1e-4 * float(xs.abs().max()))


@pytest.mark.parametrize("where", ["head", "tail"])
def test_masked_steady_state_settle_matches_reference(where):
    """NaN in the first ``n_settle`` periods runs the masked settle (value
    1e-8, gradient 1e-6 against the reference's); NaN after them leaves a
    non-finite tail, which both sides return as -inf."""
    sys_ = _systems(seed=4)
    y = _data(*(x[0] for x in sys_), periods=40, seed=5)
    if where == "head":
        y[[2, 5], 0] = np.nan
        y[7, 1:] = np.nan
    else:
        y[30, 1] = np.nan

    def one(*a):
        return ref.steady_state_kalman_loglik(jnp.asarray(y), *a[:5], d=a[5],
                                              n_settle=12)

    vals_r, grads_r = jax.jit(jax.vmap(jax.value_and_grad(
        one, argnums=tuple(range(6)))))(*(jnp.asarray(x) for x in sys_))
    leaves = [x.requires_grad_(True) for x in _t(*sys_)]
    vals = port.steady_state_kalman_loglik(torch.as_tensor(y), *leaves[:5],
                                           d=leaves[5], n_settle=12)
    vals_r = np.asarray(vals_r)
    if where == "tail":
        assert (vals.detach().numpy() == -np.inf).all()
        assert (vals_r == -np.inf).all()
        return
    np.testing.assert_allclose(vals.detach().numpy(), vals_r, rtol=1e-8)
    grads = torch.autograd.grad(vals.sum(), leaves)
    for g, r, name in zip(grads, grads_r, ["T", "R", "Q", "Z", "H", "d"]):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(r).max()),
                                   err_msg=f"grad wrt {name}")
