"""Port parity: the bootstrap particle filter
(``geconpy_torch/ops/particle_filter.py``).

On linear Gaussian systems made with numpy from a seed (the reference's
``tests/ops/test_particle_filter.py`` cases), CPU, float64, one thread:

- On injected draws: the reference's uniforms and normals, rebuilt from
  its key as it splits it, fed to the port's private core, give the
  reference's log-likelihood, increments, ESS and filtered means at rel
  1e-10, with missing data and with resampling at every step.
- By distribution under one ``torch.Generator``: bitwise reproducible; the
  mean log-likelihood of 5 runs at 4,096 particles lies within 0.5 of the
  exact Kalman value (the reference's bar at 8,192) and the runs' spread
  under 0.5; the ESS lies in [1, N].
- A batch of parameter draws equals each draw alone, bitwise; the batched
  systematic resampling equals the one-cloud version row by row; an
  explosive transition flips ``success`` without raising.
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

from geconpy_torch.ops import kalman as port_kalman
from geconpy_torch.ops import particle_filter as port
from geconpy_torch.ops.lyapunov import solve_discrete_lyapunov
from geconpy_tpu.ops import particle_filter as ref


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _system(seed, n=3, q=2, k=2, periods=40, missing=False):
    rng = np.random.default_rng(seed)
    A = 0.3 * rng.standard_normal((n, n))
    T = 0.7 * A / max(1.0, np.abs(np.linalg.eigvals(A)).max())
    R = 0.5 * rng.standard_normal((n, q))
    Z = rng.standard_normal((k, n))
    Q = np.diag([0.04, 0.09])
    H = 0.05 * np.eye(k)
    x, ys = np.zeros(n), []
    for _ in range(periods):
        x = T @ x + R @ (np.sqrt(np.diag(Q)) * rng.standard_normal(q))
        ys.append(Z @ x + np.sqrt(0.05) * rng.standard_normal(k))
    y = np.asarray(ys)
    if missing:
        y[10:20, 0] = np.nan
        y[25, :] = np.nan
    P0 = solve_discrete_lyapunov(torch.as_tensor(T),
                                 torch.as_tensor(R @ Q @ R.T)).numpy()
    return dict(T=T, R=R, Z=Z, Q=Q, H=H, y=y, P0=P0)


def _port_fns(s):
    T, R, Z = (torch.as_tensor(s[k]) for k in "TRZ")
    return lambda x, e: x @ T.mT + e @ R.mT, lambda x: x @ Z.mT


def _ref_draws(key, periods, n_particles, q):
    """The reference's per-period resampling offsets and shock normals."""
    us, eps = [], []
    for k_t in jax.random.split(key, periods):
        k_eps, k_res = jax.random.split(k_t)
        us.append(float(jax.random.uniform(k_res, ())))
        eps.append(np.asarray(jax.random.normal(k_eps, (n_particles, q),
                                                jnp.float64)))
    return np.asarray(us), np.stack(eps)


@pytest.mark.parametrize("missing, threshold", [(False, 0.5), (True, 1.0)])
def test_matches_reference_on_injected_draws(missing, threshold):
    s = _system(3, missing=missing)
    n_particles, n = 256, s["T"].shape[0]
    init = np.array(jax.random.multivariate_normal(
        jax.random.PRNGKey(4), jnp.zeros(n), jnp.asarray(s["P0"]),
        (n_particles,)))
    key = jax.random.PRNGKey(5)
    T, R, Z = (jnp.asarray(s[k]) for k in "TRZ")
    want = ref.particle_filter_loglik(
        key, jnp.asarray(s["y"]), jnp.asarray(init),
        lambda x, e: T @ x + R @ e, lambda x: Z @ x, jnp.asarray(s["Q"]),
        jnp.asarray(s["H"]), ess_threshold=threshold)
    us, eps = _ref_draws(key, len(s["y"]), n_particles, 2)
    got = port._particle_filter(
        torch.as_tensor(s["y"]), torch.as_tensor(init), *_port_fns(s),
        torch.as_tensor(s["Q"]), torch.as_tensor(s["H"]), threshold,
        lambda t: (torch.tensor(us[t]), torch.as_tensor(eps[t])))
    assert bool(got.success) and bool(want.success)
    for g, w in zip(got[:4], want[:4]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                   atol=1e-10 * np.abs(w).max())


def test_mean_loglik_matches_kalman():
    s = _system(3)
    yt = torch.as_tensor(s["y"])
    T, R, Z, Q, H, P0 = (torch.as_tensor(s[k])
                         for k in ("T", "R", "Z", "Q", "H", "P0"))
    kf = float(port_kalman.kalman_filter(yt, T, R, Q, Z, H, P0=P0).loglik)
    gen = torch.Generator().manual_seed(0)
    init = torch.randn((4096, 3), generator=gen) @ torch.linalg.cholesky(P0).mT
    runs = [port.particle_filter_loglik(
        torch.Generator().manual_seed(seed), yt, init, *_port_fns(s), Q, H)
        for seed in range(5)]
    again = port.particle_filter_loglik(torch.Generator().manual_seed(0), yt,
                                        init, *_port_fns(s), Q, H)
    for a, b in zip(again, runs[0]):
        assert torch.equal(a, b)
    lls = np.array([float(r.loglik) for r in runs])
    assert all(bool(r.success) for r in runs)
    assert abs(lls.mean() - kf) < 0.5, (lls, kf)
    assert lls.std() < 0.5
    ess = runs[0].ess_t.numpy()
    assert np.all(ess >= 1.0 - 1e-9) and np.all(ess <= 4096 + 1e-6)


def test_batch_equals_draws_one_at_a_time():
    systems = [_system(seed, missing=True) for seed in range(3)]
    st = {k: torch.as_tensor(np.stack([s[k] for s in systems]))
          for k in ("T", "R", "Z", "Q", "H")}
    init = torch.randn((3, 128, 3), generator=torch.Generator().manual_seed(1))
    us = torch.rand((40, 3), generator=torch.Generator().manual_seed(2))
    eps = torch.randn((40, 3, 128, 2),
                      generator=torch.Generator().manual_seed(3))
    y = torch.as_tensor(systems[0]["y"])

    def run(sl):
        T, R, Z = st["T"][sl], st["R"][sl], st["Z"][sl]
        return port._particle_filter(
            y, init[sl], lambda x, e: x @ T.mT + e @ R.mT,
            lambda x: x @ Z.mT, st["Q"][sl], st["H"][sl], 0.5,
            lambda t: (us[t, sl], eps[t, sl]))

    batch = run(slice(0, 3))
    for i in range(3):
        alone = run(slice(i, i + 1))
        for b, a in zip(batch, alone):
            assert torch.equal(b[i:i + 1], a)


def test_batched_resampling_equals_one_cloud():
    gen = torch.Generator().manual_seed(0)
    log_w = 0.3 * torch.randn((4, 512), generator=gen)
    u = torch.rand((4,), generator=gen)
    batch = port.systematic_resample_indices(log_w, u)
    for i in range(4):
        assert torch.equal(batch[i],
                           port.systematic_resample_indices(log_w[i], u[i]))
    parts = torch.randn((512, 2), generator=gen) + torch.tensor([1.0, -2.0])
    (res,) = port.systematic_resample(gen, log_w[0], (parts,))
    w = torch.softmax(log_w[0], dim=0)
    np.testing.assert_allclose(res.mean(0).numpy(), (w @ parts).numpy(),
                               atol=0.05)


def test_flags_nonfinite():
    res = port.particle_filter_loglik(
        torch.Generator().manual_seed(0), torch.ones(10, 1),
        torch.full((256, 1), 5.0), lambda x, e: torch.exp(x * 80.0) + e,
        lambda x: x, 0.01 * torch.eye(1), 0.01 * torch.eye(1))
    assert not bool(res.success)
