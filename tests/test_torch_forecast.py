"""Port parity: ``geconpy_torch/stats/forecast.py``.

On ``rbc_estimation`` (Y and C observed with measurement error, the
stationary filter's configuration of the reference's
``tests/stats/test_forecast.py``, 40 periods) and 2 x 6 jittered draws
carried across by ``interop.posterior_from_reference``:

- ``conditional_forecast``: the forecast and shock bands equal the
  reference's at rel 1e-8 (a filter runs first), and every conditioned
  entry is hit on every draw within 1e-8.
- ``posterior_forecast``: the filtered terminal state and covariance equal
  the reference's ``kalman_filter`` at rel 1e-8, and L0 L0ᵀ = P_T at
  1e-10 (eigh's eigenvector signs are free, so L0 itself is not held).
  On injected draws: the reference's normals, rebuilt from its seed as it
  splits it, and its starting states (its own filter and eigh), fed
  through the port's private core, give the reference's fan at rel 1e-8,
  or within 10 sqrt(n eps |P_T|): the square roots of the singular P_T's
  rounding-level eigenvalues, which a second eigh call moves.
  By its distribution: bitwise reproducible under one seed, the
  quantiles ordered, and the mean one step ahead within 5 standard errors
  of the draws' mean one-step prediction Z T x_T + d.
- ``_conditional_core`` on random systems, batched: the reference's core
  at rel 1e-10 and the dense pinv oracle of
  ``tests/stats/test_conditional_forecast_oracle.py`` within 1e-9; no
  conditions give the baseline and zero shocks; a condition at h leaves
  the shocks after h at zero.
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

import geconpy_torch
import geconpy_tpu
from geconpy_torch.interop import posterior_from_reference
from geconpy_torch.stats import forecast as port
from geconpy_torch.stats.posterior import _flat_draws
from geconpy_torch.stats.statespace import DSGEStateSpace as PortStateSpace
from geconpy_tpu.ops.kalman import kalman_filter as ref_kalman_filter
from geconpy_tpu.stats import forecast as ref
from geconpy_tpu.stats.estimation import PosteriorResult as RefResult
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace

KW = dict(observed_states=["Y", "C"], filter_type="stationary",
          kalman_settle=48, measurement_error={"Y": 0.01, "C": 0.01})
HORIZON = 6
MAX_DRAWS = 8


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


@pytest.fixture(scope="module")
def posterior():
    ref_ss = RefStateSpace(geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn("rbc_estimation"), verbose=False)
    ).configure(**KW)
    port_ss = PortStateSpace(geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"), verbose=False),
        device="cpu").configure(**KW)
    data, _ = ref_ss.data_from_prior(
        jax.random.PRNGKey(3), periods=40,
        params={"alpha": 0.35, "sigma_C": 1.5, "rho_A": 0.9,
                "sigma_A": 0.012})
    u0 = np.asarray(ref_ss.initial_position())
    us = u0[None, None, :] + 0.04 * np.random.default_rng(0).normal(
        size=(2, 6, len(u0)))
    samples = np.asarray(jax.vmap(jax.vmap(ref_ss.constrain))(jnp.asarray(us)))
    fields = dict(samples=samples, unconstrained=us, logp=np.zeros((2, 6)),
                  param_names=ref_ss.param_labels,
                  diverging=np.zeros((2, 6), dtype=bool),
                  accept_prob=np.ones((2, 6)), step_size=np.full(2, 0.1))
    return (ref_ss, port_ss, RefResult(**fields),
            posterior_from_reference(fields, port_ss), np.asarray(data))


def _assert_bands(got, want, shape, rtol, atol=0.0):
    for col, values in [("mean", got.mean)] + [
            (f"q{q}", got.quantiles[i]) for i, q in enumerate(got.levels)]:
        w = want[col].to_numpy().reshape(shape)
        np.testing.assert_allclose(values.numpy(), w, rtol=rtol,
                                   atol=max(atol, rtol * np.abs(w).max()),
                                   err_msg=col)


@pytest.fixture(scope="module")
def terminal(posterior):
    """The retained draws, the port's full-state solution, and the
    reference's terminal state and covariance of every draw (its own
    ``kalman_filter``)."""
    ref_ss, port_ss, _, port_res, data = posterior
    U = _flat_draws(port_ss, port_res, MAX_DRAWS)
    rsol = jax.jit(jax.vmap(ref_ss.build_solution_fn(full_state=True)))(
        jnp.asarray(U.numpy()))

    def one(T, R, Q, Z, H, d):
        f = ref_kalman_filter(jnp.asarray(data), T, R, Q, Z, H, d=d)
        return f.filtered_mean[-1], f.filtered_cov[-1]

    x_ref, P_ref = jax.jit(jax.vmap(one))(
        rsol["T_aug"], rsol["R_aug"], rsol["Q"], rsol["Z"], rsol["H"],
        rsol["d"])
    return U, port_ss.build_solution_fn(full_state=True)(U), x_ref, P_ref


def test_conditional_forecast_matches_reference(posterior):
    ref_ss, port_ss, ref_res, port_res, data = posterior
    path = np.array([1.01, 1.015, np.nan, 1.02]) * data[:, 0].mean()
    want_f, want_s = ref.conditional_forecast(
        ref_ss, ref_res, data, {"Y": path}, horizon=HORIZON,
        max_draws=MAX_DRAWS)
    got_f, got_s = port.conditional_forecast(
        port_ss, port_res, data, {"Y": path}, horizon=HORIZON,
        max_draws=MAX_DRAWS)
    assert got_f.dims == tuple(want_f.index.names)
    assert got_f.labels[0] == ["Y", "C"]
    assert list(got_f.labels[1]) == list(range(1, HORIZON + 1))
    _assert_bands(got_f, want_f, (2, HORIZON), rtol=1e-8)
    _assert_bands(got_s, want_s, (1, HORIZON), rtol=1e-8)
    # every draw hits its target: zero-width bands there
    for t in (0, 1, 3):
        np.testing.assert_allclose(got_f.quantiles[:, 0, t].numpy(), path[t],
                                   rtol=1e-8)
    assert float(got_f.quantiles[-1, 0, 2] - got_f.quantiles[0, 0, 2]) > 1e-8


def test_conditional_forecast_refuses_bad_conditions(posterior):
    _, port_ss, _, port_res, data = posterior
    with pytest.raises(KeyError, match="not an observed state"):
        port.conditional_forecast(port_ss, port_res, data, {"K": [1.0]})
    with pytest.raises(ValueError, match="longer than horizon"):
        port.conditional_forecast(port_ss, port_res, data,
                                  {"Y": np.ones(3)}, horizon=2)
    with pytest.raises(ValueError, match="no finite entries"):
        port.conditional_forecast(port_ss, port_res, data,
                                  {"Y": [np.nan]})


def test_terminal_state_matches_reference_filter(posterior, terminal):
    _, port_ss, _, _, data = posterior
    _, sol, x_ref, P_ref = terminal
    x_ref, P_ref = np.asarray(x_ref), np.asarray(P_ref)
    xT, PT = port._terminal_state(port_ss, sol, data)
    np.testing.assert_allclose(xT.numpy(), x_ref, rtol=1e-8,
                               atol=1e-8 * np.abs(x_ref).max())
    np.testing.assert_allclose(PT.numpy(), P_ref, rtol=1e-8,
                               atol=1e-8 * np.abs(P_ref).max())
    w, V = torch.linalg.eigh(PT)
    L0 = V * torch.sqrt(torch.clamp(w, min=0.0))[..., None, :]
    np.testing.assert_allclose((L0 @ L0.mT).numpy(), PT.numpy(), rtol=0,
                               atol=1e-10 * float(PT.abs().max()))


def test_forecast_on_injected_draws_matches_reference(posterior, terminal):
    ref_ss, port_ss, ref_res, _, data = posterior
    _, sol, x_ref, P_ref = terminal
    n_paths, seed = 3, 1
    want = ref.posterior_forecast(ref_ss, ref_res, data, horizon=HORIZON,
                                  max_draws=MAX_DRAWS,
                                  n_paths_per_draw=n_paths, seed=seed)
    n, m = sol["T_aug"].shape[-1], sol["Q"].shape[-1]
    # the reference's starting states and normals, as it makes them
    w, V = jax.jit(jax.vmap(jnp.linalg.eigh))(P_ref)
    L0 = V * jnp.sqrt(jnp.clip(w, 0.0))[:, None, :]
    x0, eps, eta = [], [], []
    for d, key in enumerate(jax.random.split(jax.random.PRNGKey(seed),
                                             MAX_DRAWS)):
        for k in jax.random.split(key, n_paths):
            k0, ke, km = jax.random.split(k, 3)
            x0.append(x_ref[d] + L0[d] @ jax.random.normal(k0, (n,)))
            eps.append(jax.random.normal(ke, (HORIZON, m)))
            eta.append(jax.random.normal(km, (HORIZON, 2)))
    x0, eps, eta = (torch.as_tensor(np.asarray(a)).reshape(
        (MAX_DRAWS, n_paths) + np.shape(a[0])) for a in (x0, eps, eta))
    paths = port._forecast_paths(sol, x0, eps, eta, True)
    got = port._forecast_frame(paths.reshape(-1, HORIZON, 2),
                               port_ss.observed_states, HORIZON,
                               (0.05, 0.16, 0.5, 0.84, 0.95))
    # P_T is singular: its rounding-level eigenvalues (~n eps |P_T|) are
    # clipped at zero or kept, and their square roots, ~sqrt(n eps |P_T|),
    # move the starting states by that much in directions eigh picks
    # freely; the test above holds L0 L0ᵀ = P_T itself
    atol = 10 * np.sqrt(n * np.finfo(float).eps * float(np.abs(P_ref).max()))
    _assert_bands(got, want, (2, HORIZON), rtol=1e-8, atol=atol)


def test_forecast_by_distribution(posterior):
    _, port_ss, _, port_res, data = posterior
    kw = dict(horizon=HORIZON, max_draws=MAX_DRAWS, n_paths_per_draw=400)
    a = port.posterior_forecast(port_ss, port_res, data, seed=2, **kw)
    b = port.posterior_forecast(port_ss, port_res, data, seed=2, **kw)
    assert torch.equal(a.mean, b.mean) and torch.equal(a.quantiles,
                                                       b.quantiles)
    assert (a.quantiles[1:] >= a.quantiles[:-1] - 1e-12).all()
    assert ((a.quantiles[-1] - a.quantiles[0]) > 0).all()
    # one step ahead: the mean over 8 x 400 paths against the draws'
    # mean prediction, within 5 standard errors of the paths' spread
    U = _flat_draws(port_ss, port_res, MAX_DRAWS)
    sol = port_ss.build_solution_fn(full_state=True)(U)
    xT, _ = port._terminal_state(port_ss, sol, data)
    pred = (sol["Z"] @ (sol["T_aug"] @ xT[..., None]))[..., 0] + sol["d"]
    spread = (a.quantiles[-1, :, 0] - a.quantiles[0, :, 0]) / (2 * 1.645)
    se = spread / np.sqrt(MAX_DRAWS * 400)
    assert ((a.mean[:, 0] - pred.mean(0)).abs() < 5 * se).all()
    # the fan starts near the end of the sample
    assert abs(float(a.quantiles[2, 0, 0]) - data[-1, 0]) \
        < 0.2 * max(1.0, abs(data[-1, 0]))


def _system(seed, n=4, k=2, m=3):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    T = 0.8 * M / np.max(np.abs(np.linalg.eigvals(M)))
    return (T, rng.normal(size=(n, m)), np.diag(rng.uniform(0.5, 1.5, m) * 0.01),
            rng.normal(size=(k, n)), rng.normal(size=(k,)) * 0.1,
            rng.normal(size=(n,)) * 0.05)


def _dense_oracle(T, R, Q, Z, d, xT, target, mask, horizon):
    """The reference test's brute force: the Q-weighted minimum-norm
    shocks by pinv in whitened space."""
    n, m = R.shape
    k = Z.shape[0]
    x, base = xT.copy(), []
    for _ in range(horizon):
        x = T @ x
        base.append(Z @ x + d)
    base = np.asarray(base)
    M = np.zeros((horizon * k, horizon * m))
    Tp = [np.eye(n)]
    for _ in range(horizon - 1):
        Tp.append(T @ Tp[-1])
    for h in range(horizon):
        for s in range(h + 1):
            M[h * k:(h + 1) * k, s * m:(s + 1) * m] = Z @ Tp[h - s] @ R
    sel = mask.reshape(-1)
    r = (target - base).reshape(-1)[sel]
    L = np.linalg.cholesky(np.kron(np.eye(horizon), Q))
    return (L @ np.linalg.pinv(M[sel] @ L) @ r).reshape(horizon, m)


def test_conditional_core_matches_reference_and_oracle():
    systems = [_system(s) for s in (1, 2, 3)]
    horizon = 6
    mask = np.zeros((horizon, 2), dtype=bool)
    mask[0, 0] = mask[2, 1] = mask[4, 0] = True
    target = np.zeros((horizon, 2))
    target[0, 0], target[2, 1], target[4, 0] = 0.02, -0.01, 0.015
    batch = [torch.as_tensor(np.stack(x)) for x in zip(*systems)]
    ys, eps, base = port._conditional_core(
        *batch, torch.as_tensor(target), torch.as_tensor(mask), horizon)
    for i, sys_ in enumerate(systems):
        want = ref._conditional_core(*(jnp.asarray(a) for a in sys_),
                                     jnp.asarray(target), jnp.asarray(mask),
                                     horizon)
        for got, w in zip((ys[i], eps[i], base[i]), want):
            w = np.asarray(w)
            np.testing.assert_allclose(got.numpy(), w, rtol=1e-10,
                                       atol=1e-10 * np.abs(w).max())
        np.testing.assert_allclose(
            eps[i].numpy(), _dense_oracle(*sys_, target, mask, horizon),
            atol=1e-9)
        np.testing.assert_allclose(ys[i].numpy()[mask], target[mask],
                                   atol=1e-9)


def test_conditional_core_without_conditions_and_without_leaks():
    sys_ = [torch.as_tensor(a) for a in _system(4)]
    horizon = 7
    none = torch.zeros((horizon, 2), dtype=torch.bool)
    ys, eps, base = port._conditional_core(*sys_, torch.zeros(horizon, 2),
                                           none, horizon)
    assert float(eps.abs().max()) < 1e-12
    torch.testing.assert_close(ys, base, rtol=0, atol=1e-12)
    mask = none.clone()
    mask[2, 1] = True
    target = torch.zeros(horizon, 2)
    target[2, 1] = 0.03
    _, eps, _ = port._conditional_core(*sys_, target, mask, horizon)
    assert float(eps[3:].abs().max()) < 1e-10
    assert float(eps[:3].abs().max()) > 1e-4
