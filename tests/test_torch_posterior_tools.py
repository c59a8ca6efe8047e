"""Port parity: the posterior bands of ``geconpy_torch/stats/posterior.py``.

On ``rbc_estimation`` (Y and C observed with measurement error) and a
posterior of 2 x 6 draws jittered around the initial position (the
reference's ``tests/stats/test_posterior_identities.py`` fixture), carried
to the port by ``interop.posterior_from_reference``, so both packages see
the same draws:

- ``posterior_irfs``, ``posterior_autocorrelation``, ``posterior_fevd``:
  the mean and every quantile equal the reference's frame at rel 1e-10
  (of the largest entry), with the same labels; ``posterior_diagnostics``'
  flags are equal, its spectral radius at rel 1e-10, and its residual
  norms, which are rounding (~1e-16), within 1e-12.
- ``posterior_predictive`` on injected draws: the reference's standard
  normals, rebuilt from its key as it splits it, fed through the port's
  private core, give the reference's bands at rel 1e-10.  By its
  distribution under one ``torch.Generator``: bitwise reproducible, and
  at a single repeated draw the mean and variance of the last period
  within 5 standard errors of the model's own.
- The reference's identities: one draw's IRF is that draw's solution
  iterated, FEVD rows sum to 1, the predictive envelope covers the data.
- ``posterior_girfs`` on injected draws (the reference's normals rebuilt
  from its key) at rel 1e-10, and bitwise reproducible under one
  generator; ``posterior_from_reference`` refuses mismatched labels and
  shapes.
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
from geconpy_torch.stats import nonlinear as port_nonlinear
from geconpy_torch.stats import posterior as port
from geconpy_torch.stats.statespace import DSGEStateSpace as PortStateSpace
from geconpy_tpu.stats import posterior as ref
from geconpy_tpu.stats.estimation import PosteriorResult as RefResult
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace

KW = dict(observed_states=["Y", "C"], measurement_error=["Y", "C"])
MAX_DRAWS = 8


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _fields(ref_ss, us):
    c, n = us.shape[:2]
    samples = np.asarray(jax.vmap(jax.vmap(ref_ss.constrain))(jnp.asarray(us)))
    return dict(samples=samples, unconstrained=us, logp=np.zeros((c, n)),
                param_names=ref_ss.param_labels,
                diverging=np.zeros((c, n), dtype=bool),
                accept_prob=np.ones((c, n)), step_size=np.full(c, 0.1))


@pytest.fixture(scope="module")
def posterior():
    ref_ss = RefStateSpace(geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn("rbc_estimation"), verbose=False)
    ).configure(**KW)
    port_ss = PortStateSpace(geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"), verbose=False),
        device="cpu").configure(**KW)
    u0 = np.asarray(ref_ss.initial_position())
    us = u0[None, None, :] + 0.04 * np.random.default_rng(0).normal(
        size=(2, 6, len(u0)))
    fields = _fields(ref_ss, us)
    data, _ = ref_ss.data_from_prior(jax.random.PRNGKey(3), periods=40)
    return (ref_ss, port_ss, RefResult(**fields),
            posterior_from_reference(fields, port_ss), np.asarray(data))


def _assert_bands(got, want, shape, rtol=1e-10):
    """Port bands against the reference's frame, column by column."""
    for col, values in [("mean", got.mean)] + [
            (f"q{q}", got.quantiles[i]) for i, q in enumerate(got.levels)]:
        w = want[col].to_numpy().reshape(shape)
        assert values.shape == shape
        np.testing.assert_allclose(values.numpy(), w, rtol=rtol,
                                   atol=rtol * np.abs(w).max(), err_msg=col)


def test_irf_bands_match_reference(posterior):
    ref_ss, port_ss, ref_res, port_res, _ = posterior
    want = ref.posterior_irfs(ref_ss, ref_res, periods=12, max_draws=MAX_DRAWS)
    got = port.posterior_irfs(port_ss, port_res, periods=12,
                              max_draws=MAX_DRAWS)
    assert got.dims == tuple(want.index.names)
    assert list(got.labels[0]) == list(want.index.levels[0])
    assert got.labels[1] == list(ref_ss.model.functions.variable_names)
    _assert_bands(got, want, (len(got.labels[0]), len(got.labels[1]), 12))


def test_acf_bands_match_reference(posterior):
    ref_ss, port_ss, ref_res, port_res, _ = posterior
    want = ref.posterior_autocorrelation(ref_ss, ref_res, n_lags=6,
                                         max_draws=MAX_DRAWS)
    got = port.posterior_autocorrelation(port_ss, port_res, n_lags=6,
                                         max_draws=MAX_DRAWS)
    assert got.dims == tuple(want.index.names) == ("lag", "variable")
    _assert_bands(got, want, (6, len(got.labels[1])))


def test_fevd_matches_reference_and_rows_sum_to_one(posterior):
    ref_ss, port_ss, ref_res, port_res, _ = posterior
    want = ref.posterior_fevd(ref_ss, ref_res, horizon=16, max_draws=MAX_DRAWS)
    got = port.posterior_fevd(port_ss, port_res, horizon=16,
                              max_draws=MAX_DRAWS)
    assert got.variable_names == list(want.index)
    assert got.shock_names == list(want.columns)
    w = want.to_numpy()
    np.testing.assert_allclose(got.values.numpy(), w, rtol=1e-10,
                               atol=1e-10 * np.abs(w).max())
    np.testing.assert_allclose(got.values.sum(dim=1).numpy(), 1.0, rtol=1e-12)


def test_diagnostics_match_reference(posterior):
    ref_ss, port_ss, ref_res, port_res, _ = posterior
    want = ref.posterior_diagnostics(ref_ss, ref_res)
    got = port.posterior_diagnostics(port_ss, port_res)
    assert list(want.columns) == list(got._fields)
    for name in ("ss_success", "solver_success", "stable"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      want[name].to_numpy())
    np.testing.assert_allclose(got.spectral_radius.numpy(),
                               want["spectral_radius"].to_numpy(), rtol=1e-10)
    for name in ("deterministic_norm", "stochastic_norm"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   want[name].to_numpy(), rtol=0, atol=1e-12)


def test_single_draw_irf_is_the_iterated_solution(posterior):
    _, port_ss, _, port_res, _ = posterior
    single = posterior_from_reference(dict(
        samples=port_res.samples[:1, :1],
        unconstrained=port_res.unconstrained[:1, :1], logp=np.zeros((1, 1)),
        param_names=port_res.param_names, diverging=np.zeros((1, 1), bool),
        accept_prob=np.ones((1, 1)), step_size=np.full(1, 0.1)), port_ss)
    out = port.posterior_irfs(port_ss, single, periods=8, max_draws=1)
    sol = port_ss.build_solution_fn()(torch.as_tensor(
        port_res.unconstrained[0, 0]))
    T, R = sol["T"], sol["R"]
    sd = torch.sqrt(torch.diagonal(sol["Q"]))
    for j in range(R.shape[1]):
        x = R[:, j] * sd[j]
        for t in range(8):
            torch.testing.assert_close(out.mean[j, :, t], x, rtol=0,
                                       atol=1e-12)
            x = T @ x
    # with one draw the quantile bands collapse onto the mean
    torch.testing.assert_close(out.quantiles[0], out.mean, rtol=0, atol=1e-15)


def _reference_normals(key, n_draws, periods, n_shocks, k):
    """The standard normals the reference's ``posterior_predictive`` draws
    from ``key``: one key per draw, split into the shocks' and the
    measurement errors'."""
    eps, eta = [], []
    for k_draw in jax.random.split(key, n_draws):
        k_eps, k_eta = jax.random.split(k_draw)
        eps.append(np.asarray(jax.random.normal(k_eps, (periods, n_shocks))))
        eta.append(np.asarray(jax.random.normal(k_eta, (periods, k))))
    return torch.as_tensor(np.stack(eps)), torch.as_tensor(np.stack(eta))


def test_predictive_on_injected_draws_matches_reference(posterior):
    ref_ss, port_ss, ref_res, port_res, _ = posterior
    key = jax.random.PRNGKey(5)
    want = ref.posterior_predictive(ref_ss, ref_res, key, periods=20,
                                    max_draws=MAX_DRAWS)
    sol = port_ss.build_solution_fn()(port._flat_draws(port_ss, port_res,
                                                       MAX_DRAWS))
    eps, eta = _reference_normals(key, MAX_DRAWS, 20, sol["Q"].shape[-1], 2)
    ys = port._predictive_paths(sol, eps, eta)
    got = port._bands(ys.mT, (0.05, 0.5, 0.95), ("variable", "time"),
                      (list(port_ss.observed_states), range(20)))
    _assert_bands(got, want, (2, 20))


def test_predictive_by_distribution(posterior):
    _, port_ss, _, port_res, data = posterior
    a = port.posterior_predictive(port_ss, port_res,
                                  torch.Generator().manual_seed(7),
                                  periods=data.shape[0], max_draws=MAX_DRAWS)
    b = port.posterior_predictive(port_ss, port_res,
                                  torch.Generator().manual_seed(7),
                                  periods=data.shape[0], max_draws=MAX_DRAWS)
    assert torch.equal(a.mean, b.mean) and torch.equal(a.quantiles,
                                                       b.quantiles)
    assert a.dims == ("variable", "time") and torch.isfinite(a.mean).all()
    # the reference's envelope check: the data inside a generous band
    for i in range(2):
        lo, hi = a.quantiles[0, i].min(), a.quantiles[2, i].max()
        spread = hi - lo
        assert data[:, i].min() > lo - 3 * spread
        assert data[:, i].max() < hi + 3 * spread
    # one draw repeated: the last period's mean and variance against the
    # model's from a zero start, Var y_t = Z Sigma_t Zᵀ + H
    n = 400
    rep = {k: np.repeat(v[:1, :1], n, axis=1) for k, v in (
        ("samples", port_res.samples), ("unconstrained",
                                         port_res.unconstrained))}
    one = posterior_from_reference(dict(
        rep, logp=np.zeros((1, n)), param_names=port_res.param_names,
        diverging=np.zeros((1, n), bool), accept_prob=np.ones((1, n)),
        step_size=np.full(1, 0.1)), port_ss)
    periods = 10
    sol = port_ss.build_solution_fn()(torch.as_tensor(
        port_res.unconstrained[0, 0]))
    gen = torch.Generator().manual_seed(11)
    U = port._flat_draws(port_ss, one, None)
    sol_b = port_ss.build_solution_fn()(U)
    eps = torch.randn((n, periods, sol["Q"].shape[-1]), generator=gen)
    eta = torch.randn((n, periods, 2), generator=gen)
    y_last = port._predictive_paths(sol_b, eps, eta)[:, -1]
    T, R, Q, Z, H = (sol[k] for k in ("T_aug", "R_aug", "Q", "Z", "H"))
    Sigma = torch.zeros_like(T)
    for _ in range(periods):
        Sigma = T @ Sigma @ T.T + R @ Q @ R.T
    var = torch.diagonal(Z @ Sigma @ Z.T + H)
    se = torch.sqrt(var / n)
    assert ((y_last.mean(0) - sol["d"]).abs() < 5 * se).all()
    # the variance estimate's standard error is var sqrt(2 / (n - 1))
    assert ((y_last.var(0) - var).abs() < 5 * var * np.sqrt(2 / (n - 1))).all()


def test_girfs_match_reference_on_injected_draws(posterior):
    """The reference's GIRF normals, rebuilt from its key as it splits it
    over the draws, through the port's second-order solve and core: the
    bands at rel 1e-10.  Under one generator the port's bands are bitwise
    reproducible, and a given shock size moves them."""
    ref_ss, port_ss, ref_res, port_res, _ = posterior
    key, periods, n_mc = jax.random.PRNGKey(6), 8, 16
    want = ref.posterior_girfs(ref_ss, ref_res, "epsilon_A", key,
                               periods=periods, n_mc=n_mc,
                               max_draws=MAX_DRAWS)
    us = port._flat_draws(port_ss, port_res, MAX_DRAWS)
    normals = np.stack([np.asarray(jax.random.normal(
        k, (n_mc, periods, 1), jnp.float64))
        for k in jax.random.split(key, len(us))])
    sol = port_nonlinear._solution_fn(port_ss)(us)
    girfs = port._girf_paths(sol, 0, None, torch.as_tensor(normals))
    got = port._bands(girfs.mT, (0.05, 0.5, 0.95), ("variable", "time"),
                      (list(port_ss.model.functions.variable_names),
                       range(periods)))
    assert got.dims == tuple(want.index.names)
    _assert_bands(got, want, (len(got.labels[0]), periods))
    runs = [port.posterior_girfs(port_ss, port_res, "epsilon_A",
                                 torch.Generator().manual_seed(1),
                                 shock_size=size, periods=periods,
                                 n_mc=n_mc, max_draws=4)
            for size in (None, None, 0.05)]
    assert torch.equal(runs[0].mean, runs[1].mean)
    assert not torch.allclose(runs[0].mean, runs[2].mean)


def test_posterior_from_reference_refuses_mismatches(posterior):
    ref_ss, port_ss, ref_res, _, _ = posterior
    fields = {k: getattr(ref_res, k) for k in (
        "samples", "unconstrained", "logp", "param_names", "diverging",
        "accept_prob", "step_size")}
    with pytest.raises(ValueError, match="order differs"):
        posterior_from_reference(dict(fields, param_names=list(
            reversed(fields["param_names"]))), port_ss)
    with pytest.raises(ValueError, match="estimated parameters differ"):
        posterior_from_reference(dict(fields, param_names=["x"] + list(
            fields["param_names"][1:])), port_ss)
    with pytest.raises(ValueError, match="unconstrained must be"):
        posterior_from_reference(dict(fields, unconstrained=fields[
            "unconstrained"][..., :1]), port_ss)
    with pytest.raises(ValueError, match="logp must be"):
        posterior_from_reference(dict(fields, logp=np.zeros(3)), port_ss)
    with pytest.raises(ValueError, match="missing arrays"):
        posterior_from_reference({"samples": fields["samples"]}, port_ss)
