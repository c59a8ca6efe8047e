"""Port parity: ``geconpy_torch/stats/prior_predictive.py``.

``rbc_estimation`` with Y observed with an estimated measurement error
(five estimated parameters):

- On injected draws: the same constrained prior draws (the port's, from a
  ``torch.Generator``) go to the reference's ``prior_predictive_sweep``,
  whose priors' ``sample`` is patched for the test to return them in the
  order it asks, and to the port's private core; the IRF and
  standard-deviation bands, the mean FEVD and the success rate equal the
  reference's at rel 1e-10.  Some draws are pushed outside the stable
  region (rho_A near 1 does not fail; alpha at its bound does), so the
  solvable-draw filter is exercised.
- By distribution: bitwise reproducible under one seed; over 2,000 draws
  the impact of the technology shock on A (sigma_A itself, A being
  log-linear) has the prior mean of sigma_A, 0.01, within 5 standard
  errors; every draw's FEVD row sums to 1.
- ``mesh=`` raises.
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
from geconpy_torch.stats import prior_predictive as port
from geconpy_torch.stats.statespace import DSGEStateSpace as PortStateSpace
from geconpy_tpu.stats import prior_predictive as ref
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace

KW = dict(observed_states=["Y"], measurement_error=["Y"])
QUANTILES = (0.05, 0.5, 0.95)


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


@pytest.fixture(scope="module")
def spaces():
    ref_ss = RefStateSpace(geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn("rbc_estimation"), verbose=False)
    ).configure(**KW)
    port_ss = PortStateSpace(geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"), verbose=False),
        device="cpu").configure(**KW)
    assert port_ss.param_labels == ref_ss.param_labels
    return ref_ss, port_ss


def _assert_bands(got, want_mean, want_q, rtol=1e-10):
    for values, w in [(got.mean, want_mean)] + [
            (got.quantiles[i], want_q[i]) for i in range(len(got.levels))]:
        np.testing.assert_allclose(values.numpy(), w, rtol=rtol,
                                   atol=rtol * np.abs(w).max())


def test_sweep_on_injected_draws_matches_reference(spaces, monkeypatch):
    ref_ss, port_ss = spaces
    n, periods, horizon = 64, 12, 8
    gen = torch.Generator().manual_seed(0)
    X = torch.stack([p.prior.sample(gen, (n,)) for p in port_ss.estimated],
                    dim=1)
    alpha = port_ss.param_labels.index("alpha")
    X[:3, alpha] = 1.0 - 1e-13        # at the bound: no steady state
    columns = iter(X.numpy().T)
    for p in ref_ss.estimated:
        monkeypatch.setattr(type(p.prior), "sample",
                            lambda self, key, shape: jnp.asarray(next(columns)))
    want = ref.prior_predictive_sweep(ref_ss, n_draws=n, periods=periods,
                                      fevd_horizon=horizon)
    U = torch.stack([p.prior.to_unconstrained(X[:, i])
                     for i, p in enumerate(port_ss.estimated)], dim=1)
    got = port._sweep_core(port_ss, U, periods, horizon, QUANTILES)
    assert 0.0 < got.success_rate < 1.0
    assert got.success_rate == want["success_rate"]
    mf = port_ss.model.functions
    shape = (mf.n_shocks, mf.n_variables, periods)
    irf = want["irf"]
    _assert_bands(got.irf, irf["mean"].to_numpy().reshape(shape),
                  [irf[f"q{q}"].to_numpy().reshape(shape) for q in QUANTILES])
    assert got.irf.dims == tuple(irf.index.names)
    std = want["std"]
    assert got.std.labels[0] == list(std.index)
    _assert_bands(got.std, std["mean"].to_numpy(),
                  [std[f"q{q}"].to_numpy() for q in QUANTILES])
    fevd = want["fevd"]
    assert got.fevd.shock_names == list(fevd.columns)
    np.testing.assert_allclose(got.fevd.values.numpy(), fevd.to_numpy(),
                               rtol=1e-10, atol=1e-12)


def test_sweep_by_distribution(spaces):
    _, port_ss = spaces
    kw = dict(n_draws=2000, periods=4, fevd_horizon=6)
    a = port.prior_predictive_sweep(port_ss, seed=3, **kw)
    b = port.prior_predictive_sweep(port_ss, seed=3, **kw)
    assert torch.equal(a.irf.quantiles, b.irf.quantiles)
    assert a.success_rate == b.success_rate > 0.9
    mf = port_ss.model.functions
    impact = a.irf.mean[mf.shock_names.index("epsilon_A"),
                        mf.variable_names.index("A"), 0]
    # InverseGamma(6, 0.05): mean 0.01, sd 0.005
    se = 0.005 / np.sqrt(2000 * a.success_rate)
    assert abs(float(impact) - 0.01) < 5 * se
    np.testing.assert_allclose(a.fevd.values.sum(dim=1).numpy(), 1.0,
                               rtol=1e-12)
    from geconpy_torch.parallel import make_mesh

    # under a mesh of 8 CPU devices: the same draws and solvable set; the
    # bands at rel 1e-12 (a chunk's elementwise exp or pow may round in
    # its last bit unlike the whole batch's, tests/test_torch_mesh.py)
    c = port.prior_predictive_sweep(port_ss, seed=3,
                                    mesh=make_mesh(devices=("cpu",) * 8), **kw)
    assert c.success_rate == a.success_rate
    np.testing.assert_allclose(c.irf.quantiles.numpy(),
                               a.irf.quantiles.numpy(), rtol=1e-12,
                               atol=1e-15)
