"""Port parity: the evidence functions of
``geconpy_torch/stats/model_comparison.py``.

- On a Gaussian log posterior with a known log evidence (the reference's
  ``tests/stats/test_model_comparison.py`` problem): ``find_map`` reaches
  the mode and ``laplace_evidence`` recovers log Z within 1e-8;
  ``modified_harmonic_mean`` is the reference's numpy code, so on the same
  draws it returns the reference's value bit for bit, and log Z within
  0.02 (0.05 on chain-shaped input).
- On ``rbc_estimation`` (Y observed with measurement error, rho_A and
  sigma_A estimated, the stationary filter, 60 periods made at rho_A =
  0.6; 60 Adam steps of ``find_map``, cut from 500): the port's Laplace
  evidence at its mode against the reference's ``laplace_evidence`` at the same
  point.  The reference takes the exact ``jax.hessian`` there, the port
  central differences, which ``tests/test_torch_model_comparison.py``
  holds at rtol 1e-6; |Δ log det H| = |tr(H⁻¹ ΔH)| <= d κ(H) |ΔH|/|H|,
  so the bar is 0.5 d κ(H) 1e-6 (κ the Hessian's condition number).
- ``compare_models`` (``marginal_likelihood`` from the prior's initial
  position): the generating specification beats a restricted one (rho_A
  frozen at its calibrated 0.95), the probabilities sum to 1; from the
  same log evidences and a non-uniform model prior, both packages'
  ``compare_models`` build the same table (order, log Bayes factors,
  probabilities at 1e-12).
- ``marginal_likelihood`` refuses a missing result or an unknown method.
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
from geconpy_torch.stats import model_comparison as port
from geconpy_torch.stats.estimation import PosteriorResult
from geconpy_torch.stats.statespace import DSGEStateSpace as PortStateSpace
from geconpy_tpu.stats import model_comparison as ref
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace

_LOG2PI = 1.8378770664093453
ADAM_STEPS = 60
KW = dict(observed_states=["Y"], constant_params=["alpha", "sigma_C"],
          measurement_error={"Y": 0.005}, filter_type="stationary",
          kalman_settle=12)


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


@pytest.fixture(scope="module")
def gaussian():
    rng = np.random.default_rng(0)
    d = 4
    mu = rng.normal(size=d)
    A = rng.normal(size=(d, d))
    S = A @ A.T + np.eye(d)
    Sinv = np.linalg.inv(S)
    logdetS = np.linalg.slogdet(S)[1]
    logZ = -3.7

    def logpost_np(u):
        delta = u - mu
        quad = np.einsum("...i,ij,...j->...", delta, Sinv, delta)
        return -0.5 * (d * _LOG2PI + logdetS + quad) + logZ

    def value_and_grad(U):
        delta = U - torch.as_tensor(mu)
        P = torch.as_tensor(Sinv)
        quad = ((delta @ P) * delta).sum(-1)
        return (-0.5 * (d * _LOG2PI + logdetS + quad) + logZ,
                -(delta @ P))

    return value_and_grad, logpost_np, mu, S, logZ, d


def test_laplace_exact_on_gaussian(gaussian):
    vag, _, mu, _, logZ, _ = gaussian
    u_mode = port.find_map(vag, torch.as_tensor(mu + 2.5))
    np.testing.assert_allclose(u_mode.numpy(), mu, atol=1e-8)
    np.testing.assert_allclose(port.laplace_evidence(vag, u_mode), logZ,
                               atol=1e-8)


@pytest.mark.parametrize("shape,tau,bar", [((20_000,), 0.5, 0.02),
                                           ((4, 2_000), 0.3, 0.05)])
def test_harmonic_mean_is_the_reference(gaussian, shape, tau, bar):
    _, logpost_np, mu, S, logZ, d = gaussian
    draws = np.random.default_rng(3).multivariate_normal(
        mu, S, size=int(np.prod(shape))).reshape(shape + (d,))
    lp = logpost_np(draws)
    got = port.modified_harmonic_mean(draws, lp, tau=tau)
    assert got == ref.modified_harmonic_mean(draws, lp, tau=tau)
    np.testing.assert_allclose(got, logZ, atol=bar)


@pytest.fixture(scope="module")
def rbc():
    ref_model = geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn("rbc_estimation"), verbose=False)
    port_model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"), verbose=False)
    ref_ss = RefStateSpace(ref_model).configure(**KW)
    port_ss = PortStateSpace(port_model, device="cpu").configure(**KW)
    data, _ = port_ss.data_from_prior(torch.Generator().manual_seed(2),
                                      periods=60,
                                      params={"rho_A": 0.6, "sigma_A": 0.012})
    return ref_ss, port_ss, port_model, np.asarray(data)


def test_laplace_on_dsge_matches_reference(rbc):
    ref_ss, port_ss, _, data = rbc
    vag = port_ss.build_logpost_and_grad(data)
    u_mode = port.find_map(vag, port_ss.initial_position(),
                           adam_steps=ADAM_STEPS)
    got = port.laplace_evidence(vag, u_mode)
    want = ref.laplace_evidence(jax.jit(ref_ss.build_logpost(data)),
                                jnp.asarray(u_mode.numpy()))
    H = port.neg_hessian_fn(vag)(u_mode).numpy()
    d = len(u_mode)
    bar = 0.5 * d * np.linalg.cond(H) * 1e-6
    assert np.isfinite(want) and abs(got - want) <= bar, (got, want, bar)
    # the reference's check: a modest correction to the mode's logpost
    assert abs(got - float(vag(u_mode[None])[0][0])) < 30.0


def test_harmonic_method_reads_the_result(rbc):
    _, port_ss, _, data = rbc
    rng = np.random.default_rng(4)
    us = np.asarray(port_ss.initial_position())[None, None] \
        + 0.05 * rng.normal(size=(2, 200, 2))
    lp = port_ss.build_logpost(data)(torch.as_tensor(
        us.reshape(-1, 2))).numpy().reshape(2, 200)
    res = PosteriorResult(samples=us, unconstrained=us, logp=lp,
                          param_names=port_ss.param_labels,
                          diverging=np.zeros((2, 200), bool),
                          accept_prob=np.ones((2, 200)),
                          step_size=np.full(2, 0.1))
    got = port.marginal_likelihood(port_ss, data, result=res,
                                   method="harmonic")
    assert got == ref.modified_harmonic_mean(us, lp)


def test_compare_models_table(rbc, monkeypatch):
    ref_ss, port_ss, port_model, data = rbc
    restricted = PortStateSpace(port_model, device="cpu").configure(
        **dict(KW, constant_params=["alpha", "sigma_C", "rho_A"]))
    tab = port.compare_models({"restricted": restricted, "full": port_ss},
                              data, adam_steps=ADAM_STEPS)
    assert tab.names[0] == "full"
    assert float(tab.posterior_prob[0]) > 0.5
    np.testing.assert_allclose(float(tab.posterior_prob.sum()), 1.0,
                               rtol=1e-12)
    assert float(tab.log_bayes_factor[0]) == 0.0
    assert (tab.log_ml[:-1] >= tab.log_ml[1:]).all()
    # the reference's table from the same log evidences and model prior
    values = dict(zip(tab.names, tab.log_ml.tolist()))
    for module in (ref, port):
        monkeypatch.setattr(module, "marginal_likelihood",
                            lambda ss, data, method, **kw: values[ss])
    prior = {"full": 0.3, "restricted": 0.7}
    models = {"restricted": "restricted", "full": "full"}
    want = ref.compare_models(models, data, prior_probs=prior)
    got = port.compare_models(models, data, prior_probs=prior)
    assert got.names == list(want.index)
    for col in ("log_ml", "log_bayes_factor", "posterior_prob"):
        np.testing.assert_allclose(getattr(got, col).numpy(),
                                   want[col].to_numpy(), rtol=1e-12)
    with pytest.raises(ValueError, match="keys must match"):
        port.compare_models({"full": port_ss}, data,
                            prior_probs={"other": 1.0})


class _DummySS:
    def build_logpost_and_grad(self, data):
        raise AssertionError("not reached")


def test_method_validation():
    with pytest.raises(ValueError, match="requires a fit"):
        port.marginal_likelihood(_DummySS(), np.zeros((5, 1)),
                                 method="harmonic")
    with pytest.raises(ValueError, match="method must be"):
        port.marginal_likelihood(_DummySS(), np.zeros((5, 1)),
                                 method="bridge")
