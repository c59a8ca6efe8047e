"""Port parity: maximum likelihood (``geconpy_torch/stats/ml.py``).

``rbc_estimation`` as the reference's ``tests/stats/test_ml.py`` configures
it (Y and C observed with measurement error 0.005, the stationary filter,
alpha and sigma_C constant), 200 periods made at rho_A = 0.92 and sigma_A
= 0.012 (600 in the reference's test); ``fit_ml`` with 100 Adam steps (of
500).  Against the reference's pieces at the port's mode: its flag-gated
log-likelihood there equals the port's at rel 1e-8 and its exact gradient
is zero there (so the port found the reference's maximum), the transform
Jacobian is the reference's ``jacrev`` at 1e-12, and the standard errors
are the reference's formula on the reference's Hessian
(``neg_hessian_fn``) within κ(H) 1e-6 relative: the port's
central-difference Hessian is held at rtol 1e-6
(``tests/test_torch_model_comparison.py``) and an inverse moves by at most
κ(H) times a relative change.  Then the reference test's checks:
success, the truth within 4 standard errors, BIC > AIC, t-stats > 2.
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
from geconpy_torch.stats import ml as port
from geconpy_torch.stats.statespace import DSGEStateSpace as PortStateSpace
from geconpy_tpu.stats import model_comparison as ref_mc
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace

KW = dict(observed_states=["Y", "C"], filter_type="stationary",
          kalman_settle=48, measurement_error={"Y": 0.005, "C": 0.005},
          constant_params=["alpha", "sigma_C"])
TRUTH = {"rho_A": 0.92, "sigma_A": 0.012}


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


@pytest.fixture(scope="module")
def fitted():
    port_ss = PortStateSpace(geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"), verbose=False),
        device="cpu").configure(**KW)
    ref_ss = RefStateSpace(geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn("rbc_estimation"), verbose=False)
    ).configure(**KW)
    data, _ = port_ss.data_from_prior(torch.Generator().manual_seed(5),
                                      periods=200, params=TRUTH)
    return ref_ss, port_ss, data, port.fit_ml(port_ss, data, adam_steps=100)


def test_fit_ml_matches_the_reference_at_its_mode(fitted):
    ref_ss, port_ss, data, res = fitted
    extras = ref_ss.build_logpost_extras(data)

    def loglik(u):          # the reference's objective (ml.py:55-61)
        ex = extras(u)
        return jnp.where(jnp.isfinite(ex.logpost), ex.loglik,
                         jnp.asarray(-jnp.inf, ex.loglik.dtype))

    loglik = jax.jit(loglik)
    u = jnp.asarray(res.unconstrained)
    np.testing.assert_allclose(res.loglik, float(loglik(u)), rtol=1e-8)
    g = np.asarray(jax.jit(jax.grad(loglik))(u))
    assert np.abs(g).max() < 1e-5 * abs(res.loglik), g
    J = np.asarray(jax.jacrev(ref_ss.constrain)(u))
    J_port = torch.autograd.functional.jacobian(
        port_ss.constrain, torch.as_tensor(res.unconstrained)).numpy()
    np.testing.assert_allclose(J_port, J, rtol=1e-12, atol=1e-14)
    H = np.asarray(jax.jit(ref_mc.neg_hessian_fn(loglik, u))(u))
    cov = J @ np.linalg.inv(H + 1e-12 * np.eye(len(H))) @ J.T
    se = np.sqrt(np.clip(np.diag(cov), 0, np.inf))
    got = np.asarray([res.std_errors[n] for n in ref_ss.param_labels])
    np.testing.assert_allclose(got, se, rtol=np.linalg.cond(H) * 1e-6)


def test_mle_recovers_and_reports(fitted):
    _, _, data, res = fitted
    assert res.success
    assert list(res.params) == ["rho_A", "sigma_A"]
    for name, true in TRUTH.items():
        se = res.std_errors[name]
        assert 0 < se < 0.2
        assert abs(res.params[name] - true) < 4 * se + 1e-3
    assert np.isfinite(res.aic) and np.isfinite(res.bic)
    assert res.bic > res.aic        # k ln T > 2k at T = 200
    np.testing.assert_allclose(res.aic, 2 * 2 - 2 * res.loglik, rtol=1e-15)
    summ = res.summary()
    assert summ["names"] == ["rho_A", "sigma_A"]
    np.testing.assert_allclose(summ["t_stat"],
                               summ["estimate"] / summ["std_error"])
    assert (np.abs(summ["t_stat"]) > 2).all()
