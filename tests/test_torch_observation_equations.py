"""Port parity: observation equations with lag augmentation, ``aggregate=``
and the full shock covariance (``DSGEStateSpace.configure``'s
``observation_equations``, ``aggregate`` and ``full_shock_covariance``).

Each configuration on both packages, the data made by the reference's
``data_from_prior(PRNGKey(0), periods=40)`` and handed over as numpy, at
the generating draw: ``build_logpost`` at rel 1e-8 in value and 1e-6 in
gradient (sequential filter, XLA policy), and the solution function's
T_aug, R_aug, Q, Z and d at 1e-10, with the same estimated parameters and
filter core.  Cases: ``rbc_estimation`` observing output growth
``Y[] - Y[-1]`` with the steady-state intercept (one lag block);
``rbc_estimation`` observing a three-period sum of Y by ``aggregate`` and
C under measurement error (two lag blocks); ``rbc_tank`` with two shocks
and ``full_shock_covariance=True`` (one LKJ partial correlation).  The
port's own ``data_from_prior`` simulates the augmented system: finite
data of the right shape, and the generating draw holds the correlation.
CPU, float64, one thread.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest
import torch

import geconpy_torch
import geconpy_tpu
from geconpy_torch.stats.statespace import (DSGEStateSpace as PortStateSpace,
                                            aggregated_obs_equation)
from geconpy_tpu.stats import statespace as ref_statespace
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace

RBC = dict(constant_params=["alpha", "sigma_C"])
CASES = {
    "growth_rate": ("rbc_estimation", dict(
        RBC, observed_states=["dY"], ss_obs_intercept=True,
        observation_equations={"dY": "Y[] - Y[-1]"})),
    "aggregate": ("rbc_estimation", dict(
        RBC, observed_states=["Y_q", "C"], measurement_error=["C"],
        aggregate={"Y_q": ("Y", "sum", 3)})),
    "full_shock_covariance": ("rbc_tank", dict(
        observed_states=["Y", "C"], full_shock_covariance=True)),
}


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


@pytest.fixture(scope="module")
def models():
    """Each model parsed once per package, shared by its cases."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = (
                geconpy_tpu.model_from_gcn(geconpy_tpu.get_example_gcn(name),
                                           verbose=False),
                geconpy_torch.model_from_gcn(
                    geconpy_torch.get_example_gcn(name)))
        return cache[name]

    return get


@pytest.fixture(scope="module", params=list(CASES))
def case(request, models):
    model, kw = CASES[request.param]
    ref_model, port_model = models(model)
    ref_ss = RefStateSpace(ref_model).configure(**kw)
    port_ss = PortStateSpace(port_model, device="cpu").configure(**kw)
    data, draw = ref_ss.data_from_prior(jax.random.PRNGKey(0), periods=40)
    return request.param, ref_ss, port_ss, np.asarray(data), \
        np.asarray(ref_ss.unconstrain(draw))


def test_configuration_matches_reference(case):
    name, ref_ss, port_ss, _data, _u0 = case
    assert port_ss.param_labels == ref_ss.param_labels
    np.testing.assert_array_equal(port_ss._filter_core, ref_ss._filter_core)
    assert port_ss._obs_max_lag == ref_ss._obs_max_lag
    assert port_ss._n_corr == ref_ss._n_corr
    if name == "full_shock_covariance":
        assert port_ss.param_labels[-1] == "corr_epsilon_pref_epsilon_A"
        assert port_ss.estimated[-1].prior.alpha == \
            ref_ss.estimated[-1].prior.alpha


def test_logpost_matches_reference(case):
    _name, ref_ss, port_ss, data, u0 = case
    v_ref, g_ref = (np.asarray(x) for x in jax.jit(jax.value_and_grad(
        ref_ss.build_logpost(data)))(u0))
    u = torch.tensor(u0, requires_grad=True)
    val = port_ss.build_logpost(data)(u)
    (grad,) = torch.autograd.grad(val, u)
    assert np.isfinite(v_ref)
    np.testing.assert_allclose(float(val.detach()), v_ref, rtol=1e-8)
    np.testing.assert_allclose(grad.numpy(), g_ref, rtol=1e-6,
                               atol=1e-6 * np.max(np.abs(g_ref)))


def test_solution_matches_reference(case):
    _name, ref_ss, port_ss, _data, u0 = case
    want = jax.jit(ref_ss.build_solution_fn())(u0)
    got = port_ss.build_solution_fn()(torch.tensor(u0))
    L = ref_ss._obs_max_lag
    assert got["T_aug"].shape[-1] == (L + 1) * len(ref_ss._filter_core)
    for key in ("T_aug", "R_aug", "Q", "Z", "d"):
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=1e-10 * max(np.max(np.abs(w)), 1.0),
                                   err_msg=key)


def test_data_from_prior_simulates_the_augmented_system(case):
    name, _ref_ss, port_ss, _data, _u0 = case
    data, draw = port_ss.data_from_prior(torch.Generator().manual_seed(1),
                                         periods=30)
    assert data.shape == (30, len(port_ss.observed_states))
    assert np.isfinite(data).all()
    assert set(draw) == set(port_ss.param_labels)
    if name == "full_shock_covariance":
        assert -1.0 < draw["corr_epsilon_pref_epsilon_A"] < 1.0


def test_aggregated_obs_equation_is_the_reference_text():
    for method in ("sum", "mean", "last", "first"):
        assert aggregated_obs_equation("Y", method, 3) == \
            ref_statespace.aggregated_obs_equation("Y", method, 3)
    with pytest.raises(ValueError, match="aggregation"):
        aggregated_obs_equation("Y", "median", 3)
