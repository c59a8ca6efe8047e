"""Port parity for the slice as a whole: mixed-frequency estimation, the
smoothers behind ``filter_data`` and the posterior tools.

The reference's mixed-frequency configuration
(``tests/stats/test_obs_equations_posterior.py:101-135``):
``rbc_estimation`` with ``Y_q``, the sum of Y over 3 periods, observed at
the end of each quarter (``prepare_mixed_frequency_data``) and C every
period, measurement error 0.001 on both, ``filter_type="stationary"``,
120 periods from the reference's ``data_from_prior(PRNGKey(2))``.  The
port's ``build_logpost`` (the cyclostationary filter, p = 3) equals the
reference's in value (1e-8) and gradient (1e-6), and
``build_batched_logpost(settle="pallas")`` on 8 draws equals the
reference's (1e-8) without taking the DARE kernel's route.
``filter_data`` (filtered and smoothed paths, log-likelihood) equals the
reference's DataFrame within 1e-10, and so do
``prepare_mixed_frequency_data``, ``posterior_smoothed_states`` and
``historical_shock_decomposition`` on a small ``PosteriorResult`` of
jittered draws (built as ``tests/stats/test_posterior_identities.py``
builds its own), whose parts sum to the smoothed states.
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
from geconpy_torch.stats import posterior as port_post
from geconpy_torch.stats.estimation import PosteriorResult as PortResult
from geconpy_torch.stats.statespace import DSGEStateSpace as PortStateSpace
from geconpy_tpu.stats import posterior as ref_post
from geconpy_tpu.stats.estimation import PosteriorResult as RefResult
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace

MIXED = dict(observed_states=["Y_q", "C"], aggregate={"Y_q": ("Y", "sum", 3)},
             filter_type="stationary", constant_params=["alpha", "sigma_C"],
             measurement_error={"Y_q": 0.001, "C": 0.001})


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
    return (geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn("rbc_estimation"), verbose=False),
        geconpy_torch.model_from_gcn(
            geconpy_torch.get_example_gcn("rbc_estimation"), verbose=False))


@pytest.fixture(scope="module")
def mixed(models):
    ref_model, port_model = models
    ref_ss = RefStateSpace(ref_model).configure(**MIXED)
    port_ss = PortStateSpace(port_model, device="cpu").configure(**MIXED)
    assert port_ss._obs_max_lag == ref_ss._obs_max_lag == 2
    full, draw = ref_ss.data_from_prior(jax.random.PRNGKey(2), periods=120)
    full = np.asarray(full)
    full[:, 0] = ref_post.prepare_mixed_frequency_data(
        full[2::3, 0], period=3, n_high_freq=120)[:, 0]
    u0 = np.asarray(ref_ss.unconstrain(draw))
    return ref_ss, port_ss, full, u0


def test_prepare_mixed_frequency_data_matches_reference():
    low = np.random.default_rng(0).standard_normal((10, 2))
    cases = [(low[:, 0], dict(period=3)), (low, dict(period=4)),
             (low, dict(period=3, offset=0)),
             (low, dict(period=3, n_high_freq=25)),
             (low, dict(period=12, n_high_freq=200))]
    for arr, kw in cases:
        got = port_post.prepare_mixed_frequency_data(arr, **kw)
        want = ref_post.prepare_mixed_frequency_data(arr, **kw)
        np.testing.assert_array_equal(got, want)
    assert geconpy_torch.prepare_mixed_frequency_data is \
        port_post.prepare_mixed_frequency_data


def test_logpost_value_and_gradient_match_reference(mixed):
    ref_ss, port_ss, data, u0 = mixed
    assert np.isnan(data).sum() == 80
    v_ref, g_ref = (np.asarray(x) for x in jax.jit(jax.value_and_grad(
        ref_ss.build_logpost(data)))(u0))
    u = torch.tensor(u0, requires_grad=True)
    val = port_ss.build_logpost(data)(u)
    (grad,) = torch.autograd.grad(val, u)
    assert np.isfinite(v_ref)
    np.testing.assert_allclose(float(val.detach()), v_ref, rtol=1e-8)
    np.testing.assert_allclose(grad.numpy(), g_ref, rtol=1e-6,
                               atol=1e-6 * np.max(np.abs(g_ref)))


def test_batched_logpost_takes_the_cyclostationary_route(mixed):
    """``settle="pallas"`` on periodically missing data: the policy kernel's
    path (K4's plain version here) runs and the DARE kernel's does not;
    the values equal the reference's on 8 draws."""
    ref_ss, port_ss, data, u0 = mixed
    U = u0[None] + 0.05 * np.random.default_rng(5).standard_normal((8,
                                                                    len(u0)))
    record: dict = {}
    got = port_ss.build_batched_logpost(data, settle="pallas")(
        torch.as_tensor(U), record=record).numpy()
    assert "cycle_reduction" in record and "dare_settle" not in record
    want = np.asarray(jax.jit(ref_ss.build_batched_logpost(
        data, interpret=True, cr_tile=8, settle="pallas"))(jnp.asarray(U)))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-8)


@pytest.mark.parametrize("smoother", [False, True])
def test_filter_data_matches_reference(mixed, smoother):
    ref_ss, port_ss, data, _u0 = mixed
    params = {"rho_A": 0.9}
    want = ref_ss.filter_data(data, params=params, smoother=smoother)
    got = port_ss.filter_data(data, params=params, smoother=smoother)
    assert got.variable_names == list(want.columns)
    assert got.paths.shape == want.shape
    w = want.to_numpy()
    np.testing.assert_allclose(got.paths.numpy(), w, rtol=1e-10,
                               atol=1e-10 * np.abs(w).max())
    np.testing.assert_allclose(float(got.loglik), want.attrs["loglik"],
                               rtol=1e-10)


@pytest.fixture(scope="module")
def posterior(models):
    """``rbc_estimation`` with Y and C observed with measurement error, 40
    periods, and 2 x 4 draws jittered around the initial position (the
    reference's ``test_posterior_identities.py`` fixtures)."""
    ref_model, port_model = models
    kw = dict(observed_states=["Y", "C"], measurement_error=["Y", "C"])
    ref_ss = RefStateSpace(ref_model).configure(**kw)
    port_ss = PortStateSpace(port_model, device="cpu").configure(**kw)
    u0 = np.asarray(ref_ss.initial_position())
    us = u0[None, None, :] + 0.04 * np.random.default_rng(0).normal(
        size=(2, 4, len(u0)))
    samples = np.asarray(jax.vmap(jax.vmap(ref_ss.constrain))(jnp.asarray(us)))
    fields = dict(samples=samples, unconstrained=us, logp=np.zeros((2, 4)),
                  param_names=ref_ss.param_labels,
                  diverging=np.zeros((2, 4), dtype=bool),
                  accept_prob=np.ones((2, 4)), step_size=np.full(2, 0.1))
    data, _ = ref_ss.data_from_prior(jax.random.PRNGKey(3), periods=40)
    return (ref_ss, port_ss, RefResult(**fields), PortResult(**fields),
            np.asarray(data))


def test_posterior_smoothed_states_match_reference(posterior):
    ref_ss, port_ss, ref_res, port_res, data = posterior
    want = ref_post.posterior_smoothed_states(ref_ss, ref_res, data,
                                              max_draws=6)
    got = port_post.posterior_smoothed_states(port_ss, port_res, data,
                                              max_draws=6)
    periods, n = got.mean.shape
    assert want.index.names == ["time", "variable"]
    assert list(want.index.levels[1]) == got.variable_names
    np.testing.assert_allclose(got.mean.numpy(),
                               want["mean"].to_numpy().reshape(periods, n),
                               rtol=1e-10, atol=1e-12)
    for i, q in enumerate(got.levels):
        np.testing.assert_allclose(
            got.quantiles[i].numpy(),
            want[f"q{q}"].to_numpy().reshape(periods, n),
            rtol=1e-10, atol=1e-12)


def test_historical_shock_decomposition_matches_reference(posterior):
    ref_ss, port_ss, ref_res, port_res, data = posterior
    want = ref_post.historical_shock_decomposition(ref_ss, ref_res, data,
                                                   max_draws=6)
    got = port_post.historical_shock_decomposition(port_ss, port_res, data,
                                                   max_draws=6)
    periods, n = got.smoothed.shape
    assert got.shock_names == [c for c in want.columns
                               if c not in ("initial", "smoothed")]
    for j, name in enumerate(got.shock_names):
        w = want[name].to_numpy().reshape(periods, n)
        np.testing.assert_allclose(got.contributions[j].numpy(), w,
                                   rtol=1e-10, atol=1e-10 * np.abs(w).max())
    for field in ("initial", "smoothed"):
        w = want[field].to_numpy().reshape(periods, n)
        np.testing.assert_allclose(getattr(got, field).numpy(), w,
                                   rtol=1e-10, atol=1e-10 * np.abs(w).max())
    total = got.contributions.sum(dim=0) + got.initial
    np.testing.assert_allclose(total.numpy(), got.smoothed.numpy(), rtol=0,
                               atol=1e-10)
