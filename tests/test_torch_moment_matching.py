"""Port parity: GMM moment matching (``geconpy_torch/stats/moment_matching.py``
against ``geconpy_tpu/stats/moment_matching.py``).

The reference test's setup (``tests/stats/test_moment_matching.py``):
``rbc_estimation`` with Y and C observed under measurement error 1e-4,
alpha and sigma_C constant, the sequential filter, 4,000 periods made by
the port's ``data_from_prior`` (CPU generator, seed 21) at rho_A = 0.9,
sigma_A = 0.015, handed to both packages.

- ``model_moments`` at a fixed point: rel 1e-10.
- ``fit_moment_matching(lags=(1, 2))`` with ``ADAM_STEPS`` Adam steps (of
  400; the same on both sides) and the 6 Gauss-Newton steps: estimates
  within rel 1e-8, standard errors (the sandwich on the exact Jacobians)
  within rel 1e-8, the loss within rel 1e-8 (abs 1e-14), the model moments
  within rel 1e-10 and the labels equal; then the reference test's checks
  (recovery, SE ranges, the moment table).
- Identity weights recover rho_A as in the reference test; an explicit
  weight vector equal to the "diag" weights gives the "diag" fit; the
  input checks raise the reference's errors.
CPU, float64, one thread.
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
from geconpy_torch.stats import moment_matching as port
from geconpy_torch.stats.statespace import DSGEStateSpace as PortStateSpace
from geconpy_tpu.stats import moment_matching as ref
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace

KW = dict(observed_states=["Y", "C"], constant_params=["alpha", "sigma_C"],
          measurement_error={"Y": 1e-4, "C": 1e-4}, filter_type="sequential")
ADAM_STEPS = 100


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    src = "rbc_estimation"
    ref_ss = RefStateSpace(geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn(src), verbose=False)).configure(**KW)
    port_ss = PortStateSpace(geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn(src), verbose=False),
        device="cpu").configure(**KW)
    data, _ = port_ss.data_from_prior(torch.Generator().manual_seed(21),
                                      periods=4000,
                                      params={"rho_A": 0.9, "sigma_A": 0.015})
    return ref_ss, port_ss, np.asarray(data)


@pytest.fixture(scope="module")
def fits(setup):
    ref_ss, port_ss, data = setup
    want = ref.fit_moment_matching(ref_ss, data, lags=(1, 2),
                                   adam_steps=ADAM_STEPS)
    got = port.fit_moment_matching(port_ss, data, lags=(1, 2),
                                   adam_steps=ADAM_STEPS)
    return want, got


def test_model_moments_match(setup):
    ref_ss, port_ss, _ = setup
    u = port_ss.initial_position() + 0.05
    want = np.asarray(ref.model_moments(
        jax.jit(ref_ss.build_solution_fn(full_state=True))(
            jnp.asarray(u.numpy())), (1, 3)))
    got = port.model_moments(port_ss.build_solution_fn(full_state=True)(u),
                             (1, 3)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-18)
    # the batched call gives each draw's moments
    U = torch.stack([u, u + 0.01])
    batch = port.model_moments(port_ss.build_solution_fn(full_state=True)(U),
                               (1, 3)).numpy()
    np.testing.assert_allclose(batch[0], got, rtol=1e-12, atol=1e-20)


def test_fit_matches_reference(fits):
    want, got = fits
    assert got.success == want.success
    assert got.n_moments == want.n_moments == 2 + 3 + 4 * 2
    assert got.moment_labels == list(want.moments.index)
    for name, v in want.params.items():
        np.testing.assert_allclose(got.params[name], v, rtol=1e-8)
        np.testing.assert_allclose(got.std_errors[name], want.std_errors[name],
                                   rtol=1e-8)
    np.testing.assert_allclose(got.loss, want.loss, rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(got.moments[:, 0].numpy(),
                               want.moments["model"].to_numpy(), rtol=1e-8,
                               atol=1e-16)
    np.testing.assert_allclose(got.moments[:, 1].numpy(),
                               want.moments["sample"].to_numpy(), rtol=1e-12)


def test_fit_recovers_parameters(fits):
    """The reference test's checks, on the port's fit."""
    _, res = fits
    assert res.success
    assert abs(res.params["rho_A"] - 0.9) < 0.04
    assert abs(res.params["sigma_A"] - 0.015) < 0.003
    assert 0 < res.std_errors["rho_A"] < 0.1
    assert 0 < res.std_errors["sigma_A"] < 0.01
    assert res.moments.shape == (res.n_moments, 2)
    cov = [i for i, lab in enumerate(res.moment_labels) if lab[0] == "cov"]
    np.testing.assert_allclose(res.moments[cov, 0].numpy(),
                               res.moments[cov, 1].numpy(), rtol=0.25)


def test_weights_and_validation(setup, fits):
    _, port_ss, data = setup
    res_id = port.fit_moment_matching(port_ss, data, lags=(1,),
                                      weights="identity", adam_steps=200)
    assert res_id.success
    assert abs(res_id.params["rho_A"] - 0.9) < 0.06

    # the explicit vector of the "diag" weights takes the matrix path
    h = port._sample_moment_series(data, (1, 2))
    w = 1.0 / np.clip(np.diag(port._newey_west(h)), 1e-30, np.inf)
    res_w = port.fit_moment_matching(port_ss, data, lags=(1, 2), weights=w,
                                     adam_steps=ADAM_STEPS)
    for name, v in fits[1].params.items():
        np.testing.assert_allclose(res_w.params[name], v, rtol=1e-8)

    with pytest.raises(ValueError, match="positive"):
        port.fit_moment_matching(port_ss, data, lags=(0,))
    bad = data.copy()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="fully observed"):
        port.fit_moment_matching(port_ss, bad)
    with pytest.raises(ValueError, match="weights must be"):
        port.fit_moment_matching(port_ss, data, weights="optimal")
