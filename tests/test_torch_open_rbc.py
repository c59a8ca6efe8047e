"""The estimation path end to end on ``open_rbc``, a model whose steady
state is numeric (10 unknowns, 8 Newton iterations from the default
guess), so every gradient flows through the steady state's implicit
adjoint.

``configure(observed_states=["Y"])`` estimates the six parameters of the
GCN's priors; the data are the reference's ``data_from_prior(PRNGKey(0),
periods=64)``, handed to both packages as numpy.  Against the reference
(CPU, float64, one thread):

- the ``build_logpost`` twin (sequential filter, XLA policy) at the
  generating draw: value rel 1e-8, gradient rel 1e-6, and the extras'
  flags equal;
- ``build_batched_loglik(policy="pallas", settle="pallas")`` through the
  kernels' plain versions against the reference's ``interpret=True``, rel
  1e-8 on 8 draws, one with a steady state that fails (sigma_C = e^15):
  -inf on both sides;
- ``build_batched_logpost_and_grad`` on ``filter_type="stationary"`` with
  ``settle="pallas"`` (K4 and K6 through their plain versions): rel 1e-8
  (value) and 1e-6 (gradient), the failed draw -inf with a zeroed
  gradient;

and on the port alone: ``data_from_prior`` and a short ``fit_smc`` finish
with finite results.
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
from geconpy_torch.stats.statespace import DSGEStateSpace as PortStateSpace
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace

ESTIMATED = ["alpha", "psi_b", "rho_A", "sigma_A", "sigma_C", "sigma_L"]


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    ref = geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn("open_rbc"), verbose=False)
    port = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("open_rbc"))
    return ref, port


def _spaces(models, **kw):
    ref, port = models
    kw = dict(observed_states=["Y"], **kw)
    return (RefStateSpace(ref).configure(**kw),
            PortStateSpace(port, device="cpu").configure(**kw))


@pytest.fixture(scope="module")
def twin(models):
    ref_ss, port_ss = _spaces(models)
    assert port_ss.param_labels == ESTIMATED
    data, draw = ref_ss.data_from_prior(jax.random.PRNGKey(0), periods=64)
    data = np.asarray(data)
    u0 = np.asarray(ref_ss.unconstrain(draw))
    U = u0 + 0.05 * np.random.default_rng(0).standard_normal((8, len(u0)))
    U[5, ESTIMATED.index("sigma_C")] = 15.0     # no steady state
    return data, u0, U


def test_logpost_twin_matches_reference(models, twin):
    ref_ss, port_ss = _spaces(models)
    data, u0, _ = twin
    v_ref, g_ref = (np.asarray(x) for x in jax.jit(jax.value_and_grad(
        ref_ss.build_logpost(data)))(u0))
    u = torch.tensor(u0, requires_grad=True)
    val = port_ss.build_logpost(data)(u)
    (grad,) = torch.autograd.grad(val, u)
    assert np.isfinite(v_ref)
    np.testing.assert_allclose(float(val.detach()), v_ref, rtol=1e-8)
    np.testing.assert_allclose(grad.numpy(), g_ref, rtol=1e-6,
                               atol=1e-6 * np.abs(g_ref).max())
    want = jax.jit(ref_ss.build_logpost_extras(data))(u0)
    got = port_ss.build_logpost_extras(data)(torch.tensor(u0))
    for field in ("ss_success", "solver_success"):
        assert bool(getattr(got, field)) == bool(getattr(want, field)) is True
    np.testing.assert_allclose(float(got.logprior), float(want.logprior),
                               rtol=1e-8)


def test_batched_loglik_pallas_matches_interpret_mode(models, twin):
    ref_ss, port_ss = _spaces(models)
    data, _, U = twin
    want = np.asarray(ref_ss.build_batched_loglik(
        data, policy="pallas", settle="pallas", interpret=True)(U))
    got = port_ss.build_batched_loglik(data, policy="pallas",
                                       settle="pallas")(torch.tensor(U))
    got = got.numpy()
    assert np.isneginf(want[5]) and np.isneginf(got[5])
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(want).sum() == 7
    np.testing.assert_allclose(got, want, rtol=1e-8)


def test_stationary_value_and_grad_matches_reference(models, twin):
    ref_ss, port_ss = _spaces(models, filter_type="stationary")
    settle = "pallas"
    data, _, U = twin
    v_ref, g_ref = (np.asarray(x) for x in jax.jit(
        ref_ss.build_batched_logpost_and_grad(
            data, interpret=True, cr_tile=8, settle=settle))(U))
    v, g = port_ss.build_batched_logpost_and_grad(data, settle=settle)(
        torch.tensor(U))
    v, g = v.numpy(), g.numpy()
    assert np.isneginf(v[5]) and np.isneginf(v_ref[5])
    assert not g[5].any()
    ok = np.isfinite(v_ref)
    assert ok.sum() == 7
    np.testing.assert_array_equal(np.isfinite(v), ok)
    np.testing.assert_allclose(v[ok], v_ref[ok], rtol=1e-8)
    np.testing.assert_allclose(g[ok], g_ref[ok], rtol=1e-6,
                               atol=1e-6 * np.abs(g_ref[ok]).max())


def test_data_from_prior_and_smc_run_on_the_port(models):
    _, port = models
    ss = PortStateSpace(port, device="cpu").configure(observed_states=["Y"])
    data, draw = ss.data_from_prior(torch.Generator().manual_seed(0),
                                    periods=64)
    assert data.shape == (64, 1) and np.isfinite(data).all()
    assert set(draw) == set(ESTIMATED)
    res = geconpy_torch.fit_smc(ss, data, n_particles=128, n_mh=2, seed=0,
                                policy="pallas", settle="fused", resample_ess=0.6,
                                dtype=torch.float64)
    assert res.phi_schedule[-1] == 1.0
    assert np.isfinite(res.log_evidence)
    assert np.isfinite(np.asarray(res.samples)).all()
