"""The ``rbc_estimation`` case of ``tests/test_torch_filters.py`` and
``tests/test_torch_filter_types.py``: ``build_logpost`` of both packages
under one ``configure``, value 1e-8 and gradient 1e-6."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import torch

import geconpy_torch
import geconpy_tpu
from geconpy_torch.stats.statespace import DSGEStateSpace as PortStateSpace
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace


def rbc_case():
    """``rbc_estimation`` with Y observed with measurement error, 48
    periods from the reference's ``data_from_prior(PRNGKey(4))``, and the
    generating draw."""
    ref_model = geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn("rbc_estimation"), verbose=False)
    port_model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"), verbose=False)
    base = dict(observed_states=["Y"], constant_params=["alpha", "sigma_C"],
                measurement_error=["Y"])
    ref_ss = RefStateSpace(ref_model).configure(**base)
    data, draw = ref_ss.data_from_prior(jax.random.PRNGKey(4), periods=48)
    u0 = np.asarray(ref_ss.unconstrain(draw))
    return ref_model, port_model, base, np.asarray(data), u0


def assert_logpost_matches(case, extra):
    """``build_logpost`` of both packages configured with ``extra``: value
    1e-8, gradient 1e-6 at the generating draw."""
    ref_model, port_model, base, data, u0 = case
    kw = dict(base, **extra)
    ref_ss = RefStateSpace(ref_model).configure(**kw)
    port_ss = PortStateSpace(port_model, device="cpu").configure(**kw)
    assert port_ss.param_labels == ref_ss.param_labels
    v_ref, g_ref = (np.asarray(x) for x in jax.jit(jax.value_and_grad(
        ref_ss.build_logpost(data)))(u0))
    u = torch.tensor(u0, requires_grad=True)
    val = port_ss.build_logpost(data)(u)
    (grad,) = torch.autograd.grad(val, u)
    assert np.isfinite(v_ref)
    np.testing.assert_allclose(float(val.detach()), v_ref, rtol=1e-8)
    np.testing.assert_allclose(grad.numpy(), g_ref, rtol=1e-6,
                               atol=1e-6 * np.max(np.abs(g_ref)))
