"""Shared cases of ``tests/test_torch_nonlinear.py`` and
``tests/test_torch_nonlinear_filters.py``: ``rbc_estimation`` with Y and C
observed under measurement error and ``brock_mirman`` with the growth
observable dY, each configured in both packages, with the reference's
data and generating draw."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import torch

import geconpy_torch
import geconpy_tpu
from geconpy_torch.stats.statespace import DSGEStateSpace as PortStateSpace
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace

RBC = dict(observed_states=["Y", "C"], measurement_error=["Y", "C"])
BM_LAG = dict(observed_states=["dY"], shock_std=0.01,
              observation_equations={"dY": "Y[] - Y[-1]"})
VALUE_TOL, GRAD_TOL = 1e-8, 1e-6


def pair(name, kw, seed, periods):
    """(reference state space, port state space on the CPU, data, the
    generating draw unconstrained): ``periods`` from the port's
    ``data_from_prior`` under a CPU generator seeded with ``seed``."""
    ref_ss = RefStateSpace(geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn(name), verbose=False)).configure(**kw)
    port_ss = PortStateSpace(geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn(name), verbose=False),
        device="cpu").configure(**kw)
    data, draw = port_ss.data_from_prior(torch.Generator().manual_seed(seed),
                                         periods=periods)
    return ref_ss, port_ss, data, port_ss.unconstrain(draw).numpy()


def close(got, want, tol, scale=None):
    """``got`` within rel ``tol`` of ``want``, entrywise or of ``scale``
    (by default ``want``'s largest entry)."""
    want = np.asarray(want)
    if want.size == 0:
        assert np.shape(got) == want.shape
        return
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(scale, 1e-300))


def ref_value_and_grad(ref_ss, data, U, **kw):
    """The reference's second-order value and gradient at each row of U,
    compiled (its stored filter, which its own tests hold equal to the
    checkpointed one)."""
    f = jax.jit(jax.vmap(jax.value_and_grad(
        ref_ss.build_logpost_second_order(data, remat=False, **kw))))
    return (np.asarray(x) for x in f(jnp.asarray(U)))
