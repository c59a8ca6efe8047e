"""Port parity: the posterior mode search
(``geconpy_torch/stats/model_comparison.py``).

``find_map`` over the port's batched value+grad (used at a batch of one,
the Hessian's 2 x dim shifted draws in one batched call) finds the
reference's mode from the same start at 1e-6 in u.  The reference runs
its own ``find_map`` on its batched log posterior (its Pallas kernels in
interpret mode, as ``tests/test_torch_logpost_grad.py`` runs them), where
it takes the same central-difference Hessian (run under ``jax.jit``, where
the reference's probe of forward mode skips its eager check).  Both run 150 Adam steps
(find_map's default is 500) and the default 5 Newton steps.  Also: the
central-difference Hessian against the reference's ``fd_hessian`` at one
point, a singular Hessian's Newton step rejected rather than raised, and
``posterior_mode``'s memo.  ``rbc_estimation`` (Y observed, rho_A and
sigma_A estimated, stationary filter, 48 periods); CPU, float64.
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
from geconpy_torch.stats import estimation as port_estimation
from geconpy_torch.stats import model_comparison as port
from geconpy_torch.stats.statespace import DSGEStateSpace as PortStateSpace
from geconpy_tpu.stats import model_comparison as ref
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace

RBC = dict(observed_states=["Y"], constant_params=["alpha", "sigma_C"],
           filter_type="stationary", kalman_settle=12)
ADAM_STEPS = 150


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


@pytest.fixture(scope="module")
def rbc():
    ref_ss = RefStateSpace(geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn("rbc_estimation"), verbose=False)
    ).configure(**RBC)
    data, _ = ref_ss.data_from_prior(jax.random.PRNGKey(1), periods=48,
                                     params={"rho_A": 0.9, "sigma_A": 0.012})
    data = np.asarray(data)
    port_ss = PortStateSpace(geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation")), device="cpu"
    ).configure(**RBC)
    f = ref_ss.build_batched_logpost(data, interpret=True, cr_tile=8)
    ref_logpost = lambda u: f(u[None])[0]   # noqa: E731
    u0 = np.asarray(ref_ss.initial_position())
    u1 = u0 + np.array([0.1, -0.05])
    # one program for both (under jit the reference's Hessian probe skips
    # its eager validation and takes the central differences at once)
    mode, hess = jax.jit(lambda u, v: (
        ref.find_map(ref_logpost, u, adam_steps=ADAM_STEPS),
        ref.neg_hessian_fn(ref_logpost, v)(v)))(jnp.asarray(u0),
                                                jnp.asarray(u1))
    ref_out = {"mode": np.asarray(mode), "u1": u1, "hess": np.asarray(hess)}
    return ref_out, port_ss, data, u0


def test_find_map_matches_reference(rbc):
    ref_out, port_ss, data, u0 = rbc
    want = ref_out["mode"]
    vag = port_ss.build_batched_logpost_and_grad(data)
    got = port.find_map(vag, torch.tensor(u0), adam_steps=ADAM_STEPS)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the mode: the gradient vanishes and no neighbour is higher
    vals, grads = vag(torch.cat([got[None], got + 1e-3 * torch.eye(2),
                                 got - 1e-3 * torch.eye(2)]))
    assert float(grads[0].abs().max()) < 1e-4 * (1 + float(vals[0].abs()))
    assert bool((vals[1:] < vals[0]).all())


def test_fd_hessian_matches_reference(rbc):
    ref_out, port_ss, data, _u0 = rbc
    u, want = ref_out["u1"], ref_out["hess"]
    calls = []
    vag = port_ss.build_batched_logpost_and_grad(data)

    def counted(U):
        calls.append(U.shape[0])
        return vag(U)

    got = port.neg_hessian_fn(counted)(torch.tensor(u))
    assert calls == [4]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(got.numpy(), got.numpy().T)


def test_newton_rejects_a_singular_hessian():
    """A flat direction makes the FD Hessian singular: the Newton step is
    rejected (non-finite), not raised; Adam still moves the point."""
    def vag(U):
        return -0.5 * U[:, 0] ** 2, torch.stack([-U[:, 0], 0 * U[:, 1]], -1)

    u = port.find_map(vag, torch.tensor([1.0, 2.0]), adam_steps=3,
                      newton_steps=2)
    assert torch.isfinite(u).all()
    assert u[1].item() == 2.0 and u[0].item() < 1.0


def test_posterior_mode_is_memoized(rbc, monkeypatch):
    _ref_out, port_ss, data, _u0 = rbc
    u1, lp1 = port_estimation.posterior_mode(port_ss, data, dtype=torch.float64,
                                             adam_steps=2, newton_steps=1)
    monkeypatch.setattr(port_estimation, "find_map", None)   # not called again
    u2, lp2 = port_estimation.posterior_mode(port_ss, data, dtype=torch.float64)
    assert u2 is u1 and lp2 == lp1
    assert port_ss.build_batched_logpost_and_grad(data) is \
        port_ss.build_batched_logpost_and_grad(data.copy())
