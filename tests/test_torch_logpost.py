"""Port parity for milestone M1: the single-draw log posterior on the
sequential Kalman filter with the XLA policy, the twin of the repository's
``entry()`` (``__graft_entry__.py:50-69``).

``rbc_estimation`` with Y observed, alpha and sigma_C constant and
otherwise the reference's ``configure`` defaults (sequential filter, XLA
policy); the data are made once by the reference's
``data_from_prior(PRNGKey(0), periods=64)`` and handed to both packages as
numpy; ``u0`` is the generating draw, unconstrained.  The port's
``build_logpost(data)(u0)`` (CPU tensors) equals the reference's under
``jax.jit`` at rel 1e-8 in value and 1e-6 in gradient, and every field of
``build_logpost_extras`` agrees (flags equal, the residual norms, which
are rounding noise, within 1e-12).  Then, at the same bars: missing data
(NaN), ``p0_init="diffuse"`` with a presample, the batched value+grad on
the sequential filter (K4's plain version here; the reference's Pallas
kernel in interpret mode) and ``build_batched_loglik(policy="xla")`` for
each settle (rel 1e-8); a failed draw gives -inf, never an exception; and
the reference's defaults of ``configure``, ``build_batched_loglik`` and
``fit``.  CPU, float64, one thread.
"""

import inspect
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

ENTRY = dict(observed_states=["Y"], constant_params=["alpha", "sigma_C"])


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
    ref = geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn("rbc_estimation"), verbose=False)
    port = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"))
    return ref, port


def _spaces(models, **extra):
    ref_model, port_model = models
    kw = dict(ENTRY, **extra)
    return (RefStateSpace(ref_model).configure(**kw),
            PortStateSpace(port_model, device="cpu").configure(**kw))


@pytest.fixture(scope="module")
def entry_twin(models):
    """The reference's ``_build(periods=64)`` on both packages."""
    ref_ss, port_ss = _spaces(models)
    data, draw = ref_ss.data_from_prior(jax.random.PRNGKey(0), periods=64)
    data = np.asarray(data)
    u0 = np.asarray(ref_ss.unconstrain(draw))
    return ref_ss, port_ss, data, u0


def _ref_value_grad(ref_ss, data, u):
    return (np.asarray(x) for x in jax.jit(jax.value_and_grad(
        ref_ss.build_logpost(data)))(u))


def _port_value_grad(port_ss, data, u):
    u = torch.tensor(u, requires_grad=True)
    val = port_ss.build_logpost(data)(u)
    (grad,) = torch.autograd.grad(val, u)
    return val.detach().numpy(), grad.numpy()


def _assert_value_grad(port, ref):
    (v, g), (v_ref, g_ref) = port, ref
    assert np.isfinite(v_ref)
    np.testing.assert_allclose(v, v_ref, rtol=1e-8)
    np.testing.assert_allclose(g, g_ref, rtol=1e-6,
                               atol=1e-6 * np.max(np.abs(g_ref)))


def test_entry_twin_matches_reference(entry_twin):
    ref_ss, port_ss, data, u0 = entry_twin
    assert port_ss.filter_type == ref_ss.filter_type == "sequential"
    _assert_value_grad(_port_value_grad(port_ss, data, u0),
                       _ref_value_grad(ref_ss, data, u0))


def test_entry_twin_extras_match_reference(entry_twin):
    ref_ss, port_ss, data, u0 = entry_twin
    want = jax.jit(ref_ss.build_logpost_extras(data))(u0)
    got = port_ss.build_logpost_extras(data)(torch.tensor(u0))
    assert got._fields == want._fields
    for field in ("ss_success", "solver_success"):
        assert bool(getattr(got, field)) == bool(getattr(want, field))
        assert bool(getattr(got, field))
    for field in ("logpost", "loglik", "logprior", "spectral_radius"):
        np.testing.assert_allclose(float(getattr(got, field)),
                                   float(getattr(want, field)), rtol=1e-8)
    for field in ("deterministic_norm", "stochastic_norm"):
        assert abs(float(getattr(got, field))
                   - float(getattr(want, field))) < 1e-12
    # the solution function: a batch of one and a single draw agree
    sol = port_ss.build_solution_fn()(torch.tensor(u0))
    sols = port_ss.build_solution_fn()(torch.tensor(u0)[None])
    assert torch.equal(sol["T_aug"], sols["T_aug"][0])
    ref_sol = jax.jit(ref_ss.build_solution_fn())(u0)
    for key in ("T", "R", "Z", "Q", "H", "x_ss"):
        np.testing.assert_allclose(sol[key].numpy(), np.asarray(ref_sol[key]),
                                   rtol=1e-9, atol=1e-12, err_msg=key)


def test_batched_logpost_equals_single_draws(entry_twin):
    _ref_ss, port_ss, data, u0 = entry_twin
    U = u0[None] + 0.1 * np.random.default_rng(0).standard_normal((4, 2))
    lp = port_ss.build_logpost(data)
    batched = lp(torch.tensor(U))
    for b in range(4):
        np.testing.assert_allclose(float(lp(torch.tensor(U[b]))),
                                   float(batched[b]), rtol=1e-13)


def test_missing_data_matches_reference(entry_twin):
    ref_ss, port_ss, data, u0 = entry_twin
    data = data.copy()
    rng = np.random.default_rng(1)
    data[rng.uniform(size=data.shape) < 0.2] = np.nan
    data[10] = np.nan
    assert np.isnan(data).any()
    _assert_value_grad(_port_value_grad(port_ss, data, u0),
                       _ref_value_grad(ref_ss, data, u0))


def test_diffuse_init_matches_reference(models, entry_twin):
    _ref, _port, data, u0 = entry_twin
    ref_ss, port_ss = _spaces(models, p0_init="diffuse", diffuse_presample=2)
    _assert_value_grad(_port_value_grad(port_ss, data, u0),
                       _ref_value_grad(ref_ss, data, u0))


def test_batched_value_and_grad_on_the_sequential_filter(entry_twin):
    ref_ss, port_ss, data, u0 = entry_twin
    U = u0[None] + 0.1 * np.random.default_rng(2).standard_normal((4, 2))
    v_ref, g_ref = (np.asarray(x) for x in jax.jit(
        ref_ss.build_batched_logpost_and_grad(data, interpret=True,
                                              cr_tile=8))(U))
    v, g = port_ss.build_batched_logpost_and_grad(data)(torch.tensor(U))
    assert np.isfinite(v_ref).all()
    np.testing.assert_allclose(v.numpy(), v_ref, rtol=1e-8)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-6,
                               atol=1e-6 * np.max(np.abs(g_ref)))
    # the XLA policy's batched value+grad (fit's) agrees with K4's path
    v_x, g_x = port_ss.build_logpost_and_grad(data)(torch.tensor(U))
    np.testing.assert_allclose(v_x.numpy(), v_ref, rtol=1e-8)
    np.testing.assert_allclose(g_x.numpy(), g_ref, rtol=1e-6,
                               atol=1e-6 * np.max(np.abs(g_ref)))


@pytest.mark.parametrize("settle", ["xla", "pallas", "fused"])
def test_batched_loglik_xla_policy_matches_reference(entry_twin, settle):
    ref_ss, port_ss, data, u0 = entry_twin
    U = u0[None] + 0.1 * np.random.default_rng(3).standard_normal((5, 2))
    want = np.asarray(jax.jit(ref_ss.build_batched_loglik(
        data, n_settle=16, policy="xla", settle=settle, interpret=True,
        cr_tile=8))(U))
    got = port_ss.build_batched_loglik(data, n_settle=16, policy="xla",
                                       settle=settle)(torch.tensor(U))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8)


def test_failed_draw_is_minus_inf(entry_twin):
    _ref_ss, port_ss, data, u0 = entry_twin
    U = np.stack([u0, u0 + 0.05])
    U[0, 0] = np.nan
    extras = port_ss.build_logpost_extras(data)(torch.tensor(U))
    assert extras.logpost[0].item() == -np.inf
    assert np.isfinite(extras.logpost[1].item())
    v, g = port_ss.build_logpost_and_grad(data)(torch.tensor(U))
    assert v[0].item() == -np.inf and torch.equal(g[0], torch.zeros(2))
    assert torch.isfinite(g[1]).all()


def test_the_reference_defaults():
    from geconpy_tpu.stats import estimation as ref_estimation

    for name, ref_fn, port_fn in (
            ("configure", RefStateSpace.configure, PortStateSpace.configure),
            ("build_batched_loglik", RefStateSpace.build_batched_loglik,
             PortStateSpace.build_batched_loglik),
            ("fit", ref_estimation.fit, geconpy_torch.fit)):
        ref_params = inspect.signature(ref_fn).parameters
        port_params = inspect.signature(port_fn).parameters
        for key in ("filter_type", "policy", "settle"):
            if key in ref_params:
                assert port_params[key].default == ref_params[key].default, \
                    (name, key)
    assert inspect.signature(PortStateSpace.configure).parameters[
        "filter_type"].default == "sequential"
