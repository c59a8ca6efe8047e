"""Port parity for the slice as a whole: the batched likelihood sweep.

``geconpy_torch``'s ``DSGEStateSpace.build_batched_loglik`` (on CPU
tensors, so through the kernels' plain versions) must equal the reference's
``build_batched_loglik(policy="pallas", settle="pallas", cr_tile=8,
interpret=True)`` at rtol 1e-8, on the two configurations of
``tests/stats/test_statespace.py`` (SW-2007 with 5 estimated parameters and
y/pinf/r observed; ``rbc_estimation`` with Y/C observed under measurement
error), and so must each of the three settles (``"xla"``, ``"pallas"``,
``"fused"``) against the reference's sweep with the same ``settle``.  The
draws cross over by name through
``geconpy_torch.interop.state_from_reference``; the same draws are finite
on both sides.
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
from geconpy_torch.interop import state_from_reference
from geconpy_torch.stats.statespace import DSGEStateSpace as PortStateSpace
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace

SW_EST = ["crhoa", "sigma_ea", "crr", "crpi", "chabb"]
CASES = {
    "sw2007": dict(
        configure=lambda names: dict(
            observed_states=["y", "pinf", "r"], filter_type="steady_state",
            kalman_settle=16,
            constant_params=[p for p in names if p not in SW_EST]),
        periods=80, scale=0.05),
    "rbc_estimation": dict(
        configure=lambda names: dict(
            observed_states=["Y", "C"], measurement_error=["Y", "C"],
            filter_type="steady_state", kalman_settle=16),
        periods=60, scale=0.1),
}


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _reference_arrays(ref_ss, U):
    plan = ref_ss.model.static_reduction
    return {"param_labels": np.asarray(ref_ss.param_labels),
            "theta_default": np.asarray(ref_ss._theta_default),
            "est_idx": np.asarray(ref_ss._est_idx),
            "static_idx": np.asarray(plan.static_idx),
            "dynamic_idx": np.asarray(plan.dynamic_idx),
            "U": np.asarray(U)}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    name = request.param
    spec = CASES[name]
    ref_model = geconpy_tpu.model_from_gcn(geconpy_tpu.get_example_gcn(name),
                                           verbose=False)
    ref_ss = RefStateSpace(ref_model).configure(
        **spec["configure"](ref_model.param_names))
    data, draw = ref_ss.data_from_prior(jax.random.PRNGKey(0),
                                        periods=spec["periods"])
    data = np.asarray(data)
    u0 = np.asarray(ref_ss.unconstrain(draw))
    rng = np.random.default_rng(1)
    U = u0[None] + spec["scale"] * rng.standard_normal((8, u0.shape[0]))

    port_model = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn(name))
    port_ss = PortStateSpace(port_model, device="cpu").configure(
        **spec["configure"](port_model.param_names))
    return name, ref_ss, port_ss, data, U


def test_batched_loglik_matches_reference(case):
    _name, ref_ss, port_ss, data, U = case
    f_ref = jax.jit(ref_ss.build_batched_loglik(
        data, n_settle=16, policy="pallas", settle="pallas", cr_tile=8,
        interpret=True))
    ll_ref = np.asarray(f_ref(U))
    state = state_from_reference(_reference_arrays(ref_ss, U), port_ss)
    ll_port = port_ss.build_batched_loglik(
        data, n_settle=16, policy="pallas", settle="pallas")(state["U"]).numpy()
    np.testing.assert_array_equal(np.isfinite(ll_port), np.isfinite(ll_ref))
    assert np.isfinite(ll_ref).sum() >= 6
    ok = np.isfinite(ll_ref)
    np.testing.assert_allclose(ll_port[ok], ll_ref[ok], rtol=1e-8)


@pytest.mark.parametrize("settle", ["xla", "pallas", "fused"])
def test_batched_loglik_settles_match_reference(case, settle):
    """Each settle of the sweep against the reference's sweep with the same
    settle: equal accept masks, rtol 1e-8 on the draws both accept."""
    _name, ref_ss, port_ss, data, U = case
    f_ref = jax.jit(ref_ss.build_batched_loglik(
        data, n_settle=16, policy="pallas", settle=settle, cr_tile=8,
        interpret=True))
    ll_ref = np.asarray(f_ref(U))
    state = state_from_reference(_reference_arrays(ref_ss, U), port_ss)
    ll_port = port_ss.build_batched_loglik(
        data, n_settle=16, policy="pallas", settle=settle)(state["U"]).numpy()
    np.testing.assert_array_equal(np.isfinite(ll_port), np.isfinite(ll_ref))
    ok = np.isfinite(ll_ref)
    assert ok.sum() >= 6
    np.testing.assert_allclose(ll_port[ok], ll_ref[ok], rtol=1e-8)


def test_batched_loglik_refuses_an_unknown_settle(case):
    """The reference's message, word for word."""
    _name, ref_ss, port_ss, data, _U = case
    with pytest.raises(ValueError) as ref_err:
        ref_ss.build_batched_loglik(data, settle="cuda")
    with pytest.raises(ValueError) as port_err:
        port_ss.build_batched_loglik(data, settle="cuda")
    assert str(port_err.value) == str(ref_err.value)
    assert "'xla', 'pallas' or 'fused'" in str(port_err.value)


def test_configure_matches_reference(case):
    _name, ref_ss, port_ss, _data, _U = case
    assert port_ss.param_labels == ref_ss.param_labels
    np.testing.assert_array_equal(port_ss._filter_core, ref_ss._filter_core)
    assert port_ss._sigma_source == ref_ss._sigma_source
    assert port_ss._me_fixed == ref_ss._me_fixed
    assert [p.name for _, p in port_ss._me_estimated] == \
        [p.name for _, p in ref_ss._me_estimated]
    np.testing.assert_allclose(port_ss.initial_position().numpy(),
                               np.asarray(ref_ss.initial_position()),
                               rtol=1e-12)


def test_constrain_inverts_unconstrain(case):
    _name, _ref_ss, port_ss, _data, U = case
    u = torch.as_tensor(U[0])
    x = port_ss.constrain(u)
    np.testing.assert_allclose(port_ss.unconstrain(x.numpy()).numpy(),
                               U[0], rtol=1e-9, atol=1e-9)


def test_rejected_draw_is_minus_inf(case):
    """A draw outside the determinacy region gets -inf, never an exception."""
    name, _ref_ss, port_ss, data, U = case
    U_bad = U.copy()
    if name == "sw2007":
        # crpi < 1 violates the Taylor principle: no stable solution
        j = port_ss.param_labels.index("crpi")
        x = port_ss.constrain(torch.as_tensor(U_bad[0])).numpy()
        x[j] = 0.5
        U_bad[0] = port_ss.unconstrain(x).numpy()
    else:
        U_bad[0, :] = np.nan
    ll = port_ss.build_batched_loglik(data, n_settle=16)(torch.as_tensor(U_bad))
    assert ll[0].item() == -np.inf
    assert np.isfinite(ll[1:].numpy()).sum() >= 6


def test_interop_refuses_mismatches(case):
    _name, ref_ss, port_ss, _data, U = case
    arrays = _reference_arrays(ref_ss, U)
    bad_order = dict(arrays, param_labels=arrays["param_labels"][::-1])
    with pytest.raises(ValueError, match="order"):
        state_from_reference(bad_order, port_ss)
    bad_names = dict(arrays, param_labels=np.asarray(
        ["not_a_parameter"] + list(arrays["param_labels"][1:])))
    with pytest.raises(ValueError, match="differ"):
        state_from_reference(bad_names, port_ss)
    bad_plan = dict(arrays, static_idx=arrays["static_idx"][:-1])
    with pytest.raises(ValueError, match="plan"):
        state_from_reference(bad_plan, port_ss)


def test_data_requires_full_observation(case):
    _name, _ref_ss, port_ss, data, _U = case
    bad = data.copy()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="fully observed"):
        port_ss.build_batched_loglik(bad)
