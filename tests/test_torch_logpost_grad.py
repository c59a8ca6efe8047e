"""Port parity for the slice as a whole: the batched value+gradient.

``geconpy_torch``'s ``DSGEStateSpace.build_batched_logpost_and_grad`` (on
CPU tensors, so through the kernels' plain versions) equals the
reference's ``build_batched_logpost_and_grad(data, interpret=True,
cr_tile=8)`` with ``settle="xla"`` and ``settle="pallas"``: values at
rtol/atol 1e-8 and gradients at rtol/atol 1e-6, the bars of
``tests/stats/test_pallas_grad.py``.  Cases: ``rbc_estimation`` (Y
observed, alpha and sigma_C constant, stationary filter, kalman_settle 12,
48 periods, batch 6) and SW-2007 (5 estimated parameters, y/pinf/r
observed, stationary filter, 80 periods, batch 4) and SW-2007 at the
bench's own configuration (``bench.py:91-96, :184-185``: all 22
estimated parameters, the 7 observables, stationary filter,
kalman_settle 32; 80 periods, batch 3), each on the reference's own data
and draws.  Also: a rejected draw gets -inf and a zero gradient
row without touching the others; float32 draws give the float64 path's
results; and the device contract of ``DSGEStateSpace``.
"""

import os
import types

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
from geconpy_torch.stats.statespace import DSGEStateSpace as PortStateSpace
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace

SW_EST = ["crhoa", "sigma_ea", "crr", "crpi", "chabb"]
SW_OBS = ["y", "c", "inve", "w", "pinf", "r", "lab"]
SW_ESTIMATED_FULL = [
    "crhoa", "crhob", "crhog", "crhoqs", "crhoms", "crhopinf", "crhow",
    "cmap", "cmaw", "cgy", "sigma_ea", "sigma_eb", "sigma_eg", "sigma_eqs",
    "sigma_em", "sigma_epinf", "sigma_ew", "crpi", "crr", "cry", "chabb",
    "csigma"]
CASES = {
    "rbc_estimation": dict(
        configure=lambda names: dict(
            observed_states=["Y"], constant_params=["alpha", "sigma_C"],
            filter_type="stationary", kalman_settle=12),
        periods=48, batch=6, key=3),
    "sw2007": dict(
        configure=lambda names: dict(
            observed_states=["y", "pinf", "r"], filter_type="stationary",
            kalman_settle=32,
            constant_params=[p for p in names if p not in SW_EST]),
        periods=80, batch=4, key=0),
    "sw2007_bench": dict(
        configure=lambda names: dict(
            observed_states=SW_OBS, filter_type="stationary",
            kalman_settle=32,
            constant_params=[p for p in names if p not in SW_ESTIMATED_FULL]),
        periods=80, batch=3, key=0, model="sw2007"),
}


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    name = request.param
    spec = CASES[name]
    model_name = spec.get("model", name)
    ref_model = geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn(model_name), verbose=False)
    ref_ss = RefStateSpace(ref_model).configure(
        **spec["configure"](ref_model.param_names))
    data, draw = ref_ss.data_from_prior(jax.random.PRNGKey(spec["key"]),
                                        periods=spec["periods"])
    data = np.asarray(data)
    u0 = np.asarray(ref_ss.unconstrain(draw))
    rng = np.random.default_rng(7)
    U = u0[None] + 0.05 * rng.standard_normal((spec["batch"], u0.shape[0]))
    port_model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn(model_name))
    port_ss = PortStateSpace(port_model, device="cpu").configure(
        **spec["configure"](port_model.param_names))
    assert port_ss.param_labels == ref_ss.param_labels
    return name, ref_ss, port_ss, data, U


@pytest.mark.parametrize("settle", ["xla", "pallas"])
def test_value_and_grad_match_reference(case, settle):
    _name, ref_ss, port_ss, data, U = case
    vag_ref = jax.jit(ref_ss.build_batched_logpost_and_grad(
        data, interpret=True, cr_tile=8, settle=settle))
    v_ref, g_ref = (np.asarray(x) for x in vag_ref(jnp.asarray(U)))
    v, g = port_ss.build_batched_logpost_and_grad(data, settle=settle)(
        torch.as_tensor(U))
    assert np.isfinite(v_ref).all()
    np.testing.assert_allclose(v.numpy(), v_ref, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-6, atol=1e-6)


def test_rejected_draw_gets_minus_inf_and_zero_gradient(case):
    """As ``test_batched_logpost_rejects_bad_draw_with_zero_grad``: an
    absurd draw is rejected (-inf, zero gradient row), and the good draw's
    value and gradient are those it has alone."""
    _name, _ref_ss, port_ss, data, U = case
    vag = port_ss.build_batched_logpost_and_grad(data)
    good = torch.as_tensor(U[:1])
    v, g = vag(torch.cat([good, torch.full_like(good, 40.0)]))
    v1, g1 = vag(good)
    assert v[1].item() == -np.inf
    assert torch.isfinite(g).all() and (g[1] == 0).all()
    np.testing.assert_allclose(v[:1].numpy(), v1.numpy(), rtol=1e-12)
    np.testing.assert_allclose(g[:1].numpy(), g1.numpy(), rtol=1e-10,
                               atol=1e-12)


def test_float32_draws_run_the_float64_path(case):
    """The path computes in float64 whatever U's dtype (the kernels
    included); float32 draws give its results in float32."""
    _name, _ref_ss, port_ss, data, U = case
    vag = port_ss.build_batched_logpost_and_grad(data, settle="pallas")
    U32 = torch.as_tensor(U).float()
    v32, g32 = vag(U32)
    v64, g64 = vag(U32.double())
    assert v32.dtype == g32.dtype == torch.float32
    np.testing.assert_array_equal(v32.numpy(), v64.float().numpy())
    np.testing.assert_array_equal(g32.numpy(), g64.float().numpy())


@pytest.fixture(scope="module")
def rbc_port():
    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"))
    return model, dict(observed_states=["Y"], filter_type="stationary",
                       constant_params=["alpha", "sigma_C"])


def test_state_space_defaults_to_the_gpu(rbc_port, monkeypatch):
    model, kw = rbc_port
    ss = PortStateSpace(model).configure(**kw)
    assert ss.device == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ss.initial_position()


def test_inputs_on_another_device_raise(rbc_port):
    model, kw = rbc_port
    ss = PortStateSpace(model, device="cpu").configure(**kw)
    data, _draw = ss.data_from_prior(torch.Generator().manual_seed(0),
                                     periods=20)
    U = ss.initial_position()[None]
    with pytest.raises(ValueError, match="is on meta"):
        ss.build_batched_logpost_and_grad(data)(U.to("meta"))
    with pytest.raises(ValueError, match="is on meta"):
        ss.build_batched_loglik(data)(U.to("meta"))
    with pytest.raises(ValueError, match="is on meta"):
        ss.constrain(U.to("meta"))
    # a stand-in for a generator on another device (a CUDA one on a GPU)
    elsewhere = types.SimpleNamespace(device=torch.device("meta"))
    with pytest.raises(ValueError, match="generator is on meta"):
        ss.data_from_prior(elsewhere, periods=20)
    assert ss.unconstrain(ss.constrain(U[0])).device == torch.device("cpu")


def test_unported_options_raise(rbc_port):
    """The options that raised while unported now give the reference's
    values (the name is the one this test had then): data with periodic
    missingness (the cyclostationary filter, never the DARE kernel's
    route), ``kalman_settle_method="sda"`` and ``filter_type=
    "steady_state"`` through ``build_batched_logpost`` equal the
    reference's at rel 1e-8.  What the reference refuses raises its
    ``ValueError``: aperiodic missingness with the stationary filter, and
    a settle other than ``"xla"`` or ``"pallas"``."""
    model, kw = rbc_port
    ss = PortStateSpace(model, device="cpu").configure(**kw)
    data, _draw = ss.data_from_prior(torch.Generator().manual_seed(0),
                                     periods=20)
    U = ss.initial_position()[None] + 0.05 * torch.as_tensor(
        np.random.default_rng(3).standard_normal((2, len(ss.param_labels))))
    ref_model = geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn("rbc_estimation"), verbose=False)
    periodic = data.copy()
    periodic[1::2, 0] = np.nan
    for extra, dat in ((dict(), periodic),
                       (dict(kalman_settle_method="sda"), data),
                       (dict(filter_type="steady_state"), data)):
        port_ss = PortStateSpace(model, device="cpu").configure(
            **{**kw, **extra})
        ref_ss = RefStateSpace(ref_model).configure(**{**kw, **extra})
        record: dict = {}
        got = port_ss.build_batched_logpost(dat, settle="pallas")(
            U, record=record).numpy()
        want = np.asarray(jax.jit(ref_ss.build_batched_logpost(
            dat, interpret=True, cr_tile=8, settle="pallas"))(
            jnp.asarray(U.numpy())))
        assert np.isfinite(want).all()
        np.testing.assert_allclose(got, want, rtol=1e-8)
        # the DARE kernel's route only with every series observed
        assert ("dare_settle" in record) == (
            port_ss.filter_type == "stationary" and dat is data)
    missing = data.copy()
    missing[3, 0] = np.nan
    with pytest.raises(ValueError, match="periodic missingness"):
        ss.build_batched_logpost(missing)
    with pytest.raises(ValueError, match="settle"):
        ss.build_batched_logpost(data, settle="fused")


# the reference's configure keywords with its defaults (statespace.py:102-124)
REFERENCE_CONFIGURE = dict(
    measurement_error=None, shock_std=None, solver="cycle_reduction",
    kalman_settle=48, kalman_settle_method="hewer", loglin_variables="auto",
    cycle_reduction_tol=1e-10, cycle_reduction_maxiter=100, me_prior=None,
    observation_equations=None, aggregate=None, ss_obs_intercept=False,
    full_shock_covariance=False, lkj_eta=1.0, p0_init="stationary",
    diffuse_kappa=1e6, diffuse_presample=0)


def test_configure_takes_the_reference_keywords(rbc_port):
    """Every keyword of the reference's ``configure``, with the reference's
    default, runs through both packages with the same estimated
    parameters; the sequential filter (with and without the diffuse
    initialisation), observation equations, ``aggregate`` and the full
    shock covariance are accepted, and so are ``solver="gensys"`` and
    ``"backward"``, and ``filter_type="chandrasekhar"``, whose log
    posterior is the reference's; invalid values raise ``ValueError``, not
    ``TypeError``."""
    import inspect

    model, kw = rbc_port
    ref_params = inspect.signature(RefStateSpace.configure).parameters
    port_params = inspect.signature(PortStateSpace.configure).parameters
    assert list(port_params) == list(ref_params)
    for name, p in ref_params.items():
        if name != "self":
            assert port_params[name].default == p.default, name
    call = dict(REFERENCE_CONFIGURE, observed_states=["Y"],
                constant_params=["alpha", "sigma_C"], filter_type="stationary")
    ref_ss = RefStateSpace(geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn("rbc_estimation"), verbose=False)
    ).configure(**call)
    port_ss = PortStateSpace(model, device="cpu").configure(**call)
    assert port_ss.param_labels == ref_ss.param_labels
    assert (port_ss.solver, port_ss.p0_init) == ("cycle_reduction", "stationary")
    # the other solvers run, and give the reference's log posterior (-inf
    # included: the backward solve of this forward-looking model is not a
    # stable solution on either side)
    data, _draw = ref_ss.data_from_prior(jax.random.PRNGKey(2), periods=24)
    data = np.asarray(data)
    for solver in ("gensys", "backward"):
        kw = {**call, "solver": solver}
        ss = PortStateSpace(model, device="cpu").configure(**kw)
        ref_solver = RefStateSpace(ref_ss.model).configure(**kw)
        assert ss.solver == solver
        u = ref_solver.initial_position()
        want = float(jax.jit(ref_solver.build_logpost(data))(u))
        got = float(ss.build_logpost(data)(torch.as_tensor(np.asarray(u))))
        np.testing.assert_allclose(got, want, rtol=1e-8)
    # the Chandrasekhar filter gives the reference's log posterior
    kw = {**call, "filter_type": "chandrasekhar"}
    ss = PortStateSpace(model, device="cpu").configure(**kw)
    ref_ch = RefStateSpace(ref_ss.model).configure(**kw)
    u = ref_ch.initial_position()
    want = float(jax.jit(ref_ch.build_logpost(data))(u))
    got = float(ss.build_logpost(data)(torch.as_tensor(np.asarray(u))))
    np.testing.assert_allclose(got, want, rtol=1e-8)
    for extra in (dict(filter_type="sequential"),
                  dict(filter_type="sequential", p0_init="diffuse",
                       diffuse_kappa=1e4, diffuse_presample=2)):
        ss = PortStateSpace(model, device="cpu").configure(**{**call, **extra})
        assert (ss.filter_type, ss.p0_init) == ("sequential",
                                                extra.get("p0_init",
                                                          "stationary"))
        assert ss.param_labels == ref_ss.param_labels
    for extra, obs, lags in (
            (dict(aggregate={"Y_q": ("Y", "sum", 3)}), ["Y_q"], 2),
            (dict(observation_equations={"dY": "Y[] - Y[-1]"}), ["dY"], 1),
            (dict(full_shock_covariance=True), ["Y"], 0)):
        kw = {**call, **extra, "observed_states": obs}
        ss = PortStateSpace(model, device="cpu").configure(**kw)
        ref_kw = RefStateSpace(ref_ss.model).configure(**kw)
        assert ss._obs_max_lag == lags
        assert ss.param_labels == ref_kw.param_labels
    for extra in (dict(p0_init="diffuse"), dict(p0_init="exact"),
                  dict(solver="qz"), dict(filter_type="kalman")):
        with pytest.raises(ValueError):
            PortStateSpace(model, device="cpu").configure(**{**call, **extra})
