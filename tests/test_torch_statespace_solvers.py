"""Port parity: ``configure(solver="gensys" | "backward")`` and the front
door of the state space.

- ``build_logpost`` with ``solver="gensys"`` (``rbc_estimation`` with Y and
  C observed with measurement error, the configuration of
  ``tests/stats/test_statespace.py:116-128``) and with ``"backward"`` (a
  small backward-looking VAR with GCN priors, written below) against the
  reference at 1e-8 on the reference's data and draws; gensys against the
  port's cycle reduction at rel 1e-7, as the reference's own test holds it.
- The gradient with ``"backward"`` against the reference's ``jax.grad`` at
  1e-6.  With ``"gensys"`` the reference's ``jax.grad`` raises (JAX has no
  derivative of the complete QR of a tall matrix, which the disk split
  takes at every step), and so would torch's autograd; the port's gensys
  policy re-attaches T and R to the pencil through the implicit policy
  adjoint, so its gradient is held to central differences (rel 1e-5) and
  to the reference's cycle-reduction gradient of the same function (1e-6).
  Both facts are pinned here.
- The ``policy="xla"`` batched sweep with gensys against the reference's at
  rel 1e-8; ``policy="pallas"`` and ``build_batched_logpost`` refuse
  another solver than cycle reduction, as the reference's do.
- ``statespace_from_gcn``, the module-level ``data_from_prior``,
  ``sample_prior`` (names, support, means) and ``pct_missing`` (the share
  of NaN cells, and the cells it leaves equal to the ``pct_missing=0`` run
  from the same generator state).
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
from geconpy_torch.stats.statespace import DSGEStateSpace as PortStateSpace
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace

RBC_KW = dict(observed_states=["Y", "C"], measurement_error=["Y", "C"])

VAR_GCN = """
options
{
    linear = TRUE;
};

block VAR
{
    identities
    {
        x[] = rho_x * x[-1] + 0.1 * z[-1] + eps_x[];
        z[] = rho_z * z[-1] + eps_z[];
        w[] = x[] + 2.0 * z[];
    };

    shocks
    {
        eps_x[] ~ Normal(mu=0, sigma=sigma_x);
        eps_z[] ~ Normal(mu=0, sigma=sigma_z);
    };

    calibration
    {
        rho_x ~ Beta(alpha=8, beta=2) = 0.8;
        rho_z ~ Beta(alpha=5, beta=5) = 0.5;
        sigma_x ~ InverseGamma(alpha=6, beta=0.05) = 0.01;
        sigma_z ~ InverseGamma(alpha=6, beta=0.05) = 0.01;
    };
};
"""
VAR_KW = dict(observed_states=["x", "w"], solver="backward")


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spaces(source, **kw):
    ref = RefStateSpace(geconpy_tpu.model_from_gcn(source, verbose=False))
    port = PortStateSpace(geconpy_torch.model_from_gcn(source, verbose=False),
                          device="cpu")
    return ref.configure(**kw), port.configure(**kw)


def _draws(ref_ss, draw, n, seed):
    """The reference's draw and ``n - 1`` draws about it, unconstrained."""
    u0 = np.asarray(ref_ss.unconstrain(draw))
    rng = np.random.default_rng(seed)
    return np.vstack([u0, u0 + 0.05 * rng.standard_normal((n - 1, u0.size))])


@pytest.fixture(scope="module")
def rbc_gensys():
    src = geconpy_tpu.get_example_gcn("rbc_estimation")
    ref_cr, port_cr = _spaces(src, **RBC_KW)
    ref, port = _spaces(src, solver="gensys", **RBC_KW)
    data, draw = ref_cr.data_from_prior(jax.random.PRNGKey(7), periods=60)
    data = np.asarray(data)
    return ref, port, port_cr, ref_cr, data, _draws(ref_cr, draw, 3, 0)


@pytest.fixture(scope="module")
def var_backward():
    ref, port = _spaces(VAR_GCN, **VAR_KW)
    data, draw = ref.data_from_prior(jax.random.PRNGKey(3), periods=60)
    return ref, port, np.asarray(data), _draws(ref, draw, 3, 1)


def _port_values(fn, U):
    return np.array([float(fn(torch.as_tensor(u))) for u in U])


def test_gensys_logpost_matches_reference(rbc_gensys):
    ref, port, port_cr, _ref_cr, data, U = rbc_gensys
    assert port.solver == "gensys"
    assert port._filter_core.tolist() == list(range(
        port.model.n_variables)) == np.asarray(ref._filter_core).tolist()
    f_ref = jax.jit(ref.build_logpost(data))
    want = np.array([float(f_ref(jnp.asarray(u))) for u in U])
    got = _port_values(port.build_logpost(data), U)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)
    batched = port.build_logpost(data)(torch.as_tensor(U)).numpy()
    np.testing.assert_allclose(batched, got, rtol=1e-12)
    np.testing.assert_allclose(got, _port_values(port_cr.build_logpost(data),
                                                 U), rtol=1e-7)
    sol = port.build_solution_fn()(torch.as_tensor(U[0]))
    assert bool(sol["solver_success"])


def test_backward_logpost_and_gradient_match_reference(var_backward):
    ref, port, data, U = var_backward
    assert port.model.is_backward_looking
    f_ref = ref.build_logpost(data)
    want = np.array([float(jax.jit(f_ref)(jnp.asarray(u))) for u in U])
    got = _port_values(port.build_logpost(data), U)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)
    g_ref = np.asarray(jax.jit(jax.vmap(jax.grad(f_ref)))(jnp.asarray(U)))
    _vals, g = port.build_logpost_and_grad(data)(torch.as_tensor(U))
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-6,
                               atol=1e-6 * np.abs(g_ref).max())


def test_gensys_gradient_reference_raises_port_matches_differences(
        rbc_gensys):
    ref, port, _port_cr, ref_cr, data, U = rbc_gensys
    u = U[0]
    with pytest.raises(NotImplementedError, match="QR decomposition"):
        jax.grad(ref.build_logpost(data))(jnp.asarray(u))
    f = port.build_logpost(data)
    _v, g = port.build_logpost_and_grad(data)(torch.as_tensor(u)[None])
    g = g[0].numpy()
    assert np.isfinite(g).all()
    h = 1e-5
    fd = np.array([(float(f(torch.as_tensor(u + h * e)))
                    - float(f(torch.as_tensor(u - h * e)))) / (2 * h)
                   for e in np.eye(u.size)])
    assert np.abs(g - fd).max() / np.abs(fd).max() < 1e-5
    g_cr = np.asarray(jax.jit(jax.grad(ref_cr.build_logpost(data)))(
        jnp.asarray(u)))
    np.testing.assert_allclose(g, g_cr, rtol=1e-6,
                               atol=1e-6 * np.abs(g_cr).max())


def test_gensys_sweep_matches_reference(rbc_gensys):
    ref, port, _port_cr, _ref_cr, data, U = rbc_gensys
    want = np.asarray(jax.jit(ref.build_batched_loglik(
        data, n_settle=16, policy="xla", interpret=True))(jnp.asarray(U)))
    got = port.build_batched_loglik(data, n_settle=16, policy="xla")(
        torch.as_tensor(U)).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-8)
    with pytest.raises(ValueError, match="requires solver='cycle_reduction'"):
        port.build_batched_loglik(data, policy="pallas")
    with pytest.raises(ValueError, match="requires solver='cycle_reduction'"):
        port.build_batched_logpost(data)


def test_configure_refuses_unknown_solvers():
    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"), verbose=False)
    with pytest.raises(ValueError, match="solver must be"):
        PortStateSpace(model, device="cpu").configure(
            observed_states=["Y"], solver="qz")


def test_statespace_from_gcn_and_module_data_from_prior():
    src = geconpy_torch.get_example_gcn("rbc_estimation")
    bare = geconpy_torch.statespace_from_gcn(src, verbose=False, device="cpu")
    assert isinstance(bare, PortStateSpace) and not bare._configured
    ss = geconpy_torch.statespace_from_gcn(src, verbose=False, device="cpu",
                                           observed_states=["Y"])
    ref = geconpy_tpu.statespace_from_gcn(src, verbose=False,
                                          observed_states=["Y"])
    assert ss.param_labels == ref.param_labels
    assert ss.device == torch.device("cpu")
    data, draw = geconpy_torch.data_from_prior(ss, periods=30)
    again, draw2 = ss.data_from_prior(torch.Generator().manual_seed(0),
                                      periods=30)
    np.testing.assert_array_equal(data, again)
    assert draw == draw2 and set(draw) == set(ss.param_labels)
    other, _ = geconpy_torch.data_from_prior(
        ss, torch.Generator().manual_seed(1), periods=30)
    assert not np.array_equal(data, other)


def test_sample_prior_names_support_and_means():
    ss = geconpy_torch.statespace_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"), verbose=False,
        device="cpu", **RBC_KW)
    n = 4000
    draws = ss.sample_prior(torch.Generator().manual_seed(0), n_draws=n)
    assert list(draws) == ss.param_labels
    for p in ss.estimated:
        d = draws[p.name]
        assert d.shape == (n,) and np.isfinite(d).all()
        sd = np.sqrt(p.prior.variance())
        assert abs(d.mean() - p.prior.mean()) < 5 * sd / np.sqrt(n), p.name
    assert (draws["sigma_A"] > 0).all() and (draws["sigma_obs_Y"] >= 0).all()
    assert ((draws["alpha"] > 0) & (draws["alpha"] < 1)).all()
    assert 0.2 < draws["alpha"].mean() < 0.6
    again = ss.sample_prior(torch.Generator().manual_seed(0), n_draws=n)
    assert all(np.array_equal(again[k], v) for k, v in draws.items())


def test_pct_missing_masks_cells_of_the_same_run():
    ss = geconpy_torch.statespace_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"), verbose=False,
        device="cpu", **RBC_KW)
    gen = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    full, draw = ss.data_from_prior(gen(), periods=400)
    holed, draw_h = ss.data_from_prior(gen(), periods=400, pct_missing=0.25)
    assert draw == draw_h and np.isfinite(full).all()
    missing = np.isnan(holed)
    assert abs(missing.mean() - 0.25) < 0.04
    np.testing.assert_array_equal(holed[~missing], full[~missing])
    for bad in (-0.1, 1.0):
        with pytest.raises(ValueError, match="pct_missing"):
            ss.data_from_prior(gen(), periods=10, pct_missing=bad)
    # the port's sequential filter takes the ragged panel
    u = ss.unconstrain(draw)
    assert np.isfinite(float(ss.build_logpost(holed)(u)))
