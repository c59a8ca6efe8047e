"""Port parity: the SMC sampler on the batched sweep.

The configuration of ``tests/stats/test_smc.py``: ``rbc_estimation`` with
``Y`` observed, ``rho_A`` and ``sigma_A`` estimated, 150 periods made by the
JAX package at ``rho_A = 0.9``, ``sigma_A = 0.012`` and handed over as
numpy.  The port runs on the CPU in float64 through the kernels' plain
versions.

Exact pieces are held exactly: the resampling indices for the same offset,
``_ess_of`` (1e-12), and a particle cloud's log-likelihoods and log-priors
(rtol 1e-8, the sweep's bar).  The two samplers draw from different random
generators, so their runs are compared statistically, with fixed seeds:
log evidence within 2.0 and posterior means within 0.5 posterior standard
deviations at 256 particles.
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
from geconpy_torch.interop import particles_from_reference
from geconpy_torch.ops.particle_filter import (systematic_resample,
                                               systematic_resample_indices)
from geconpy_torch.stats import smc as port_smc
from geconpy_tpu.ops.particle_filter import \
    systematic_resample as ref_systematic_resample
from geconpy_tpu.stats import smc as ref_smc

CONFIGURE = dict(observed_states=["Y"], constant_params=["alpha", "sigma_C"],
                 filter_type="steady_state", kalman_settle=32)
TRUTH = {"rho_A": 0.9, "sigma_A": 0.012}


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


@pytest.fixture(scope="module")
def setup():
    ref_model = geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn("rbc_estimation"), verbose=False)
    ref_ss = geconpy_tpu.stats.statespace.DSGEStateSpace(ref_model).configure(
        **CONFIGURE)
    data, _draw = ref_ss.data_from_prior(jax.random.PRNGKey(11), periods=150,
                                         params=TRUTH)
    port_model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"))
    port_ss = geconpy_torch.DSGEStateSpace(port_model, device="cpu").configure(
        **CONFIGURE)
    return ref_ss, port_ss, np.array(data)


@pytest.fixture(scope="module")
def port_run(setup):
    _ref_ss, port_ss, data = setup
    return geconpy_torch.fit_smc(port_ss, data, n_particles=256, n_mh=2,
                                 seed=0, policy="pallas", settle="pallas",
                                 dtype=torch.float64)


def test_resample_indices_equal_reference():
    rng = np.random.default_rng(3)
    log_w = rng.standard_normal(257) * 3.0
    log_w[5] = -1e30                           # a failed particle
    key = jax.random.PRNGKey(2)
    u = float(jax.random.uniform(key, ()))
    (ref_idx,) = ref_systematic_resample(key, jnp.asarray(log_w),
                                         (jnp.arange(257),))
    got = systematic_resample_indices(torch.as_tensor(log_w),
                                      torch.as_tensor(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_idx))
    assert 5 not in got.tolist()


def test_resample_gathers_every_tensor_with_one_offset():
    log_w = torch.as_tensor(np.random.default_rng(4).standard_normal(64))
    U = torch.arange(128.0).reshape(64, 2)
    ll = torch.arange(64.0)
    U_r, ll_r = systematic_resample(torch.Generator().manual_seed(0), log_w,
                                    (U, ll))
    np.testing.assert_array_equal(U_r[:, 0].numpy(), 2 * ll_r.numpy())
    assert (np.diff(ll_r.numpy()) >= 0).all()
    again = systematic_resample(torch.Generator().manual_seed(0), log_w, (ll,))
    np.testing.assert_array_equal(again[0].numpy(), ll_r.numpy())


def test_ess_of_equals_reference():
    rng = np.random.default_rng(5)
    ll = rng.standard_normal(300) * 40.0 + 400.0
    ll[7] = -1e30
    logw = rng.standard_normal(300)
    for dphi in (0.0, 1e-3, 0.2, 1.0):
        assert port_smc._ess_of(dphi, ll, logw) == pytest.approx(
            ref_smc._ess_of(dphi, ll, logw), rel=1e-12)


def _reference_cloud(ref_ss, data, n):
    """A prior cloud of the reference with its log-likelihoods (as
    ``fit_smc`` computes them: log-posterior less log-prior) and log-priors."""
    cols = [np.asarray(p.prior.to_unconstrained(
        p.prior.sample(jax.random.PRNGKey(i), (n,))))
        for i, p in enumerate(ref_ss.estimated)]
    U = np.stack(cols, axis=1)

    def logprior_one(u):
        lp = 0.0
        for i, p in enumerate(ref_ss.estimated):
            x, logjac = p.prior.from_unconstrained(u[i])
            lp = lp + p.prior.logpdf(x) + logjac
        return lp

    lp = np.asarray(jax.vmap(logprior_one)(jnp.asarray(U)))
    lpost = np.asarray(jax.jit(ref_ss.build_batched_loglik(
        data, n_settle=32, interpret=True))(jnp.asarray(U)))
    ll = np.where(np.isfinite(lpost), lpost - lp, -np.inf)
    return {"param_labels": np.asarray(ref_ss.param_labels), "U": U,
            "ll": ll, "lp": lp}


def test_cloud_loglik_and_logprior_match_reference(setup):
    ref_ss, port_ss, data = setup
    arrays = _reference_cloud(ref_ss, data, 32)
    cloud = particles_from_reference(arrays, port_ss)
    loglik = port_smc._build_loglik(
        port_ss, port_ss.build_batched_loglik(data, n_settle=32))
    ll, lp = loglik(cloud["U"])
    np.testing.assert_allclose(lp.numpy(), cloud["lp"].numpy(), rtol=1e-10)
    ok = np.isfinite(cloud["ll"].numpy())
    assert ok.sum() >= 24
    np.testing.assert_array_equal(np.isfinite(ll.numpy()), ok)
    np.testing.assert_allclose(ll.numpy()[ok], cloud["ll"].numpy()[ok],
                               rtol=1e-8)

    with pytest.raises(ValueError, match="order"):
        particles_from_reference(
            dict(arrays, param_labels=arrays["param_labels"][::-1]), port_ss)
    with pytest.raises(ValueError, match="one value per particle"):
        particles_from_reference(dict(arrays, ll=arrays["ll"][:-1]), port_ss)
    with pytest.raises(ValueError, match="missing"):
        particles_from_reference({"U": arrays["U"]}, port_ss)


def test_smc_reaches_the_posterior(port_run):
    res = port_run
    assert res.phi_schedule[-1] == pytest.approx(1.0)
    assert (np.diff(res.phi_schedule) >= 0).all()
    assert len(res.phi_schedule) >= 3
    assert (res.accept_rates > 0.05).all()
    assert res.samples.shape == (256, 2) and res.unconstrained.shape == (256, 2)
    assert np.isfinite(res.samples).all() and np.isfinite(res.log_evidence)
    assert res.param_names == ["rho_A", "sigma_A"]
    for name, val in TRUTH.items():
        s = res.samples[:, res.param_names.index(name)]
        lo, hi = np.quantile(s, [0.005, 0.995])
        assert lo <= val <= hi, (name, lo, val, hi)


def test_smc_summary_is_a_plain_dict(port_run):
    summ = port_run.summary()
    assert list(summ) == ["rho_A", "sigma_A"]
    assert set(summ["rho_A"]) == {"mean", "sd", "q0.05", "q0.5", "q0.95"}
    assert summ["rho_A"]["sd"] < 0.1
    assert summ["rho_A"]["q0.05"] < summ["rho_A"]["q0.5"] < summ["rho_A"]["q0.95"]
    np.testing.assert_allclose(summ["sigma_A"]["mean"],
                               port_run.samples[:, 1].mean())


def test_smc_same_seed_same_result(setup):
    _ref_ss, port_ss, data = setup
    kw = dict(n_particles=128, n_mh=1, seed=7, policy="pallas",
              settle="pallas", dtype=torch.float64)
    a = geconpy_torch.fit_smc(port_ss, data, **kw)
    b = geconpy_torch.fit_smc(port_ss, data, **kw)
    np.testing.assert_array_equal(a.samples, b.samples)
    assert a.log_evidence == b.log_evidence
    c = geconpy_torch.fit_smc(port_ss, data, **dict(kw, seed=8))
    assert not np.array_equal(a.samples, c.samples)


def test_smc_fused_and_pallas_settles_agree(setup):
    _ref_ss, port_ss, data = setup
    kw = dict(n_particles=128, n_mh=1, seed=7, policy="pallas",
              dtype=torch.float64)
    pallas = geconpy_torch.fit_smc(port_ss, data, settle="pallas", **kw)
    fused = geconpy_torch.fit_smc(port_ss, data, settle="fused", **kw)
    assert fused.log_evidence == pytest.approx(pallas.log_evidence, abs=1e-6)
    np.testing.assert_array_equal(fused.phi_schedule.shape,
                                  pallas.phi_schedule.shape)


@pytest.mark.parametrize("seed", [1, 2, 5])
def test_smc_resampling_at_every_stage_takes_real_steps(setup, seed):
    """With ``resample_ess`` above ``target_ess`` every tempering stage
    resamples, so every step of the schedule is a bisected one.  (With the
    two equal, the defaults here and in the reference, a stage that lands
    on the threshold is followed by steps of ~1e-15 until rounding noise
    tips the ESS under it: these seeds then take 80-110 stages for the
    same posterior.)"""
    _ref_ss, port_ss, data = setup
    res = geconpy_torch.fit_smc(port_ss, data, n_particles=256, n_mh=2,
                                seed=seed, policy="pallas", settle="pallas",
                                resample_ess=0.6, dtype=torch.float64)
    steps = np.diff(np.concatenate([[0.0], res.phi_schedule]))
    assert res.phi_schedule[-1] == pytest.approx(1.0)
    assert (steps > 1e-6).all() and 3 <= len(steps) <= 10
    assert (res.ess_path[:-1] < 0.6 * 256).all()
    assert abs(res.log_evidence - 427.4) < 1.0


def test_smc_agrees_with_reference_run(setup, port_run):
    ref_ss, _port_ss, data = setup
    ref = ref_smc.fit_smc(ref_ss, data, n_particles=256, n_mh=2, seed=0,
                          interpret=True)
    assert abs(port_run.log_evidence - ref.log_evidence) < 2.0, \
        (port_run.log_evidence, ref.log_evidence)
    sd = ref.samples.std(axis=0)
    gap = np.abs(port_run.samples.mean(axis=0) - ref.samples.mean(axis=0)) / sd
    assert (gap < 0.5).all(), gap


def test_smc_refusals(setup):
    _ref_ss, port_ss, data = setup
    with pytest.raises(ValueError, match="target_ess"):
        geconpy_torch.fit_smc(port_ss, data, target_ess=1.0,
                              policy="pallas")
    with pytest.raises(ValueError, match="'xla', 'pallas' or 'fused'"):
        geconpy_torch.fit_smc(port_ss, data, policy="pallas", settle="cuda")
    with pytest.raises(ValueError, match="policy must be 'xla' or 'pallas'"):
        geconpy_torch.fit_smc(port_ss, data, policy="cuda")
    with pytest.raises(RuntimeError, match="did not reach phi=1 in 1 stages"):
        geconpy_torch.fit_smc(port_ss, data, n_particles=64, max_stages=1,
                              policy="pallas", settle="pallas",
                              dtype=torch.float64)


def test_smc_default_policy_is_the_references(setup):
    """``fit_smc``'s ``policy`` sits at the reference's position with the
    reference's default, ``"xla"`` (the adaptive float64 policy solve, no
    kernel), and ``settle`` defaults to the reference's ``"xla"``: the
    default run of the port against the reference's default ``fit_smc``,
    at the tolerances of ``test_smc_agrees_with_reference_run``."""
    import inspect

    ref_sig = inspect.signature(ref_smc.fit_smc).parameters
    port_sig = inspect.signature(geconpy_torch.fit_smc).parameters
    assert list(port_sig)[:10] == list(ref_sig)[:10]
    assert port_sig["policy"].default == ref_sig["policy"].default == "xla"
    assert port_sig["settle"].kind is inspect.Parameter.KEYWORD_ONLY
    assert port_sig["settle"].default == "xla"
    ref_ss, port_ss, data = setup
    port = geconpy_torch.fit_smc(port_ss, data, 256, 0.5, 0.5, 2, 0, "xla",
                                 dtype=torch.float64)
    ref = ref_smc.fit_smc(ref_ss, data, n_particles=256, n_mh=2, seed=0,
                          interpret=True)
    assert port.phi_schedule[-1] == pytest.approx(1.0)
    assert abs(port.log_evidence - ref.log_evidence) < 2.0, \
        (port.log_evidence, ref.log_evidence)
    sd = ref.samples.std(axis=0)
    gap = np.abs(port.samples.mean(axis=0) - ref.samples.mean(axis=0)) / sd
    assert (gap < 0.5).all(), gap
