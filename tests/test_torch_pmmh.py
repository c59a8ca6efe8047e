"""Port parity: particle-marginal Metropolis-Hastings
(``geconpy_torch/stats/pmmh.py``), ``fit_pmmh`` and ``fit(order=2)``
(``geconpy_torch/stats/estimation.py``).

CPU, float64, one thread:

- On injected draws: the reference's proposal normals and acceptance
  uniforms, rebuilt from its key as it splits it, fed to the port's
  private core, give the reference's draws, likelihoods, acceptance rates
  and final scales at rel 1e-10, for an exact likelihood and for an
  unbiased noisy one (its noise rebuilt from the reference's per-chain
  keys).
- By distribution under one ``torch.Generator`` (the reference's
  ``tests/stats/test_pmmh.py`` settings and bars): a standard normal is
  recovered (|mean| < 0.05, sd within rel 0.06, acceptance in (0.1,
  0.6)); failed estimates are never accepted; ``segment_size`` changes
  nothing, bitwise.
- ``fit_pmmh`` and ``fit(order=2)`` on the pruned second-order
  ``rbc_estimation`` (Y observed with measurement error, 40 periods): the
  result's shapes and finite draws; ``fit_pmmh`` equal to
  ``sample_pmmh`` run from the same generator, its log posterior the
  likelihood estimate plus the log prior; ``fit(order=2)``'s log
  posteriors those of ``build_logpost_second_order`` at its draws, and the
  same seed giving the same fit; ``fit(order=2, policy="pallas")`` raises the
  reference's ``ValueError`` (``tests/test_torch_estimation.py``).
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
from geconpy_torch.stats import pmmh as port
from geconpy_torch.stats.estimation import _logprior, fit, fit_pmmh
from geconpy_torch.stats.statespace import DSGEStateSpace
from geconpy_tpu.stats import pmmh as ref

NOISE = 0.7


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _ref_stream(key, n_chains, dim, total):
    """The reference's random numbers (``pmmh.py:93-100``): per-chain
    likelihood keys at the start, then per iteration the proposal normals,
    the per-chain likelihood keys and the acceptance uniforms."""
    k_init, k_run = jax.random.split(key)
    init_keys = jax.random.split(k_init, n_chains)
    normals, ll_keys, uniforms = [], [], []
    for k_t in jax.random.split(k_run, total):
        k_prop, k_ll, k_acc = jax.random.split(k_t, 3)
        normals.append(np.array(jax.random.normal(k_prop, (n_chains, dim),
                                                    jnp.float64)))
        ll_keys.append(jax.random.split(k_ll, n_chains))
        uniforms.append(np.array(jax.random.uniform(k_acc, (n_chains,),
                                                      jnp.float64)))
    return init_keys, normals, ll_keys, uniforms


@pytest.mark.parametrize("noisy", [False, True])
def test_core_matches_reference_on_injected_draws(noisy):
    n_chains, dim, warmup, samples = 3, 2, 30, 40
    q0 = np.random.default_rng(1).normal(size=(n_chains, dim))
    key = jax.random.PRNGKey(5)

    def ref_loglik(u, k):
        noise = NOISE * jax.random.normal(k, ()) - 0.5 * NOISE ** 2 \
            if noisy else 0.0
        return -0.5 * jnp.sum(u ** 2) + noise, jnp.asarray(True)

    want = ref.sample_pmmh(ref_loglik, lambda u: -0.5 * jnp.sum((u / 3) ** 2),
                           jnp.asarray(q0), key, num_warmup=warmup,
                           num_samples=samples, initial_scale=0.5)
    init_keys, normals, ll_keys, uniforms = _ref_stream(
        key, n_chains, dim, warmup + samples)
    noise = [np.asarray(jax.vmap(lambda k: NOISE * jax.random.normal(k, ())
                                 - 0.5 * NOISE ** 2)(ks)) if noisy
             else np.zeros(n_chains) for ks in [init_keys] + ll_keys]
    calls = iter(noise)
    stream_n, stream_u = iter(normals), iter(uniforms)

    def parts(U):
        ll = -0.5 * (U ** 2).sum(-1) + torch.as_tensor(next(calls))
        return ll, -0.5 * ((U / 3) ** 2).sum(-1)

    got = port._pmmh(parts, torch.as_tensor(q0),
                     lambda: torch.as_tensor(next(stream_n)),
                     lambda: torch.as_tensor(next(stream_u)), warmup,
                     samples, 0.5, 0.234)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                   atol=1e-10 * np.abs(w).max())


def _standard_normal(u, _generator):
    return -0.5 * (u ** 2).sum(-1), torch.ones(u.shape[0], dtype=torch.bool)


def test_recovers_standard_normal():
    gen = torch.Generator().manual_seed(0)
    q0 = torch.randn((8, 1), generator=torch.Generator().manual_seed(100))
    res = port.sample_pmmh(_standard_normal, lambda u: u.new_zeros(u.shape[0]),
                           q0, gen, num_warmup=1000, num_samples=4000,
                           initial_scale=0.5)
    draws = res.samples.reshape(-1).numpy()
    assert abs(draws.mean()) < 0.05
    np.testing.assert_allclose(draws.std(), 1.0, rtol=0.06)
    acc = res.accept_rate.numpy()
    assert np.all(acc > 0.1) and np.all(acc < 0.6)


def test_gates_failed_estimates_and_segments_change_nothing():
    def boxed(u, _generator):
        return -0.5 * (u ** 2).sum(-1), (u.abs() < 1.0).all(-1)

    q0 = 0.5 * (2 * torch.rand((8, 1), generator=torch.Generator()
                               .manual_seed(42)) - 1)
    runs = [port.sample_pmmh(boxed, lambda u: u.new_zeros(u.shape[0]), q0,
                             torch.Generator().manual_seed(5), num_warmup=200,
                             num_samples=400, initial_scale=0.5,
                             segment_size=seg) for seg in (None, 33)]
    assert bool((runs[0].samples.abs() < 1.0).all())
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def rbc():
    ss = DSGEStateSpace(geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"), verbose=False),
        device="cpu").configure(observed_states=["Y"],
                                measurement_error=["Y"],
                                constant_params=["alpha", "sigma_C",
                                                 "sigma_A"])
    data, _ = ss.data_from_prior(torch.Generator().manual_seed(2),
                                 periods=40)
    return ss, data


def test_fit_pmmh_on_the_second_order_model(rbc):
    ss, data = rbc
    kw = dict(num_chains=2, num_warmup=10, num_samples=15, n_particles=128,
              seed=2)
    res = fit_pmmh(ss, data, **kw)
    assert res.samples.shape == (2, 15, len(ss.estimated))
    assert np.isfinite(res.samples).all() and np.isfinite(res.logp).all()
    assert set(res.summary()["names"]) == set(ss.param_labels)
    # the same sampler run from the same generator gives the same draws,
    # and logp is the joint posterior: their likelihood estimates plus the
    # log prior
    gen = torch.Generator().manual_seed(2)
    inits = torch.stack([ss.initial_position(jitter=0.25, generator=gen)
                         for _ in range(2)])
    direct = port.sample_pmmh(
        ss.build_pf_loglik_second_order(data, n_particles=128),
        lambda U: _logprior(ss, U), inits, gen, num_warmup=10,
        num_samples=15)
    np.testing.assert_array_equal(res.unconstrained, direct.samples.numpy())
    np.testing.assert_allclose(
        res.logp, (direct.loglik + _logprior(ss, direct.samples)).numpy(),
        rtol=1e-14)


def test_fit_order_two(rbc):
    ss, data = rbc
    kw = dict(num_chains=2, num_warmup=2, num_samples=2, max_depth=2,
              seed=1, order=2, dtype=torch.float64)
    res = fit(ss, data, **kw)
    assert res.samples.shape == (2, 2, len(ss.estimated))
    assert np.isfinite(res.logp).all()
    # the draws' log posteriors are the second-order ones
    lp2 = ss.build_logpost_second_order(data)(
        torch.as_tensor(res.unconstrained.reshape(-1, len(ss.estimated))))
    np.testing.assert_allclose(res.logp.reshape(-1), lp2.numpy(), rtol=1e-12)
    again = fit(ss, data, **kw)
    np.testing.assert_array_equal(again.unconstrained, res.unconstrained)
