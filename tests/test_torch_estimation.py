"""Port parity: NUTS estimation, ``geconpy_torch.fit``
(``geconpy_torch/stats/estimation.py``).

A short ``fit`` on ``rbc_estimation`` (Y observed, rho_A and sigma_A
estimated, stationary filter, 48 periods made by the JAX package at
rho_A = 0.9, sigma_A = 0.012) holds its posterior means to a reference
``fit(policy="pallas")`` run (its Pallas kernels in interpret mode) within
0.5 posterior standard deviations, as ``tests/test_torch_smc.py`` does:
16 pooled chains, 20 warmup and 20 sampling transitions, max_depth 4,
starts jittered around the prior means, a unit metric to start from (the
reference's curvature seed takes its forward-mode branch on this path and
differs from the central differences the port computes; see ROADMAP
Queue 3).  The two draw from different random generators, so only the
posteriors are compared.  Then, on tiny fits: the same seed gives the same
result, ``segment_size`` changes nothing, ``init="map"`` reads the mode's
memo, ``summary()`` is a plain dict, every refusal raises, and
``initial_position(jitter, generator)``.  CPU, float64, one thread.
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
from geconpy_torch.stats import estimation as port_estimation
from geconpy_torch.stats.statespace import DSGEStateSpace as PortStateSpace
from geconpy_tpu.stats import estimation as ref_estimation
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace

RBC = dict(observed_states=["Y"], constant_params=["alpha", "sigma_C"],
           filter_type="stationary", kalman_settle=12)
FIT = dict(num_chains=16, num_warmup=20, num_samples=20, max_depth=4,
           policy="pallas", pooled_adaptation=True, init="prior",
           init_jitter=0.1, mass_init="unit", seed=0)
TINY = dict(num_chains=3, num_warmup=3, num_samples=3, max_depth=2,
            policy="pallas", dtype=torch.float64)


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
    ref_ss = RefStateSpace(geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn("rbc_estimation"), verbose=False)
    ).configure(**RBC)
    data, _ = ref_ss.data_from_prior(jax.random.PRNGKey(0), periods=48,
                                     params={"rho_A": 0.9, "sigma_A": 0.012})
    data = np.asarray(data)
    port_ss = PortStateSpace(geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation")), device="cpu"
    ).configure(**RBC)
    return ref_ss, port_ss, data


def test_fit_posterior_matches_reference(setup, monkeypatch):
    ref_ss, port_ss, data = setup
    batched = ref_estimation.make_batched_logp_grad
    monkeypatch.setattr(ref_estimation, "make_batched_logp_grad",
                        lambda ss, d, **kw: batched(ss, d, interpret=True,
                                                    cr_tile=8, **kw))
    ref = geconpy_tpu.fit(ref_ss, data, **FIT)
    got = geconpy_torch.fit(port_ss, data, dtype=torch.float64, **FIT)
    assert got.samples.shape == ref.samples.shape == (16, 20, 2)
    assert got.param_names == list(ref.param_names)
    assert np.isfinite(got.samples).all() and np.isfinite(got.logp).all()
    sd = ref.samples.reshape(-1, 2).std(axis=0)
    ref_mean = np.array(list(ref.posterior_mean().values()))
    got_mean = np.array(list(got.posterior_mean().values()))
    assert (np.abs(got_mean - ref_mean) < 0.5 * sd).all(), (got_mean, ref_mean)
    np.testing.assert_allclose(got.samples.reshape(-1, 2).std(axis=0), sd,
                               rtol=0.5)
    # every transition's value+grad calls: whole tree levels, never more
    # than the reference's 2^max_depth - 1 leaves
    assert got.n_calls.shape == (40,)
    assert set(got.n_calls) <= {1, 3, 7, 15}
    assert (got.n_leapfrog <= got.n_calls[20:][None, :]).all()


@pytest.fixture(scope="module")
def tiny(setup):
    _ref_ss, port_ss, data = setup
    return geconpy_torch.fit(port_ss, data, seed=3, **TINY)


def test_same_seed_same_result(setup, tiny):
    _ref_ss, port_ss, data = setup
    again = geconpy_torch.fit(port_ss, data, seed=3, **TINY)
    for key in ("samples", "unconstrained", "logp", "diverging",
                "accept_prob", "step_size", "n_leapfrog", "n_calls"):
        np.testing.assert_array_equal(getattr(again, key), getattr(tiny, key))
    other = geconpy_torch.fit(port_ss, data, seed=4, **TINY)
    assert not np.array_equal(other.samples, tiny.samples)


def test_segment_size_changes_nothing(setup, tiny):
    _ref_ss, port_ss, data = setup
    seg = geconpy_torch.fit(port_ss, data, seed=3, segment_size=2, **TINY)
    np.testing.assert_array_equal(seg.samples, tiny.samples)
    np.testing.assert_array_equal(seg.logp, tiny.logp)


def test_summary_is_a_plain_dict(tiny):
    summ = tiny.summary()
    assert type(summ) is dict
    assert summ["names"] == ["rho_A", "sigma_A"]
    assert set(summ) == {"names", "mean", "sd", "hdi_3%", "hdi_97%", "ess",
                         "r_hat"}
    np.testing.assert_allclose(summ["mean"],
                               list(tiny.posterior_mean().values()))
    assert tiny.summary() is summ
    assert tiny.samples.dtype == np.float64
    assert tiny.seconds.keys() == {"hessian", "warmup", "sampling"}


def test_init_map_reads_the_mode_memo(setup, monkeypatch):
    _ref_ss, port_ss, data = setup
    u_mode, _ = port_estimation.posterior_mode(port_ss, data,
                                               dtype=torch.float64,
                                               policy="pallas", adam_steps=20)
    monkeypatch.setattr(port_estimation, "find_map", None)   # not called
    res = geconpy_torch.fit(port_ss, data, seed=0, init="map",
                            **dict(TINY, num_warmup=0, num_samples=1,
                                   max_depth=1))
    # mass_init="auto" seeds the metric from the curvature at the mode;
    # one leapfrog step of 0.1 from 0.05-jittered starts stays near it
    assert (np.abs(res.unconstrained[:, 0] - u_mode.numpy()) < 0.5).all()


def test_fit_with_the_xla_policy(setup):
    """``policy="xla"``, the reference's default: the chains' value+grad is
    the batched single-draw log posterior, which agrees with the
    ``"pallas"`` path's (``tests/test_torch_logpost.py``), so a fit from the
    same seed makes the same first transition's calls."""
    _ref_ss, port_ss, data = setup
    xla = geconpy_torch.fit(port_ss, data, seed=3, **dict(TINY, policy="xla"))
    pallas = geconpy_torch.fit(port_ss, data, seed=3, **TINY)
    assert xla.samples.shape == pallas.samples.shape == (3, 3, 2)
    assert np.isfinite(xla.logp).all()
    np.testing.assert_allclose(xla.unconstrained[:, 0], pallas.unconstrained[:, 0],
                               rtol=1e-6)


@pytest.mark.parametrize("kwargs, error, match", [
    (dict(order=2, policy="pallas"), ValueError, "order=2"),
    (dict(order=3), ValueError, "order"),
    (dict(policy="mosaic"), ValueError, "policy"),
    (dict(init="mode"), ValueError, "init"),
    (dict(mass_init="identity"), ValueError, "mass_init"),
    (dict(mass_matrix="full"), ValueError, "mass_matrix"),
])
def test_refusals_raise(setup, kwargs, error, match):
    _ref_ss, port_ss, data = setup
    call = dict(TINY, **kwargs)
    with pytest.raises(error, match=match):
        geconpy_torch.fit(port_ss, data, **call)


@pytest.mark.parametrize("keyword", ["mesh", "cache_dir"])
def test_mesh_and_cache_dir_are_accepted(setup, tiny, keyword, tmp_path,
                                         monkeypatch):
    """A one-device CPU mesh and a compile-cache directory change nothing
    of the result; the cache directory becomes the kernels' build root."""
    from geconpy_torch.ops import _cuda
    from geconpy_torch.parallel import make_mesh

    _ref_ss, port_ss, data = setup
    monkeypatch.setattr(_cuda, "CACHE_ROOT", None)
    extra = {"mesh": make_mesh(devices=("cpu",) * 3),
             "cache_dir": str(tmp_path / "cache")}[keyword]
    got = geconpy_torch.fit(port_ss, data, seed=3, **{keyword: extra}, **TINY)
    for key in ("samples", "logp", "accept_prob", "n_calls"):
        np.testing.assert_array_equal(getattr(got, key), getattr(tiny, key))
    if keyword == "cache_dir":
        assert geconpy_torch.persistent_cache_enabled() == str(tmp_path / "cache")
        assert _cuda.build_root() == tmp_path / "cache"


def test_initial_position_jitter(setup):
    ref_ss, port_ss, _data = setup
    u0 = port_ss.initial_position()
    np.testing.assert_allclose(u0.numpy(), np.asarray(ref_ss.initial_position()),
                               rtol=1e-12)
    u = port_ss.initial_position(jitter=0.5,
                                 generator=torch.Generator().manual_seed(1))
    z = torch.randn(2, generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(u.numpy(), (u0 + 0.5 * z).numpy(), rtol=1e-15)
    assert torch.equal(port_ss.initial_position(jitter=0.5), u0)

    class Elsewhere:
        device = torch.device("meta")

    with pytest.raises(ValueError, match="generator is on meta"):
        port_ss.initial_position(jitter=0.5, generator=Elsewhere())
