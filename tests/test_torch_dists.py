"""Port parity: priors.

For every family the bundled ``sw2007`` and ``rbc_estimation`` priors use
(Beta, Normal, Gamma, InverseGamma, and HalfNormal as the default
measurement-error prior), and for the other registered families,
``logpdf``, ``from_unconstrained`` (value and log-Jacobian) and
``to_unconstrained`` equal the JAX priors at rtol 1e-12 on the same numpy
points; the GCN prior statements resolve to the same families and fields.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geconpy_torch
import geconpy_tpu
from geconpy_torch.dists import core as port
from geconpy_torch.dists import resolve_priors as port_resolve_priors
from geconpy_tpu.dists import core as ref
from geconpy_tpu.dists import resolve_priors as ref_resolve_priors

FAMILIES = [
    ("Normal", dict(mu=0.3, sigma=0.7)),
    ("HalfNormal", dict(sigma=0.1)),
    ("Beta", dict(alpha=28.5, beta=1.5)),
    ("Gamma", dict(alpha=9.0, beta=6.0)),
    ("InverseGamma", dict(alpha=6.0, beta=0.05)),
    ("Uniform", dict(lower_=-1.0, upper_=2.0)),
    ("LogNormal", dict(mu=-0.5, sigma=0.4)),
    ("Exponential", dict(lam=2.0)),
    ("StudentT", dict(nu=4.0, mu=0.1, sigma=0.5)),
    ("TruncatedNormal", dict(mu=0.5, sigma=0.2, lower_=0.0, upper_=1.0)),
]


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _pair(name, kwargs):
    return getattr(ref, name)(**kwargs), getattr(port, name)(**kwargs)


@pytest.mark.parametrize("name,kwargs", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_logpdf_and_transforms_match(name, kwargs):
    d_ref, d_port = _pair(name, kwargs)
    rng = np.random.default_rng(0)
    u = rng.standard_normal(64) * 1.5
    x_ref, jac_ref = d_ref.from_unconstrained(jnp.asarray(u))
    x_port, jac_port = d_port.from_unconstrained(torch.as_tensor(u))
    np.testing.assert_allclose(x_port.numpy(), np.asarray(x_ref), rtol=1e-12)
    np.testing.assert_allclose(jac_port.numpy(), np.asarray(jac_ref),
                               rtol=1e-12, atol=1e-300)
    x = np.array(x_ref)
    np.testing.assert_allclose(d_port.logpdf(torch.as_tensor(x)).numpy(),
                               np.asarray(d_ref.logpdf(jnp.asarray(x))),
                               rtol=1e-12)
    np.testing.assert_allclose(d_port.to_unconstrained(torch.as_tensor(x)).numpy(),
                               np.asarray(d_ref.to_unconstrained(jnp.asarray(x))),
                               rtol=1e-9, atol=1e-12)
    assert d_port.mean() == pytest.approx(d_ref.mean(), rel=1e-12, nan_ok=True)
    np.testing.assert_allclose(d_port.ppf(np.array([0.1, 0.5, 0.9])),
                               np.asarray(d_ref.ppf(np.array([0.1, 0.5, 0.9]))),
                               rtol=1e-10)


BOUNDED = [f for f in FAMILIES if f[0] not in ("Normal", "StudentT")]


@pytest.mark.parametrize("name,kwargs", BOUNDED, ids=[f[0] for f in BOUNDED])
def test_logpdf_outside_support_is_minus_inf(name, kwargs):
    d_ref, d_port = _pair(name, kwargs)
    lo, hi = d_ref.support()
    pts = [p for p in (lo - 1.0, hi + 1.0) if np.isfinite(p)]
    assert pts
    got = d_port.logpdf(torch.as_tensor(pts)).numpy()
    want = np.asarray(d_ref.logpdf(jnp.asarray(pts)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,kwargs", FAMILIES[:5],
                         ids=[f[0] for f in FAMILIES[:5]])
def test_samples_follow_the_distribution(name, kwargs):
    _d_ref, d_port = _pair(name, kwargs)
    g = torch.Generator().manual_seed(0)
    s = d_port.sample(g, (20000,)).numpy()
    assert s.dtype == np.float64 and s.shape == (20000,)
    assert abs(s.mean() - d_port.mean()) < 5 * d_port.std() / np.sqrt(len(s))


@pytest.mark.parametrize("model", ["sw2007", "rbc_estimation"])
def test_gcn_priors_resolve_to_the_same_distributions(model):
    ref_model = geconpy_tpu.model_from_gcn(geconpy_tpu.get_example_gcn(model),
                                           verbose=False)
    port_model = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn(model))
    rp, rs = ref_resolve_priors(ref_model.primitives.priors,
                                ref_model.primitives.shock_priors)
    pp, ps = port_resolve_priors(port_model.primitives.priors,
                                 port_model.primitives.shock_priors)
    assert sorted(pp) == sorted(rp) and sorted(ps) == sorted(rs)
    for key, d in rp.items():
        assert type(pp[key]).__name__ == type(d).__name__
        assert isinstance(pp[key], port.Distribution)
        assert dataclasses.asdict(pp[key]) == pytest.approx(dataclasses.asdict(d))
    for key, d in rs.items():
        assert (ps[key].dist_name, ps[key].fixed_kwargs, ps[key].param_kwargs) \
            == (d.dist_name, d.fixed_kwargs, d.param_kwargs)
