"""Port parity: the prior samplers (``geconpy_torch/stats/sampling.py``)
and ``Distribution.hdi``.

- ``hdi`` of every prior family of ``tests/test_torch_dists.py`` equals
  the reference's at rel 1e-10, and so does ``bounds_from_priors``.
- The host samplers are the reference's numpy and scipy code: for the same
  seed ``sample_uniform`` (random, LHS, Sobol, Halton, Poisson disk) and
  ``sample_uniform_from_priors`` give the reference's arrays bit for bit,
  and ``sample_from_priors_qmc`` its arrays at rel 1e-10 (the ``ppf`` of
  both packages agree to that).
- ``sample_from_priors`` draws from a ``torch.Generator`` (the reference
  splits a JAX key), so it is held by its distribution: bitwise
  reproducible under one seed, and the sample means of 20,000 draws within
  5 standard errors of each prior's mean.
- The cases of the reference's ``tests/stats/test_sampling.py`` on the
  port: the bounds cover the central mass, LHS puts one draw in each
  stratum, an unknown method raises.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest
import torch

from geconpy_torch.dists import core as port_dists
from geconpy_torch.stats import sampling as port
from geconpy_tpu.dists import core as ref_dists
from geconpy_tpu.stats import sampling as ref
from test_torch_dists import FAMILIES


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _priors(module):
    """Three priors (the reference test's) and a fourth family."""
    return {"alpha": module.Beta(2.0, 5.0), "rho": module.Normal(0.9, 0.05),
            "sigma": module.Gamma(2.0, 0.5),
            "tau": module.InverseGamma(6.0, 0.05)}


@pytest.mark.parametrize("mass", [0.94, 0.99])
@pytest.mark.parametrize("name,kwargs", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_hdi_matches_reference(name, kwargs, mass):
    got = getattr(port_dists, name)(**kwargs).hdi(mass)
    want = getattr(ref_dists, name)(**kwargs).hdi(mass)
    assert all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_bounds_from_priors_match_reference_and_cover_the_mass():
    got = port.bounds_from_priors(_priors(port_dists), mass=0.99)
    want = ref.bounds_from_priors(_priors(ref_dists), mass=0.99)
    assert list(got) == list(want)
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-10)
    lo, hi = got["alpha"]
    assert 0.0 <= lo < hi <= 1.0
    lo, hi = got["rho"]
    assert lo < 0.9 < hi


@pytest.mark.parametrize("method", ["random", "lhs", "sobol", "halton",
                                    "poisson"])
def test_sample_uniform_is_the_reference_bit_for_bit(method):
    bounds = {"a": (0.1, 0.9), "b": (-2.0, 3.0), "c": (1e-3, 5e-3)}
    got = port.sample_uniform(bounds, n_draws=16, method=method, seed=3)
    want = ref.sample_uniform(bounds, n_draws=16, method=method, seed=3)
    assert list(got) == list(want)
    for name in got:
        np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize("method", ["lhs", "sobol", "halton"])
def test_uniform_from_priors_is_the_reference_within_bounds(method):
    got = port.sample_uniform_from_priors(_priors(port_dists), n_draws=128,
                                          method=method, seed=0)
    want = ref.sample_uniform_from_priors(_priors(ref_dists), n_draws=128,
                                          method=method, seed=0)
    bounds = port.bounds_from_priors(_priors(port_dists), mass=0.99)
    for name, vals in got.items():
        np.testing.assert_allclose(vals, want[name], rtol=1e-10)
        lo, hi = bounds[name]
        assert vals.shape == (128,)
        assert (vals >= lo).all() and (vals <= hi).all()


@pytest.mark.parametrize("method", ["sobol", "halton", "lhs"])
def test_qmc_inverse_cdf_draws_match_reference(method):
    got = port.sample_from_priors_qmc(_priors(port_dists), n_draws=256,
                                      method=method, seed=1)
    want = ref.sample_from_priors_qmc(_priors(ref_dists), n_draws=256,
                                      method=method, seed=1)
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-10)
    assert abs(got["rho"].mean() - 0.9) < 0.005
    assert (got["alpha"] > 0).all() and (got["alpha"] < 1).all()
    assert (got["sigma"] > 0).all()


def test_lhs_stratification():
    priors = {"u": port_dists.Normal(0.0, 1.0)}
    draws = port.sample_uniform_from_priors(priors, n_draws=64, method="lhs",
                                            mass=0.99, seed=0)
    lo, hi = port.bounds_from_priors(priors, 0.99)["u"]
    unit = (draws["u"] - lo) / (hi - lo)
    strata = np.floor(unit * 64).astype(int)
    assert sorted(strata) == list(range(64))


def test_mc_draws_follow_the_priors_and_reproduce():
    priors = _priors(port_dists)
    draws = port.sample_from_priors(priors, 20_000, seed=1, device="cpu")
    assert list(draws) == list(priors)
    for name, d in priors.items():
        x = draws[name]
        assert x.dtype == torch.float64 and x.shape == (20_000,)
        # the sample mean within 5 standard errors of the prior's mean
        assert abs(float(x.mean()) - d.mean()) < 5 * d.std() / np.sqrt(20_000)
    assert abs(float(draws["rho"].std()) - 0.05) < 0.005
    again = port.sample_from_priors(priors, 20_000, seed=1, device="cpu")
    other = port.sample_from_priors(priors, 16, seed=2, device="cpu")
    for name in priors:
        assert torch.equal(draws[name], again[name])
    assert not torch.allclose(draws["rho"][:16], other["rho"])


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown QMC method"):
        port.sample_uniform_from_priors(_priors(port_dists), method="banana")
    with pytest.raises(ValueError, match="upper bound must exceed"):
        port.sample_uniform({"a": (1.0, 0.0)})
