"""Port parity: Iskrev identification (``geconpy_torch/stats/
identification.py`` against ``geconpy_tpu/stats/identification.py``), and
the label-switching fixture behind it.

The reference's tests (``tests/stats/test_identification.py``,
``tests/stats/test_nonidentification.py``) on both packages: ``nk_3eq``
with (x, pi) observed at the swap-symmetric point (rank deficient by
exactly 2, the null space the swap-difference directions, collinearity 1
on the degenerate columns), with the rate observed (identified),
``rbc_estimation`` with Y and C observed (identified) and with Y alone at
3 lags (the Jacobian's shape and labels).  In each, J within rel 1e-10 of
the reference's (relative to its largest entry), singular values and
collinearity within 1e-8, rank, ``identified`` and labels equal.  Then
the likelihood-level symmetry: without the rate the port's log-likelihood
is equal at a point and its swap (rel 1e-9) and equals the reference's
(rel 1e-8); with the rate observed the two differ by more than 1.
CPU, float64, one thread.
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
from geconpy_torch.stats.identification import iskrev_identification as port
from geconpy_torch.stats.statespace import DSGEStateSpace as PortStateSpace
from geconpy_tpu.stats.identification import iskrev_identification as ref
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace

SYM_POINT = {"rho_rn": 0.6, "rho_v": 0.6, "sigma_rn": 0.003, "sigma_v": 0.003}
NK_CONST = ["beta", "kappa", "sigma", "phi_pi", "phi_x"]
CASES = {
    "nk3eq_without_rate": ("nk_3eq", dict(observed_states=["x", "pi"],
                                          constant_params=NK_CONST),
                           SYM_POINT, 5),
    "nk3eq_with_rate": ("nk_3eq", dict(observed_states=["x", "pi", "i"],
                                       measurement_error={"i": 0.001},
                                       constant_params=NK_CONST),
                        SYM_POINT, 5),
    "rbc_estimation": ("rbc_estimation",
                       dict(observed_states=["Y", "C"],
                            measurement_error=["Y", "C"]), None, 5),
    "rbc_estimation_one_obs": ("rbc_estimation",
                               dict(observed_states=["Y"],
                                    measurement_error=["Y"]), None, 3),
}
SWAP = ({"rho_rn": 0.8, "rho_v": 0.3, "sigma_rn": 0.004, "sigma_v": 0.002},
        {"rho_rn": 0.3, "rho_v": 0.8, "sigma_rn": 0.002, "sigma_v": 0.004})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    return {name: (geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn(name), verbose=False),
        geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn(name),
                                     verbose=False))
        for name in ("nk_3eq", "rbc_estimation")}


def _pair(models, name, kw):
    ref_model, port_model = models[name]
    return (RefStateSpace(ref_model).configure(**kw),
            PortStateSpace(port_model, device="cpu").configure(**kw))


@pytest.fixture(scope="module")
def results(models):
    out = {}
    for case, (name, kw, params, n_lags) in CASES.items():
        ref_ss, port_ss = _pair(models, name, kw)
        out[case] = (ref(ref_ss, params=params, n_lags=n_lags),
                     port(port_ss, params=params, n_lags=n_lags), port_ss)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_matches_reference(results, case):
    want, got, _ = results[case]
    np.testing.assert_allclose(got.jacobian, want.jacobian, rtol=1e-10,
                               atol=1e-10 * np.abs(want.jacobian).max())
    np.testing.assert_allclose(got.singular_values, want.singular_values,
                               rtol=1e-8, atol=1e-8 * want.singular_values[0])
    np.testing.assert_allclose(got.collinearity, want.collinearity,
                               atol=1e-8)
    assert got.rank == want.rank
    assert got.identified == want.identified
    assert got.nullspace.shape == want.nullspace.shape
    assert got.param_names == want.param_names
    assert got.moment_labels == want.moment_labels


def test_nk3eq_without_rate_is_rank_deficient(results):
    _, res, _ = results["nk3eq_without_rate"]
    assert not res.identified
    assert res.rank == len(res.param_names) - 2
    idx = [res.param_names.index(p) for p in
           ("rho_rn", "rho_v", "sigma_rn", "sigma_v")]
    for col in res.nullspace.T:
        outside = np.delete(col, idx)
        if outside.size:
            assert np.abs(outside).max() < 1e-6
        np.testing.assert_allclose(col[idx[0]], -col[idx[1]], atol=1e-6)
        np.testing.assert_allclose(col[idx[2]], -col[idx[3]], atol=1e-6)
    assert res.collinearity[idx[0]] > 1.0 - 1e-8
    assert res.collinearity[idx[2]] > 1.0 - 1e-8
    assert res.summary()["in_nullspace"][idx].all()


def test_identified_cases(results):
    _, res, _ = results["nk3eq_with_rate"]
    assert res.identified and res.nullspace.shape[1] == 0
    _, res, _ = results["rbc_estimation"]
    assert res.identified
    summary = res.summary()
    assert summary["param"] == res.param_names
    assert not summary["in_nullspace"].any()
    assert np.all(res.collinearity <= 1.0 + 1e-9)
    _, res, port_ss = results["rbc_estimation_one_obs"]
    assert res.jacobian.shape == (1 + 1 + 3, len(port_ss.param_labels))
    assert len(res.moment_labels) == 5


@pytest.mark.parametrize("rate", [False, True])
def test_shock_blocks_exchangeable_only_without_rate(models, rate):
    kw = dict(observed_states=["x", "pi", "i"] if rate else ["x", "pi"],
              constant_params=NK_CONST)
    if rate:
        kw["measurement_error"] = {"i": 0.001}
    ref_ss, port_ss = _pair(models, "nk_3eq", kw)
    data, _ = port_ss.data_from_prior(torch.Generator().manual_seed(3),
                                      periods=120)
    data = np.asarray(data)
    ref_extras = jax.jit(ref_ss.build_logpost_extras(data))
    port_extras = port_ss.build_logpost_extras(data)
    lls = []
    for point in SWAP:
        u = port_ss.unconstrain(point)
        ll = float(port_extras(u).loglik)
        np.testing.assert_allclose(
            ll, float(ref_extras(jnp.asarray(u.numpy())).loglik), rtol=1e-8)
        lls.append(ll)
    assert np.isfinite(lls).all()
    if rate:
        assert abs(lls[0] - lls[1]) > 1.0, lls
    else:
        np.testing.assert_allclose(lls[0], lls[1], rtol=1e-9)
