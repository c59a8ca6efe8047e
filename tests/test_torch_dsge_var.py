"""Port parity: DSGE-VAR (``geconpy_torch/stats/dsge_var.py`` against
``geconpy_tpu/stats/dsge_var.py``).

The reference's three anchors (``tests/stats/test_dsge_var.py``), each
also held to the reference: the NIW marginal likelihood against direct
quadrature in the scalar case (rel 1e-6) and against the reference's
``niw_log_marginal`` on numpy-seeded VAR moments (rel 1e-10); the
DSGE-implied VAR moments of ``nk_3eq`` (x, pi observed) against the
reference's (rel 1e-10) and against a 60,000-period simulation's sample
moments; the lambda profile on 300 periods made by the model: log ML
within rel 1e-10 of the reference's at every lambda, the argmax at large
lambda, the properness bound equal and the too-small lambda refused.
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
from geconpy_torch.stats import dsge_var as port
from geconpy_torch.stats.statespace import DSGEStateSpace as PortStateSpace
from geconpy_tpu.stats import dsge_var as ref
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace

KW = dict(observed_states=["x", "pi"], filter_type="sequential")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def spaces():
    return (RefStateSpace(geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn("nk_3eq"), verbose=False)).configure(**KW),
            PortStateSpace(geconpy_torch.model_from_gcn(
                geconpy_torch.get_example_gcn("nk_3eq"), verbose=False),
                device="cpu").configure(**KW))


def test_niw_marginal_against_quadrature():
    from scipy import integrate, stats

    rng = np.random.default_rng(0)
    T = 12
    Y = rng.normal(0.3, 0.8, size=(T, 1))
    X = np.ones((T, 1))
    lam = 2.0
    gxx, gxy, gyy = 1.0, 0.25, 1.3
    lt = lam * T
    nu0 = lt - 1
    S0 = lt * (gyy - gxy**2 / gxx)
    P0 = lt * gxx
    M = np.eye(T) + np.outer(X, X) / P0
    resid = Y[:, 0] - X[:, 0] * (gxy / gxx)
    Minv_r = np.linalg.solve(M, resid)
    _, ldM = np.linalg.slogdet(M)

    def integrand(s2):
        loglik = (-0.5 * T * np.log(2 * np.pi * s2) - 0.5 * ldM
                  - 0.5 * resid @ Minv_r / s2)
        return np.exp(loglik + stats.invgamma.logpdf(s2, nu0 / 2.0,
                                                     scale=S0 / 2.0))

    val, _ = integrate.quad(integrand, 1e-6, 60.0, limit=400)
    got = float(port.niw_log_marginal(
        *(torch.tensor(a) for a in ([[gxx]], [[gxy]], [[gyy]], X.T @ X,
                                    X.T @ Y, Y.T @ Y)), T=T, lam=lam))
    np.testing.assert_allclose(got, np.log(val), rtol=1e-6)


@pytest.mark.parametrize("lam", [0.5, 3.0])
def test_niw_matches_reference(lam):
    rng = np.random.default_rng(1)
    n, p, T = 3, 2, 80
    k = n * p + 1
    F = rng.normal(size=(k + n + 5, k + n))
    G = F.T @ F / len(F)
    Gxx, Gxy, Gyy = G[:k, :k], G[:k, k:], G[k:, k:]
    X = np.column_stack([rng.normal(size=(T, k - 1)), np.ones(T)])
    Y = rng.normal(size=(T, n))
    args = (Gxx, Gxy, Gyy, X.T @ X, X.T @ Y, Y.T @ Y)
    want = float(ref.niw_log_marginal(*(jnp.asarray(a) for a in args), T=T,
                                      lam=lam))
    got = float(port.niw_log_marginal(*(torch.tensor(a) for a in args), T=T,
                                      lam=lam))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_implied_moments_match_reference_and_simulation(spaces):
    ref_ss, port_ss = spaces
    data, draw = port_ss.data_from_prior(torch.Generator().manual_seed(0),
                                         periods=60000, params={})
    u = port_ss.unconstrain(draw)
    p = 2
    want = ref.dsge_var_moments(jax.jit(ref_ss.build_solution_fn(
        full_state=True))(jnp.asarray(u.numpy())), p)
    got = port.dsge_var_moments(port_ss.build_solution_fn(full_state=True)(u),
                                p)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12 * float(np.abs(w).max()))
    Gxx, Gxy, Gyy = (g.numpy() for g in got)
    X, Y = port._stack_var_data(np.asarray(data), p)
    Te = len(Y)
    np.testing.assert_allclose(X.T @ X / Te, Gxx, atol=0.05 * np.abs(Gxx).max())
    np.testing.assert_allclose(X.T @ Y / Te, Gxy, atol=0.05 * np.abs(Gxx).max())
    np.testing.assert_allclose(Y.T @ Y / Te, Gyy, atol=0.05 * np.abs(Gyy).max())


def test_lambda_profile_matches_reference(spaces):
    ref_ss, port_ss = spaces
    data, draw = port_ss.data_from_prior(torch.Generator().manual_seed(1),
                                         periods=300, params={})
    data = np.asarray(data)
    u = port_ss.unconstrain(draw)
    lambdas = [0.001, 0.25, 0.5, 1.0, 5.0, 50.0]
    want = ref.dsge_var_lambda_profile(ref_ss, data, p=2, u=u.numpy(),
                                       lambdas=lambdas)
    got = port.dsge_var_lambda_profile(port_ss, data, p=2, u=u,
                                       lambdas=lambdas)
    np.testing.assert_array_equal(got.lambdas, want.index.to_numpy())
    np.testing.assert_allclose(got.log_ml, want["log_ml"].to_numpy(),
                               rtol=1e-10)
    assert got.lambda_min == want.attrs["lambda_min"]
    # correctly specified: the data prefer heavy weight on the restrictions
    assert got.lambdas[np.argmax(got.log_ml)] >= 5.0
    assert np.isfinite(got.log_ml).all()
    one = port.dsge_var_marginal_likelihood(port_ss, data, lam=5.0, p=2, u=u)
    assert one == got.log_ml[list(got.lambdas).index(5.0)]
    # the default grid
    default = port.dsge_var_lambda_profile(port_ss, data, p=2, u=u)
    assert len(default.lambdas) == 11 and default.lambdas[0] > got.lambda_min
    with pytest.raises(ValueError, match="lambda too small"):
        port.dsge_var_marginal_likelihood(port_ss, data, lam=0.001, p=2)
    bad = data.copy()
    bad[3, 1] = np.nan
    with pytest.raises(ValueError, match="fully observed"):
        port.dsge_var_lambda_profile(port_ss, bad, p=2)
