"""Port parity: impulse responses, simulation and moments of a solved model.

The deterministic cores of ``geconpy_torch.analysis.simulate`` and
``geconpy_torch.stats.covariance`` against ``geconpy_tpu``'s at 1e-10
(rtol and atol), fed the reference's T and R (``nk_3eq`` at its
calibration: 5 variables, 2 shocks) as numpy and the same shocks:
``simulate_linear`` (one path, a batch, a start x0), ``impulse_response``
(scalar, per-shock and trajectory), ``impulse_response_function``
(dict sizes, ``orthogonalize``), ``stationary_covariance``,
``autocovariance``, ``autocorrelation``, ``fevd`` and the labelled
``*_matrix`` forms, ``build_shock_cov`` and ``build_Q_matrix``.  The two
packages draw from different random generators, so ``simulate`` is held
to equality under one ``torch.Generator`` and to sample moments: the
sample variance of output over 4 x 20,000 periods within 15% of
``stationary_covariance`` on ``rbc``, the reference's own test.
"""

import importlib
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
from geconpy_torch.stats import covariance as port_cov
from geconpy_tpu.stats import covariance as ref_cov

# the packages re-export the function simulate under the module's name
port_sim = importlib.import_module("geconpy_torch.analysis.simulate")
ref_sim = importlib.import_module("geconpy_tpu.analysis.simulate")

TOL = dict(rtol=1e-10, atol=1e-10)


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def solved():
    """(reference PolicySolution, port PolicySolution holding the
    reference's T and R, T, R) of ``nk_3eq``."""
    ref = geconpy_tpu.model_from_gcn(geconpy_tpu.get_example_gcn("nk_3eq"),
                                     verbose=False).solve_model(verbose=False)
    port_model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("nk_3eq"), verbose=False)
    port = port_model.solve_model(verbose=False, device="cpu")
    T, R = ref.T.to_numpy(), ref.R.to_numpy()
    port.T, port.R = torch.as_tensor(T), torch.as_tensor(R)
    return ref, port, T, R


def _frame(df, outer):
    """(outer, time, n) array of a reference MultiIndex frame."""
    return df.to_numpy().reshape(outer, -1, df.shape[1])


def test_simulate_linear_matches_reference(solved):
    _ref, _port, T, R = solved
    rng = np.random.default_rng(0)
    one = rng.normal(size=(30, 2)) * 0.01
    batch = rng.normal(size=(4, 30, 2)) * 0.01
    x0 = rng.normal(size=(4, 5)) * 0.01
    np.testing.assert_allclose(port_sim.simulate_linear(T, R, one).numpy(),
                               ref_sim.simulate_linear(T, R, one), **TOL)
    np.testing.assert_allclose(port_sim.simulate_linear(T, R, batch).numpy(),
                               ref_sim.simulate_linear(T, R, batch), **TOL)
    np.testing.assert_allclose(
        port_sim.simulate_linear(T, R, batch, x0=x0).numpy(),
        ref_sim.simulate_linear(T, R, batch, x0=x0), **TOL)
    np.testing.assert_allclose(
        port_sim.simulate_linear(T, R, one, x0=x0[0]).numpy(),
        ref_sim.simulate_linear(T, R, one, x0=x0[0]), **TOL)


@pytest.mark.parametrize("kw", [dict(shock_size=1.0),
                                dict(shock_size=[0.5, -2.0]),
                                dict(shock_trajectory="path")])
def test_impulse_response_matches_reference(solved, kw):
    _ref, _port, T, R = solved
    if "shock_trajectory" in kw:
        kw = dict(shock_trajectory=np.random.default_rng(1).normal(
            size=(12, 2)))
    got = port_sim.impulse_response(T, R, 12, **kw).numpy()
    want = np.asarray(ref_sim.impulse_response(T, R, 12, **{
        k: np.asarray(v) for k, v in kw.items()}))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kw", [dict(shock_size={"epsilon_v": 0.25}),
                                dict(shock_size=0.01),
                                dict(orthogonalize=True,
                                     shock_cov=[[1e-4, 3e-5], [3e-5, 4e-4]])])
def test_impulse_response_function_matches_reference(solved, kw):
    ref, port, _T, _R = solved
    got = geconpy_torch.impulse_response_function(port, periods=15, **kw)
    want = ref_sim.impulse_response_function(ref, periods=15, **kw)
    assert got.shocks == list(ref.R.columns)
    assert got.variables == list(want.columns)
    assert got.values.shape == (2, 15, 5)
    np.testing.assert_allclose(got.values.numpy(), _frame(want, 2), **TOL)
    with pytest.raises(ValueError, match="shock_cov"):
        geconpy_torch.impulse_response_function(port, orthogonalize=True)


Q_CASES = {"diag": np.diag([1e-4, 4e-4]),
           "full": np.array([[1e-4, 3e-5], [3e-5, 4e-4]])}


@pytest.mark.parametrize("q", list(Q_CASES))
def test_moments_match_reference(solved, q):
    _ref, _port, T, R = solved
    Q = Q_CASES[q]
    np.testing.assert_allclose(
        port_cov.stationary_covariance(T, R, Q).numpy(),
        ref_cov.stationary_covariance(T, R, Q), **TOL)
    np.testing.assert_allclose(port_cov.autocovariance(T, R, Q, 6).numpy(),
                               ref_cov.autocovariance(T, R, Q, 6), **TOL)
    np.testing.assert_allclose(port_cov.autocorrelation(T, R, Q, 6).numpy(),
                               ref_cov.autocorrelation(T, R, Q, 6), **TOL)
    shares = port_cov.fevd(T, R, Q, 25).numpy()
    np.testing.assert_allclose(shares, ref_cov.fevd(T, R, Q, 25), **TOL)
    np.testing.assert_allclose(shares.sum(-1), 1.0, atol=1e-12)


def test_labelled_moments_match_reference(solved):
    ref, port, _T, _R = solved
    got = geconpy_torch.stationary_covariance_matrix(port, shock_std=0.02)
    want = ref_cov.stationary_covariance_matrix(ref, shock_std=0.02)
    assert got.variables == list(want.columns)
    np.testing.assert_allclose(got.values.numpy(), want.to_numpy(), **TOL)
    for fn in (geconpy_torch.autocovariance_matrix,
               geconpy_torch.autocorrelation_matrix):
        got = fn(port, n_lags=4, shock_cov=Q_CASES["full"])
        want = getattr(ref_cov, fn.__name__)(ref, n_lags=4,
                                             shock_cov=Q_CASES["full"])
        np.testing.assert_allclose(got.values.numpy(), _frame(want, 4), **TOL)
    cov = geconpy_torch.autocovariance_matrix(port, n_lags=3,
                                              correlation=False)
    want = ref_cov.autocovariance_matrix(ref, n_lags=3, correlation=False)
    np.testing.assert_allclose(cov.values.numpy(), _frame(want, 3), **TOL)
    np.testing.assert_allclose(port.stationary_covariance().values.numpy(),
                               ref.stationary_covariance().to_numpy(), **TOL)


def test_shock_covariance_builders_match_reference():
    names = ["a", "b", "c"]
    for kw in (dict(), dict(shock_std=0.3), dict(shock_std_dict={"b": 0.2}),
               dict(shock_cov_matrix=np.diag([1.0, 2.0, 3.0]))):
        np.testing.assert_array_equal(port_cov.build_Q_matrix(names, **kw),
                                      ref_cov.build_Q_matrix(names, **kw))
    for bad in (dict(shock_std=0.1, shock_std_dict={"a": 1.0}),
                dict(shock_std_dict={"z": 1.0}),
                dict(shock_cov_matrix=np.eye(2))):
        with pytest.raises(ValueError):
            port_cov.build_Q_matrix(names, **bad)
    for kw in (dict(), dict(shock_std=[0.1, 0.2, 0.3]),
               dict(shock_cov=np.eye(3) * 2)):
        np.testing.assert_array_equal(
            port_cov.build_shock_cov(3, **kw).numpy(),
            ref_cov.build_shock_cov(3, **kw))


def test_simulate_is_reproducible_under_one_generator(solved):
    _ref, port, T, R = solved
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    a = geconpy_torch.simulate(port, periods=20, n_simulations=3,
                               generator=gen(5))
    b = geconpy_torch.simulate(port, periods=20, n_simulations=3,
                               generator=gen(5))
    c = geconpy_torch.simulate(port, periods=20, n_simulations=3,
                               generator=gen(6))
    assert a.values.shape == (3, 20, 5) and a.variables == port.variables
    assert torch.equal(a.values, b.values)
    assert not torch.equal(a.values, c.values)
    assert torch.equal(a.values, geconpy_torch.simulate(
        port, periods=20, n_simulations=3, seed=5).values)
    # the paths are the linear recursion over the generator's draws
    eps = torch.randn((3, 20, 2), generator=gen(5), dtype=torch.float64)
    np.testing.assert_allclose(
        a.values.numpy(), ref_sim.simulate_linear(T, R, 0.01 * eps.numpy()),
        **TOL)
    full = geconpy_torch.simulate(port, periods=20, n_simulations=3,
                                  shock_cov=Q_CASES["full"], generator=gen(5))
    L = np.linalg.cholesky(Q_CASES["full"])
    np.testing.assert_allclose(
        full.values.numpy(),
        ref_sim.simulate_linear(T, R, eps.numpy() @ L.T), **TOL)


def test_simulated_variance_matches_stationary_covariance():
    model = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn("rbc"),
                                         verbose=False)
    sol = model.solve_model(verbose=False, device="cpu")
    Sigma = geconpy_torch.stationary_covariance_matrix(sol, shock_std=0.01)
    sims = geconpy_torch.simulate(sol, periods=20000, n_simulations=4,
                                  shock_std=0.01, seed=7)
    y = sol.variables.index("Y")
    sample_var = float(sims.values[..., y].var())
    np.testing.assert_allclose(float(Sigma.values[y, y]), sample_var,
                               rtol=0.15)
    # the pruned second-order simulation and IRFs of the same solution
    _, res2 = model.solve_model_second_order(solution=sol, shock_std=0.01)
    sims2 = port_sim.simulate_second_order(sol, res2, periods=20,
                                           n_simulations=3, shock_std=0.01,
                                           seed=7)
    assert sims2.values.shape == (3, 20, len(sol.variables))
    assert sims2.variables == sol.variables
    assert bool(torch.isfinite(sims2.values).all())
    irf2 = port_sim.impulse_response_second_order(sol, res2, periods=5)
    assert irf2.values.shape == (len(sol.shocks), 5, len(sol.variables))
