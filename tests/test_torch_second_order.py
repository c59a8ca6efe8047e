"""Port parity: second-order perturbation and the pruned system
(``geconpy_torch/models/second_order.py``, ``Model.solve_model_second_order``
and the analysis wrappers).

Against the JAX package on the CPU, float64, one thread:

- G_xx, G_xu, G_uu and g_ss of ``solve_model_second_order`` on ``rbc``,
  ``nk_rotemberg`` and ``nk_sw`` (21 variables, 6 shocks: the width of the
  chip run) in logs and on ``brock_mirman`` and ``burnside`` in levels, at
  rel 1e-10 of the largest entry of the four blocks; ``burnside``'s blocks
  against its closed form (rel 1e-8, the reference's bar), and
  ``brock_mirman``'s vanish in logs.
- ``simulate_pruned``, ``irf_second_order``, ``second_order_mean`` and
  ``impulse_response_second_order`` on the same shocks at rel 1e-10;
  ``generalized_irf`` on the reference's normals, rebuilt from its key,
  at rel 1e-10, and by distribution under one ``torch.Generator``
  (bitwise reproducible; equal to the deterministic IRF where the
  quadratic blocks vanish, within 1e-12).
- The adjoint of ``solve_quadratic_sylvester`` against ``jax.vjp`` of the
  reference at rel 1e-8 and against central differences (the reference's
  bar).
- A batch of draws through the solver equals the draws one at a time,
  bitwise; the long-run mean of a pruned simulation lies within 5
  standard errors of ``second_order_mean``.
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
from geconpy_torch import analysis as port_sim
from geconpy_torch.models import second_order as port_so
from geconpy_tpu import analysis as ref_sim
from geconpy_tpu.models import second_order as ref_so

CASES = {"rbc": {}, "nk_rotemberg": {}, "nk_sw": {},
         "brock_mirman_levels": dict(loglin_variables=False),
         "burnside_levels": dict(loglin_variables=False)}
BLOCKS = ("G_xx", "G_xu", "G_uu", "g_ss")
TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


@pytest.fixture(scope="module")
def solved():
    """name -> (port model, port (sol, res2), reference (sol, res2))."""
    out = {}
    for case, kw in CASES.items():
        name = case.split("_levels")[0]
        pm = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn(name),
                                          verbose=False)
        rm = geconpy_tpu.model_from_gcn(geconpy_tpu.get_example_gcn(name),
                                        verbose=False)
        out[case] = (pm, pm.solve_model_second_order(shock_std=0.01,
                                                     device="cpu", **kw),
                     rm.solve_model_second_order(shock_std=0.01, **kw))
    return out


def _close(got, want, scale, tol=TOL, msg=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol,
                               atol=tol * scale, err_msg=msg)


@pytest.mark.parametrize("case", list(CASES))
def test_blocks_match_reference(solved, case):
    _, (psol, pres), (rsol, rres) = solved[case]
    assert bool(pres.success) and bool(rres.success)
    scale = max(float(np.abs(np.asarray(getattr(rres, b))).max())
                for b in BLOCKS)
    for b in BLOCKS:
        _close(getattr(pres, b), getattr(rres, b), scale, msg=b)
    _close(psol.T, rsol.T.to_numpy(), 1.0)


def test_loglin_second_order_vanishes():
    bm = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("brock_mirman"), verbose=False)
    _, res2 = bm.solve_model_second_order(shock_std=0.01, device="cpu")
    assert bool(res2.success)
    for b in BLOCKS:
        assert float(getattr(res2, b).abs().max()) < 1e-7, b


def _burnside_sums(beta, theta, rho, xbar, n_terms=4000):
    i = np.arange(1, n_terms + 1)
    q = beta * np.exp(theta * xbar)
    b = theta * rho * (1 - rho ** i) / (1 - rho)
    c = q ** i
    v = (theta ** 2 / (2 * (1 - rho) ** 2)) * (
        i - 2 * rho * (1 - rho ** i) / (1 - rho)
        + rho ** 2 * (1 - rho ** (2 * i)) / (1 - rho ** 2))
    return float(np.sum(c * b * b)), float(np.sum(c * v))


def test_burnside_matches_closed_form():
    """Every quadratic block and the uncertainty correction against
    Burnside's (1998) closed form (``tests/models/test_second_order.py``)."""
    beta, theta, rho, xbar, sigma = 0.95, -1.5, -0.139, 0.0179, 0.0348
    S2, Sv = _burnside_sums(beta, theta, rho, xbar)
    m = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn("burnside"),
                                     verbose=False)
    sol, res2 = m.solve_model_second_order(loglin_variables=False,
                                           shock_std=sigma, device="cpu")
    iy, ix = sol.variables.index("y"), sol.variables.index("x")
    np.testing.assert_allclose(float(res2.G_xx[iy, ix, ix]), S2 * rho ** 2,
                               rtol=1e-8)
    np.testing.assert_allclose(float(res2.G_xu[iy, ix, 0]), S2 * rho,
                               rtol=1e-8)
    np.testing.assert_allclose(float(res2.G_uu[iy, 0, 0]), S2, rtol=1e-8)
    np.testing.assert_allclose(0.5 * float(res2.g_ss[iy]), Sv * sigma ** 2,
                               rtol=1e-8)


def _jax_res(rres):
    return ref_so.SecondOrderResult(*(jnp.asarray(x) for x in rres))


@pytest.mark.parametrize("case", ["rbc", "nk_sw", "brock_mirman_levels"])
def test_pruned_paths_irfs_and_mean_match_reference(solved, case):
    _, (psol, pres), (rsol, rres) = solved[case]
    T, R = rsol.T.to_numpy(), rsol.R.to_numpy()
    k = R.shape[1]
    eps = 0.01 * np.random.default_rng(0).standard_normal((30, k))
    want = np.asarray(ref_so.simulate_pruned(T, R, rres, jnp.asarray(eps)))
    got = port_so.simulate_pruned(psol.T, psol.R, pres, torch.as_tensor(eps))
    _close(got, want, np.abs(want).max())
    # the same paths as a batch of paths, and a start off the steady state
    y0 = 0.01 * np.random.default_rng(1).standard_normal(T.shape[0])
    want0 = np.asarray(ref_so.simulate_pruned(T, R, rres, jnp.asarray(eps),
                                              y1_0=jnp.asarray(y0)))
    got0 = port_so.simulate_pruned(psol.T, psol.R, pres,
                                   torch.as_tensor(np.stack([eps, eps])),
                                   y1_0=torch.as_tensor(y0))
    _close(got0[1], want0, np.abs(want0).max())
    vec = np.zeros(k)
    vec[-1] = 0.02
    want = np.asarray(ref_so.irf_second_order(T, R, rres, jnp.asarray(vec),
                                              periods=15))
    got = port_so.irf_second_order(psol.T, psol.R, pres, torch.as_tensor(vec),
                                   periods=15)
    _close(got, want, np.abs(want).max())
    Q = 0.01 ** 2 * np.eye(k)
    want = np.asarray(ref_so.second_order_mean(T, R, rres, jnp.asarray(Q)))
    got = port_so.second_order_mean(psol.T, psol.R, pres, torch.as_tensor(Q))
    _close(got, want, max(np.abs(want).max(), 1e-300))


def test_labelled_irfs_match_reference(solved):
    _, (psol, pres), (rsol, rres) = solved["nk_sw"]
    sizes = {psol.shocks[0]: 0.03}
    want = ref_sim.impulse_response_second_order(rsol, rres, periods=10,
                                                  shock_size=sizes)
    got = port_sim.impulse_response_second_order(psol, pres, periods=10,
                                                 shock_size=sizes)
    assert got.shocks == list(want.index.get_level_values(0).unique())
    assert got.variables == list(want.columns)
    w = want.to_numpy().reshape(got.values.shape)
    _close(got.values, w, np.abs(w).max())


def test_simulate_second_order_draws_and_labels(solved):
    """The wrapper simulates the pruned system on its generator's normals
    times the shock Cholesky factor (the reference's rules); those paths
    equal the reference's ``simulate_pruned`` on the same shocks."""
    _, (psol, pres), (rsol, rres) = solved["rbc"]
    k = len(psol.shocks)
    cov = 1e-4 * (np.eye(k) + 0.0)
    sims = port_sim.simulate_second_order(
        psol, pres, periods=12, n_simulations=3, shock_cov=cov,
        generator=torch.Generator().manual_seed(4))
    assert sims.values.shape == (3, 12, len(psol.variables))
    assert sims.variables == list(rsol.T.columns)
    draws = torch.randn((3, 12, k), generator=torch.Generator().manual_seed(4))
    eps = (draws @ torch.linalg.cholesky(torch.as_tensor(cov)).mT).numpy()
    T, R = rsol.T.to_numpy(), rsol.R.to_numpy()
    want = np.stack([np.asarray(ref_so.simulate_pruned(T, R, rres,
                                                       jnp.asarray(e)))
                     for e in eps])
    _close(sims.values, want, np.abs(want).max())
    again = port_sim.simulate_second_order(
        psol, pres, periods=12, n_simulations=3, shock_cov=cov,
        generator=torch.Generator().manual_seed(4))
    assert torch.equal(again.values, sims.values)


def test_generalized_irf_on_injected_draws(solved):
    _, (psol, pres), (rsol, rres) = solved["brock_mirman_levels"]
    T, R = rsol.T.to_numpy(), rsol.R.to_numpy()
    Q = np.array([[0.02 ** 2]])
    x0 = np.zeros(T.shape[0])
    x0[rsol.T.index.get_loc("K")] = 0.05
    key = jax.random.PRNGKey(7)
    want = np.asarray(ref_so.generalized_irf(
        T, R, rres, jnp.array([0.1]), jnp.asarray(Q), periods=10, n_draws=32,
        key=key, x0=jnp.asarray(x0)))
    normals = np.asarray(jax.random.normal(key, (32, 10, 1), jnp.float64))
    got = port_so._girf_from_normals(
        psol.T, psol.R, pres, torch.tensor([0.1]), torch.as_tensor(Q),
        torch.tensor(normals), torch.as_tensor(x0))
    _close(got, want, np.abs(want).max())


def test_generalized_irf_by_distribution():
    """Under one generator the GIRF is bitwise reproducible; where every
    quadratic block vanishes (Brock-Mirman in logs) it equals the
    deterministic IRF (the reference's
    ``test_generalized_irf_reduces_to_deterministic_at_first_order``)."""
    bm = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("brock_mirman"), verbose=False)
    sol, res2 = bm.solve_model_second_order(shock_std=0.02, device="cpu")
    Q = torch.tensor([[0.02 ** 2]])
    det = port_so.irf_second_order(sol.T, sol.R, res2, torch.tensor([0.05]),
                                   periods=15)
    runs = [port_so.generalized_irf(sol.T, sol.R, res2, torch.tensor([0.05]),
                                    Q, periods=15, n_draws=16,
                                    generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    np.testing.assert_allclose(runs[0].numpy(), det.numpy(), rtol=0,
                               atol=1e-12)


def test_long_run_mean_matches_second_order_mean():
    """Brock-Mirman in levels (genuine curvature): 16 independent pruned
    paths of 6,000 periods after 500 of burn-in; the mean of the path
    means lies within 5 standard errors of the closed form."""
    sigma = 0.05
    m = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("brock_mirman"), verbose=False)
    sol, res2 = m.solve_model_second_order(loglin_variables=False,
                                           shock_std=sigma, device="cpu")
    exact = port_so.second_order_mean(sol.T, sol.R, res2,
                                      torch.tensor([[sigma ** 2]]))
    assert float(exact.abs().max()) > 1e-5
    eps = sigma * torch.randn((16, 6500, 1),
                              generator=torch.Generator().manual_seed(11))
    paths = port_so.simulate_pruned(sol.T, sol.R, res2, eps)[:, 500:]
    means = paths.mean(dim=1)                        # (16, n)
    se = means.std(dim=0) / 4.0
    gap = (means.mean(dim=0) - exact).abs()
    assert bool((gap <= 5 * se + 1e-12).all()), (gap, se)


def test_batch_equals_draws_one_at_a_time():
    m = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn("rbc"),
                                     verbose=False)
    solve2 = m.second_order_solver()
    theta = m.default_theta()[None] * (1.0 + 0.01 * torch.arange(3.0)[:, None])
    ss = m.ss_solver(theta)
    lin = m.linearizer()(ss.x_ss, ss.theta_full)
    from geconpy_torch.ops.static_reduction import solve_policy_reduced

    T, R, ok, _, _ = solve_policy_reduced(lin.A, lin.B, lin.C, lin.D,
                                          m.static_reduction)
    assert bool(ok.all())
    Q = 1e-4 * torch.eye(m.n_shocks).expand(3, -1, -1)
    batch = solve2(ss.x_ss, ss.theta_full, T, R, Q)
    for i in range(3):
        one = solve2(ss.x_ss[i:i + 1], ss.theta_full[i:i + 1], T[i:i + 1],
                     R[i:i + 1], Q[i:i + 1])
        for b, o in zip(batch, one):
            assert torch.equal(b[i:i + 1], o)


def _sylvester_case(n=4):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(n, n)) + 3.0 * np.eye(n),
            rng.normal(size=(n, n)) * 0.3, rng.normal(size=(n, n)) * 0.2,
            rng.normal(size=(n, n, n)), rng.normal(size=(n, n, n)))


def test_sylvester_adjoint_matches_jax_vjp():
    A_l, C, T, K, V = _sylvester_case()

    def ref_scalar(*args):
        X, _ = ref_so.solve_quadratic_sylvester(*args)
        return jnp.sum(X * V)

    want = jax.grad(ref_scalar, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (A_l, C, T, K)))
    args = [torch.tensor(a, requires_grad=True) for a in (A_l, C, T, K)]
    X, ok = port_so.solve_quadratic_sylvester(*args)
    assert bool(ok)
    got = torch.autograd.grad((X * torch.as_tensor(V)).sum(), args)
    Xr, _ = ref_so.solve_quadratic_sylvester(*(jnp.asarray(a)
                                               for a in (A_l, C, T, K)))
    _close(X, Xr, np.abs(np.asarray(Xr)).max())
    for g, w in zip(got, want):
        _close(g, w, np.abs(np.asarray(w)).max(), tol=1e-8)


def test_sylvester_adjoint_matches_central_differences():
    A_l, C, T, K, V = _sylvester_case()
    rng = np.random.default_rng(1)
    args = [torch.tensor(a, requires_grad=True) for a in (A_l, C, T, K)]
    X, _ = port_so.solve_quadratic_sylvester(*args)
    grads = torch.autograd.grad((X * torch.as_tensor(V)).sum(), args)

    def scalar(vals):
        X, _ = port_so.solve_quadratic_sylvester(
            *(torch.as_tensor(v) for v in vals))
        return float((X * torch.as_tensor(V)).sum())

    base = [A_l, C, T, K]
    h = 1e-6
    for ai, a in enumerate(base):
        for _ in range(5):
            idx = tuple(rng.integers(0, 4, a.ndim))
            up = [b.copy() for b in base]
            dn = [b.copy() for b in base]
            up[ai][idx] += h
            dn[ai][idx] -= h
            fd = (scalar(up) - scalar(dn)) / (2 * h)
            g = float(grads[ai][idx])
            assert abs(g - fd) < 1e-5 * max(1.0, abs(fd)), (ai, idx, g, fd)
