"""Port parity: OccBin (``geconpy_torch/analysis/occbin.py`` against
``geconpy_tpu/analysis/occbin.py``).

The reference's tests (``tests/analysis/test_occbin.py``) run on both
packages: the floored AR(1) (a one-period spell, a two-period spell fed
back through the notional law, no binding, an initial state with a
parameter override), the condition checks, the three-equation NK model at
the zero lower bound and its ``occbin_irf`` at +/-0.05.  Each port path is
within 1e-10 of the reference's (relative to its largest entry), with the
same regime sequence, ``success`` and ``n_iter``; then the reference
test's own checks run on the port's result.  Last, the chip's case: a
zero lower bound on ``nk_sw``'s gross policy rate (a notional rate
``Rnot`` on the smoothed Taylor rule, ``R = Rnot`` slack and ``R = 1``
binding, both regimes built with ``simplify_constants_flag=False`` so
that ``B[] = 0`` stays a variable in both), a preference shock of -0.2
over 40 periods: equal to the reference, a spell of at least two periods
and R never below 1.  CPU, float64, one thread.
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
from geconpy_torch.analysis import occbin as port
from geconpy_tpu.analysis import occbin as ref

REF_GCN = """
block DYNAMICS
{
    identities
    {
        xnot[] = rho * x[-1] + epsilon_x[];
        x[] = xnot[];
    };
    shocks { epsilon_x[]; };
    calibration { rho = 0.8; };
};
"""
ALT_GCN = REF_GCN.replace("x[] = xnot[];", "x[] = -0.5;")
FLOOR = dict(bind="xnot[] < -0.5", relax="xnot[] > -0.5")

NK_REF = """
options { linear = TRUE; };
block STEADY_STATE {
    identities { pi[ss] = 0; x[ss] = 0; i[ss] = 0; inot[ss] = 0; rn[ss] = 0; };
};
block NK {
    identities {
        pi[] = beta * E[][pi[1]] + kappa * x[];
        x[] = E[][x[1]] - (1 / sigma) * (i[] - E[][pi[1]] - rn[]);
        inot[] = phi_pi * pi[] + phi_x * x[];
        i[] = inot[];
        rn[] = rho_rn * rn[-1] + epsilon_rn[];
    };
    shocks { epsilon_rn[]; };
    calibration {
        beta = 0.99; kappa = 0.1; sigma = 2.0;
        phi_pi = 1.5; phi_x = 0.5; rho_rn = 0.7;
    };
};
"""
NK_ALT = NK_REF.replace("i[] = inot[];", "i[] = -0.0101;")
ZLB = dict(bind="inot[] < -0.0101", relax="inot[] > -0.0101")

SW_RULE = """        log(R[] / R[ss]) = rho_R * log(R[-1] / R[ss]) +
            (1 - rho_R) * (phi_pi * log(pi[]) + phi_y * log(Y[] / Y[-1])) +
            epsilon_R[];
"""


def nk_sw_zlb_sources(src: str) -> tuple[str, str]:
    """(slack, binding) regimes of nk_sw with a floor of 1 on R."""
    assert SW_RULE in src
    slack = src.replace(SW_RULE, SW_RULE.replace("log(R[] / R[ss])",
                                                 "log(Rnot[] / R[ss])")
                        + "        R[] = Rnot[];\n")
    slack = slack.replace("        R[ss] = 1 / beta;\n",
                          "        R[ss] = 1 / beta;\n"
                          "        Rnot[ss] = 1 / beta;\n")
    return slack, slack.replace("        R[] = Rnot[];\n", "        R[] = 1;\n")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _regimes(pkg, ref_src, alt_src, simplify_ref=True):
    return (pkg.model_from_gcn(ref_src, verbose=False,
                               simplify_constants_flag=simplify_ref),
            pkg.model_from_gcn(alt_src, verbose=False,
                               simplify_constants_flag=False))


@pytest.fixture(scope="module")
def toy():
    return (_regimes(geconpy_tpu, REF_GCN, ALT_GCN),
            _regimes(geconpy_torch, REF_GCN, ALT_GCN))


@pytest.fixture(scope="module")
def nk():
    return (_regimes(geconpy_tpu, NK_REF, NK_ALT),
            _regimes(geconpy_torch, NK_REF, NK_ALT))


def _both(pair, conds, **kw):
    (rr, ra), (pr, pa) = pair
    want = ref.solve_occbin(rr, ra, **conds, **kw)
    got = port.solve_occbin(pr, pa, **conds, device="cpu", **kw)
    traj = want.trajectory.to_numpy()
    assert got.variables == list(want.trajectory.columns)
    assert got.success == want.success
    assert got.n_iter == want.n_iter
    np.testing.assert_array_equal(got.regime, want.regime)
    np.testing.assert_allclose(got.trajectory.numpy(), traj, rtol=1e-10,
                               atol=1e-10 * np.abs(traj).max())
    return got


def _col(res, var):
    return res.trajectory[:, res.variables.index(var)].numpy()


def test_floor_binds_then_releases(toy):
    res = _both(toy, FLOOR, periods=30,
                shocks={"epsilon_x": np.array([-2.0])})
    assert res.success and res.regime[0] == 1 and not res.regime[1:].any()
    x, xnot = _col(res, "x"), _col(res, "xnot")
    np.testing.assert_allclose(xnot[0], -2.0, atol=1e-6)
    np.testing.assert_allclose(x[0], -0.5, atol=1e-6)
    np.testing.assert_allclose(x[1:6], -0.4 * 0.8 ** np.arange(5), atol=1e-6)


def test_multi_period_spell(toy):
    res = _both(toy, FLOOR, periods=30,
                shocks={"epsilon_x": np.array([-3.0, -0.16])})
    assert res.success and list(res.regime[:3]) == [1, 1, 0]
    np.testing.assert_allclose(_col(res, "x")[:4], [-0.5, -0.5, -0.4, -0.32],
                               atol=1e-6)


def test_no_shock_stays_linear(toy):
    res = _both(toy, FLOOR, periods=10,
                shocks={"epsilon_x": np.array([0.3])})
    assert res.success and not res.regime.any()
    np.testing.assert_allclose(_col(res, "x")[:5], 0.3 * 0.8 ** np.arange(5),
                               atol=1e-6)


def test_initial_state_and_param_override(toy):
    res = _both(toy, FLOOR, periods=10, initial_state={"x": -1.0}, rho=0.6)
    assert res.success and list(res.regime[:2]) == [1, 0]
    np.testing.assert_allclose(_col(res, "x")[:3], [-0.5, -0.3, -0.18],
                               atol=1e-6)


def test_condition_and_input_validation(toy):
    _, (pr, pa) = toy
    with pytest.raises(ValueError, match="must contain one of"):
        port.solve_occbin(pr, pa, bind="xnot[] + 1", relax="xnot[] > -0.5",
                          device="cpu")
    with pytest.raises(ValueError, match="unknown symbols"):
        port.solve_occbin(pr, pa, bind="zzz[] < 0", relax="xnot[] > -0.5",
                          device="cpu")
    with pytest.raises(KeyError, match="unknown shock"):
        port.solve_occbin(pr, pa, **FLOOR, shocks={"eps_zzz": [1.0]},
                          device="cpu")
    with pytest.raises(KeyError, match="unknown parameter"):
        port.solve_occbin(pr, pa, **FLOOR, zzz=1.0, device="cpu")
    with pytest.raises(ValueError, match="must share variables"):
        port.solve_occbin(pr, geconpy_torch.model_from_gcn(
            NK_REF, verbose=False), **FLOOR, device="cpu")


def test_zlb_forward_looking(nk):
    res = _both(nk, ZLB, periods=40,
                shocks={"epsilon_rn": np.array([-0.05])})
    assert res.success and res.regime[0] == 1
    spell = int(res.regime.sum())
    assert res.regime[:spell].all() and not res.regime[spell:].any()
    i, x, inot = _col(res, "i"), _col(res, "x"), _col(res, "inot")
    np.testing.assert_allclose(i[:spell], -0.0101, atol=1e-6)
    assert (inot[:spell] < -0.0101 + 1e-9).all()
    assert (i > -0.0101 - 1e-6).all()
    np.testing.assert_allclose(i[spell:], inot[spell:], atol=1e-6)
    # the unconstrained linear path through the slack regime's policy
    ref_model = nk[1][0]
    sol = ref_model.solve_model(loglin_variables=False, verbose=False,
                                device="cpu")
    eps = torch.zeros(40, ref_model.n_shocks, dtype=torch.float64)
    eps[0, ref_model.shocks.index("epsilon_rn")] = -0.05
    from geconpy_torch.analysis.simulate import simulate_linear

    x_lin = simulate_linear(sol.T, sol.R, eps)[:, ref_model.variables.index(
        "x")].numpy()
    assert x[0] < x_lin[0] - 1e-4
    np.testing.assert_allclose(x[spell + 5:], x_lin[spell + 5:], rtol=0.05,
                               atol=1e-5)


def test_occbin_irf_asymmetry(nk):
    (rr, ra), (pr, pa) = nk
    want = ref.occbin_irf(rr, ra, shock="epsilon_rn", sizes=(0.05, -0.05),
                          periods=40, **ZLB)
    got = port.occbin_irf(pr, pa, shock="epsilon_rn", sizes=(0.05, -0.05),
                          periods=40, device="cpu", **ZLB)
    assert sorted(got) == [-0.05, 0.05]
    for size, res in got.items():
        frame = want.loc[size]
        np.testing.assert_array_equal(res.regime, frame["regime"].to_numpy())
        cols = frame[res.variables].to_numpy()
        np.testing.assert_allclose(res.deviation.numpy(), cols, rtol=1e-10,
                                   atol=1e-10 * np.abs(cols).max())
    j = got[0.05].variables.index("x")
    xp, xn = got[0.05].deviation[:, j], got[-0.05].deviation[:, j]
    assert not got[0.05].regime.any() and got[-0.05].regime[0] == 1
    assert abs(float(xn[0])) > abs(float(xp[0])) * 1.5


def test_nk_sw_zero_lower_bound():
    slack, binding = nk_sw_zlb_sources(geconpy_torch.get_example_gcn("nk_sw"))
    pair = (_regimes(geconpy_tpu, slack, binding, simplify_ref=False),
            _regimes(geconpy_torch, slack, binding, simplify_ref=False))
    res = _both(pair, dict(bind="Rnot[] < 1", relax="Rnot[] > 1"),
                periods=40, shocks={"epsilon_pref": np.array([-0.2])})
    assert res.success and res.regime.sum() >= 2
    assert _col(res, "R").min() >= 1.0 - 1e-12
    assert _col(res, "Rnot").min() < 1.0
