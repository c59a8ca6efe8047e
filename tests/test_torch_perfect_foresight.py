"""Port parity: perfect foresight (``geconpy_torch/analysis/
perfect_foresight.py`` against ``geconpy_tpu/analysis/perfect_foresight.py``).

The reference's tests (``tests/analysis/test_perfect_foresight.py``) run on
both packages with the same arguments: ``rbc`` (a temporary shock, a small
shock against the linear IRF, a permanent change through
``terminal_params``, a ``param_paths`` run, ``direction="krylov"``
against ``"direct"``) and ``brock_mirman`` against its closed form (a
shock path and an anticipated shock).  Each port trajectory is within
1e-10 of the reference's (relative to its largest entry), with the same
``success`` and ``n_iter`` and a residual norm within 1e-12 (rounding
noise under the tolerance); then the reference test's own checks run on
the port's result.  ``nk_sw`` (21 variables, nonlinear) takes the four
kinds of run of the chip's check at 60 periods; the 512-period Krylov run
is the port's alone.  CPU, float64, one thread.
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
from geconpy_torch.analysis.perfect_foresight import \
    solve_perfect_foresight as port
from geconpy_tpu.analysis.perfect_foresight import \
    solve_perfect_foresight as ref


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_MODELS: dict = {}


def _models(name):
    if name not in _MODELS:
        _MODELS[name] = (
            geconpy_tpu.model_from_gcn(geconpy_tpu.get_example_gcn(name),
                                       verbose=False),
            geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn(name),
                                         verbose=False))
    return _MODELS[name]


def _both(name, **kw):
    ref_model, port_model = _models(name)
    want = ref(ref_model, **kw)
    got = port(port_model, device="cpu", **kw)
    traj = want.trajectory.to_numpy()
    assert got.trajectory.shape == traj.shape
    assert got.variables == list(want.trajectory.columns)
    assert got.time == list(want.trajectory.index)
    assert got.success == want.success
    assert got.n_iter == want.n_iter
    assert abs(got.resid_norm - want.resid_norm) < 1e-12
    np.testing.assert_allclose(got.trajectory.numpy(), traj, rtol=1e-10,
                               atol=1e-10 * np.abs(traj).max())
    return got


def _at(res, t, var):
    return float(res.trajectory[res.time.index(t), res.variables.index(var)])


def _ss(name, **updates):
    return _models(name)[1].steady_state(verbose=False, device="cpu",
                                         **updates).to_string()


def test_temporary_shock_trajectory():
    shock = np.zeros(5)
    shock[0] = 0.05
    res = _both("rbc", periods=120, shocks={"epsilon_A": shock})
    assert res.success and res.resid_norm < 1e-8
    ss = _ss("rbc")
    np.testing.assert_allclose(_at(res, -1, "Y"), ss["Y_ss"], rtol=1e-8)
    assert _at(res, 0, "A") > 1.0 and _at(res, 0, "Y") > ss["Y_ss"]
    np.testing.assert_allclose(_at(res, 120, "Y"), ss["Y_ss"], rtol=1e-8)
    assert abs(_at(res, 100, "Y") - ss["Y_ss"]) \
        < 0.25 * abs(_at(res, 0, "Y") - ss["Y_ss"])


def test_small_shock_matches_linear_irf():
    size = 1e-4
    res = _both("rbc", periods=80, shocks={"epsilon_A": np.array([size])})
    model = _models("rbc")[1]
    irf = geconpy_torch.impulse_response_function(
        model.solve_model(verbose=False, device="cpu"), periods=20,
        shock_size=size)
    ss = _ss("rbc")
    j = irf.variables.index("Y")
    for t in range(10):
        np.testing.assert_allclose(np.log(_at(res, t, "Y") / ss["Y_ss"]),
                                   float(irf.values[0, t, j]), rtol=2e-2,
                                   atol=1e-9)


@pytest.mark.parametrize("guess", ["linear", "initial"])
def test_permanent_shock(guess):
    res = _both("rbc", periods=300, terminal_params={"delta": 0.025},
                initial_guess=guess)
    assert res.success
    ss_new, ss_old = _ss("rbc", delta=0.025), _ss("rbc")
    np.testing.assert_allclose(_at(res, 300, "K"), ss_new["K_ss"], rtol=1e-8)
    np.testing.assert_allclose(_at(res, 280, "K"), ss_new["K_ss"], rtol=1e-3)
    assert ss_new["K_ss"] < ss_old["K_ss"] and _at(res, 5, "K") < ss_old["K_ss"]


def test_time_varying_parameter_path():
    res = _both("rbc", periods=200, param_paths={"delta": np.concatenate(
        [np.full(20, 0.015), np.full(180, 0.02)])})
    assert res.success
    ss = _ss("rbc")
    assert _at(res, 10, "K") > ss["K_ss"]
    np.testing.assert_allclose(_at(res, 200, "K"), ss["K_ss"], rtol=1e-8)


def _bm_closed_form(eps_path, periods, alpha=0.33, beta=0.96, rho=0.9):
    K = (alpha * beta) ** (1 / (1 - alpha))
    logA, rows = 0.0, []
    for t in range(periods):
        logA = rho * logA + (eps_path[t] if t < len(eps_path) else 0.0)
        A = np.exp(logA)
        Y = A * K ** alpha
        K = alpha * beta * Y
        rows.append((A, Y, K, (1 - alpha * beta) * Y))
    return np.array(rows)


@pytest.mark.parametrize("news", [False, True])
def test_brock_mirman_closed_form(news):
    if news:
        eps = np.zeros(8)
        eps[5] = 0.08
    else:
        eps = np.array([0.1, 0.0, -0.05])
    periods = 100 if news else 120
    res = _both("brock_mirman", periods=periods, shocks={"epsilon": eps})
    assert res.success
    closed = _bm_closed_form(eps, periods)
    traj = res.trajectory[1:-1].numpy()
    atol = 1e-6 if news else 1e-7
    for c, var in enumerate(["A", "Y", "K", "C"]):
        np.testing.assert_allclose(traj[:, res.variables.index(var)],
                                   closed[:, c], atol=atol)
    if news:
        K_ss = (0.33 * 0.96) ** (1 / (1 - 0.33))
        np.testing.assert_allclose(traj[:5, res.variables.index("K")], K_ss,
                                   atol=1e-8)


def test_krylov_direction_matches_direct():
    shocks = {"epsilon_A": np.array([0.02])}
    direct = _both("rbc", periods=80, shocks=shocks)
    krylov = _both("rbc", periods=80, shocks=shocks, direction="krylov")
    assert direct.success and krylov.success
    np.testing.assert_allclose(krylov.trajectory.numpy(),
                               direct.trajectory.numpy(), rtol=1e-6,
                               atol=1e-8)


def test_krylov_direction_long_horizon():
    model = _models("rbc")[1]
    res = port(model, periods=512, shocks={"epsilon_A": np.array([0.02])},
               direction="krylov", device="cpu")
    assert res.success
    np.testing.assert_allclose(_at(res, 512, "K"), _ss("rbc")["K_ss"],
                               rtol=1e-6)


@pytest.mark.parametrize("run", ["direct", "krylov", "terminal", "path"])
def test_nk_sw_runs(run):
    """The four runs of the chip's check, on the nonlinear nk_sw."""
    periods = 60
    kw = {"direct": dict(shocks={"epsilon_pref": np.array([0.05])}),
          "krylov": dict(shocks={"epsilon_pref": np.array([0.05])},
                         direction="krylov"),
          "terminal": dict(terminal_params={"g_y": 0.22},
                           initial_guess="linear"),
          "path": dict(param_paths={"beta": np.concatenate(
              [np.full(20, 0.995), np.full(periods - 20, 0.99)])})}[run]
    res = _both("nk_sw", periods=periods, **kw)
    assert res.success and res.n_iter >= 1
    assert bool(torch.isfinite(res.trajectory).all())


def test_input_checks():
    model = _models("rbc")[1]
    with pytest.raises(KeyError, match="unknown shock"):
        port(model, periods=10, shocks={"epsilon_zzz": [0.1]}, device="cpu")
    with pytest.raises(KeyError, match="param_paths"):
        port(model, periods=10, param_paths={"zzz": [0.1]}, device="cpu")
