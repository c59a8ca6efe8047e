"""Port parity: IRF-matching estimation (``geconpy_torch/stats/
irf_matching.py`` against ``geconpy_tpu/stats/irf_matching.py``).

The reference's tests (``tests/stats/test_irf_matching.py``) on ``rbc``:

- ``build_irf_fn``: the port's IRFs (one draw and a batch of two) within
  1e-10 of the reference's, and so are those of the search's one solve
  for several shocks (``nk_3eq``'s two, at 10 and 25 periods);
- targets made by the model at alpha = 0.33, rho_A = 0.88 (Y, C, K, L; 30
  horizons), fit from alpha = 0.40, rho_A = 0.80 with ``ADAM_STEPS`` Adam
  steps (of 400, on both sides) and 6 Gauss-Newton steps: estimates within
  rel 1e-8, standard errors within rel 1e-8, the loss (machine zero)
  within 1e-20, ``fitted`` within 1e-10 of the reference's frame in its
  row order, ``n_obs`` and ``success`` equal; the truth recovered;
- a target with NaN horizons 5-10 and weights 1e4 (``IRFTarget`` weights):
  the same bars, 14 entries matched, SE < 1e-2;
- the reference's input errors.
The reference's ``{shock: DataFrame}`` becomes ``{shock: IRFTarget}``.
CPU, float64, one thread.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pandas as pd
import pytest
import torch

import geconpy_torch
import geconpy_tpu
from geconpy_torch.stats import irf_matching as port
from geconpy_tpu.stats import irf_matching as ref

ADAM_STEPS = 100
VARS = ["Y", "C", "K", "L"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    return (geconpy_tpu.model_from_gcn(geconpy_tpu.get_example_gcn("rbc"),
                                       verbose=False),
            geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn("rbc"),
                                         verbose=False))


def _target(port_model, variables, periods, **params):
    path, ok = port.build_irf_fn(port_model, "epsilon_A", periods=periods)(
        port_model.default_theta(**params))
    assert bool(ok)
    idx = [port_model.variables.index(v) for v in variables]
    return path[:, idx].numpy()


def _check(want, got, estimated):
    assert got.success == want.success
    assert got.n_obs == want.n_obs
    for name in estimated:
        np.testing.assert_allclose(got.params[name], want.params[name],
                                   rtol=1e-8)
        np.testing.assert_allclose(got.std_errors[name],
                                   want.std_errors[name], rtol=1e-8)
    np.testing.assert_allclose(got.loss, want.loss, rtol=1e-8, atol=1e-20)
    assert got.fitted_labels == list(want.fitted.index)
    np.testing.assert_allclose(got.fitted.numpy(), want.fitted.to_numpy(),
                               rtol=1e-10, atol=1e-12)


def test_build_irf_fn_matches_reference(models):
    ref_model, port_model = models
    theta = port_model.default_theta(alpha=0.31, rho_A=0.9)
    for shock in ref_model.shocks:
        want, ok_r = jax.jit(ref.build_irf_fn(ref_model, shock, periods=25))(
            theta.numpy())
        fn = port.build_irf_fn(port_model, shock, periods=25)
        got, ok_p = fn(theta)
        assert bool(ok_p) == bool(ok_r)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                                   atol=1e-14)
        batch, ok_b = fn(torch.stack([theta, theta * 1.01]))
        assert batch.shape == (2, 25, port_model.n_variables)
        assert bool(ok_b.all())
        np.testing.assert_allclose(batch[0].numpy(), got.numpy(), rtol=1e-12,
                                   atol=1e-16)


def test_one_solve_for_several_shocks():
    """The search's shared solve gives every shock of ``nk_3eq`` (periods
    10 and 25) the reference's ``build_irf_fn`` path and flag."""
    ref_model = geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn("nk_3eq"), verbose=False)
    port_model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("nk_3eq"), verbose=False)
    periods = dict(zip(port_model.shocks, (10, 25)))
    assert len(periods) == 2
    theta = port_model.default_theta()
    got = port._irf_fn(port_model, periods, 0.5)(theta)
    for shock, n in periods.items():
        want, ok = jax.jit(ref.build_irf_fn(ref_model, shock, periods=n,
                                            shock_size=0.5))(theta.numpy())
        assert got[shock][0].shape == (n, port_model.n_variables)
        assert bool(got[shock][1]) == bool(ok)
        np.testing.assert_allclose(got[shock][0].numpy(), np.asarray(want),
                                   rtol=1e-10, atol=1e-14)


def test_recovers_generating_parameters(models):
    ref_model, port_model = models
    periods, true = 30, {"alpha": 0.33, "rho_A": 0.88}
    values = _target(port_model, VARS, periods, **true)
    kw = dict(estimated=["alpha", "rho_A"], x0={"alpha": 0.40, "rho_A": 0.80},
              adam_steps=ADAM_STEPS)
    want = ref.fit_irf_matching(
        ref_model, {"epsilon_A": pd.DataFrame(values, columns=VARS)}, **kw)
    got = port.fit_irf_matching(
        port_model, {"epsilon_A": port.IRFTarget(values, VARS)},
        device="cpu", **kw)
    _check(want, got, kw["estimated"])
    assert got.success and got.loss < 1e-12
    for name, v in true.items():
        assert abs(got.params[name] - v) < 1e-5
    assert got.n_obs == 4 * periods
    np.testing.assert_allclose(got.fitted[:, 0].numpy(),
                               got.fitted[:, 1].numpy(), atol=1e-8)


def test_nan_entries_skipped_and_weights(models):
    ref_model, port_model = models
    values = _target(port_model, ["Y"], 20, rho_A=0.9)
    values[5:11] = np.nan
    weights = np.full((20, 1), 1e4)
    kw = dict(estimated=["rho_A"], x0={"rho_A": 0.7}, adam_steps=ADAM_STEPS)
    want = ref.fit_irf_matching(
        ref_model, {"epsilon_A": pd.DataFrame(values, columns=["Y"])},
        weights={"epsilon_A": pd.DataFrame(weights, columns=["Y"])}, **kw)
    got = port.fit_irf_matching(
        port_model, {"epsilon_A": port.IRFTarget(values, ["Y"])},
        weights={"epsilon_A": port.IRFTarget(weights, ["Y"])}, device="cpu",
        **kw)
    _check(want, got, kw["estimated"])
    assert got.n_obs == 20 - 6
    assert abs(got.params["rho_A"] - 0.9) < 1e-5
    assert got.std_errors["rho_A"] < 1e-2


def test_input_validation(models):
    _, model = models
    tgt = port.IRFTarget(np.zeros((5, 1)), ["Y"])
    with pytest.raises(KeyError, match="not a free parameter"):
        port.fit_irf_matching(model, {"epsilon_A": tgt}, estimated=["nope"],
                              device="cpu")
    with pytest.raises(KeyError, match="not a model variable"):
        port.fit_irf_matching(
            model, {"epsilon_A": port.IRFTarget(np.zeros((5, 1)), ["zzz"])},
            estimated=["alpha"], device="cpu")
    with pytest.raises(KeyError, match="unknown shock"):
        port.build_irf_fn(model, "epsilon_zzz")
    with pytest.raises(ValueError, match="no finite entries"):
        port.fit_irf_matching(
            model, {"epsilon_A": port.IRFTarget(np.zeros((5, 0)), [])},
            estimated=["alpha"], device="cpu")
