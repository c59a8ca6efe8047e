"""Port parity: ``Model.solve_model`` and the rest of the solved-model API.

``geconpy_torch``'s ``Model`` (on the CPU, float64) against
``geconpy_tpu``'s:

- ``model_from_gcn(..., verbose=False)`` works (the reference's
  signature) and ``verbose=True`` logs the model's size;
- the properties (names, sizes, lead indices, timing classes) are equal;
- ``linearize_model`` gives A, B, C, D within 1e-12 with the names;
- the ``backward_var.gcn`` fixture takes the backward solver on its own
  and matches the reference (1e-12), and ``solver="backward"`` on a
  forward-looking model raises the reference's error;
- ``on_failure`` ("error" raises the reference's messages, "ignore"
  returns the failed solution with the same eu code) on ``pert_fails.gcn``,
  and the auto solver's gensys fallback (cycle reduction cut to one
  iteration) picks gensys and logs the reference's message;
- ``check_bk_condition`` gives the reference's eigenvalue table
  (rel 1e-10) and attributes;
- ``PolicySolution``'s repr, its conveniences, its ``summary`` (the
  reference's P/Q/R/S tables at rel 1e-10) and the part not ported yet.
"""

import logging
import os
import pathlib
import re

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest
import torch

import geconpy_torch
import geconpy_tpu

FIXTURES = pathlib.Path(__file__).parent / "_gcn_fixtures"


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(source):
    return (geconpy_tpu.model_from_gcn(source, verbose=False),
            geconpy_torch.model_from_gcn(source, verbose=False))


@pytest.fixture(scope="module")
def rbc():
    return _both(geconpy_tpu.get_example_gcn("rbc"))


@pytest.fixture(scope="module")
def nk():
    return _both(geconpy_tpu.get_example_gcn("nk_3eq"))


def test_model_from_gcn_takes_verbose(caplog):
    import inspect

    ref = inspect.signature(geconpy_tpu.model_from_gcn).parameters
    port = inspect.signature(geconpy_torch.model_from_gcn).parameters
    assert list(port) == list(ref)
    assert port["verbose"].default is True
    src = geconpy_torch.get_example_gcn("rbc")
    with caplog.at_level(logging.INFO, logger="geconpy_torch.models.model"):
        quiet = geconpy_torch.model_from_gcn(src, verbose=False)
        assert not caplog.records
        loud = geconpy_torch.model_from_gcn(src)
    assert "Model compiled" in caplog.text
    assert quiet.variables == loud.variables


def test_model_properties_match_reference(nk):
    ref, port = nk
    assert port.variables == ref.variables
    assert port.shocks == ref.shocks
    assert (port.n_variables, port.n_shocks) == (ref.n_variables, ref.n_shocks)
    np.testing.assert_array_equal(port.lead_var_idx, ref.lead_var_idx)
    assert port.is_backward_looking == ref.is_backward_looking is False
    assert port.variable_timing == ref.variable_timing


def test_linearize_model_matches_reference(rbc):
    ref, port = rbc
    r = ref.linearize_model(beta=0.985)
    p = port.linearize_model(beta=0.985, device="cpu")
    assert p["variables"] == list(r["A"].columns)
    assert p["shocks"] == list(r["D"].columns)
    for k in "ABCD":
        assert p[k].dtype == torch.float64 and p[k].device.type == "cpu"
        np.testing.assert_allclose(p[k].numpy(), r[k].to_numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_backward_model_takes_the_backward_solver():
    ref, port = _both(FIXTURES / "backward_var.gcn")
    assert port.is_backward_looking and ref.is_backward_looking
    sol = port.solve_model(verbose=False, device="cpu")
    r = ref.solve_model(verbose=False)
    assert sol.success and sol.solver == "backward" == r.solver
    assert sol.eu is None
    x, z, w = (sol.variables.index(v) for v in "xzw")
    assert float(sol.T[x, x]) == pytest.approx(0.8, abs=1e-12)
    assert float(sol.T[w, z]) == pytest.approx(0.5 * 2.0 + 0.1, abs=1e-12)
    np.testing.assert_allclose(sol.T.numpy(), r.T.to_numpy(), atol=1e-12)
    np.testing.assert_allclose(sol.R.numpy(), r.R.to_numpy(), atol=1e-12)
    explicit = port.solve_model(solver="backward", verbose=False, device="cpu")
    assert torch.equal(explicit.T, sol.T)


def test_solver_argument_errors_match_reference(rbc):
    ref, port = rbc
    for kw in (dict(solver="backward"), dict(solver="qz")):
        with pytest.raises(ValueError) as ref_err:
            ref.solve_model(verbose=False, **kw)
        with pytest.raises(ValueError) as port_err:
            port.solve_model(verbose=False, device="cpu", **kw)
        assert str(port_err.value) == str(ref_err.value)


def test_on_failure_matches_reference():
    ref, port = _both(FIXTURES / "pert_fails.gcn")
    r = ref.solve_model(solver="gensys", on_failure="ignore", verbose=False)
    p = port.solve_model(solver="gensys", on_failure="ignore", verbose=False,
                         device="cpu")
    assert not p.success and not r.success
    assert p.eu == r.eu
    with pytest.raises(RuntimeError) as ref_err:
        ref.solve_model(solver="gensys", verbose=False)
    with pytest.raises(RuntimeError) as port_err:
        port.solve_model(solver="gensys", verbose=False, device="cpu")
    assert str(port_err.value) == str(ref_err.value)
    assert "policy solution failed (solver=gensys" in str(port_err.value)
    host = port.solve_model(solver="gensys_host", on_failure="ignore",
                            verbose=False, device="cpu")
    r_host = ref.solve_model(solver="gensys_host", on_failure="ignore",
                             verbose=False)
    assert not host.success and host.eu == r_host.eu


def test_auto_falls_back_to_gensys_as_the_reference(nk, caplog):
    """Cycle reduction cut to one iteration fails; the auto solver then
    takes gensys, says so, and returns gensys's solution."""
    ref, port = nk
    r = ref.solve_model(maxiter=1, verbose=False)
    with caplog.at_level(logging.INFO, logger="geconpy_torch.models.model"):
        p = port.solve_model(maxiter=1, device="cpu")
    assert (p.solver, p.eu, p.success) == (r.solver, r.eu, r.success) \
        == ("gensys", (1, 1), True)
    assert "cycle reduction failed; gensys fallback succeeded" in caplog.text
    gs = port.solve_model(solver="gensys", verbose=False, device="cpu")
    assert torch.equal(p.T, gs.T) and torch.equal(p.R, gs.R)
    np.testing.assert_allclose(p.T.numpy(), r.T.to_numpy(), atol=1e-10)
    with pytest.raises(RuntimeError, match="solver=cycle_reduction"):
        port.solve_model(solver="cycle_reduction", maxiter=1, verbose=False,
                         device="cpu")


@pytest.mark.parametrize("name", ["rbc", "pert_fails"])
def test_check_bk_condition_matches_reference(name):
    src = geconpy_tpu.get_example_gcn(name) if name == "rbc" \
        else FIXTURES / f"{name}.gcn"
    ref, port = _both(src)
    r = ref.check_bk_condition(verbose=False)
    p = port.check_bk_condition(verbose=False, device="cpu")
    for key in ("bk_satisfied", "n_unstable", "n_forward"):
        assert p[key] == r.attrs[key], key
    assert p["bk_satisfied"] == (name == "rbc")
    finite = np.isfinite(r["modulus"].to_numpy())
    np.testing.assert_array_equal(np.isfinite(p["modulus"]), finite)
    for col in ("real", "imag", "modulus"):
        got, want = p[col][finite], r[col].to_numpy()[finite]
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_policy_solution_repr_and_unported_parts(rbc):
    ref, port = rbc
    p = port.solve_model(solver="gensys", verbose=False, device="cpu")
    r = ref.solve_model(solver="gensys", verbose=False)
    # the same format; the norms agree to rounding, not to the printed digits
    norms = lambda text: re.sub(r"norm=[^,]+", "norm=*", text)  # noqa: E731
    assert norms(repr(p)) == norms(repr(r))
    assert "det_norm=" in repr(p) and "eu=(1, 1)" in repr(p)
    assert isinstance(p.T, torch.Tensor) and p.T.shape == (9, 9)
    assert p.steady_state.success
    assert set(map(str, p.steady_state)) == set(map(str, r.steady_state))
    # the P/Q/R/S tables against the reference's frame
    tables, want = p.summary(), r.summary()
    assert (tables.states, tables.jumps) == (want.attrs["states"],
                                             want.attrs["jumps"])
    for block, rows, cols in (("P", tables.states, tables.states),
                              ("Q", tables.states, tables.shocks),
                              ("R", tables.jumps, tables.states),
                              ("S", tables.jumps, tables.shocks)):
        np.testing.assert_allclose(getattr(tables, block).numpy(),
                                   want.loc[block].loc[rows, cols].to_numpy(),
                                   rtol=1e-10, atol=1e-14, err_msg=block)
    # the second-order blocks on p's device beside the first-order solution
    sol2, res2 = port.solve_model_second_order(solution=p, shock_std=0.01)
    assert sol2 is p and bool(res2.success)
    assert res2.G_xx.shape == (9, 9, 9) and res2.G_xu.shape == (9, 9, 1)
    assert res2.G_uu.shape == (9, 1, 1) and res2.g_ss.shape == (9,)
    irf = p.impulse_responses(periods=5)
    assert irf.values.shape == (1, 5, 9) and irf.shocks == p.shocks
    sims = p.simulate(periods=6, n_simulations=2)
    assert sims.values.shape == (2, 6, 9)
    Sigma = p.stationary_covariance()
    assert Sigma.values.shape == (9, 9) and Sigma.variables == p.variables
    acf = p.autocorrelation(n_lags=3)
    assert acf.values.shape == (3, 9, 9)


def test_solve_model_defaults_to_the_gpu(rbc):
    """Without ``device`` the solve is put on the GPU: with none present it
    raises, and never carries on on the CPU."""
    _ref, port = rbc
    if torch.cuda.is_available():
        assert port.solve_model(verbose=False).T.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            port.solve_model(verbose=False)
