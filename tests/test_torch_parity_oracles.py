"""The external oracles of the port: its policy matrices against real
Dynare output and gEcon-R's golden P/Q/R/S blocks.

Port twins of ``tests/parity/test_dynare_parity.py`` and
``tests/parity/test_gecon_r_parity.py``, at their own tolerances: Dynare's
T and R at atol = rtol = 1e-5 for every solver of
``Model.solve_model``; gEcon-R's P and Q at atol 2e-7 / rtol 1e-6, R and S
at 2e-6 / 1e-5, through the port's
``models/perturbation.py::gecon_matrices``.  They read the in-repo
``tests/parity/fixtures/`` and ``tests/parity/gcn/``; the port solves on
the CPU in float64.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import geconpy_torch
from geconpy_torch.models.perturbation import gecon_matrices
from parity.fixtures.gecon_r_golden import RBC_2_BLOCK_SS_GOLDEN
from parity.load_dynare import load_dynare_policy

GCN_DIR = Path(__file__).parent / "parity" / "gcn"

# (dynare fixture name, gcn path or source, loglin)
CASES = [
    ("one_block_1_ss", GCN_DIR / "one_block_1_ss.gcn", False),
    ("rbc_2_block_ss", GCN_DIR / "rbc_2_block_ss.gcn", False),
    ("basic_rbc", geconpy_torch.get_example_gcn("rbc"), False),
    ("basic_rbc_loglinear", geconpy_torch.get_example_gcn("rbc"), True),
    ("full_nk", GCN_DIR / "full_nk_calvo.gcn", False),
]

_MODEL_CACHE: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(gcn):
    key = str(gcn)
    if key not in _MODEL_CACHE:
        _MODEL_CACHE[key] = geconpy_torch.model_from_gcn(gcn, verbose=False)
    return _MODEL_CACHE[key]


def _solve(gcn, loglin, solver):
    return _model(gcn).solve_model(solver=solver, loglin_variables=loglin,
                                   verbose=False, device="cpu")


def _reindex(mat: torch.Tensor, rows, cols, want_rows, want_cols):
    r = [list(rows).index(x) for x in want_rows]
    c = [list(cols).index(x) for x in want_cols]
    return mat.cpu().numpy()[np.ix_(r, c)]


@pytest.mark.parametrize("solver", ["cycle_reduction", "gensys", "gensys_host"])
@pytest.mark.parametrize(
    "dynare_name,gcn,loglin", CASES, ids=[c[0] for c in CASES])
def test_policy_matches_dynare(dynare_name, gcn, loglin, solver):
    dyn = load_dynare_policy(dynare_name)
    dynare_T, dynare_R = dyn["T"], dyn["R"]

    sol = _solve(gcn, loglin, solver)
    assert sol.success

    missing = set(dynare_T.index) - set(sol.variables)
    assert not missing, f"model lacks Dynare variables: {sorted(missing)}"

    T = _reindex(sol.T, sol.variables, sol.variables, dynare_T.index,
                 dynare_T.columns)
    R = _reindex(sol.R, sol.variables, sol.shocks, dynare_R.index,
                 dynare_R.columns)
    assert_allclose(T, dynare_T.to_numpy(), atol=1e-5, rtol=1e-5,
                    err_msg=f"{dynare_name} T vs Dynare ({solver})")
    assert_allclose(R, dynare_R.to_numpy(), atol=1e-5, rtol=1e-5,
                    err_msg=f"{dynare_name} R vs Dynare ({solver})")


def test_non_state_columns_are_zero():
    """Columns of T outside the Dynare state set are (numerically) zero."""
    dyn = load_dynare_policy("rbc_2_block_ss")
    sol = _solve(GCN_DIR / "rbc_2_block_ss.gcn", False, "cycle_reduction")
    states = set(dyn["T"].columns)
    non_state = [c for c in sol.variables if c not in states]
    block = _reindex(sol.T, sol.variables, sol.variables, dyn["T"].index,
                     non_state)
    assert np.max(np.abs(block)) < 1e-8


def _natural_order(names):
    import re

    def key(s):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]

    return sorted(range(len(names)), key=lambda i: key(names[i]))


def _solve_in_gecon_convention(gcn_path):
    """T and R rescaled from the port's log-linear convention (negative
    steady states stay in levels) to gEcon's |ss| scaling, in gEcon's
    natural variable order, as the reference test does."""
    sol = _solve(gcn_path, True, "cycle_reduction")
    names = list(sol.variables)
    ss_vals = np.array([float(v) for v in sol.steady_state.values()])
    scale_ours = sol.loglin_scale.cpu().numpy()
    conv = scale_ours / np.abs(ss_vals)
    T = np.diag(conv) @ sol.T.cpu().numpy() @ np.diag(1.0 / conv)
    R = np.diag(conv) @ sol.R.cpu().numpy()
    order = _natural_order(names)
    return (T[np.ix_(order, order)], R[order, :], [names[i] for i in order],
            ss_vals[order])


def test_policy_blocks_match_gecon_r():
    golden = RBC_2_BLOCK_SS_GOLDEN
    T, R, names, ss_vals = _solve_in_gecon_convention(
        GCN_DIR / "rbc_2_block_ss.gcn")
    P, Q, R_out, S, state_idx, jump_idx = gecon_matrices(T, R, names)

    gP, gQ, gR, gS = (np.asarray(golden[k], dtype=float) for k in "PQRS")
    assert P.shape == gP.shape, (
        f"state partition differs: {P.shape} vs golden {gP.shape} "
        f"(states: {[names[i] for i in state_idx]})")
    assert_allclose(P, gP, atol=2e-7, rtol=1e-6, err_msg="P vs gEcon-R")
    assert_allclose(Q, gQ, atol=2e-7, rtol=1e-6, err_msg="Q vs gEcon-R")
    # the goldens' negative-steady-state jumper rows carry a sign flip
    flip = np.where(ss_vals[jump_idx] < 0, -1.0, 1.0)[:, None]
    assert_allclose(R_out * flip, gR, atol=2e-6, rtol=1e-5,
                    err_msg="R vs gEcon-R")
    assert_allclose(S * flip, gS, atol=2e-6, rtol=1e-5, err_msg="S vs gEcon-R")
