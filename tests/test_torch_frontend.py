"""The port's front-end: ``geconpy_torch`` runs without JAX.

- In a subprocess where ``sys.modules["jax"] = None`` (so any import of JAX
  fails), ``import geconpy_torch`` builds SW-2007 and configures it as the
  benchmark's forward sweep does; the names, static/dynamic plan, filter
  core and static pivot order it reports equal the JAX package's.
- An AST scan shows that no file under ``geconpy_torch/`` imports ``jax``
  or ``pandas``.
- The front-end alias maps ``dists/from_ast.py`` onto the port's priors.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

import geconpy_tpu
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "geconpy_torch"
SW_OBS = ["y", "c", "inve", "w", "pinf", "r", "lab"]
SW_ESTIMATED = [
    "crhoa", "crhob", "crhog", "crhoqs", "crhoms", "crhopinf", "crhow",
    "cmap", "cmaw", "cgy", "sigma_ea", "sigma_eb", "sigma_eg", "sigma_eqs",
    "sigma_em", "sigma_epinf", "sigma_ew", "crpi", "crr", "cry", "chabb",
    "csigma"]

_CHILD = f"""
import json, sys
sys.modules["jax"] = None          # any JAX import now raises ImportError
sys.modules["pandas"] = None
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(1)
import geconpy_torch
from geconpy_torch.stats.statespace import DSGEStateSpace
model = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn("sw2007"))
ss = DSGEStateSpace(model).configure(
    observed_states={SW_OBS!r}, filter_type="steady_state", kalman_settle=32,
    constant_params=[p for p in model.param_names if p not in {SW_ESTIMATED!r}])
mf = model.functions
plan = model.static_reduction
print(json.dumps({{
    "variables": mf.variable_names, "shocks": mf.shock_names,
    "params": mf.param_names, "labels": ss.param_labels,
    "static": plan.static_idx.tolist(), "dynamic": plan.dynamic_idx.tolist(),
    "core": ss._filter_core.tolist(),
    "order": ss._static_pivot_order().tolist(),
    "jax_loaded": [m for m in sys.modules if m == "jax" or m.startswith("jax.")
                   if sys.modules[m] is not None],
}}))
"""


@pytest.fixture(scope="module")
def child_report():
    env = dict(os.environ)
    proc = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def reference():
    model = geconpy_tpu.model_from_gcn(geconpy_tpu.get_example_gcn("sw2007"),
                                       verbose=False)
    ss = RefStateSpace(model).configure(
        observed_states=SW_OBS, filter_type="steady_state", kalman_settle=32,
        constant_params=[p for p in model.param_names if p not in SW_ESTIMATED])
    return model, ss


def test_port_builds_sw2007_without_jax(child_report):
    assert child_report["jax_loaded"] == []
    assert len(child_report["labels"]) == 22


def test_names_and_plan_match_reference(child_report, reference):
    model, ss = reference
    mf = model.functions
    assert child_report["variables"] == mf.variable_names
    assert child_report["shocks"] == mf.shock_names
    assert child_report["params"] == mf.param_names
    assert child_report["labels"] == ss.param_labels
    plan = model.static_reduction
    assert child_report["static"] == np.asarray(plan.static_idx).tolist()
    assert child_report["dynamic"] == np.asarray(plan.dynamic_idx).tolist()
    assert child_report["core"] == np.asarray(ss._filter_core).tolist()


def test_pivot_order_matches_reference(child_report, reference):
    _model, ss = reference
    assert child_report["order"] == np.asarray(ss._static_pivot_order()).tolist()


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_port_imports_jax_or_pandas():
    files = sorted(PACKAGE.rglob("*.py"))
    assert len(files) >= 15
    offenders = {str(p.relative_to(ROOT)): sorted(_imports(p) & {"jax", "pandas"})
                 for p in files}
    assert not {k: v for k, v in offenders.items() if v}


def test_from_ast_builds_torch_priors():
    import geconpy_torch
    from geconpy_torch._frontend import frontend
    from geconpy_torch.dists import core

    fe = frontend()
    assert fe.from_ast.Distribution is core.Distribution
    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"))
    priors, shocks = fe.from_ast.resolve_priors(model.primitives.priors,
                                                model.primitives.shock_priors)
    assert all(isinstance(p, core.Distribution) for p in priors.values())
    assert isinstance(shocks["epsilon_A"], fe.from_ast.CompositeDistribution)


def test_get_example_gcn_reads_the_reference_data():
    import geconpy_torch

    assert geconpy_torch.get_example_gcn("rbc") == geconpy_tpu.get_example_gcn("rbc")
    with pytest.raises(FileNotFoundError, match="available"):
        geconpy_torch.get_example_gcn("no_such_model")
