"""The port's front-end: ``geconpy_torch`` needs nothing of the JAX package.

- In a subprocess that runs from a temporary directory holding only a copy
  of ``geconpy_torch/``, with every import of ``jax``, ``geconpy_tpu`` and
  ``pandas`` refused by a ``sys.meta_path`` finder, every module of the
  package imports, and ``geconpy_torch`` builds SW-2007 and configures it
  for the forward sweep (``steady_state``) and the value+grad path
  (``stationary``); the names,
  static/dynamic plan, filter core and static pivot order it reports equal
  the JAX package's.
- An AST scan shows that no file under ``geconpy_torch/``, nor
  ``chip_smoke.py``, imports ``jax``, ``pandas`` or ``geconpy_tpu``, and
  that no code of the package names a path under ``geconpy_tpu``.
- The copied front-end modules are the reference's code (docstrings and
  package names aside), and the bundled models are the reference's files.
"""

import ast
import json
import os
import pathlib
import shutil
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
REFERENCE = ROOT / "geconpy_tpu"
SW_OBS = ["y", "c", "inve", "w", "pinf", "r", "lab"]
SW_ESTIMATED = [
    "crhoa", "crhob", "crhog", "crhoqs", "crhoms", "crhopinf", "crhow",
    "cmap", "cmaw", "cgy", "sigma_ea", "sigma_eb", "sigma_eg", "sigma_eqs",
    "sigma_em", "sigma_epinf", "sigma_ew", "crpi", "crr", "cry", "chabb",
    "csigma"]
COPIED = ([f"lang/{p.name}" for p in sorted((REFERENCE / "lang").glob("*.py"))]
          + [f"symbolic/{p.name}"
             for p in sorted((REFERENCE / "symbolic").glob("*.py"))]
          + [f"models/{m}.py" for m in ("primitives", "block", "special_blocks",
                                         "registry", "simplify", "timing")]
          + ["dists/from_ast.py", "ops/gensys_np.py", "stats/detrend.py",
             "utils/reporting.py"])

_CHILD = f"""
import json, sys

class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "geconpy_tpu", "pandas"):
            raise ImportError(f"{{name}} is refused in this process")

sys.meta_path.insert(0, _Refuse())
import importlib, pkgutil
import torch
torch.set_num_threads(1)
import geconpy_torch
from geconpy_torch.stats.statespace import DSGEStateSpace
modules = sorted(m.name for m in pkgutil.walk_packages(geconpy_torch.__path__,
                                                       "geconpy_torch."))
for name in modules:
    importlib.import_module(name)
model = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn("sw2007"))
constant = [p for p in model.param_names if p not in {SW_ESTIMATED!r}]
report = {{}}
for filter_type in ("steady_state", "stationary"):
    ss = DSGEStateSpace(model, device="cpu").configure(
        observed_states={SW_OBS!r}, filter_type=filter_type,
        kalman_settle=32, constant_params=constant)
    report[filter_type] = {{
        "labels": ss.param_labels, "core": ss._filter_core.tolist(),
        "order": ss._static_pivot_order().tolist()}}
mf = model.functions
plan = model.static_reduction
report.update({{
    "variables": mf.variable_names, "shocks": mf.shock_names,
    "params": mf.param_names,
    "static": plan.static_idx.tolist(), "dynamic": plan.dynamic_idx.tolist(),
    "package": geconpy_torch.__file__, "modules": modules,
    "loaded": sorted(m.split(".")[0] for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "geconpy_tpu",
                                            "pandas")),
}})
print(json.dumps(report))
"""


@pytest.fixture(scope="module")
def child_report(tmp_path_factory):
    work = tmp_path_factory.mktemp("port_alone")
    shutil.copytree(PACKAGE, work / "geconpy_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True,
                          text=True, env=env, cwd=work, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    report["work"] = str(work)
    return report


@pytest.fixture(scope="module")
def reference():
    model = geconpy_tpu.model_from_gcn(geconpy_tpu.get_example_gcn("sw2007"),
                                       verbose=False)
    constant = [p for p in model.param_names if p not in SW_ESTIMATED]
    spaces = {ft: RefStateSpace(model).configure(
        observed_states=SW_OBS, filter_type=ft, kalman_settle=32,
        constant_params=constant) for ft in ("steady_state", "stationary")}
    return model, spaces


def test_port_builds_sw2007_without_jax(child_report):
    assert child_report["loaded"] == []
    assert child_report["package"].startswith(child_report["work"])
    # every module of the package imports there, this slice's among them
    for name in ("stats._optim", "stats.detrend", "stats.moment_matching",
                 "stats.identification", "stats.irf_matching",
                 "stats.dsge_var", "ops.block_tridiag", "ops.gmres",
                 "ops.newton", "analysis.perfect_foresight",
                 "analysis.occbin"):
        assert f"geconpy_torch.{name}" in child_report["modules"]
    for ft in ("steady_state", "stationary"):
        assert len(child_report[ft]["labels"]) == 22


def test_names_and_plan_match_reference(child_report, reference):
    model, spaces = reference
    mf = model.functions
    assert child_report["variables"] == mf.variable_names
    assert child_report["shocks"] == mf.shock_names
    assert child_report["params"] == mf.param_names
    plan = model.static_reduction
    assert child_report["static"] == np.asarray(plan.static_idx).tolist()
    assert child_report["dynamic"] == np.asarray(plan.dynamic_idx).tolist()
    for ft, ss in spaces.items():
        assert child_report[ft]["labels"] == ss.param_labels
        assert child_report[ft]["core"] == np.asarray(ss._filter_core).tolist()


def test_pivot_order_matches_reference(child_report, reference):
    _model, spaces = reference
    for ft, ss in spaces.items():
        assert child_report[ft]["order"] == \
            np.asarray(ss._static_pivot_order()).tolist()


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
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 40
    offenders = {str(p.relative_to(ROOT)):
                 sorted(_imports(p) & {"jax", "jaxlib", "pandas", "geconpy_tpu"})
                 for p in files}
    assert not {k: v for k, v in offenders.items() if v}


def _strip_docstrings(tree: ast.AST) -> ast.AST:
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return tree


def test_no_code_of_the_port_names_the_reference_package():
    """String constants outside docstrings never name ``geconpy_tpu``: the
    port reads no file of the JAX package (its models are in ``data/``)."""
    offenders = []
    for path in sorted(PACKAGE.rglob("*.py")):
        tree = _strip_docstrings(ast.parse(path.read_text()))
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and "geconpy_tpu" in node.value:
                offenders.append(f"{path.relative_to(ROOT)}:{node.lineno}")
    assert not offenders


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_is_the_reference_code(rel):
    """Docstrings and the package name in text aside, each copied module is
    the reference's code (``models/block.py`` with its ``_repr_html_``)."""
    def dump(path):
        tree = _strip_docstrings(ast.parse(path.read_text()))
        return ast.dump(tree).replace("geconpy_tpu", "geconpy_torch")

    port, ref = PACKAGE / rel, REFERENCE / rel
    assert dump(port) == dump(ref)
    assert f"geconpy_tpu/{rel}" in ast.get_docstring(ast.parse(port.read_text()))


def test_from_ast_builds_torch_priors():
    import geconpy_torch
    from geconpy_torch.dists import core, from_ast

    assert from_ast.Distribution is core.Distribution
    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"))
    priors, shocks = from_ast.resolve_priors(model.primitives.priors,
                                             model.primitives.shock_priors)
    assert all(isinstance(p, core.Distribution) for p in priors.values())
    assert isinstance(shocks["epsilon_A"], from_ast.CompositeDistribution)


def test_get_example_gcn_reads_the_reference_data():
    """The port's bundled models are the reference's, read from its own
    ``data/``."""
    import geconpy_torch

    names = sorted(p.stem for p in (REFERENCE / "data").glob("*.gcn"))
    assert names == sorted(p.stem for p in (PACKAGE / "data").glob("*.gcn"))
    assert len(names) == 21
    for name in names:
        assert geconpy_torch.get_example_gcn(name) == \
            geconpy_tpu.get_example_gcn(name)
    with pytest.raises(FileNotFoundError, match="available"):
        geconpy_torch.get_example_gcn("no_such_model")
