"""The port's public surface against the reference's.

In the style of ``tests/test_public_api.py``: the 25 user-facing names the
reference exports from ``gEconpy`` are present in ``geconpy_torch`` and
in its ``__all__``.  Beyond them:

- every module of ``geconpy_tpu`` has its counterpart in ``geconpy_torch``
  (the four ``ops/pallas_*.py`` files aside, whose kernels are in
  ``geconpy_torch/csrc``), and every name a reference module lists in
  ``__all__`` is defined by its counterpart, apart from the JAX-only
  names: ``lower_to_jax`` (the port's is ``lower_to_torch``),
  ``make_batched_logp_grad`` (JAX's ``vmap`` of a single-draw gradient)
  and ``compiled_memory_summary`` (it reads an XLA executable);
- the reference's keywords of the entry points that take a mesh, a
  compile cache or a filter start are keywords of the port's;
- the names this port adds at the top level work.
"""

import ast
import inspect
import pathlib

import pytest
import torch

import geconpy_torch as gt

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "geconpy_tpu"

REFERENCE_NAMES = [
    # gEconpy/__init__.py __all__, minus pytensor-specific internals
    "autocorrelation_matrix", "autocovariance_matrix", "bounds_from_priors",
    "build_Q_matrix", "check_bk_condition", "check_steady_state",
    "data_from_prior", "impulse_response_function", "make_mod_file",
    "matrix_to_dataframe", "model_from_gcn", "prepare_mixed_frequency_data",
    "print_gcn_file", "print_steady_state", "prior_solvability_check",
    "sample_from_priors", "sample_from_priors_qmc", "sample_uniform",
    "sample_uniform_from_priors", "simulate", "solvability_check",
    "solve_perfect_foresight", "statespace_from_gcn",
    "stationary_covariance_matrix", "summarize_perturbation_solution",
]

JAX_ONLY = {("codegen", "lower_to_jax"), ("codegen.lower", "lower_to_jax"),
            ("stats.estimation", "make_batched_logp_grad"),
            ("utils.memory", "compiled_memory_summary")}


def test_reference_names_all_present():
    assert len(REFERENCE_NAMES) == 25
    missing = [n for n in REFERENCE_NAMES if not hasattr(gt, n)]
    assert not missing, f"missing reference API names: {missing}"
    not_exported = [n for n in REFERENCE_NAMES if n not in gt.__all__]
    assert not_exported == [], f"present but not in __all__: {not_exported}"


def _reference_modules():
    for path in sorted(REFERENCE.rglob("*.py")):
        rel = path.relative_to(REFERENCE)
        if not rel.name.startswith("pallas_"):
            yield rel


def _all_of(path: pathlib.Path) -> list[str]:
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    return []


def test_every_reference_module_has_its_counterpart():
    rels = list(_reference_modules())
    assert len(rels) > 90
    missing = [str(r) for r in rels if not (ROOT / "geconpy_torch" / r).exists()]
    assert missing == []


@pytest.mark.parametrize("rel", [r for r in _reference_modules()
                                 if _all_of(REFERENCE / r)], ids=str)
def test_reference_exports_are_defined(rel):
    import importlib

    dotted = ".".join(rel.with_suffix("").parts).removesuffix("__init__")
    dotted = dotted.rstrip(".")
    module = importlib.import_module(
        "geconpy_torch" + (f".{dotted}" if dotted else ""))
    missing = [n for n in _all_of(REFERENCE / rel)
               if not hasattr(module, n) and (dotted, n) not in JAX_ONLY]
    assert missing == []


def _reference_params(dotted: str, name: str) -> list[str]:
    path = REFERENCE / (dotted.replace(".", "/") + ".py")
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            a = node.args
            return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    raise LookupError(name)


@pytest.mark.parametrize("dotted, name", [
    ("stats.estimation", "fit"), ("stats.smc", "fit_smc"),
    ("stats.nuts", "sample_nuts"),
    ("stats.perturbation_diagnostics", "solvability_check"),
    ("stats.perturbation_diagnostics", "prior_solvability_check"),
    ("stats.perturbation_diagnostics", "bk_condition_sweep"),
    ("stats.prior_predictive", "prior_predictive_sweep"),
    ("stats.checkpoint", "fit_with_checkpointing"),
    ("ops.kalman", "stationary_kalman_loglik"),
    ("ops.kalman", "stationary_loglik_from_P"),
    ("ops.kalman", "steady_state_kalman_loglik"),
    ("ops.kalman", "steady_state_filter_parts"),
    ("ops.cyclo_kalman", "cyclostationary_kalman_loglik"),
    ("utils.compile_cache", "enable_persistent_cache"),
    ("analysis.dynare", "make_mod_file"),
])
def test_reference_keywords_are_accepted(dotted, name):
    import importlib

    fn = getattr(importlib.import_module(f"geconpy_torch.{dotted}"), name)
    params = inspect.signature(fn).parameters
    # a JAX key is a torch.Generator; the port's value_and_grad is the
    # reference's logp_fn and logp_grad_fn in one, and axis_name names a
    # shard_map axis for calls from inside one (JAX only)
    renamed = {"key": "generator", "logp_fn": "value_and_grad"}
    jax_only = {"axis_name", "logp_grad_fn"} if name == "sample_nuts" else set()
    want = [renamed.get(p, p) for p in _reference_params(dotted, name)
            if p not in jax_only]
    assert [p for p in want if p not in params] == []
    # the reference's positional parameters keep their order
    positional = [p for p in params
                  if params[p].kind is inspect.Parameter.POSITIONAL_OR_KEYWORD]
    assert [p for p in want if p in positional] == \
        [p for p in positional if p in want]


def test_top_level_front_end_names():
    src = gt.get_example_gcn("rbc")
    primitives = gt.load_gcn(src)
    assert isinstance(primitives, gt.ModelPrimitives)
    assert len(primitives.equations) == len(primitives.variables)
    ast_model = gt.parse_gcn(src)
    assert "HOUSEHOLD" in gt.print_model(ast_model)
    model = gt.model_from_gcn(src, verbose=False)
    ss = model.steady_state(verbose=False, device="cpu")
    assert isinstance(ss, gt.SteadyStateResults)
    assert isinstance(gt.TimeAwareSymbol("K", 0), gt.TimeAwareSymbol)
    assert issubclass(gt.SymbolDictionary, dict)
    assert gt.persistent_cache_enabled() is None


def test_parallel_is_a_subpackage():
    mesh = gt.parallel.make_mesh(devices=("cpu",) * 2)
    assert mesh.size == 2 and mesh.axis_names == ("batch",)
    assert all(d == torch.device("cpu") for d in mesh.devices)
