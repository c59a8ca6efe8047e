"""The port's reports, HTML, Dynare export and labelled matrices against
the reference's.

- ``make_mod_file`` is byte-equal to the reference's on bundled models
  with an analytic steady state (the header names the package that wrote
  it, so the reference's text is compared with ``geconpy_tpu`` read as
  ``geconpy_torch``); on models whose steady state is solved numerically
  (the ``initval`` block) every line but those values is equal and the
  values agree at rel 1e-10 (the two root finders round differently).
- ``build_report``, ``Model._repr_html_``, ``Block._repr_html_``,
  ``model_to_html``, ``print_gcn_file`` and ``print_steady_state`` give
  the reference's strings.
- ``matrix_to_dataframe`` gives the reference frame's values and labels,
  with its shape inference, explicit dimensions, rounding and errors.
- ``utils/reporting.py`` and ``analysis/dynare.py`` are the reference's
  code (AST, docstrings and package names aside; ``make_mod_file`` also
  takes ``device``, and its two steady-state calls pass it on).
"""

import ast
import os
import pathlib

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest
import torch

import geconpy_torch
import geconpy_tpu
from geconpy_torch.analysis.dynare import make_mod_file
from geconpy_torch.utils import reporting as port_reporting
from geconpy_torch.utils.formatting import matrix_to_dataframe
from geconpy_tpu.utils import reporting as ref_reporting
from geconpy_tpu.utils.formatting import matrix_to_dataframe as ref_matrix

ROOT = pathlib.Path(__file__).resolve().parents[1]
ANALYTIC = ["rbc", "nk_3eq", "rbc_estimation", "sw2007", "nk_sw"]
NUMERIC = ["open_rbc", "rbc_ces"]


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu():
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


def _as_port(text: str) -> str:
    return text.replace("geconpy_tpu", "geconpy_torch")


@pytest.mark.parametrize("name", ANALYTIC)
def test_mod_file_is_byte_equal(name):
    ref, port = _models(name)
    assert port.functions.has_full_analytic_ss
    kw = dict(shock_std=0.02, periods=100, order=1)
    assert make_mod_file(port, device="cpu", **kw) == \
        _as_port(geconpy_tpu.make_mod_file(ref, **kw))


@pytest.mark.parametrize("name", NUMERIC)
def test_mod_file_with_a_numeric_steady_state(name):
    ref, port = _models(name)
    assert not port.functions.has_full_analytic_ss
    got = make_mod_file(port, device="cpu").splitlines()
    want = _as_port(geconpy_tpu.make_mod_file(ref)).splitlines()
    assert len(got) == len(want)
    start = want.index("initval;")
    stop = want.index("end;", start)
    for i, (g, w) in enumerate(zip(got, want)):
        if start < i < stop:
            g_name, g_val = g.rstrip(";").split(" = ")
            w_name, w_val = w.rstrip(";").split(" = ")
            assert g_name == w_name
            np.testing.assert_allclose(float(g_val), float(w_val),
                                       rtol=1e-10, atol=1e-14)
        else:
            assert g == w


@pytest.mark.parametrize("name", ["rbc", "rbc_estimation", "open_rbc"])
def test_build_report_equals_reference(name, capsys):
    ref, port = _models(name)
    want = ref_reporting.build_report(ref)
    assert port_reporting.build_report(port) == want
    assert port.build_report() == want
    assert want in capsys.readouterr().out


@pytest.mark.parametrize("name", ["rbc", "nk_3eq"])
def test_html_equals_reference(name):
    ref, port = _models(name)
    assert port._repr_html_() == ref._repr_html_()
    assert port_reporting.model_to_html(port) == ref_reporting.model_to_html(ref)
    for block_name, block in port.primitives.blocks.items():
        ref_block = ref.primitives.blocks[block_name]
        assert block._repr_html_() == ref_block._repr_html_()
    assert "Block: " in port._repr_html_() and "\\[" in port._repr_html_()


def test_print_gcn_file_equals_reference(tmp_path):
    src = geconpy_torch.get_example_gcn("rbc")
    assert port_reporting.print_gcn_file(src) == \
        ref_reporting.print_gcn_file(src)
    path = tmp_path / "rbc.gcn"
    path.write_text(src)
    assert geconpy_torch.print_gcn_file(str(path)) == \
        geconpy_tpu.print_gcn_file(str(path))


def test_print_steady_state_equals_reference(capsys):
    ref, port = _models("rbc")
    want = ref_reporting.print_steady_state(ref.steady_state(verbose=False))
    got = geconpy_torch.print_steady_state(
        port.steady_state(verbose=False, device="cpu"))
    # the residual norm (~1e-16) is rounding; every value line is equal
    assert got.splitlines()[1:] == want.splitlines()[1:]
    assert got.splitlines()[0].startswith("Steady state converged")
    assert "K_ss" in capsys.readouterr().out


def _frame_equal(got, want):
    np.testing.assert_array_equal(got.values.numpy(), want.to_numpy())
    assert got.index == list(want.index)
    assert got.columns == list(want.columns)


@pytest.mark.parametrize("dims", [(None, None), ("variable", "shock"),
                                  ("equation", "variable")])
def test_matrix_to_dataframe_equals_reference(dims):
    ref, port = _models("rbc")
    n, k = port.n_variables, port.n_shocks
    rows = n if dims[0] != "shock" else k
    cols = k if dims[1] == "shock" else n
    mat = np.random.default_rng(0).standard_normal((rows, cols))
    want = ref_matrix(mat, ref, dim1=dims[0], dim2=dims[1], round=3)
    got = matrix_to_dataframe(torch.as_tensor(mat), port, dim1=dims[0],
                              dim2=dims[1], round=3)
    _frame_equal(got, want)
    _frame_equal(geconpy_torch.matrix_to_dataframe(mat, port, dims[0],
                                                   dims[1]),
                 ref_matrix(mat, ref, dims[0], dims[1]))


def test_matrix_to_dataframe_errors():
    _ref, port = _models("rbc")
    with pytest.raises(ValueError, match="2-dimensional"):
        matrix_to_dataframe(np.zeros(3), port)
    with pytest.raises(ValueError, match="matches neither"):
        matrix_to_dataframe(np.zeros((port.n_variables + 1, 2)), port)
    with pytest.raises(ValueError, match="unknown dimension"):
        matrix_to_dataframe(np.zeros((2, 2)), port, dim1="state",
                            dim2="shock")


def _code(path: pathlib.Path) -> str:
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree).replace("geconpy_tpu", "geconpy_torch")


def test_reporting_is_the_reference_code():
    rel = "utils/reporting.py"
    assert _code(ROOT / "geconpy_torch" / rel) == _code(ROOT / "geconpy_tpu" / rel)


def test_dynare_is_the_reference_code_but_for_the_device(tmp_path):
    rel = "analysis/dynare.py"
    port = (ROOT / "geconpy_torch" / rel).read_text()
    # the three lines that differ: the keyword, and the two calls that
    # pass it on
    port = port.replace(
        "use_steady_state_model: bool = True, *,\n"
        "                  device: str = \"cuda\") -> str:",
        "use_steady_state_model: bool = True) -> str:").replace(
        "model.steady_state(verbose=False, device=device)",
        "model.steady_state(verbose=False)")
    tmp = tmp_path / "dynare.py"
    tmp.write_text(port)
    assert _code(tmp) == _code(ROOT / "geconpy_tpu" / rel)
