"""Port parity: the copied sympy front-end builds the reference's model
primitives.

For every bundled model, ``geconpy_torch.models.primitives.load_gcn`` and
``geconpy_tpu.models.primitives.load_gcn`` on the same GCN source give the
same ``ModelPrimitives``: variable, shock and parameter names, the
parameter values, the dynamic and steady-state equations, the analytic
steady state and the calibrating and deterministic relations, and the
prior and shock-prior statements (family and arguments, through the port's
and the reference's ``resolve_priors``).  The two packages' symbols are
different classes of the same name, so an expression is compared with
each symbol replaced by a plain ``Symbol`` of its name: structurally, or
where the trees differ (sympy's caches are shared by the two packages in
one process, so a simplification may come out in another equivalent form)
by ``sympy.simplify(a - b) == 0``.  Each symbol's class, name, time index
and assumptions must be equal too.
"""

import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pathlib

import pytest
import sympy as sp

import geconpy_torch
from geconpy_torch.dists import resolve_priors as port_resolve_priors
from geconpy_torch.models import primitives as port_primitives
from geconpy_tpu.dists import resolve_priors as ref_resolve_priors
from geconpy_tpu.models import primitives as ref_primitives

MODELS = sorted(p.stem for p in (pathlib.Path(geconpy_torch.__file__).parent
                                 / "data").glob("*.gcn"))


def _plain(expr):
    expr = sp.sympify(expr)
    return expr.xreplace({s: sp.Symbol(s.name) for s in expr.free_symbols})


def _symbol_key(s):
    """Class, name, time index and the assumptions it was made with (srepr
    would also print whatever assumptions were deduced so far)."""
    return (type(s).__name__, s.name, str(getattr(s, "time_index", "")),
            sorted(s.assumptions0.items()))


def _symbols(expr):
    return sorted(map(_symbol_key, sp.sympify(expr).free_symbols))


def _assert_same(port_exprs, ref_exprs):
    assert len(port_exprs) == len(ref_exprs)
    for a, b in zip(port_exprs, ref_exprs):
        assert _symbols(a) == _symbols(b)
        pa, pb = _plain(a), _plain(b)
        assert pa == pb or sp.simplify(pa - pb) == 0, (a, b)


def _assert_same_dict(port, ref):
    assert sorted(map(_symbol_key, port)) == sorted(map(_symbol_key, ref))
    by_key = {_symbol_key(k).__repr__(): v for k, v in ref.items()}
    keys = list(port)
    _assert_same([port[k] for k in keys],
                 [by_key[_symbol_key(k).__repr__()] for k in keys])


@pytest.fixture(scope="module", params=MODELS)
def primitives(request):
    source = geconpy_torch.get_example_gcn(request.param)
    return (request.param, port_primitives.load_gcn(source),
            ref_primitives.load_gcn(source))


def test_bundled_models_are_all_checked():
    assert len(MODELS) == 21


def test_names_and_values_match(primitives):
    _name, port, ref = primitives
    assert [v.name for v in port.variables] == [v.name for v in ref.variables]
    assert [s.name for s in port.shocks] == [s.name for s in ref.shocks]
    assert {k.name: float(v) for k, v in port.param_dict.items()} == \
        {k.name: float(v) for k, v in ref.param_dict.items()}
    assert sorted(k.name for k in port.deterministic_dict) == \
        sorted(k.name for k in ref.deterministic_dict)
    assert sorted(k.name for k in port.calib_dict) == \
        sorted(k.name for k in ref.calib_dict)
    assert port.is_linear == ref.is_linear
    assert port.options == ref.options


def test_equations_match(primitives):
    _name, port, ref = primitives
    _assert_same(port.equations, ref.equations)
    _assert_same(port.steady_state_system, ref.steady_state_system)
    _assert_same_dict(port.ss_solution_dict, ref.ss_solution_dict)
    _assert_same_dict(port.deterministic_dict, ref.deterministic_dict)
    _assert_same_dict(port.calib_dict, ref.calib_dict)


def test_priors_match(primitives):
    _name, port, ref = primitives
    assert sorted(port.priors) == sorted(ref.priors)
    assert sorted(port.shock_priors) == sorted(ref.shock_priors)
    pp, ps = port_resolve_priors(port.priors, port.shock_priors)
    rp, rs = ref_resolve_priors(ref.priors, ref.shock_priors)
    assert sorted(pp) == sorted(rp) and sorted(ps) == sorted(rs)
    for key, d in rp.items():
        assert type(pp[key]).__name__ == type(d).__name__
        assert dataclasses.asdict(pp[key]) == pytest.approx(dataclasses.asdict(d))
    for key, d in rs.items():
        assert type(ps[key]).__name__ == type(d).__name__
        if hasattr(d, "dist_name"):
            assert (ps[key].dist_name, ps[key].fixed_kwargs,
                    ps[key].param_kwargs) == (d.dist_name, d.fixed_kwargs,
                                              d.param_kwargs)
