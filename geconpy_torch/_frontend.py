"""Loader for the JAX-free sympy front-end of :mod:`geconpy_tpu`.

The GCN language (``lang/``), the symbolic layer (``symbolic/``), the
model primitives (``models/{primitives,block,special_blocks,registry,
simplify,timing}.py``) and the prior AST converter (``dists/from_ast.py``)
are host-side sympy code that imports no JAX.  Their packages' ``__init__``
files do import JAX modules (``geconpy_tpu/__init__.py``,
``geconpy_tpu/models/__init__.py``, ``geconpy_tpu/dists/__init__.py``), so a
plain ``import geconpy_tpu.models.primitives`` would pull JAX in.

This module registers a private alias package whose ``__path__`` is the
``geconpy_tpu/`` source directory, with bare ``models`` and ``dists``
sub-packages (their ``__init__`` files never run), and maps the alias's
``dists.core`` to :mod:`geconpy_torch.dists.core`.  Importing the front-end
modules through the alias therefore reads the reference's source files
unchanged while ``dists/from_ast.py`` builds **torch** priors.  The same
path is taken whether or not JAX is installed.
"""

from __future__ import annotations

import importlib
import importlib.machinery
import importlib.util
import pathlib
import sys
import types

__all__ = ["ALIAS", "REFERENCE_ROOT", "frontend", "get_example_gcn"]

#: name of the private alias package that mirrors ``geconpy_tpu/``
ALIAS = "geconpy_torch._geconpy_tpu_frontend"

#: the reference package's source directory (read, never imported)
REFERENCE_ROOT = pathlib.Path(__file__).resolve().parent.parent / "geconpy_tpu"

_MODULES = ("symbolic", "models.timing", "models.primitives",
            "dists.from_ast")


def _bare_package(name: str, path: pathlib.Path) -> types.ModuleType:
    spec = importlib.machinery.ModuleSpec(name, None, is_package=True)
    spec.submodule_search_locations = [str(path)]
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    return module


def frontend() -> types.SimpleNamespace:
    """Import the front-end modules through the alias (idempotent).

    Returns a namespace with the modules the port uses: ``symbolic``,
    ``timing`` (``models/timing.py``), ``primitives``
    (``models/primitives.py``) and ``from_ast`` (``dists/from_ast.py``).
    """
    if ALIAS not in sys.modules:
        if not (REFERENCE_ROOT / "models" / "primitives.py").exists():
            raise ImportError(
                f"geconpy_torch needs the geconpy_tpu sources beside it; "
                f"not found at {REFERENCE_ROOT}")
        root = _bare_package(ALIAS, REFERENCE_ROOT)
        for sub in ("models", "dists"):
            setattr(root, sub, _bare_package(f"{ALIAS}.{sub}",
                                             REFERENCE_ROOT / sub))
        from .dists import core

        sys.modules[f"{ALIAS}.dists.core"] = core
        root.dists.core = core
    mods = {name: importlib.import_module(f"{ALIAS}.{name}")
            for name in _MODULES}
    return types.SimpleNamespace(
        symbolic=mods["symbolic"],
        timing=mods["models.timing"], primitives=mods["models.primitives"],
        from_ast=mods["dists.from_ast"])


def get_example_gcn(name: str = "rbc") -> str:
    """Source of a bundled example model, read from ``geconpy_tpu/data``
    by path (mirrors ``geconpy_tpu/__init__.py:59`` get_example_gcn)."""
    data_dir = REFERENCE_ROOT / "data"
    path = data_dir / f"{name}.gcn"
    if not path.exists():
        available = sorted(p.stem for p in data_dir.glob("*.gcn"))
        raise FileNotFoundError(
            f"no example model {name!r}; available: {available}")
    return path.read_text()
