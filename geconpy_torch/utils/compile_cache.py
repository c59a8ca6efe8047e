"""Persistent (cross-process) cache of the CUDA kernels' build.

Mirrors ``geconpy_tpu/utils/compile_cache.py`` (``enable_persistent_cache``
:38, ``persistent_cache_enabled`` :70), where the cache holds XLA's
compiled executables.  The port's only compile is the ``nvcc`` build of
``geconpy_torch/csrc`` (``ops/_cuda.py``), already kept per hash of the
sources; this points that build at a directory that outlives the
checkout, so a second process with the same directory loads the library
without running ``nvcc``.  The same three tiers as the reference:

1. env: ``GECONPY_TORCH_CACHE_DIR`` set before import enables the cache
   there (``geconpy_torch/__init__.py``);
2. call site: ``fit(..., cache_dir=...)`` or an explicit
   :func:`enable_persistent_cache` call;
3. off by default: the build stays under ``build/geconpy_torch/`` beside
   the package.

``min_compile_time_secs`` is accepted and has no effect: every build is a
single ``nvcc`` run worth keeping.
"""

from __future__ import annotations

import os
import pathlib

__all__ = ["enable_persistent_cache", "persistent_cache_enabled"]

_ENV_VAR = "GECONPY_TORCH_CACHE_DIR"


def enable_persistent_cache(cache_dir: str | None = None, *,
                            min_compile_time_secs: float = 1.0) -> str:
    """Build and look up the CUDA kernels' library under ``cache_dir``.

    Defaults to ``$GECONPY_TORCH_CACHE_DIR`` or
    ``~/.cache/geconpy_torch/cuda``; the directory is created.  Idempotent;
    returns the active cache directory.  A library already loaded in this
    process stays loaded.
    """
    from ..ops import _cuda

    del min_compile_time_secs
    if cache_dir is None:
        cache_dir = os.environ.get(_ENV_VAR) or os.path.join(
            os.path.expanduser("~"), ".cache", "geconpy_torch", "cuda")
    cache_dir = os.path.abspath(cache_dir)
    os.makedirs(cache_dir, exist_ok=True)
    _cuda.CACHE_ROOT = pathlib.Path(cache_dir)
    return cache_dir


def persistent_cache_enabled() -> str | None:
    """The active cache directory, or None when the cache is off."""
    from ..ops import _cuda

    return None if _cuda.CACHE_ROOT is None else str(_cuda.CACHE_ROOT)
