"""The persistent cache of the CUDA kernels' build
(``utils/compile_cache.py``), without ``nvcc``.

- ``GECONPY_TORCH_CACHE_DIR`` set before import turns the cache on there
  (in a child process, as the reference's env tier); unset, the build root
  stays ``build/geconpy_torch/`` beside the package.
- ``enable_persistent_cache`` resolves its directory (the argument, else
  the variable, else ``~/.cache/geconpy_torch/cuda``), creates it, is
  idempotent, accepts ``min_compile_time_secs``, and moves the build
  directory of the sources' hash under it; ``fit(cache_dir=)`` turns it on.
- ``library()`` builds only when the library of the sources' hash is
  missing under the active root, and loads a cached one without building
  (``BUILDS`` counts the builds; the loader is stubbed here).
"""

import os
import pathlib
import subprocess
import sys

import pytest

import geconpy_torch
from geconpy_torch.ops import _cuda
from geconpy_torch.utils import compile_cache

REPO = pathlib.Path(__file__).resolve().parents[1]

_CHILD = r"""
import os, sys
import geconpy_torch
from geconpy_torch.ops import _cuda
print("ENABLED", geconpy_torch.persistent_cache_enabled())
print("ROOT", _cuda.build_root())
print("DIR", _cuda._build_dir().parent)
"""


def _child(env_dir):
    env = dict(os.environ)
    env.pop("GECONPY_TORCH_CACHE_DIR", None)
    if env_dir is not None:
        env["GECONPY_TORCH_CACHE_DIR"] = str(env_dir)
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return dict(line.split(" ", 1) for line in out.stdout.splitlines()
                if line.split(" ", 1)[0] in ("ENABLED", "ROOT", "DIR"))


@pytest.fixture(autouse=True)
def _cache_off(monkeypatch):
    monkeypatch.setattr(_cuda, "CACHE_ROOT", None)
    monkeypatch.delenv("GECONPY_TORCH_CACHE_DIR", raising=False)


def test_env_var_enables_the_cache_at_import(tmp_path):
    on = _child(tmp_path / "envcache")
    assert on["ENABLED"] == str(tmp_path / "envcache")
    assert on["ROOT"] == on["DIR"] == str(tmp_path / "envcache")
    assert (tmp_path / "envcache").is_dir()
    off = _child(None)
    assert off["ENABLED"] == "None"
    assert off["ROOT"] == off["DIR"] == str(_cuda.BUILD_ROOT)
    assert _cuda.BUILD_ROOT == REPO / "build" / "geconpy_torch"


def test_directory_resolution(tmp_path, monkeypatch):
    assert geconpy_torch.persistent_cache_enabled() is None
    assert _cuda.build_root() == _cuda.BUILD_ROOT
    explicit = tmp_path / "a" / "b"
    got = geconpy_torch.enable_persistent_cache(str(explicit),
                                                min_compile_time_secs=0.0)
    assert got == str(explicit) and explicit.is_dir()
    assert compile_cache.persistent_cache_enabled() == str(explicit)
    assert _cuda._build_dir().parent == explicit
    # idempotent
    assert geconpy_torch.enable_persistent_cache(str(explicit)) == got
    # the variable, then the home directory
    monkeypatch.setenv("GECONPY_TORCH_CACHE_DIR", str(tmp_path / "env"))
    assert geconpy_torch.enable_persistent_cache() == str(tmp_path / "env")
    monkeypatch.delenv("GECONPY_TORCH_CACHE_DIR")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    want = tmp_path / "home" / ".cache" / "geconpy_torch" / "cuda"
    assert geconpy_torch.enable_persistent_cache() == str(want)
    assert want.is_dir() and _cuda.build_root() == want
    # a relative directory is made absolute
    monkeypatch.chdir(tmp_path)
    assert geconpy_torch.enable_persistent_cache("rel") == \
        str(tmp_path / "rel")


def test_library_builds_only_when_missing(tmp_path, monkeypatch):
    geconpy_torch.enable_persistent_cache(str(tmp_path))
    loaded = []

    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            return fn

    def fake_build(out_dir):
        _cuda.BUILDS += 1
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / _cuda._LIB_NAME).write_bytes(b"")

    monkeypatch.setattr(_cuda, "_LIB", None)
    monkeypatch.setattr(_cuda, "_build", fake_build)
    monkeypatch.setattr(_cuda.ctypes, "CDLL",
                        lambda path: loaded.append(path) or FakeLib())
    builds = _cuda.BUILDS
    _cuda.library()
    assert _cuda.BUILDS == builds + 1
    lib_path = _cuda._build_dir() / _cuda._LIB_NAME
    assert lib_path.exists() and lib_path.parent.parent == tmp_path
    # a second process (a fresh loader) finds it and does not build
    monkeypatch.setattr(_cuda, "_LIB", None)
    _cuda.library()
    assert _cuda.BUILDS == builds + 1
    assert loaded == [str(lib_path)] * 2
