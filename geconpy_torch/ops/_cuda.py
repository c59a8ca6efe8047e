"""Build and bind the hand-written CUDA kernels (``geconpy_torch/csrc``).

The sources compile with ``nvcc`` for ``sm_90a`` (one process per source,
all started together) into one shared library with a plain C interface,
bound with :mod:`ctypes`.  The build runs at
first use and again whenever the sources change: the library lives under
``build/geconpy_torch/<hash of the sources>/`` beside the package, or under
the persistent cache's directory once
:func:`~geconpy_torch.utils.compile_cache.enable_persistent_cache` has
named one (:func:`build_root`), and the compiler's output (including
``-Xptxas -v`` register and spill counts) is kept there as ``nvcc.log``.
A process that finds the library of its sources' hash loads it without
running ``nvcc``; ``BUILDS`` counts the builds this process ran.  Nothing
here runs at import, so the CPU tests import every module without
``nvcc``.

Each C entry point returns ``cudaGetLastError()`` right after its launch;
:func:`check` raises on anything but 0.  Kernels launch on PyTorch's
current stream and do not synchronise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

__all__ = ["library", "check", "stream_handle", "dtype_code",
           "require_cuda_inputs", "count_launch", "workspace", "build_root",
           "CSRC", "BUILD_ROOT"]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "geconpy_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LIB_NAME = "libgeconpy_torch_kernels.so"

_LIB: ctypes.CDLL | None = None
# the persistent cache's directory (utils/compile_cache.py), or None
CACHE_ROOT: pathlib.Path | None = None
BUILDS = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_Z = ctypes.c_size_t
_SIGNATURES = {
    "gcp_cr_policy": ([_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
                      ctypes.c_int),
    "gcp_cr_policy_smem_bytes": ([_I, _I], ctypes.c_size_t),
    "gcp_cr": ([_I, _P, _P, _P, _P, _P, _I, _I, _I, _P], ctypes.c_int),
    "gcp_cr_smem_bytes": ([_I], ctypes.c_size_t),
    "gcp_cr_policy_large": ([_I, _P, _P, _P, _P, _P, _P, _P, _P, _Z, _I, _I,
                             _I, _I, _P], ctypes.c_int),
    "gcp_cr_large": ([_I, _P, _P, _P, _P, _P, _P, _Z, _I, _I, _I, _P],
                     ctypes.c_int),
    "gcp_cr_fits": ([_I, _I], ctypes.c_int),
    "gcp_cr_large_work_bytes": ([_I, _I, _I, _I, _I], ctypes.c_size_t),
    "gcp_cr_policy_onchip": ([_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _P], ctypes.c_int),
    "gcp_cr_onchip": ([_I, _P, _P, _P, _P, _P, _I, _I, _I, _P], ctypes.c_int),
    "gcp_cr_onchip_smem_bytes": ([_I, _I], ctypes.c_size_t),
    "gcp_cr_onchip_block_threads": ([], ctypes.c_int),
    "gcp_cr_onchip_resident": ([_I, _I, _I, _I], ctypes.c_int),
    "gcp_smem_optin": ([], ctypes.c_int),
    "gcp_cr_policy_cluster": ([_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _P], ctypes.c_int),
    "gcp_cr_cluster": ([_I, _P, _P, _P, _P, _P, _I, _I, _I, _P], ctypes.c_int),
    "gcp_cr_cluster_ctas": ([_I, _I], ctypes.c_int),
    "gcp_cr_cluster_rows": ([_I, _I], ctypes.c_int),
    "gcp_cr_cluster_smem_bytes": ([_I, _I], ctypes.c_size_t),
    "gcp_cr_cluster_resident": ([_I, _I, _I, _I], ctypes.c_int),
    "gcp_dare": ([_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
                 ctypes.c_int),
    "gcp_dare_smem_bytes": ([_I, _I], ctypes.c_size_t),
    "gcp_dare_block_threads": ([], ctypes.c_int),
    "gcp_dare_large": ([_I, _P, _P, _P, _P, _P, _P, _Z, _I, _I, _I, _I, _I,
                        _I, _P], ctypes.c_int),
    "gcp_dare_fits": ([_I, _I], ctypes.c_int),
    "gcp_dare_large_work_bytes": ([_I, _I, _I, _I], ctypes.c_size_t),
    "gcp_dare_cluster": ([_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _P], ctypes.c_int),
    "gcp_dare_cluster_ctas": ([_I, _I], ctypes.c_int),
    "gcp_dare_cluster_fits": ([_I, _I], ctypes.c_int),
    "gcp_dare_cluster_smem_bytes": ([_I, _I], ctypes.c_size_t),
    "gcp_dare_cluster_resident": ([_I, _I, _I], ctypes.c_int),
    "gcp_dare_cluster_block_threads": ([], ctypes.c_int),
    "gcp_settle": ([_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                    _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "gcp_settle_filter": ([_I, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "gcp_settle_smem_bytes": ([_I, _I, _I, _I], ctypes.c_size_t),
    "gcp_settle_draws_per_block": ([_I, _I, _I, _I], ctypes.c_int),
    "gcp_settle_large": ([_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P, _Z, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "gcp_settle_filter_large": ([_I, _P, _P, _P, _P, _P, _P, _P, _P, _Z,
                                 _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "gcp_settle_fits": ([_I, _I, _I, _I], ctypes.c_int),
    "gcp_settle_large_work_bytes": ([_I, _I, _I, _I, _I, _I],
                                    ctypes.c_size_t),
    "gcp_settle_cluster": ([_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "gcp_settle_filter_cluster": ([_I, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "gcp_settle_cluster_ctas": ([_I, _I, _I, _I], ctypes.c_int),
    "gcp_settle_cluster_fits": ([_I, _I, _I, _I], ctypes.c_int),
    "gcp_settle_cluster_smem_bytes": ([_I, _I, _I, _I], ctypes.c_size_t),
    "gcp_settle_cluster_resident": ([_I, _I, _I, _I, _I], ctypes.c_int),
    "gcp_settle_cluster_block_threads": ([], ctypes.c_int),
    "gcp_filter_tail": ([_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _P], ctypes.c_int),
    "gcp_filter_tail_draws_per_block": ([], ctypes.c_int),
    "gcp_filter_tail_block_threads": ([], ctypes.c_int),
    "gcp_filter_tail_smem_bytes": ([_I, _I, _I], ctypes.c_size_t),
    "gcp_filter_tail_max_n": ([], ctypes.c_int),
    "gcp_filter_tail_max_k": ([], ctypes.c_int),
    "gcp_filter_tail_large": ([_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _P], ctypes.c_int),
    "gcp_error_string": ([_I], ctypes.c_char_p),
}


def _sources() -> list[pathlib.Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidate = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if candidate.exists():
            return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def build_root() -> pathlib.Path:
    """Where the library of each source hash is built: the persistent
    cache's directory when one is enabled, else ``BUILD_ROOT``."""
    return BUILD_ROOT if CACHE_ROOT is None else CACHE_ROOT


def _build_dir() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return build_root() / h.hexdigest()[:16]


def _build(out_dir: pathlib.Path) -> None:
    """Compile every source on its own, all at once, then link them."""
    global BUILDS
    BUILDS += 1
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        jobs = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *flags, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), obj))
        log, failed = [], []
        for cmd, proc, _obj in jobs:
            out = proc.communicate()[0]
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(f"{cmd[-1]} (exit {proc.returncode}):\n"
                              f"{out[-4000:]}")
        if not failed:
            lib = pathlib.Path(tmp) / _LIB_NAME
            cmd = [nvcc, "-shared", "-o", str(lib),
                   *(str(obj) for _c, _p, obj in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"link (exit {proc.returncode}):\n"
                              f"{proc.stderr[-4000:]}")
        (out_dir / "nvcc.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(lib, out_dir / _LIB_NAME)


def library() -> ctypes.CDLL:
    """The kernel library, built on first use (raises if it cannot be)."""
    global _LIB
    if _LIB is None:
        out_dir = _build_dir()
        path = out_dir / _LIB_NAME
        if not path.exists():
            _build(out_dir)
        lib = ctypes.CDLL(str(path))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LIB = lib
    return _LIB


def check(code: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if code != 0:
        msg = library().gcp_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype: torch.dtype) -> int:
    if dtype == torch.float32:
        return 0
    if dtype == torch.float64:
        return 1
    raise TypeError(f"the CUDA kernels take float32 or float64, got {dtype}")


def count_launch(wrapper, large: bool, workspace: bool = False) -> None:
    """Count one launch of ``wrapper``'s kernel: ``wrapper.launches``
    counts every variant, ``wrapper.large_launches`` those above the
    small-state plan, and ``wrapper.workspace_launches`` (the settle and
    DARE wrappers') the large-state kernel on its device-memory
    workspace."""
    wrapper.launches += 1
    if large:
        wrapper.large_launches += 1
    if workspace:
        wrapper.workspace_launches += 1


def workspace(nbytes: int, device: torch.device) -> torch.Tensor:
    """A float64 scratch buffer of at least ``nbytes`` bytes on ``device``
    (from PyTorch's caching allocator) for a large-state kernel."""
    return torch.empty(((nbytes + 7) // 8,), dtype=torch.float64,
                       device=device)


def require_cuda_inputs(name: str, tensors: dict, dtype: torch.dtype,
                        device: torch.device) -> None:
    """Check that every tensor has its expected shape, is contiguous and is
    on ``device`` in ``dtype``; ``tensors`` maps a name to (tensor, shape)."""
    for key, (t, shape) in tensors.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
