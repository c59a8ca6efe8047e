"""Batched constant-gain Kalman filter tail: CUDA kernel K3 and its plain twin.

Mirrors ``geconpy_tpu/ops/pallas_filter.py:65`` (``pallas_filter_tail``)
as :func:`filter_tail`.  Per draw and step t:

    v   = y_t - d - Z x
    ll += const - v' F^{-1} v / 2
    x   = M x + TK (y_t - d)

Kernel source note.  ``csrc/filter_tail.cu`` replaces the TPU kernel
``_tail_kernel`` (``ops/pallas_filter.py:34``), which takes any n and k.
On the H100 each step is ~1.3k multiply-adds per draw (n = 26, k = 7) that
depend on the previous step's state, so the recursion is bound by the
instructions of a draw's step.  It has two variants, both kernels:

* the small-state kernel (n <= 64 and k <= 32, every bundled model's
  filter core) gives each draw one warp: lane i holds row i of M and TK
  (two rows a lane for 32 < n <= 64) and, on lanes i < k, row i of Z and
  F^{-1} in registers; each step hands x, y_t - d and v round the warp
  through a small shared-memory buffer of its own (broadcast loads, four
  floats a load), forms the quadratic form with a warp reduction, and
  synchronises nothing but the warp;
* the large-state kernel (any other n or k, e.g. the lag-augmented filter
  state of 104 of SW-2007 with year-on-year inflation) gives each draw a
  block, a thread per row of the stacked step [M TK; Z 0] [x; y_t - d],
  with x, y_t - d and v in shared memory and one block barrier a step; the
  stacked matrix sits in shared memory while it fits there (n = 104,
  k = 7: 49 KB in float32) and is read from device memory (L2) each step
  when it does not.

The shared observations ``y_tail`` are read through the read-only cache.
It computes in the caller's dtype, as the reference does; results differ
from the plain version only by summation order.  ``filter_tail.launches``
counts either variant's launches, ``filter_tail.large_launches`` the
large-state kernel's.

:func:`_filter_tail_plain` is the plain PyTorch version of the same
recursion.  The wrapper uses it for CPU tensors; a CUDA tensor goes to the
kernel or the wrapper raises.
"""

from __future__ import annotations

import torch

from . import _cuda

__all__ = ["filter_tail"]


def _filter_tail_plain(y_tail, M, TK, Z, d, Finv, const, x0):
    """Plain PyTorch version of the K3 kernel (batch-first)."""
    x = x0
    ll = torch.zeros_like(const)
    for t in range(y_tail.shape[0]):
        yd = y_tail[t] - d
        v = yd - (Z @ x[..., None])[..., 0]
        quad = (v[..., :, None] * Finv * v[..., None, :]).sum(dim=(-2, -1))
        ll = ll + const - 0.5 * quad
        x = (M @ x[..., None])[..., 0] + (TK @ yd[..., None])[..., 0]
    return ll


def _filter_tail_cuda(y_tail, M, TK, Z, d, Finv, const, x0):
    """Launch the K3 kernel."""
    Bn, n, _ = M.shape
    k = Z.shape[1]
    _cuda.require_cuda_inputs(
        "filter_tail",
        {"y_tail": (y_tail, (y_tail.shape[0], k)), "M": (M, (Bn, n, n)),
         "TK": (TK, (Bn, n, k)), "Z": (Z, (Bn, k, n)), "d": (d, (Bn, k)),
         "Finv": (Finv, (Bn, k, k)), "const": (const, (Bn,)),
         "x0": (x0, (Bn, n))}, M.dtype, M.device)
    lib = _cuda.library()
    # the small-state kernel where its registers hold the draw, else the
    # large-state one
    large = n > lib.gcp_filter_tail_max_n() or k > lib.gcp_filter_tail_max_k()
    launch = lib.gcp_filter_tail_large if large else lib.gcp_filter_tail
    ll = torch.empty((Bn,), dtype=M.dtype, device=M.device)
    if Bn:
        code = launch(
            _cuda.dtype_code(M.dtype), y_tail.data_ptr(), M.data_ptr(),
            TK.data_ptr(), Z.data_ptr(), d.data_ptr(), Finv.data_ptr(),
            const.data_ptr(), x0.data_ptr(), ll.data_ptr(), Bn, n, k,
            y_tail.shape[0], _cuda.stream_handle(M.device))
        _cuda.check(code, "filter_tail")
        _cuda.count_launch(filter_tail, large)
    return ll


def filter_tail(y_tail, M, TK, Z, d, Finv, const, x0):
    """Run the constant-gain tail for a batch of draws.

    ``y_tail`` (steps, k) shared observations; ``M`` (Bn, n, n), ``TK``
    (Bn, n, k), ``Z`` (Bn, k, n), ``d`` (Bn, k), ``Finv`` (Bn, k, k),
    ``const`` (Bn,), ``x0`` (Bn, n).  Returns per-draw tail
    log-likelihoods (Bn,).
    """
    args = tuple(X.contiguous() for X in (y_tail, M, TK, Z, d, Finv, const, x0))
    if M.device.type == "cpu":
        return _filter_tail_plain(*args)
    if M.device.type == "cuda":
        return _filter_tail_cuda(*args)
    raise ValueError(f"filter_tail: no kernel for {M.device}")


#: launches of the CUDA kernel (either variant) since the count was last
#: set to 0, and of its large-state variant alone
filter_tail.launches = 0
filter_tail.large_launches = 0
