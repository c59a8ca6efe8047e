"""Batched Kalman settle phase, alone (CUDA kernel K2) and fused with the
constant-gain tail (CUDA kernel K5), each with its plain twin.

Mirrors ``geconpy_tpu/ops/pallas_settle.py:248`` (``pallas_settle_parts``)
as :func:`settle_parts`: P0 by 10 Lyapunov doublings, ``n_settle`` exact
Riccati steps (Joseph form; per-step log-likelihood with log det F from the
Gauss-Jordan pivots), then the frozen-gain quantities (M, TK, F^{-1},
const) of the constant-gain tail.  Fully observed data only.
:func:`settle_filter_loglik` mirrors ``pallas_settle_filter_loglik``
(``:186``): the same settle followed, in the same kernel launch, by the
constant-gain tail over the rest of the sample, returning each draw's whole
log-likelihood; M, TK and F^{-1} never reach device memory.

Kernel source note.  ``csrc/settle.cu`` replaces the TPU kernels
``_settle_kernel`` (``ops/pallas_settle.py:40``) and, compiled with
``kFused``, ``_fused_kernel`` (``:108``).  On the H100 the work is bound on
paper by its operations (~3.5 MFMA per draw at n = 26, k = 7, 32 steps) and
in fact by the chain of ~290 dependent small products and eliminations per
draw.  The design: four warps per draw and several draws per block, each
draw with a barrier of its own; every matrix in shared memory, zero-padded
to whole 16 x 8 tiles, so that the products run as ``mma.sync m16n8k4`` in
float64 on the tensor cores with no bounds test; the k-sized Gauss-Jordan
elimination in one warp's registers; ``y`` staged once per block in shared
memory; the fused tail spread over the draw's warps.  ``csrc/settle.cu``
has the whole note.  The kernel takes and returns the caller's dtype but
runs the recursion in float64, and so does the plain version: without
measurement error F is ill-conditioned, and two float32 recursions differed
by up to 2.7e-3 relative in ll_head on the SW-2007 sweep (H100 run).  K5's
tail runs in float64 straight from the float64 settle, so with float32 I/O
its result is not bitwise K2 followed by K3 (which round M, TK, F^{-1},
const and x_pred0 to float32 in between); it is held to the sweep's bar
against the float64 path instead.  The TPU kernel's one-hot row extraction
over the sample, its broadcast of ``y`` over the lanes, the lane padding and
the ``tile`` argument are gone.  The launch (draws per block, whether ``y``
fits beside them) is decided in the C entry point;
``gcp_settle_smem_bytes`` answers for that launch.

Two variants, both kernels, as the reference's kernels take any n: where
one draw's float64 layout and ``y`` fit the device's shared memory
(``gcp_settle_fits``; in float64 at k = 7, n <= 64 for K5 over 200
periods and n <= 72 for K2 over 32 settle steps on an H100) the
small-state kernel above runs; beyond that the large-state kernel runs the
same schedule on the same layout with each draw's buffers in a float64
workspace in device memory, which the wrapper allocates (``torch.empty``)
for the resident draws of a persistent grid, not for the batch
(``chip_smoke.py`` phase 16 prints its size).  Its products read their
operands through L1 and L2 instead of shared memory.
``settle_parts.large_launches`` and ``settle_filter_loglik.large_launches``
count the large-state launches among ``launches``.

:func:`_settle_plain` and :func:`_settle_filter_plain` are the plain PyTorch
versions of the same schedules.  The wrappers use them for CPU tensors; a
CUDA tensor goes to the kernel or the wrapper raises.
"""

from __future__ import annotations

import math

import torch

from . import _cuda
from .batched_filter import _filter_tail_plain
from .linalg import gj_eliminate
from .precision import highest_precision

__all__ = ["settle_parts", "settle_filter_loglik", "LYAP_ITERS"]

_LOG2PI = float(math.log(2.0 * math.pi))

#: Lyapunov doublings for P0: the error is ~rho(T)^(2^(m+1)), ~1e-22 at
#: rho = 0.975 and 1e-9 at rho = 0.99 (the settle steps finish the rest)
LYAP_ITERS = 10


def _mT(X: torch.Tensor) -> torch.Tensor:
    return X.transpose(-1, -2)


@highest_precision()
def _settle_plain(y_head, T, RQR, Z, H, d, lyap_iters: int):
    """Plain PyTorch version of the K2 kernel (batch-first); like the kernel
    it computes in float64 and returns the inputs' dtype."""
    out = _settle_recursion(*(X.to(torch.float64)
                              for X in (y_head, T, RQR, Z, H, d)), lyap_iters)
    return tuple(X.to(T.dtype) for X in out)


def _settle_recursion(y_head, T, RQR, Z, H, d, lyap_iters: int):
    n = T.shape[-1]
    k = Z.shape[-2]
    batch = T.shape[:-2]
    eye_n = torch.eye(n, dtype=T.dtype, device=T.device)
    eye_k = torch.eye(k, dtype=T.dtype, device=T.device).expand(batch + (k, k))
    A, P = T, RQR
    for _ in range(lyap_iters):
        P = P + (A @ P) @ _mT(A)
        A = A @ A
    x = T.new_zeros(batch + (n, 1))
    ll = T.new_zeros(batch)
    for t in range(y_head.shape[0]):
        x_pred = T @ x
        P_pred = (T @ P) @ _mT(T) + RQR
        v = y_head[t][:, None] - Z @ x_pred - d[..., None]
        PZt = P_pred @ _mT(Z)
        F = Z @ PZt + H
        sol, _mp, logdet = gj_eliminate(F, torch.cat([v, eye_k], dim=-1))
        w = sol[..., :1]
        Finv = sol[..., 1:]
        K = PZt @ Finv
        x = x_pred + K @ v
        IKZ = eye_n - K @ Z
        P = (IKZ @ P_pred) @ _mT(IKZ) + (K @ H) @ _mT(K)
        vFv = (v * w).sum(dim=(-2, -1))
        ll = ll - 0.5 * (k * _LOG2PI + logdet + vFv)
    P_pred = (T @ P) @ _mT(T) + RQR
    PZt = P_pred @ _mT(Z)
    F = Z @ PZt + H
    Finv, _mp, logdet = gj_eliminate(F, eye_k)
    K = PZt @ Finv
    TK = T @ K
    M = T - TK @ Z
    const = -0.5 * (k * _LOG2PI + logdet)
    return ll, (T @ x)[..., 0], M, TK, Finv, const


@highest_precision()
def _settle_filter_plain(y, T, RQR, Z, H, d, n_settle: int, lyap_iters: int):
    """Plain PyTorch version of the K5 kernel (batch-first): the settle over
    ``y[:n_settle]`` and the constant-gain tail over the rest, all in
    float64 with no rounding in between; returns the inputs' dtype."""
    y64, *mats = (X.to(torch.float64) for X in (y, T, RQR, Z, H, d))
    ll_head, x_pred0, M, TK, Finv, const = _settle_recursion(
        y64[:n_settle], *mats, lyap_iters)
    ll_tail = _filter_tail_plain(y64[n_settle:], M, TK, mats[2], mats[4],
                                 Finv, const, x_pred0)
    return (ll_head + ll_tail).to(T.dtype)


def _checked_library(name, y, T, RQR, Z, H, d):
    """Check a settle kernel's inputs; returns the kernel library and
    whether the large-state variant runs (the small-state plan does not fit
    one draw a block in the device's shared memory)."""
    Bn, n, _ = T.shape
    k = Z.shape[1]
    _cuda.require_cuda_inputs(
        name,
        {"y": (y, (y.shape[0], k)), "T": (T, (Bn, n, n)),
         "RQR": (RQR, (Bn, n, n)), "Z": (Z, (Bn, k, n)), "H": (H, (Bn, k, k)),
         "d": (d, (Bn, k))}, T.dtype, T.device)
    lib = _cuda.library()
    large = not lib.gcp_settle_fits(_cuda.dtype_code(T.dtype), n, k,
                                    y.shape[0])
    return lib, large


def _large_workspace(lib, fused: bool, y, T, Z):
    """The large-state launch's float64 workspace: (tensor, bytes)."""
    Bn, n, _ = T.shape
    nbytes = lib.gcp_settle_large_work_bytes(
        _cuda.dtype_code(T.dtype), int(fused), n, Z.shape[1], y.shape[0], Bn)
    return _cuda.workspace(nbytes, T.device), nbytes


def _settle_cuda(y_head, T, RQR, Z, H, d, lyap_iters: int):
    """Launch the K2 kernel (either variant)."""
    Bn, n, _ = T.shape
    k = Z.shape[1]
    n_settle = y_head.shape[0]
    lib, large = _checked_library("settle_parts", y_head, T, RQR, Z, H, d)
    empty = lambda *shape: torch.empty(shape, dtype=T.dtype,  # noqa: E731
                                       device=T.device)
    ll, xp, M, TK, Finv, const = (empty(Bn), empty(Bn, n), empty(Bn, n, n),
                                  empty(Bn, n, k), empty(Bn, k, k), empty(Bn))
    if Bn:
        ptrs = [X.data_ptr() for X in (T, RQR, Z, H, d, y_head, ll, xp, M, TK,
                                       Finv, const)]
        stream = _cuda.stream_handle(T.device)
        if large:
            work, nbytes = _large_workspace(lib, False, y_head, T, Z)
            code = lib.gcp_settle_large(
                _cuda.dtype_code(T.dtype), *ptrs, work.data_ptr(), nbytes, Bn,
                n, k, n_settle, lyap_iters, stream)
        else:
            code = lib.gcp_settle(_cuda.dtype_code(T.dtype), *ptrs, Bn, n, k,
                                  n_settle, lyap_iters, stream)
        _cuda.check(code, "settle_parts")
        _cuda.count_launch(settle_parts, large)
    return ll, xp, M, TK, Finv, const


def settle_parts(y_head, T, RQR, Z, H, d):
    """Batched settle phase: returns (ll_head, x_pred0, M, TK, Finv, const).

    Batch-first inputs: T/RQR (Bn, n, n), Z (Bn, k, n), H (Bn, k, k),
    d (Bn, k); ``y_head`` (n_settle, k) is shared across the batch and fully
    observed.  Output conventions match the reference's
    ``steady_state_filter_parts``.
    """
    y_head, T, RQR, Z, H, d = (X.contiguous()
                               for X in (y_head, T, RQR, Z, H, d))
    if T.device.type == "cpu":
        return _settle_plain(y_head, T, RQR, Z, H, d, LYAP_ITERS)
    if T.device.type == "cuda":
        return _settle_cuda(y_head, T, RQR, Z, H, d, LYAP_ITERS)
    raise ValueError(f"settle_parts: no kernel for {T.device}")


#: launches of the CUDA kernel (either variant) since the count was last
#: set to 0, and of its large-state variant alone
settle_parts.launches = 0
settle_parts.large_launches = 0


def _settle_filter_cuda(y, T, RQR, Z, H, d, n_settle: int, lyap_iters: int):
    """Launch the K5 kernel (either variant)."""
    Bn, n, _ = T.shape
    k = Z.shape[1]
    lib, large = _checked_library("settle_filter_loglik", y, T, RQR, Z, H, d)
    ll = torch.empty((Bn,), dtype=T.dtype, device=T.device)
    if Bn:
        ptrs = [X.data_ptr() for X in (T, RQR, Z, H, d, y, ll)]
        stream = _cuda.stream_handle(T.device)
        if large:
            work, nbytes = _large_workspace(lib, True, y, T, Z)
            code = lib.gcp_settle_filter_large(
                _cuda.dtype_code(T.dtype), *ptrs, work.data_ptr(), nbytes, Bn,
                n, k, n_settle, y.shape[0], lyap_iters, stream)
        else:
            code = lib.gcp_settle_filter(
                _cuda.dtype_code(T.dtype), *ptrs, Bn, n, k, n_settle,
                y.shape[0], lyap_iters, stream)
        _cuda.check(code, "settle_filter_loglik")
        _cuda.count_launch(settle_filter_loglik, large)
    return ll


def settle_filter_loglik(y, T, RQR, Z, H, d, n_settle: int = 32):
    """Fused settle + constant-gain Kalman log-likelihood: (Bn,) totals.

    ``y`` (n_total, k) is the whole fully observed sample, shared across the
    batch; the other inputs are :func:`settle_parts`'s.  ``n_settle`` exact
    Riccati steps, then the frozen-gain tail over the remaining
    observations; ``n_settle`` beyond the sample is the whole sample, as in
    the reference's ``steady_state_kalman_loglik``.
    """
    y, T, RQR, Z, H, d = (X.contiguous() for X in (y, T, RQR, Z, H, d))
    n_settle = min(int(n_settle), y.shape[0])
    if T.device.type == "cpu":
        return _settle_filter_plain(y, T, RQR, Z, H, d, n_settle, LYAP_ITERS)
    if T.device.type == "cuda":
        return _settle_filter_cuda(y, T, RQR, Z, H, d, n_settle, LYAP_ITERS)
    raise ValueError(f"settle_filter_loglik: no kernel for {T.device}")


#: launches of the CUDA kernel (either variant) since the count was last
#: set to 0, and of its large-state variant alone
settle_filter_loglik.launches = 0
settle_filter_loglik.large_launches = 0
