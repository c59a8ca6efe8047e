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

Kernel source note.  ``csrc/settle.cu`` (with ``settle.cuh``, and the
larger tiers in ``settle_cluster.cu`` and ``settle_large.cu``) replaces the
TPU kernels ``_settle_kernel`` (``ops/pallas_settle.py:40``) and, compiled
with ``kFused``, ``_fused_kernel`` (``:108``).  On the H100 the work is bound on
paper by its operations (~3.5 MFMA per draw at n = 26, k = 7, 32 steps) and
in fact by the chain of ~290 dependent small products and eliminations per
draw.  The design: four warps per draw and several draws per block, each
draw with a barrier of its own; every matrix in shared memory, zero-padded
to whole 16 x 8 tiles, so that the products run as ``mma.sync m16n8k4`` in
float64 on the tensor cores with no bounds test; the k-sized Gauss-Jordan
elimination in one warp's registers; ``y`` staged once per block in shared
memory; the fused tail spread over the draw's warps.  ``csrc/settle.cuh``
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

Three tiers, all kernels, chosen by size alone, as the reference's
kernels take any n: where one draw's float64 layout and ``y`` fit the
device's shared memory (``gcp_settle_fits``; in float64 at k = 7, n <= 64
for K5 over 200 periods and n <= 72 for K2 over 32 settle steps on an
H100) the small-state kernel above runs.  Beyond that, where a draw split
in row panels over a thread-block cluster of at most 8 CTAs fits their
shared memory (``gcp_settle_cluster_fits``), the cluster kernel runs the
same schedule with each CTA holding its panel of T, P and the work
buffers and reading its peers' rows through distributed shared memory;
no draw buffer lives in device memory.  Beyond that too, the large-state
kernel runs the schedule with each draw's buffers in a float64 workspace
in device memory, which the wrapper allocates (``torch.empty``) for the
resident draws of a persistent grid, not for the batch (``chip_smoke.py``
phase 16 prints its size).  ``settle_parts.large_launches`` and
``settle_filter_loglik.large_launches`` count the launches above the
small-state plan among ``launches``, and ``workspace_launches`` those of
the device-memory tier alone.  A launch the card refuses raises; no tier
stands in for another.

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
    """Check a settle kernel's inputs; returns the kernel library and the
    tier that runs: ``"small"`` (one draw a block fits the device's shared
    memory), ``"cluster"`` (one draw a thread-block cluster fits) or
    ``"workspace"`` (the draw's buffers in device memory)."""
    Bn, n, _ = T.shape
    k = Z.shape[1]
    _cuda.require_cuda_inputs(
        name,
        {"y": (y, (y.shape[0], k)), "T": (T, (Bn, n, n)),
         "RQR": (RQR, (Bn, n, n)), "Z": (Z, (Bn, k, n)), "H": (H, (Bn, k, k)),
         "d": (d, (Bn, k))}, T.dtype, T.device)
    lib = _cuda.library()
    shape = (_cuda.dtype_code(T.dtype), n, k, y.shape[0])
    if lib.gcp_settle_fits(*shape):
        return lib, "small"
    return lib, "cluster" if lib.gcp_settle_cluster_fits(*shape) \
        else "workspace"


def _launch(lib, tier: str, fused: bool, y, T, RQR, Z, H, d, n_settle: int,
            lyap_iters: int):
    """Launch K2 (``fused`` false; ``y`` the settle's ``n_settle``
    observations) or K5 of ``tier`` through its C entry point in ``lib``,
    with the device-memory tier's workspace; returns the outputs.  The
    wrappers choose the tier (``_checked_library``) and count the launch."""
    Bn, n, _ = T.shape
    k = Z.shape[1]
    new = lambda *shape: torch.empty(shape, dtype=T.dtype,  # noqa: E731
                                     device=T.device)
    outs = (new(Bn),) if fused else (new(Bn), new(Bn, n), new(Bn, n, n),
                                     new(Bn, n, k), new(Bn, k, k), new(Bn))
    if Bn:
        code = _cuda.dtype_code(T.dtype)
        entry = {"small": (lib.gcp_settle, lib.gcp_settle_filter),
                 "cluster": (lib.gcp_settle_cluster,
                             lib.gcp_settle_filter_cluster),
                 "workspace": (lib.gcp_settle_large,
                               lib.gcp_settle_filter_large)}[tier][fused]
        work = ()
        if tier == "workspace":
            nbytes = lib.gcp_settle_large_work_bytes(code, int(fused), n, k,
                                                     y.shape[0], Bn)
            buf = _cuda.workspace(nbytes, T.device)
            work = (buf.data_ptr(), nbytes)
        dims = (Bn, n, k, n_settle) + ((y.shape[0],) if fused else ())
        rc = entry(code, *(X.data_ptr() for X in (T, RQR, Z, H, d, y, *outs)),
                   *work, *dims, lyap_iters, _cuda.stream_handle(T.device))
        _cuda.check(rc, "settle_filter_loglik" if fused else "settle_parts")
    return outs[0] if fused else outs


def _settle_cuda(y_head, T, RQR, Z, H, d, lyap_iters: int):
    """Launch the K2 kernel of the tier the shape takes."""
    lib, tier = _checked_library("settle_parts", y_head, T, RQR, Z, H, d)
    outs = _launch(lib, tier, False, y_head, T, RQR, Z, H, d,
                   y_head.shape[0], lyap_iters)
    if T.shape[0]:
        _cuda.count_launch(settle_parts, tier != "small", tier == "workspace")
    return outs


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


#: launches of the CUDA kernel (any tier) since the count was last set to
#: 0, of the tiers above the small-state plan, and of the device-memory
#: tier alone
settle_parts.launches = 0
settle_parts.large_launches = 0
settle_parts.workspace_launches = 0


def _settle_filter_cuda(y, T, RQR, Z, H, d, n_settle: int, lyap_iters: int):
    """Launch the K5 kernel of the tier the shape takes."""
    lib, tier = _checked_library("settle_filter_loglik", y, T, RQR, Z, H, d)
    ll = _launch(lib, tier, True, y, T, RQR, Z, H, d, n_settle, lyap_iters)
    if T.shape[0]:
        _cuda.count_launch(settle_filter_loglik, tier != "small",
                           tier == "workspace")
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


#: launches of the CUDA kernel (any tier) since the count was last set to
#: 0, of the tiers above the small-state plan, and of the device-memory
#: tier alone
settle_filter_loglik.launches = 0
settle_filter_loglik.large_launches = 0
settle_filter_loglik.workspace_launches = 0
