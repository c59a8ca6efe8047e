"""Batched cycle reduction: CUDA kernels K1 and K4 and their plain twin.

Mirrors ``geconpy_tpu/ops/pallas_cycle_reduction.py``:
``static_pivot_order`` (:37, host scipy, unchanged);
``pallas_cycle_reduction_policy`` (:309) as :func:`cycle_reduction_policy`
(K1, the forward sweep), with its success rule (tail < 200 eps, min |pivot|
> 1e-7, residual < ``success_tol(dtype, 1e-6)``, finite T and R); and
``pallas_cycle_reduction`` (:219) as :func:`cycle_reduction` (K4, the
value+grad path), with its success rule (tail < 200 eps, min |pivot| >
1e-7, finite T, ``:304-305``).  Both keep the static pivot order.

Kernel source note.  ``csrc/cycle_reduction.cu`` holds one kernel body for
both TPU kernels, with a compile-time switch for the selection tail: with
it, it replaces ``_cr_sel_kernel`` (``ops/pallas_cycle_reduction.py:176``,
K1); without it, ``_cr_kernel`` (``:145``, K4: T and the flags
[min |pivot|, tail] only).  On the H100 both are bound by the per-draw
dependent chain of small eliminations and products (~1.8 MFMA per draw at
n = 26, 14 doublings) in shared memory, not by device memory; the design
gives each draw four warps under a named barrier of their own, its
matrices resident in shared memory for the whole recursion, the products on
the FP64 tensor cores and, for n <= 32, the eliminations in registers: one
warp runs the pivots ahead while the other three apply them (the source's
note says more).  That small-state kernel runs wherever one draw's
matrices fit the device's shared memory (``gcp_cr_fits``: n <= 48); the
reference's kernels take any n, so beyond that a large-state kernel runs
the same recursion with each draw's buffers in a float64 workspace in
device memory, allocated by the wrapper for the resident draws of a
persistent grid, its products and eliminations reading through L1 and L2.
``cycle_reduction_policy.large_launches`` and
``cycle_reduction.large_launches`` count those launches among
``launches``.  The TPU-only parts are gone: the Mosaic
identity embedding for n < 8 and the lane padding (neither changes T, R,
the residual or the success flag).  It takes and returns the caller's
dtype but runs the recursion in float64, and so does the plain version:
in float32 arithmetic the cycle reduction moved the SW-2007 sweep's
likelihood by up to 1.2e-3 relative over a 4096-draw batch (H100 run).

:func:`_cr_recursion` is the plain PyTorch version of both kernels' exact
schedule: the same doubling count, the same Gauss-Jordan with the
first-maximum pivot rule (:func:`~geconpy_torch.ops.linalg.gj_eliminate`),
the same flag reductions.  The wrappers use it for CPU tensors; a CUDA
tensor goes to the kernel or the wrapper raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _cuda
from .linalg import gj_eliminate
from .lyapunov import amax_abs
from .precision import highest_precision
from .tolerances import success_tol

__all__ = ["static_pivot_order", "cycle_reduction_policy", "cycle_reduction"]

#: a draw whose elimination met a smaller |pivot| is rejected
MIN_PIVOT = 1e-7


def static_pivot_order(B_calib: np.ndarray) -> np.ndarray:
    """Host-side row ordering from one pivoted LU at the calibration point
    (``A[order]`` has nonzero leading pivots; kept for reduced early-step
    growth, the elimination pivots per draw regardless)."""
    import scipy.linalg as sla

    P, _, _ = sla.lu(np.asarray(B_calib, dtype=np.float64))
    return np.argmax(P.T, axis=1).astype(np.int32)


@highest_precision()
def _cr_policy_plain(A, B, C, D, n_iter: int):
    """Plain PyTorch version of the K1 kernel: (T, R, flags (..., 3)); like
    the kernel it computes in float64 and returns the inputs' dtype."""
    out = _cr_recursion(*(X.to(torch.float64) for X in (A, B, C, D)), n_iter)
    return tuple(X.to(A.dtype) for X in out)


@highest_precision()
def _cr_plain(A, B, C, n_iter: int):
    """Plain PyTorch version of the K4 kernel: (T, flags (..., 2)); like
    the kernel it computes in float64 and returns the inputs' dtype."""
    out = _cr_recursion(*(X.to(torch.float64) for X in (A, B, C)), None,
                        n_iter)
    return tuple(X.to(A.dtype) for X in out)


def _cr_recursion(A, B, C, D, n_iter: int):
    """The recursion both kernels share: ``n_iter`` doublings, then
    T = -Ahat^{-1} A.  Without ``D`` (K4): (T, [min|pivot|, tail]); with
    ``D`` (K1) also the selection R = -(B + C T)^{-1} D and the residual:
    (T, R, [min|pivot|, tail, max|A + B T + C T^2|])."""
    n = A.shape[-1]
    A0, A1, A2, Ahat = A, B, C, B
    minpiv = torch.full(A.shape[:-2], float("inf"), dtype=A.dtype,
                        device=A.device)
    for _ in range(n_iter):
        sol, mp, _ = gj_eliminate(A1, torch.cat([A0, A2], dim=-1))
        Q0, Q2 = sol[..., :n], sol[..., n:]
        A1, Ahat, A0, A2 = (A1 - A0 @ Q2 - A2 @ Q0, Ahat - A2 @ Q0,
                            -(A0 @ Q0), -(A2 @ Q2))
        minpiv = torch.minimum(minpiv, mp)
    T, mp_final, _ = gj_eliminate(Ahat, -A)
    minpiv = torch.minimum(minpiv, mp_final)
    tail = amax_abs(A0) + amax_abs(A2)
    if D is None:
        return T, torch.stack([minpiv, tail], dim=-1)
    M = B + C @ T
    R, mp_sel, _ = gj_eliminate(M, -D)
    resid = amax_abs(A + M @ T)
    flags = torch.stack([torch.minimum(minpiv, mp_sel), tail, resid], dim=-1)
    return T, R, flags


def _cr_policy_cuda(A, B, C, D, n_iter: int):
    """Launch the K1 kernel on A, B, C (Bn, n, n), D (Bn, n, m)."""
    Bn, n, _ = A.shape
    m = D.shape[-1]
    _cuda.require_cuda_inputs(
        "cycle_reduction_policy",
        {"A": (A, (Bn, n, n)), "B": (B, (Bn, n, n)), "C": (C, (Bn, n, n)),
         "D": (D, (Bn, n, m))}, A.dtype, A.device)
    lib = _cuda.library()
    # the small-state kernel where one draw fits the device's shared
    # memory, else the large-state one with its workspace in device memory
    large = not lib.gcp_cr_fits(n, m)
    T = torch.empty((Bn, n, n), dtype=A.dtype, device=A.device)
    R = torch.empty((Bn, n, m), dtype=A.dtype, device=A.device)
    flags = torch.empty((Bn, 3), dtype=A.dtype, device=A.device)
    if Bn:
        code_dt = _cuda.dtype_code(A.dtype)
        ptrs = [X.data_ptr() for X in (A, B, C, D, T, R, flags)]
        stream = _cuda.stream_handle(A.device)
        if large:
            nbytes = lib.gcp_cr_large_work_bytes(code_dt, 1, n, m, Bn)
            work = _cuda.workspace(nbytes, A.device)
            code = lib.gcp_cr_policy_large(code_dt, *ptrs, work.data_ptr(),
                                           nbytes, Bn, n, m, n_iter, stream)
        else:
            code = lib.gcp_cr_policy(code_dt, *ptrs, Bn, n, m, n_iter, stream)
        _cuda.check(code, "cycle_reduction_policy")
        _cuda.count_launch(cycle_reduction_policy, large)
    return T, R, flags


def cr_draws_per_block(n: int, m: int = 0) -> int:
    """Draws per block of the kernel's launch at (n, m) on the current
    device (m = 0: K4); each draw is 128 threads."""
    fn = _cuda.library().gcp_cr_draws_per_block
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return fn(n, m)


def cr_policy_raw(A, B, C, D, n_iter: int):
    """``(T, R, flags)`` from the kernel (CUDA tensors) or its plain version
    (CPU tensors); flags = [min|pivot|, tail, residual] per draw."""
    if A.device.type == "cpu":
        return _cr_policy_plain(A, B, C, D, n_iter)
    if A.device.type == "cuda":
        return _cr_policy_cuda(A, B, C, D, n_iter)
    raise ValueError(f"cycle_reduction_policy: no kernel for {A.device}")


def cycle_reduction_policy(A, B, C, D, order: np.ndarray | None = None,
                           n_iter: int = 16):
    """Batched full policy solve on the (reduced) pencil:
    (Bn, n, n) x3, (Bn, n, m) -> (T, R, success, resid).

    ``order`` pre-permutes the equations (see :func:`static_pivot_order`);
    the solvent is unchanged by it.  ``success`` folds the pivots, the tail
    contraction and the residual with dtype-aware thresholds; failures are
    flags, never exceptions.
    """
    dtype = A.dtype
    tol = 200 * float(torch.finfo(dtype).eps)
    resid_tol = float(success_tol(dtype, 1e-6))
    if order is not None:
        idx = torch.as_tensor(np.asarray(order, dtype=np.int64),
                              device=A.device)
        A, B, C, D = (X[..., idx, :] for X in (A, B, C, D))
    A, B, C, D = (X.contiguous() for X in (A, B, C, D))
    T, R, flags = cr_policy_raw(A, B, C, D, n_iter)
    minpiv, tail, resid = flags[:, 0], flags[:, 1], flags[:, 2]
    success = torch.isfinite(tail) & (tail < tol) & (minpiv > MIN_PIVOT) \
        & torch.isfinite(resid) & (resid < resid_tol) \
        & torch.isfinite(T).all(dim=(1, 2)) & torch.isfinite(R).all(dim=(1, 2))
    return T, R, success, resid


#: launches of the CUDA kernel (either variant) since the count was last
#: set to 0, and of its large-state variant alone
cycle_reduction_policy.launches = 0
cycle_reduction_policy.large_launches = 0


def _cr_cuda(A, B, C, n_iter: int):
    """Launch the K4 kernel on A, B, C (Bn, n, n)."""
    Bn, n, _ = A.shape
    _cuda.require_cuda_inputs(
        "cycle_reduction",
        {"A": (A, (Bn, n, n)), "B": (B, (Bn, n, n)), "C": (C, (Bn, n, n))},
        A.dtype, A.device)
    lib = _cuda.library()
    large = not lib.gcp_cr_fits(n, 0)
    T = torch.empty((Bn, n, n), dtype=A.dtype, device=A.device)
    flags = torch.empty((Bn, 2), dtype=A.dtype, device=A.device)
    if Bn:
        code_dt = _cuda.dtype_code(A.dtype)
        ptrs = [X.data_ptr() for X in (A, B, C, T, flags)]
        stream = _cuda.stream_handle(A.device)
        if large:
            nbytes = lib.gcp_cr_large_work_bytes(code_dt, 0, n, 0, Bn)
            work = _cuda.workspace(nbytes, A.device)
            code = lib.gcp_cr_large(code_dt, *ptrs, work.data_ptr(), nbytes,
                                    Bn, n, n_iter, stream)
        else:
            code = lib.gcp_cr(code_dt, *ptrs, Bn, n, n_iter, stream)
        _cuda.check(code, "cycle_reduction")
        _cuda.count_launch(cycle_reduction, large)
    return T, flags


def cr_raw(A, B, C, n_iter: int):
    """``(T, flags)`` from the K4 kernel (CUDA tensors) or its plain version
    (CPU tensors); flags = [min|pivot|, tail] per draw."""
    if A.device.type == "cpu":
        return _cr_plain(A, B, C, n_iter)
    if A.device.type == "cuda":
        return _cr_cuda(A, B, C, n_iter)
    raise ValueError(f"cycle_reduction: no kernel for {A.device}")


def cycle_reduction(A, B, C, order: np.ndarray | None = None,
                    n_iter: int = 16):
    """Batched cycle reduction on the (reduced) pencil, primal only:
    (Bn, n, n) x3 -> (T, success).

    ``order`` pre-permutes the equations (see :func:`static_pivot_order`);
    the solvent is unchanged by it.  ``success`` folds the pivots and the
    tail contraction with the dtype's threshold and a finite T; failures
    are flags, never exceptions.
    """
    tol = 200 * float(torch.finfo(A.dtype).eps)
    if order is not None:
        idx = torch.as_tensor(np.asarray(order, dtype=np.int64),
                              device=A.device)
        A, B, C = (X[..., idx, :] for X in (A, B, C))
    A, B, C = (X.contiguous() for X in (A, B, C))
    T, flags = cr_raw(A, B, C, n_iter)
    minpiv, tail = flags[:, 0], flags[:, 1]
    success = torch.isfinite(tail) & (tail < tol) & (minpiv > MIN_PIVOT) \
        & torch.isfinite(T).all(dim=(1, 2))
    return T, success


#: launches of the CUDA kernel (either variant) since the count was last
#: set to 0, and of its large-state variant alone
cycle_reduction.launches = 0
cycle_reduction.large_launches = 0
