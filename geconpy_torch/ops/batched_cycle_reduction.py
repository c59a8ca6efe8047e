"""Batched cycle-reduction policy solve: CUDA kernel K1 and its plain twin.

Mirrors ``geconpy_tpu/ops/pallas_cycle_reduction.py``:
``static_pivot_order`` (:37, host scipy, unchanged) and
``pallas_cycle_reduction_policy`` (:309) as :func:`cycle_reduction_policy`,
with the same success rule (tail < 200 eps, min |pivot| > 1e-7, residual <
``success_tol(dtype, 1e-6)``, finite T and R).

Kernel source note.  ``csrc/cycle_reduction.cu`` replaces the TPU kernel
``_cr_sel_kernel`` (``ops/pallas_cycle_reduction.py:176``).  On the H100 it
is bound by the per-draw dependent chain of small eliminations and products
(~2.3 MFMA per draw at n = 26, 14 doublings) in shared memory, not by device
memory; the design gives each draw one thread block with all matrices
resident in shared memory for the whole recursion.  The TPU-only parts
are gone: the Mosaic identity embedding for n < 8 and the lane padding
(neither changes T, R, the residual or the success flag).  It takes and
returns the caller's dtype but runs the recursion in float64, and so does
the plain version: in float32 arithmetic the cycle reduction moved the
SW-2007 sweep's likelihood by up to 1.2e-3 relative over a 4096-draw batch
(H100 run).

:func:`gj_solve` and :func:`_cr_policy_plain` are the plain PyTorch version
of the kernel's exact schedule: the same doubling count, the same
Gauss-Jordan with the first-maximum pivot rule, the same flag reductions.
The wrapper uses it for CPU tensors; a CUDA tensor goes to the kernel or the
wrapper raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .precision import highest_precision
from .tolerances import success_tol

__all__ = ["static_pivot_order", "gj_solve", "cycle_reduction_policy"]

#: a draw whose elimination met a smaller |pivot| is rejected
MIN_PIVOT = 1e-7


def static_pivot_order(B_calib: np.ndarray) -> np.ndarray:
    """Host-side row ordering from one pivoted LU at the calibration point
    (``A[order]`` has nonzero leading pivots; kept for reduced early-step
    growth, the elimination pivots per draw regardless)."""
    import scipy.linalg as sla

    P, _, _ = sla.lu(np.asarray(B_calib, dtype=np.float64))
    return np.argmax(P.T, axis=1).astype(np.int32)


def gj_solve(A: torch.Tensor, RHS: torch.Tensor):
    """Partially pivoted Gauss-Jordan, batched:
    (..., n, n), (..., n, m) -> (A^{-1} RHS, min|pivot|, log|det A|).

    Step k picks the first maximal |aug[i, k]| over rows i >= k (argmax
    takes the first maximum; NaN counts as largest), swaps rows k and p,
    divides the pivot row by the pivot and eliminates it from every other
    row over all columns — the schedule of ``_gj_solve``
    (``pallas_cycle_reduction.py:90``) and of ``csrc/small_linalg.cuh``.
    """
    aug = torch.cat([A, RHS], dim=-1)
    n = A.shape[-1]
    batch = aug.shape[:-2]
    rows = torch.arange(n, device=A.device)
    minpiv = torch.full(batch, float("inf"), dtype=A.dtype, device=A.device)
    logdet = torch.zeros(batch, dtype=A.dtype, device=A.device)
    for k in range(n):
        colk = aug[..., :, k]
        mag = torch.where(rows >= k, colk.abs(), torch.full_like(colk, -1.0))
        p = torch.argmax(mag, dim=-1)
        pmask = rows == p[..., None]
        row_p = torch.take_along_dim(aug, p[..., None, None], dim=-2)[..., 0, :]
        row_k = aug[..., k, :]
        # swap rows k and p (identical writes when p == k)
        swapped = torch.where(pmask[..., None], row_k[..., None, :], aug)
        swapped[..., k, :] = row_p
        piv = row_p[..., k]
        r = row_p / piv[..., None]
        # column k after the swap: entry p picks up the old aug[k, k]
        col = torch.where(pmask, colk[..., k:k + 1], colk)
        col = torch.where(rows == k, torch.zeros_like(col), col)
        aug = swapped - col[..., :, None] * r[..., None, :]
        aug[..., k, :] = r
        minpiv = torch.minimum(minpiv, piv.abs())
        logdet = logdet + torch.log(piv.abs())
    return aug[..., n:], minpiv, logdet


def _amax_abs(M: torch.Tensor) -> torch.Tensor:
    return torch.amax(M.abs(), dim=(-2, -1))


@highest_precision()
def _cr_policy_plain(A, B, C, D, n_iter: int):
    """Plain PyTorch version of the K1 kernel: (T, R, flags (..., 3)); like
    the kernel it computes in float64 and returns the inputs' dtype."""
    out = _cr_recursion(*(X.to(torch.float64) for X in (A, B, C, D)), n_iter)
    return tuple(X.to(A.dtype) for X in out)


def _cr_recursion(A, B, C, D, n_iter: int):
    n = A.shape[-1]
    A0, A1, A2, Ahat = A, B, C, B
    minpiv = torch.full(A.shape[:-2], float("inf"), dtype=A.dtype,
                        device=A.device)
    for _ in range(n_iter):
        sol, mp, _ = gj_solve(A1, torch.cat([A0, A2], dim=-1))
        Q0, Q2 = sol[..., :n], sol[..., n:]
        A1, Ahat, A0, A2 = (A1 - A0 @ Q2 - A2 @ Q0, Ahat - A2 @ Q0,
                            -(A0 @ Q0), -(A2 @ Q2))
        minpiv = torch.minimum(minpiv, mp)
    T, mp_final, _ = gj_solve(Ahat, -A)
    M = B + C @ T
    R, mp_sel, _ = gj_solve(M, -D)
    resid = _amax_abs(A + M @ T)
    tail = _amax_abs(A0) + _amax_abs(A2)
    flags = torch.stack([torch.minimum(torch.minimum(minpiv, mp_final),
                                       mp_sel), tail, resid], dim=-1)
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
    smem = lib.gcp_cr_policy_smem_bytes(n, m)
    if smem > _cuda.smem_limit(A.device):
        raise ValueError(
            f"cycle_reduction_policy: n={n}, m={m} in {A.dtype} needs {smem} "
            f"bytes of shared memory per block, above the device's "
            f"{_cuda.smem_limit(A.device)}")
    T = torch.empty((Bn, n, n), dtype=A.dtype, device=A.device)
    R = torch.empty((Bn, n, m), dtype=A.dtype, device=A.device)
    flags = torch.empty((Bn, 3), dtype=A.dtype, device=A.device)
    if Bn:
        code = lib.gcp_cr_policy(
            _cuda.dtype_code(A.dtype), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), T.data_ptr(), R.data_ptr(),
            flags.data_ptr(), Bn, n, m, n_iter, _cuda.stream_handle(A.device))
        _cuda.check(code, "cycle_reduction_policy")
        cycle_reduction_policy.launches += 1
    return T, R, flags


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


#: launches of the CUDA kernel since the count was last set to 0
cycle_reduction_policy.launches = 0
