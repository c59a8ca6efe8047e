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
note says more).

Four tiers, all kernels, chosen by the shape and the device's shared
memory alone (:func:`cr_tier`), as the reference's kernels take any n:
``"small"``, that small-state kernel, wherever one draw's matrices fit a
block (n <= 48); ``"onchip"``, one draw a CTA of eight warps with its
matrices in the CTA's shared memory (the same schedule in seven n x n
blocks instead of eight, each elimination with a column a thread in
registers: n = 49..56 on an H100); ``"cluster"``, one draw a
thread-block cluster of up to 8 CTAs, each holding row panels of the
matrices, the products reading their peers' rows through distributed
shared memory and the eliminations in panels of ``CR_PANEL`` pivots
(:func:`~geconpy_torch.ops.linalg.gj_eliminate_panels`, the plain version
it is held to: n = 57..128); ``"workspace"``, beyond that, the same
recursion as the first two with each draw's buffers in a float64
workspace in device memory, allocated by the wrapper for the resident
draws of a persistent grid, its products and eliminations reading through
L1 and L2.  ``cycle_reduction_policy.large_launches`` and
``cycle_reduction.large_launches`` count the launches above the
small-state plan among ``launches``; ``onchip_launches``,
``cluster_launches`` and ``workspace_launches`` each tier's.  A launch the
card refuses raises; no tier stands in for another.  The TPU-only parts are gone: the Mosaic
identity embedding for n < 8 and the lane padding (neither changes T, R,
the residual or the success flag).  It takes and returns the caller's
dtype but runs the recursion in float64, and so does the plain version:
in float32 arithmetic the cycle reduction moved the SW-2007 sweep's
likelihood by up to 1.2e-3 relative over a 4096-draw batch (H100 run).

:func:`_cr_recursion` is the plain PyTorch version of both kernels' exact
schedule: the same doubling count, the same Gauss-Jordan with the
first-maximum pivot rule (:func:`~geconpy_torch.ops.linalg.gj_eliminate`,
or its panels for the cluster tier), the same flag reductions.  The wrappers use it for CPU tensors; a CUDA
tensor goes to the kernel or the wrapper raises.

Doublings: the wrappers' ``n_iter`` defaults to the reference's 16; the
sweep and the value+grad path pass ``CR_ITERS`` = 14
(``stats/statespace.py``), and so do the kernels' timings and bounds in
``chip_smoke.py`` and ``tools/cr_variants.py``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _cuda
from .linalg import gj_eliminate, gj_eliminate_panels
from .lyapunov import amax_abs
from .precision import highest_precision
from .tolerances import success_tol

__all__ = ["static_pivot_order", "cycle_reduction_policy", "cycle_reduction",
           "cr_tier", "CR_PANEL"]

#: a draw whose elimination met a smaller |pivot| is rejected
MIN_PIVOT = 1e-7

#: pivots a panel of the cluster tier's eliminations (``kCrPanel``)
CR_PANEL = 8

# The layouts below mirror csrc/cycle_reduction.cu's CrLayout and
# csrc/cycle_reduction_tiers.cu's CrOnchipLayout, CrClusterLayout and
# cr_cluster_plan, whose constants these are: a change there is a change
# here (tests/test_torch_cuda.py::test_cycle_reduction_tiers_follow_the_library
# holds the two sides together on a card).
#: scalars of a draw's shared memory (``kCrScal``, ``kCrOnScal`` of
#: ``csrc/cycle_reduction{,_tiers}.cu``; the on-chip tier's at its eight warps and
#: 56 rows a thread); the on-chip tier's largest n (``kCrOnRows``) and its
#: threads, one a column of the widest system (``kCrOnThreads``)
_CR_SCAL, _CR_ON_SCAL = 84, 8 + 3 * 8 + 3 * 56
_CR_ON_ROWS, _CR_ON_THREADS = 56, 256
#: the cluster tier's scalars a CTA (``kCrClScal``), its largest n and
#: cluster (``kClusterMaxCtas``)
_CR_CL_SCAL, _CR_CL_MAX_N, _CR_CL_MAX_CTAS = 1 + 2 * 8 + 5 + 3 * 8 + 3 * 8, \
    128, 8


def _ceil(v: int, q: int) -> int:
    return -(-v // q) * q


def cr_layout_bytes(n: int, m: int) -> dict:
    """Shared memory of one draw at (n, m) (m = 0: K4) in the small-state
    plan (``CrLayout``) and the on-chip tier (``CrOnchipLayout``), in
    bytes: the float64 tiles of ``ceil16(n)`` rows and ``ceil8(n) + 4``
    columns, the augmented system of three ``ceil8(n)`` blocks (or
    ``ceil8(n) + ceil8(m)`` columns, if wider) plus 4, and the scalars."""
    nr, n8 = _ceil(n, 16), _ceil(n, 8)
    tile = nr * (n8 + 4)
    aug = nr * (max(3 * n8, n8 + _ceil(m, 8)) + 4)
    small = 8 * tile if n <= 32 else 5 * tile + aug
    return {"small": 8 * (small + _CR_SCAL),
            "onchip": 8 * (4 * tile + aug + _CR_ON_SCAL)}


def cr_cluster_plan(n: int, m: int, smem_optin: int):
    """The cluster tier's cut at (n, m) (``cr_cluster_plan``): (CTAs a
    cluster, rows a CTA, bytes of a CTA's shared memory) for the fewest
    CTAs whose share of a draw fits ``smem_optin``; None where none of up
    to 8 does, or n > 128."""
    if not 1 <= n <= _CR_CL_MAX_N:
        return None
    nr, n8 = _ceil(n, 16), _ceil(n, 8)
    lda = max(3 * n8, n8 + _ceil(m, 8)) + 4
    tiles = nr // 16
    for c in range(2, _CR_CL_MAX_CTAS + 1):
        per = -(-tiles // c)
        rows = 16 * per
        total = (4 * rows * (n8 + 4) + rows * lda + _ceil(nr, rows)
                 * (CR_PANEL + 4) + CR_PANEL * lda + nr + _CR_CL_SCAL)
        if 8 * total <= smem_optin:
            return -(-tiles // per), rows, 8 * total
    return None


def cr_tier(n: int, m: int, smem_optin: int) -> str:
    """The tier K1 (``m`` columns of D) or K4 (``m = 0``) takes at an n x n
    pencil on a device whose blocks may have ``smem_optin`` bytes of shared
    memory: ``"small"`` where a draw of the small-state plan fits
    (``gcp_cr_fits``), ``"onchip"`` where a draw of the on-chip tier fits a
    CTA (with n <= 56, the rows its threads hold, and a thread for each
    column of its widest system), ``"cluster"`` where a draw split in row
    panels over at most 8 CTAs fits their shared memory
    (:func:`cr_cluster_plan`), else ``"workspace"``.  Nothing but these
    three numbers decides."""
    size = cr_layout_bytes(n, m)
    if size["small"] <= smem_optin:
        return "small"
    if n <= _CR_ON_ROWS and n + max(2 * n, m) <= _CR_ON_THREADS \
            and size["onchip"] <= smem_optin:
        return "onchip"
    if cr_cluster_plan(n, m, smem_optin) is not None:
        return "cluster"
    return "workspace"


def _count(wrapper, tier: str) -> None:
    _cuda.count_launch(wrapper, tier != "small", tier == "workspace")
    if tier in ("onchip", "cluster"):
        setattr(wrapper, f"{tier}_launches",
                getattr(wrapper, f"{tier}_launches") + 1)


def static_pivot_order(B_calib: np.ndarray) -> np.ndarray:
    """Host-side row ordering from one pivoted LU at the calibration point
    (``A[order]`` has nonzero leading pivots; kept for reduced early-step
    growth, the elimination pivots per draw regardless)."""
    import scipy.linalg as sla

    P, _, _ = sla.lu(np.asarray(B_calib, dtype=np.float64))
    return np.argmax(P.T, axis=1).astype(np.int32)


@highest_precision()
def _cr_policy_plain(A, B, C, D, n_iter: int, panel: int | None = None):
    """Plain PyTorch version of the K1 kernel: (T, R, flags (..., 3)); like
    the kernel it computes in float64 and returns the inputs' dtype.
    ``panel``: the cluster tier's schedule (:func:`_cr_recursion`)."""
    out = _cr_recursion(*(X.to(torch.float64) for X in (A, B, C, D)), n_iter,
                        panel)
    return tuple(X.to(A.dtype) for X in out)


@highest_precision()
def _cr_plain(A, B, C, n_iter: int, panel: int | None = None):
    """Plain PyTorch version of the K4 kernel: (T, flags (..., 2)); like
    the kernel it computes in float64 and returns the inputs' dtype.
    ``panel``: the cluster tier's schedule (:func:`_cr_recursion`)."""
    out = _cr_recursion(*(X.to(torch.float64) for X in (A, B, C)), None,
                        n_iter, panel)
    return tuple(X.to(A.dtype) for X in out)


def _cr_recursion(A, B, C, D, n_iter: int, panel: int | None = None):
    """The recursion the kernels share: ``n_iter`` doublings, then
    T = -Ahat^{-1} A.  Without ``D`` (K4): (T, [min|pivot|, tail]); with
    ``D`` (K1) also the selection R = -(B + C T)^{-1} D and the residual:
    (T, R, [min|pivot|, tail, max|A + B T + C T^2|]).  Every elimination
    is :func:`~geconpy_torch.ops.linalg.gj_eliminate`, or with ``panel``
    the cluster tier's :func:`~geconpy_torch.ops.linalg.gj_eliminate_panels`
    in panels of that many pivots."""
    def solve(L, RHS):
        if panel is None:
            return gj_eliminate(L, RHS)[:2]
        return gj_eliminate_panels(L, RHS, panel)

    n = A.shape[-1]
    A0, A1, A2, Ahat = A, B, C, B
    minpiv = torch.full(A.shape[:-2], float("inf"), dtype=A.dtype,
                        device=A.device)
    for _ in range(n_iter):
        sol, mp = solve(A1, torch.cat([A0, A2], dim=-1))
        Q0, Q2 = sol[..., :n], sol[..., n:]
        A1, Ahat, A0, A2 = (A1 - A0 @ Q2 - A2 @ Q0, Ahat - A2 @ Q0,
                            -(A0 @ Q0), -(A2 @ Q2))
        minpiv = torch.minimum(minpiv, mp)
    T, mp_final = solve(Ahat, -A)
    minpiv = torch.minimum(minpiv, mp_final)
    tail = amax_abs(A0) + amax_abs(A2)
    if D is None:
        return T, torch.stack([minpiv, tail], dim=-1)
    M = B + C @ T
    R, mp_sel = solve(M, -D)
    resid = amax_abs(A + M @ T)
    flags = torch.stack([torch.minimum(minpiv, mp_sel), tail, resid], dim=-1)
    return T, R, flags


def _launch(lib, tier: str, A, B, C, D, n_iter: int):
    """Launch K1 (``D`` given: (T, R, flags)) or K4 (``D`` None: (T, flags))
    of ``tier`` through its C entry point in ``lib``, with the
    device-memory tier's workspace.  The wrappers choose the tier
    (:func:`cr_tier`) and count the launch."""
    Bn, n, _ = A.shape
    m = 0 if D is None else D.shape[-1]
    new = lambda *shape: torch.empty(shape, dtype=A.dtype,  # noqa: E731
                                     device=A.device)
    select = D is not None
    outs = (new(Bn, n, n), new(Bn, n, m), new(Bn, 3)) if select else \
        (new(Bn, n, n), new(Bn, 2))
    if Bn:
        code = _cuda.dtype_code(A.dtype)
        ptrs = [X.data_ptr() for X in (A, B, C, *((D,) if select else ()),
                                       *outs)]
        dims = (Bn, n, m) if select else (Bn, n)
        stream = _cuda.stream_handle(A.device)
        entry = {"small": (lib.gcp_cr, lib.gcp_cr_policy),
                 "onchip": (lib.gcp_cr_onchip, lib.gcp_cr_policy_onchip),
                 "cluster": (lib.gcp_cr_cluster, lib.gcp_cr_policy_cluster),
                 "workspace": (lib.gcp_cr_large,
                               lib.gcp_cr_policy_large)}[tier][select]
        work = ()
        if tier == "workspace":
            nbytes = lib.gcp_cr_large_work_bytes(code, int(select), n, m, Bn)
            buf = _cuda.workspace(nbytes, A.device)
            work = (buf.data_ptr(), nbytes)
        rc = entry(code, *ptrs, *work, *dims, n_iter, stream)
        _cuda.check(rc, "cycle_reduction_policy" if select
                    else "cycle_reduction")
    return outs


def _cr_policy_cuda(A, B, C, D, n_iter: int):
    """Launch the K1 kernel of the tier the shape takes on A, B, C
    (Bn, n, n), D (Bn, n, m)."""
    Bn, n, _ = A.shape
    m = D.shape[-1]
    _cuda.require_cuda_inputs(
        "cycle_reduction_policy",
        {"A": (A, (Bn, n, n)), "B": (B, (Bn, n, n)), "C": (C, (Bn, n, n)),
         "D": (D, (Bn, n, m))}, A.dtype, A.device)
    lib = _cuda.library()
    tier = cr_tier(n, m, lib.gcp_smem_optin())
    outs = _launch(lib, tier, A, B, C, D, n_iter)
    if Bn:
        _count(cycle_reduction_policy, tier)
    return outs


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
    flags, never exceptions.  ``n_iter`` doublings: 16 by default, as the
    reference's; the sweep passes ``CR_ITERS`` = 14.
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


#: launches of the CUDA kernels (every tier) since the count was last set
#: to 0, of those above the small-state plan, and of each tier above it
cycle_reduction_policy.launches = 0
cycle_reduction_policy.large_launches = 0
cycle_reduction_policy.onchip_launches = 0
cycle_reduction_policy.cluster_launches = 0
cycle_reduction_policy.workspace_launches = 0


def _cr_cuda(A, B, C, n_iter: int):
    """Launch the K4 kernel of the tier the shape takes on A, B, C
    (Bn, n, n)."""
    Bn, n, _ = A.shape
    _cuda.require_cuda_inputs(
        "cycle_reduction",
        {"A": (A, (Bn, n, n)), "B": (B, (Bn, n, n)), "C": (C, (Bn, n, n))},
        A.dtype, A.device)
    lib = _cuda.library()
    tier = cr_tier(n, 0, lib.gcp_smem_optin())
    outs = _launch(lib, tier, A, B, C, None, n_iter)
    if Bn:
        _count(cycle_reduction, tier)
    return outs


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
    are flags, never exceptions.  ``n_iter`` doublings: 16 by default, as
    the reference's; the value+grad path passes ``CR_ITERS`` = 14.
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


#: launches of the CUDA kernels (every tier) since the count was last set
#: to 0, of those above the small-state plan, and of each tier above it
cycle_reduction.launches = 0
cycle_reduction.large_launches = 0
cycle_reduction.onchip_launches = 0
cycle_reduction.cluster_launches = 0
cycle_reduction.workspace_launches = 0
