"""Batched DARE settle: CUDA kernel K6 and its plain twin.

Mirrors ``geconpy_tpu/ops/pallas_dare.py:76`` (``pallas_dare_settle``) as
:func:`dare_settle`: the predictive-covariance fixed point P of the
discrete algebraic Riccati equation per draw, by the same fixed schedule —
a Lyapunov start of ``LYAP_ITERS`` doublings from (T, RQR), the open-loop
unconditional covariance, then ``HEWER_ITERS`` Hewer polishes, each a
pivoted Gauss-Jordan inverse of S = Z P Zᵀ + H, the predictive gain
Kp = T P Zᵀ S⁻¹, the closed loop A_cl = T − Kp Z, the noise
Q_c = sym(RQR + Kp H Kpᵀ) and ``INNER_ITERS`` doublings of (A_cl, Q_c).
Primal only: gradients re-attach at the fixed point through the implicit
DARE adjoint (``ops/kalman.py::_ImplicitDareP``), and the caller gates
convergence with ``dare_residual_settled``, since the schedule cannot stop
early per draw.

Kernel source note.  ``csrc/dare.cu`` replaces the TPU kernel
``_dare_kernel`` (``ops/pallas_dare.py:37``).  On the H100 it is bound by
the per-draw chain of 140 dependent doublings (~7.4M multiply-adds per
draw at n = 26), not by device memory.  The design gives each draw one
block of four warps and keeps its matrices in shared memory, zero-padded
to whole tiles: every product runs on the FP64 tensor cores
(``tile_mm``), a doubling takes two barriers (A P and A A in one phase,
P += (A P) A' in the next), S⁻¹ is one warp's Gauss-Jordan elimination
(in registers for k <= 8), and RQR is added from device memory in an
epilogue, so that a draw needs five n × n buffers (52,224 B at n = 26,
k = 7: four draws an SM).  That small-state kernel runs wherever one
draw's buffers fit the device's shared memory (``gcp_dare_fits``: n <= 64
at k = 7); the reference's kernel takes any n, so two more tiers run the
same schedule, chosen by size alone (:func:`dare_tier`, which asks the
kernel library).  Where a draw split in 32-row panels over a thread-block
cluster of at most 8 CTAs fits their shared memory
(``gcp_dare_cluster_fits``), the cluster kernel runs it with each CTA
holding its rows of T, P, the doubling matrix and the two work buffers and
reading its peers' rows through distributed shared memory; no draw buffer
lives in device memory, and the sums run in the other tiers' order.
Beyond that, the device-memory kernel keeps each draw's buffers in a
float64 workspace, allocated by the wrapper (``torch.empty``) for the
resident blocks of a persistent grid (``chip_smoke.py`` phase 16 prints
its size), its products reading their operands through L1 and L2.
``dare_settle.large_launches`` counts the launches above the small-state
plan among ``launches``, and ``workspace_launches`` those of the
device-memory tier alone.  A launch the card refuses raises; no tier
stands in for another.  The TPU wrapper's lane padding (H = I in the
padded slots) has no counterpart: the small-state grid is exactly one
block per draw, and the larger tiers' grids stride over the draws.
It takes and returns the caller's dtype but runs the recursion in float64,
as the settle kernel K2 does, and so does the plain version.

:func:`_dare_recursion` is the plain PyTorch version of the same schedule.
The wrapper uses it for CPU tensors; a CUDA tensor goes to the kernel or
the wrapper raises.
"""

from __future__ import annotations

import torch

from . import _cuda
from .linalg import gj_eliminate
from .precision import highest_precision

__all__ = ["dare_settle", "LYAP_ITERS", "HEWER_ITERS", "INNER_ITERS"]

#: the reference's fixed schedule (``pallas_dare.py:77-78``): 2^12 periods
#: of Lyapunov start, 8 Hewer polishes of 2^16-period inner doublings
LYAP_ITERS, HEWER_ITERS, INNER_ITERS = 12, 8, 16


def _sym(X: torch.Tensor) -> torch.Tensor:
    return 0.5 * (X + X.mT)


def _lyap(A, P, iters: int):
    for _ in range(iters):
        P = P + (A @ P) @ A.mT
        A = A @ A
    return P


def _dare_recursion(T, RQR, Z, H, lyap_iters: int, hewer_iters: int,
                    inner_iters: int):
    k = Z.shape[-2]
    eye_k = torch.eye(k, dtype=T.dtype, device=T.device).expand(H.shape)
    # K = 0 start: the unconditional covariance of the stable transition
    P = _lyap(T, RQR, lyap_iters)
    for _ in range(hewer_iters):
        PZt = P @ Z.mT
        Sinv = gj_eliminate(Z @ PZt + H, eye_k)[0]
        Kp = T @ (PZt @ Sinv)
        A_cl = T - Kp @ Z
        Qc = _sym(RQR + (Kp @ H) @ Kp.mT)
        P = _sym(_lyap(A_cl, Qc, inner_iters))
    return P


@highest_precision()
def _dare_plain(T, RQR, Z, H, lyap_iters: int = LYAP_ITERS,
                hewer_iters: int = HEWER_ITERS, inner_iters: int = INNER_ITERS):
    """Plain PyTorch version of the K6 kernel (batch-first); like the kernel
    it computes in float64 and returns the inputs' dtype."""
    P = _dare_recursion(*(X.to(torch.float64) for X in (T, RQR, Z, H)),
                        lyap_iters, hewer_iters, inner_iters)
    return P.to(T.dtype)


def dare_tier(lib, n: int, k: int) -> str:
    """The tier of K6 that the wrapper takes for n states and k observables
    on the current device, asked of the kernel library ``lib``:
    ``"small"`` (one draw a block fits the device's shared memory),
    ``"cluster"`` (one draw a thread-block cluster fits) or
    ``"workspace"`` (the draw's buffers in device memory)."""
    if lib.gcp_dare_fits(n, k):
        return "small"
    return "cluster" if lib.gcp_dare_cluster_fits(n, k) else "workspace"


def _launch(lib, tier: str, T, RQR, Z, H):
    """Launch K6 of ``tier`` through its C entry point in ``lib`` on
    checked inputs, with the device-memory tier's workspace; returns P.
    The wrapper chooses the tier (:func:`dare_tier`) and counts the
    launch; this does neither."""
    Bn, n, _ = T.shape
    k = Z.shape[1]
    P = torch.empty((Bn, n, n), dtype=T.dtype, device=T.device)
    if Bn:
        code = _cuda.dtype_code(T.dtype)
        ptrs = [X.data_ptr() for X in (T, RQR, Z, H, P)]
        sched = (LYAP_ITERS, HEWER_ITERS, INNER_ITERS)
        stream = _cuda.stream_handle(T.device)
        if tier == "workspace":
            nbytes = lib.gcp_dare_large_work_bytes(code, n, k, Bn)
            work = _cuda.workspace(nbytes, T.device)
            rc = lib.gcp_dare_large(code, *ptrs, work.data_ptr(), nbytes, Bn,
                                    n, k, *sched, stream)
        else:
            rc = {"small": lib.gcp_dare, "cluster": lib.gcp_dare_cluster}[
                tier](code, *ptrs, Bn, n, k, *sched, stream)
        _cuda.check(rc, "dare_settle")
    return P


def _dare_cuda(T, RQR, Z, H):
    """Launch the K6 kernel of the tier the shape takes."""
    Bn, n, _ = T.shape
    k = Z.shape[1]
    _cuda.require_cuda_inputs(
        "dare_settle",
        {"T": (T, (Bn, n, n)), "RQR": (RQR, (Bn, n, n)), "Z": (Z, (Bn, k, n)),
         "H": (H, (Bn, k, k))}, T.dtype, T.device)
    lib = _cuda.library()
    tier = dare_tier(lib, n, k)
    P = _launch(lib, tier, T, RQR, Z, H)
    if Bn:
        _cuda.count_launch(dare_settle, tier != "small", tier == "workspace")
    return P


def dare_settle(T, RQR, Z, H) -> torch.Tensor:
    """Batched predictive DARE fixed point: T, RQR (Bn, n, n), Z (Bn, k, n),
    H (Bn, k, k) -> P (Bn, n, n), by the fixed schedule above."""
    T, RQR, Z, H = (X.contiguous() for X in (T, RQR, Z, H))
    if T.device.type == "cpu":
        return _dare_plain(T, RQR, Z, H)
    if T.device.type == "cuda":
        return _dare_cuda(T, RQR, Z, H)
    raise ValueError(f"dare_settle: no kernel for {T.device}")


#: launches of the CUDA kernel (any tier) since the count was last set to
#: 0, of the tiers above the small-state plan, and of the device-memory
#: tier alone
dare_settle.launches = 0
dare_settle.large_launches = 0
dare_settle.workspace_launches = 0
