"""Dtype-aware numeric tolerances.

Mirrors ``geconpy_tpu/ops/tolerances.py`` (``success_tol``) unchanged:
success thresholds scale with machine epsilon so the same pipeline is
correct in float64 (tests, parity) and float32 (the GPU sweep).
"""

import numpy as np
import torch

__all__ = ["success_tol"]


def success_tol(dtype, base: float = 1e-8, eps_multiple: float = 1000.0) -> float:
    """max(base, eps_multiple * machine-eps(dtype)):
    float64 -> base (strict); float32 -> ~1.2e-4."""
    if isinstance(dtype, torch.dtype):
        eps = float(torch.finfo(dtype).eps)
    else:
        eps = float(np.finfo(np.dtype(dtype)).eps)
    return max(float(base), eps_multiple * eps)
