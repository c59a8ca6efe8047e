"""Matmul-precision guard for numeric code.

Mirrors ``geconpy_tpu/ops/precision.py`` (``highest_precision``).  On the
TPU, float32 matmuls default to bfloat16 passes; on Hopper the analogue is
TF32, which keeps about three decimal digits.  PyTorch already runs float32
matmuls in full float32 by default, but float32 convolutions go through
cuDNN in TF32, and a caller may have switched either on.  Iterative solvers
(cycle reduction, Lyapunov doubling, Riccati steps) do not converge in
float32 with TF32, so ``highest_precision`` sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False`` for its extent and restores
both afterwards.  It works as a context manager and as a decorator.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["highest_precision"]


class highest_precision(contextlib.ContextDecorator):
    """TF32 off (CUDA matmul and cuDNN) inside the block."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def _recreate_cm(self):
        # a fresh instance per decorated call, so nested uses restore
        # their own saved flags
        return type(self)()

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved
        return False
