"""Systematic resampling of a weighted particle cloud.

Mirrors ``geconpy_tpu/ops/particle_filter.py:53-66``
(``systematic_resample``).  The ancestor indices are a pure function of the
log-weights and one uniform offset (:func:`systematic_resample_indices`);
:func:`systematic_resample` draws the offset from an explicit
``torch.Generator`` and gathers the particles.  The bootstrap particle
filter of that file is not ported yet (ROADMAP Queue 1 item 8.6).
"""

from __future__ import annotations

import torch

__all__ = ["systematic_resample", "systematic_resample_indices"]


def systematic_resample_indices(log_w: torch.Tensor, u: torch.Tensor
                                ) -> torch.Tensor:
    """Ancestor indices (N,) for log-weights ``log_w`` (N,) and an offset
    ``u`` in [0, 1): the N points (u + i) / N are placed on the weights'
    cumulative distribution."""
    n = log_w.shape[0]
    cdf = torch.cumsum(torch.softmax(log_w, dim=0), dim=0)
    points = (u + torch.arange(n, dtype=cdf.dtype, device=cdf.device)) / n
    idx = torch.searchsorted(cdf, points, right=True)
    return idx.clamp(0, n - 1)


def systematic_resample(generator: torch.Generator, log_w: torch.Tensor,
                        particles: tuple[torch.Tensor, ...]
                        ) -> tuple[torch.Tensor, ...]:
    """Systematic (low-variance) resampling: one uniform offset from
    ``generator`` (on ``log_w``'s device), then every tensor of
    ``particles`` gathered along its first dimension."""
    u = torch.rand((), generator=generator, device=log_w.device,
                   dtype=log_w.dtype)
    idx = systematic_resample_indices(log_w, u)
    return tuple(p[idx] for p in particles)
