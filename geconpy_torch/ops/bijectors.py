"""Bijective reparameterizations for constrained steady-state variables.

Mirrors ``geconpy_tpu/ops/bijectors.py`` (``VectorBijector``,
``make_bijector``): variables with sign assumptions from the GCN
``assumptions`` block map to an unconstrained space elementwise.  The codes
are a host-side integer tuple; ``forward``/``inverse`` take tensors with the
element dimension last (any leading batch dimensions).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["VectorBijector", "make_bijector", "IDENTITY", "LOG", "NEG_LOG"]

_CODES: dict = {}

IDENTITY = 0   # x = u
LOG = 1        # x = exp(u)      (positive variables)
NEG_LOG = 2    # x = -exp(u)     (negative variables)


class VectorBijector(NamedTuple):
    """Elementwise map between unconstrained u and constrained x."""

    kinds: tuple[int, ...]  # one code per element

    def _codes(self, like: torch.Tensor) -> torch.Tensor:
        # one host-to-device copy per (codes, device): a copy inside a
        # root finder's iterations would wait for the launch queue
        key = (self.kinds, like.device)
        if key not in _CODES:
            _CODES[key] = torch.as_tensor(self.kinds, dtype=torch.int64,
                                          device=like.device)
        return _CODES[key]

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        """Unconstrained R^n -> constrained values (elementwise)."""
        kinds = self._codes(u)
        x = torch.where(kinds == LOG, torch.exp(u), u)
        return torch.where(kinds == NEG_LOG, -torch.exp(u), x)

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        """Constrained values -> unconstrained R^n (elementwise)."""
        kinds = self._codes(x)
        one = torch.ones_like(x)
        safe_pos = torch.log(torch.where(kinds == LOG,
                                         torch.clamp(x, min=1e-300), one))
        safe_neg = torch.log(torch.where(kinds == NEG_LOG,
                                         torch.clamp(-x, min=1e-300), one))
        u = torch.where(kinds == LOG, safe_pos, x)
        return torch.where(kinds == NEG_LOG, safe_neg, u)


def make_bijector(assumption_dicts: list[dict]) -> VectorBijector:
    """Build the per-element transform codes from sympy assumption dicts."""
    kinds = []
    for assumptions in assumption_dicts:
        if assumptions.get("positive"):
            kinds.append(LOG)
        elif assumptions.get("negative"):
            kinds.append(NEG_LOG)
        else:
            kinds.append(IDENTITY)
    return VectorBijector(tuple(kinds))
