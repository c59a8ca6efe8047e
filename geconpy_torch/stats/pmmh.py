"""Particle-marginal Metropolis-Hastings, chains batched.

Mirrors ``geconpy_tpu/stats/pmmh.py`` (``PMMHResult`` :34, ``sample_pmmh``
:41).  The particle filter's likelihood estimate is unbiased, so the
random-walk Metropolis chain on it targets the exact posterior of the
pruned second-order model (Andrieu-Doucet-Holenstein 2010).  Every chain
proposes at once: one batched likelihood call an iteration.  The proposal
scale is tuned per chain by Robbins-Monro toward ``target_accept`` in
warmup only; a NaN acceptance ratio (both points at -inf) counts as
neutral.  The chain keeps the likelihood estimate of its current point.

The random numbers come from one ``torch.Generator``: each iteration draws
the proposals' standard normals (chains, dim), then the likelihood's own
draws (inside ``loglik_fn``), then the acceptance uniforms (chains,).  The
private core :func:`_pmmh` takes these as callables, so the same sampler
runs on given draws.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["PMMHResult", "sample_pmmh"]


class PMMHResult(NamedTuple):
    samples: torch.Tensor       # (chains, draws, dim) unconstrained
    loglik: torch.Tensor        # (chains, draws) estimate at each draw
    accept_rate: torch.Tensor   # (chains,)
    scale: torch.Tensor         # (chains,) final proposal scale


@torch.no_grad()
def _pmmh(logpost_parts: Callable, q0: torch.Tensor, normals: Callable,
          uniforms: Callable, num_warmup: int, num_samples: int,
          initial_scale: float, target_accept: float) -> PMMHResult:
    """The sampler on ``logpost_parts(U) -> (loglik, logprior)`` (gated:
    -inf where either failed) and the random numbers ``normals()``
    (chains, dim) and ``uniforms()`` (chains,) of each iteration."""
    n_chains = q0.shape[0]
    dtype = q0.dtype
    q = q0
    ll, lp = logpost_parts(q)
    scale = torch.full((n_chains,), initial_scale, dtype=dtype,
                       device=q0.device)
    acc_sum = torch.zeros_like(scale)
    qs, lls = [], []
    for it in range(num_warmup + num_samples):
        prop = q + scale[:, None] * normals()
        ll_p, lp_p = logpost_parts(prop)
        log_ratio = (ll_p + lp_p) - (ll + lp)
        accept = torch.log(uniforms()) < log_ratio
        q = torch.where(accept[:, None], prop, q)
        ll = torch.where(accept, ll_p, ll)
        lp = torch.where(accept, lp_p, lp)
        in_warmup = it < num_warmup
        alpha = torch.clamp(torch.exp(log_ratio), max=1.0)
        alpha = torch.where(torch.isfinite(alpha), alpha,
                            torch.full_like(alpha, target_accept))
        eta = 1.0 / torch.sqrt(torch.tensor(1.0 + it, dtype=dtype))
        step = eta * (alpha - target_accept) if in_warmup \
            else torch.zeros_like(alpha)
        scale = torch.exp(torch.log(scale) + step)
        if not in_warmup:
            acc_sum = acc_sum + accept.to(dtype)
        qs.append(q)
        lls.append(ll)
    samples = torch.stack(qs[num_warmup:], dim=1)
    logliks = torch.stack(lls[num_warmup:], dim=1)
    return PMMHResult(samples, logliks, acc_sum / num_samples, scale)


def sample_pmmh(loglik_fn: Callable, logprior_fn: Callable,
                initial_position: torch.Tensor, generator: torch.Generator,
                num_warmup: int = 500, num_samples: int = 1000,
                initial_scale: float = 0.1, target_accept: float = 0.234,
                segment_size: int | None = None) -> PMMHResult:
    """Run PMMH chains batched along the first dimension of
    ``initial_position`` (chains, dim), on its device and in its dtype.

    ``loglik_fn(U (chains, dim), generator) -> (loglik, success)``, e.g.
    ``DSGEStateSpace.build_pf_loglik_second_order(data)``, is called once
    an iteration for every chain's proposal with the sampler's
    ``generator``; ``logprior_fn(U) -> (chains,)`` is the log prior in the
    unconstrained space (with the transforms' Jacobians).  Start the chains
    at finite-posterior points.  ``segment_size`` changes nothing (every
    iteration already returns to the host).  Returns draws in the
    unconstrained space."""
    q0 = initial_position
    shape = q0.shape

    def parts(U):
        ll, ok = loglik_fn(U, generator)
        ll = ll.to(U.dtype)
        lp = logprior_fn(U).to(U.dtype)
        ok = ok & torch.isfinite(ll) & torch.isfinite(lp)
        neg = torch.full_like(ll, -torch.inf)
        return torch.where(ok, ll, neg), torch.where(ok, lp, neg)

    def normals():
        return torch.randn(shape, generator=generator, dtype=q0.dtype,
                           device=q0.device)

    def uniforms():
        return torch.rand(shape[:1], generator=generator, dtype=q0.dtype,
                          device=q0.device)

    return _pmmh(parts, q0, normals, uniforms, num_warmup, num_samples,
                 initial_scale, target_accept)
