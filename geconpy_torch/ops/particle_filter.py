"""Bootstrap particle filter with systematic resampling, batched over
parameter draws as well as particles.

Mirrors ``geconpy_tpu/ops/particle_filter.py``: ``ParticleFilterResult``
(:45), ``systematic_resample`` (:53) and ``particle_filter_loglik``
(:70).  The particles of every draw are one (..., N, n) tensor; a step
propagates them with one call of the batched ``transition(x (..., N, n),
eps (..., N, q))`` and weights them with one masked Gaussian density whose
factorization every particle of a draw shares.  Resampling is adaptive
(where the ESS is below ``ess_threshold`` N, a masked select per draw) and
systematic: one uniform offset a draw, ancestors by ``torch.searchsorted``
on the batched weight CDF.  The log-likelihood increment is
logsumexp(log w_new) - logsumexp(log w), the unbiased estimator of the
marginal likelihood.  A non-finite increment counts as zero and flips that
draw's ``success``, never raising.

The random numbers come from an explicit ``torch.Generator``; the private
core :func:`_particle_filter` takes a callable that returns each period's
standard normals and uniform offsets, so the same filter runs on given
draws.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .kalman import _chol_nan
from .precision import highest_precision

__all__ = ["ParticleFilterResult", "particle_filter_loglik",
           "systematic_resample", "systematic_resample_indices"]

_LOG2PI = 1.8378770664093453


class ParticleFilterResult(NamedTuple):
    loglik: torch.Tensor          # (...,) log marginal likelihood estimate
    loglik_t: torch.Tensor        # (..., periods) increments
    ess_t: torch.Tensor           # (..., periods) ESS before resampling
    filtered_mean: torch.Tensor   # (..., periods, n) weighted means
    success: torch.Tensor         # (...,) bool


def systematic_resample_indices(log_w: torch.Tensor, u: torch.Tensor
                                ) -> torch.Tensor:
    """Ancestor indices (..., N) for log-weights ``log_w`` (..., N) and
    offsets ``u`` (...) in [0, 1): the N points (u + i) / N are placed on
    each draw's cumulative weight distribution."""
    n = log_w.shape[-1]
    cdf = torch.cumsum(torch.softmax(log_w, dim=-1), dim=-1)
    points = (u[..., None] + torch.arange(n, dtype=cdf.dtype,
                                          device=cdf.device)) / n
    idx = torch.searchsorted(cdf, points.expand(cdf.shape).contiguous(),
                             right=True)
    return idx.clamp(0, n - 1)


def systematic_resample(generator: torch.Generator, log_w: torch.Tensor,
                        particles: tuple[torch.Tensor, ...]
                        ) -> tuple[torch.Tensor, ...]:
    """Systematic (low-variance) resampling of one cloud: one uniform
    offset from ``generator`` (on ``log_w``'s device), then every tensor of
    ``particles`` gathered along its first dimension."""
    u = torch.rand((), generator=generator, device=log_w.device,
                   dtype=log_w.dtype)
    idx = systematic_resample_indices(log_w, u)
    return tuple(p[idx] for p in particles)


def _obs_logdensity(y_eff, maskf, y_hat, H):
    """Masked Gaussian log-density of every particle, (..., N): missing
    rows get unit variance and a zero innovation; one factorization per
    draw."""
    V = (y_eff.unsqueeze(-2) - y_hat) * maskf.unsqueeze(-2)   # (..., N, k)
    Hm = H * (maskf[..., :, None] * maskf[..., None, :]) \
        + torch.diag_embed(1.0 - maskf)
    cholm = _chol_nan(Hm)
    W = torch.cholesky_solve(V.mT, cholm)                     # (..., k, N)
    quad = (V.mT * W).sum(dim=-2)
    logdet = 2.0 * torch.log(torch.diagonal(cholm, dim1=-2,
                                            dim2=-1)).sum(-1)
    return -0.5 * ((maskf.sum(-1) * _LOG2PI + logdet)[..., None] + quad)


@highest_precision()
def _particle_filter(y, particles, transition: Callable, observe: Callable,
                     Q, H, ess_threshold: float, draws: Callable
                     ) -> ParticleFilterResult:
    """The filter on the random numbers ``draws(t) -> (u (...), eps_std
    (..., N, q))`` of period t: the resampling offsets and the shocks'
    standard normals (the shocks are ``eps_std Lᵀ``, L the Cholesky factor
    of Q)."""
    dtype, device = particles.dtype, particles.device
    y = torch.as_tensor(y, dtype=dtype, device=device)
    Q = torch.as_tensor(Q, dtype=dtype, device=device)
    H = torch.as_tensor(H, dtype=dtype, device=device)
    batch, (n_particles, n) = particles.shape[:-2], particles.shape[-2:]
    chol_Q = _chol_nan(Q)
    parts = particles
    log_w = particles.new_zeros(batch + (n_particles,))
    ll_sum = particles.new_zeros(batch)
    ok = torch.ones(batch, dtype=torch.bool, device=device)
    lls, esss, means = [], [], []
    for t in range(y.shape[-2]):
        u, eps_std = draws(t)
        ess = 1.0 / torch.softmax(log_w, dim=-1).square().sum(-1)
        do_resample = ess < ess_threshold * n_particles
        idx = systematic_resample_indices(log_w, u)
        resampled = torch.gather(parts, -2,
                                 idx[..., None].expand(parts.shape))
        parts = torch.where(do_resample[..., None, None], resampled, parts)
        log_w = torch.where(do_resample[..., None], torch.zeros_like(log_w),
                            log_w)
        parts_next = transition(parts, eps_std @ chol_Q.mT)
        y_t = y[..., t, :]
        mask = torch.isfinite(y_t)
        y_eff = torch.where(mask, y_t, torch.zeros_like(y_t))
        log_inc = _obs_logdensity(y_eff, mask.to(dtype),
                                  observe(parts_next), H)
        log_w_new = log_w + log_inc
        ll_t = torch.logsumexp(log_w_new, dim=-1) \
            - torch.logsumexp(log_w, dim=-1)
        step_ok = torch.isfinite(ll_t)
        ll_t = torch.where(step_ok, ll_t, torch.zeros_like(ll_t))
        w_norm = torch.softmax(log_w_new, dim=-1)
        means.append((w_norm.unsqueeze(-2) @ parts_next)[..., 0, :])
        lls.append(ll_t)
        esss.append(ess)
        ll_sum = ll_sum + ll_t
        ok = ok & step_ok
        parts, log_w = parts_next, log_w_new
    means = torch.stack(means, dim=-2)
    ok = ok & torch.isfinite(means[..., -1, :]).all(dim=-1)
    return ParticleFilterResult(ll_sum, torch.stack(lls, dim=-1),
                                torch.stack(esss, dim=-1), means, ok)


@torch.no_grad()
def particle_filter_loglik(generator: torch.Generator, y, init_particles,
                           transition: Callable, observe: Callable, Q, H,
                           ess_threshold: float = 0.5
                           ) -> ParticleFilterResult:
    """Bootstrap particle filter log-likelihood of ``y`` (periods, k), NaN
    = missing, from the cloud ``init_particles`` (..., N, n): batched
    ``transition(x, eps)`` with eps ~ N(0, Q), ``observe(x)`` with additive
    N(0, H) noise (H > 0 on observed rows).  Resamples where the ESS is
    below ``ess_threshold`` N.  ``generator`` (on the particles' device)
    draws, each period, the resampling offsets (...) and then the shocks'
    standard normals (..., N, q).  Not differentiable through the
    resampling."""
    particles = torch.as_tensor(init_particles)
    batch, n_particles = particles.shape[:-2], particles.shape[-2]
    q = torch.as_tensor(Q).shape[-1]
    kw = dict(generator=generator, dtype=particles.dtype,
              device=particles.device)

    def draws(_t):
        u = torch.rand(batch, **kw)
        return u, torch.randn(batch + (n_particles, q), **kw)

    return _particle_filter(y, particles, transition, observe, Q, H,
                            ess_threshold, draws)
