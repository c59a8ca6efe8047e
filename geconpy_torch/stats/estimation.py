"""Bayesian estimation front-end: NUTS over the DSGE state-space posterior.

Mirrors ``geconpy_tpu/stats/estimation.py`` (``PosteriorResult`` :92,
``fit`` :123, ``fit_pmmh`` :315).  Every leapfrog step is one value+grad
call for all chains.  With ``policy="xla"`` (the default) that is the
batched form of the single-draw log posterior
``DSGEStateSpace.build_logpost`` (the adaptive
cycle reduction and the configured filter, in plain PyTorch), which the
reference differentiates per chain under ``vmap``.  With
``policy="pallas"`` it is ``DSGEStateSpace.build_batched_logpost_and_grad``
(the reference's ``make_batched_logp_grad``, :53, routes the vmapped chains
to the same batched call), which launches the cycle-reduction kernel K4 on
the GPU.  With ``order=2`` it is the second-order log posterior's
(``DSGEStateSpace.build_logpost_and_grad_second_order``, plain PyTorch).
``fit_pmmh`` runs the batched PMMH chains of :mod:`.pmmh` on the particle
filter.  The chains run on the state space's device.
"""

from __future__ import annotations

import logging
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from .diagnostics import summarize_chains
from .model_comparison import find_map
from .nuts import NUTSResult, sample_nuts

_log = logging.getLogger(__name__)

__all__ = ["fit", "fit_pmmh", "PosteriorResult", "posterior_mode"]

# the mode per (value+grad function, start point): DSGEStateSpace caches
# its built functions, so it returns the same one for the same model and
# data, and a repeat fit skips the search (reference ``estimation.py:31,
# :233-252``)
_MAP_CACHE: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


@dataclass
class PosteriorResult:
    """Posterior draws in constrained space, with sampler diagnostics."""

    samples: np.ndarray            # (chains, draws, n_params) constrained
    unconstrained: np.ndarray      # (chains, draws, n_params)
    logp: np.ndarray               # (chains, draws)
    param_names: list[str]
    diverging: np.ndarray
    accept_prob: np.ndarray
    step_size: np.ndarray
    summary_: dict | None = None
    n_leapfrog: np.ndarray | None = None   # (chains, draws)
    n_calls: np.ndarray | None = None      # value+grad calls per transition,
                                           # warmup then sampling
    seconds: dict | None = None            # host clock: "hessian",
                                           # "warmup", "sampling"

    def summary(self) -> dict:
        """Per-parameter posterior table (cached): a plain dict with
        ``"names"`` and the reference's columns mean, sd, hdi_3%, hdi_97%,
        ess and r_hat, one array each (the reference returns a
        ``pandas.DataFrame``; the port imports no pandas)."""
        if self.summary_ is None:
            self.summary_ = summarize_chains(self.samples, self.param_names)
        return self.summary_

    def posterior_mean(self) -> dict[str, float]:
        """Posterior mean per parameter, pooled over chains and draws."""
        flat = self.samples.reshape(-1, self.samples.shape[-1])
        return dict(zip(self.param_names, flat.mean(axis=0)))


def _value_and_grad(ss_mod, data: np.ndarray, policy: str, order: int = 1):
    """The value+grad of ``fit``'s ``policy`` and ``order``."""
    if order == 2:
        return ss_mod.build_logpost_and_grad_second_order(data)
    if policy == "xla":
        return ss_mod.build_logpost_and_grad(data)
    return ss_mod.build_batched_logpost_and_grad(data)


def posterior_mode(ss_mod, data: np.ndarray, dtype: torch.dtype = torch.float32,
                   policy: str = "xla", order: int = 1, **find_map_kwargs
                   ) -> tuple[torch.Tensor, float]:
    """The posterior mode from ``ss_mod.initial_position()`` in ``dtype``,
    and its log posterior, by :func:`find_map` on the value+grad of
    ``fit``'s ``policy`` and ``order``.

    Memoized per (value+grad function, start point), as the reference
    memoizes its mode search: the first search for a model, data and start
    point is kept, whatever ``find_map_kwargs`` a later call passes, and
    ``fit(init="map")`` with the same ``policy`` reads it."""
    vag = _value_and_grad(ss_mod, data, policy, order)
    u0 = ss_mod.initial_position().to(dtype)
    bucket = _MAP_CACHE.setdefault(vag, {})
    key = (str(dtype), u0.cpu().numpy().tobytes())
    if key not in bucket:
        u_mode = find_map(vag, u0, **find_map_kwargs)
        bucket[key] = (u_mode, float(vag(u_mode[None])[0][0]))
    return bucket[key]


def fit(
    ss_mod,
    data: np.ndarray,
    num_chains: int = 4,
    num_warmup: int = 500,
    num_samples: int = 500,
    seed: int = 0,
    max_depth: int = 8,
    target_accept: float = 0.8,
    init_jitter: float = 0.5,
    pooled_adaptation: bool = False,
    policy: str = "xla",
    init: str = "prior",
    mass_init: str = "auto",
    mass_matrix: str = "diag",
    order: int = 1,
    segment_size: int | None = None,
    mesh=None,
    cache_dir: str | None = None,
    dtype: torch.dtype = torch.float32,
) -> PosteriorResult:
    """Sample the posterior with batched NUTS chains on ``ss_mod``'s device.

    The reference's signature and defaults.  Each leapfrog step is one
    value+grad call for all chains, and the chains' termination is read
    back once per tree level.  ``policy="xla"`` (the default) takes the
    value+grad of ``ss_mod.build_logpost(data)`` over the chains
    (``ss_mod.build_logpost_and_grad``: the adaptive cycle reduction and
    the configured filter, the sequential one by default).
    ``policy="pallas"`` takes ``ss_mod.build_batched_logpost_and_grad(data)``
    (the cycle-reduction kernel K4, the default settle).  ``order=2``
    samples the posterior of the pruned second-order solution on the
    value+grad of ``ss_mod.build_logpost_second_order(data)`` (the
    marginalized unscented filter, ``stats/nonlinear.py``) and requires
    ``policy="xla"``.  ``mesh`` (a :class:`~geconpy_torch.parallel.Mesh`
    whose first device is the state space's) splits the chains of every
    value+grad call over its devices, the function built once per distinct
    device; the result equals the run without a mesh.  ``num_chains`` must
    divide by the mesh size.  ``cache_dir`` turns on the persistent cache
    of the CUDA kernels' build there
    (:func:`~geconpy_torch.utils.compile_cache.enable_persistent_cache`).

    ``seed`` seeds one ``torch.Generator`` on the state space's device,
    which draws the starts and every random number of the sampler.
    ``dtype`` (not in the reference, which reads JAX's global x64 flag) is
    the chains' dtype: the chain state, the adaptation and the Welford sums
    run in it, while the value+grad computes in float64 inside and returns
    ``dtype``.

    ``init="map"`` starts every chain at 0.05 N(0, 1) around the posterior
    mode (:func:`posterior_mode`, memoized); ``init="prior"`` jitters each
    chain by ``init_jitter`` N(0, 1) around ``ss_mod.initial_position()``.
    A start outside the support (-inf) is pulled half way to that anchor,
    up to six times, as in the reference.  The mode search and the
    finiteness of the starts run on the log posterior of ``policy``, at a
    batch of one or of the chains (with ``policy="pallas"`` where the
    reference calls its XLA ``build_logpost``: the two agree at the parity
    bars of ``tests/test_torch_logpost_grad.py``).  ``mass_init="auto"`` seeds
    the metric from the curvature at the start when ``init="map"``, else
    from the identity.  ``segment_size`` changes nothing (every transition
    returns to the host).  ``summary()`` of the result is a plain dict.
    """
    if cache_dir is not None:
        from ..utils.compile_cache import enable_persistent_cache

        enable_persistent_cache(cache_dir)
    if order == 2 and policy != "xla":
        raise ValueError("order=2 estimation requires policy='xla' "
                         "(the Pallas batch kernels are first-order)")
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order!r}")
    if policy not in ("xla", "pallas"):
        raise ValueError(f"policy must be 'xla' or 'pallas', got {policy!r}")
    if init not in ("prior", "map"):
        raise ValueError(f"init must be 'prior' or 'map', got {init!r}")
    mass_init = {"auto": "hessian" if init == "map" else "unit"}.get(
        mass_init, mass_init)
    if mass_init not in ("unit", "hessian"):
        raise ValueError(f"mass_init must be 'auto', 'unit' or 'hessian', "
                         f"got {mass_init!r}")
    if mass_matrix not in ("diag", "dense"):
        raise ValueError(f"mass_matrix must be 'diag' or 'dense', "
                         f"got {mass_matrix!r}")

    if mesh is None:
        vag = _value_and_grad(ss_mod, data, policy, order)
    else:
        vag = ss_mod._built_on_mesh(mesh, lambda ss: _value_and_grad(
            ss, data, policy, order))
    if order == 2:
        logpost = ss_mod.build_logpost_second_order(data)
    elif policy == "xla":
        logpost = ss_mod.build_logpost(data)
    else:
        logpost = ss_mod.build_batched_logpost(data)
    device = ss_mod._device()
    generator = torch.Generator(device=device).manual_seed(seed)
    if init == "map":
        u_mode, mode_logp = posterior_mode(ss_mod, data, dtype=dtype,
                                           policy=policy, order=order)
        _log.info("MAP found: logpost %.2f", mode_logp)
        inits = u_mode[None, :] + 0.05 * torch.randn(
            (num_chains, u_mode.shape[0]), generator=generator, dtype=dtype,
            device=device)
        anchor = u_mode[None, :]
    else:
        inits = torch.stack([
            ss_mod.initial_position(jitter=init_jitter, generator=generator)
            for _ in range(num_chains)]).to(dtype)
        anchor = ss_mod.initial_position().to(dtype)[None, :]

    # a chain starting outside the support (-inf) begins frozen, and under
    # pooled adaptation a frozen chain degrades the shared metric for
    # everyone: shrink such starts toward the anchor until all are finite
    for _ in range(6):
        with torch.no_grad():
            finite = torch.isfinite(logpost(inits))
        if bool(finite.all()):
            break
        _log.info("shrinking init jitter for %d/%d non-finite chain starts",
                  int((~finite).sum()), num_chains)
        shrunk = anchor + 0.5 * (inits - anchor)
        inits = torch.where(finite[:, None], inits, shrunk)

    _log.info("NUTS: %d chains x (%d warmup + %d samples), %d parameters",
              num_chains, num_warmup, num_samples, len(ss_mod.estimated))
    res: NUTSResult = sample_nuts(
        vag, inits, generator, num_warmup=num_warmup,
        num_samples=num_samples, max_depth=max_depth,
        target_accept=target_accept, pooled=pooled_adaptation,
        mass_init=mass_init, mass_matrix=mass_matrix,
        segment_size=segment_size, mesh=mesh)

    # one transfer of each result to the host
    constrained = ss_mod.constrain(res.samples.to(torch.float64))
    out = {k: v.cpu().numpy() for k, v in
           (("samples", constrained), ("unconstrained", res.samples),
            ("logp", res.logp), ("diverging", res.diverging),
            ("accept_prob", res.accept_prob), ("step_size", res.step_size),
            ("n_leapfrog", res.n_leapfrog))}
    div_rate = float(out["diverging"].mean())
    if div_rate > 0.05:
        _log.warning("%.1f%% divergent transitions — treat results with care",
                     100 * div_rate)
    return PosteriorResult(param_names=ss_mod.param_labels,
                           n_calls=res.n_calls, seconds=res.seconds, **out)


def _logprior(ss_mod, U: torch.Tensor) -> torch.Tensor:
    """Log prior density of unconstrained draws U (..., dim), the
    transforms' Jacobians included."""
    lp = U.new_zeros(U.shape[:-1])
    for i, p in enumerate(ss_mod.estimated):
        x, logjac = p.prior.from_unconstrained(U[..., i])
        lp = lp + p.prior.logpdf(x) + logjac
    return lp


def fit_pmmh(
    ss_mod,
    data: np.ndarray,
    num_chains: int = 4,
    num_warmup: int = 1000,
    num_samples: int = 2000,
    seed: int = 0,
    n_particles: int = 4096,
    initial_scale: float = 0.1,
    init_jitter: float = 0.25,
    segment_size: int | None = None,
) -> PosteriorResult:
    """Particle-marginal Metropolis-Hastings posterior of the pruned
    second-order model (the reference's ``fit_pmmh``, :315, with its
    defaults): the exact pseudo-marginal target of the particle filter
    (``build_pf_loglik_second_order``, ``n_particles`` a chain), chains
    batched on ``ss_mod``'s device, float64.  ``seed`` seeds one
    ``torch.Generator`` there, which jitters each chain's start by
    ``init_jitter`` N(0, 1) around ``ss_mod.initial_position()`` and draws
    every random number of the sampler and the filter.  ``logp`` is the
    joint log posterior (the likelihood estimate plus the log prior);
    ``step_size`` holds the final proposal scales.  A chain accepting
    under 5% logs a warning."""
    from .pmmh import sample_pmmh

    pf = ss_mod.build_pf_loglik_second_order(data, n_particles=n_particles)
    device = ss_mod._device()
    generator = torch.Generator(device=device).manual_seed(seed)
    inits = torch.stack([
        ss_mod.initial_position(jitter=init_jitter, generator=generator)
        for _ in range(num_chains)])
    res = sample_pmmh(pf, lambda U: _logprior(ss_mod, U), inits, generator,
                      num_warmup=num_warmup, num_samples=num_samples,
                      initial_scale=initial_scale, segment_size=segment_size)
    # the joint log posterior, not the bare likelihood estimate: the
    # evidence estimators read logp as the posterior density
    logp = res.loglik + _logprior(ss_mod, res.samples)
    acc = res.accept_rate.cpu().numpy()
    if acc.min() < 0.05:
        _log.warning("PMMH chain acceptance as low as %.3f — increase "
                     "n_particles (estimator variance) or lower "
                     "initial_scale", acc.min())
    n_c, n_d, _ = res.samples.shape
    return PosteriorResult(
        samples=ss_mod.constrain(res.samples).cpu().numpy(),
        unconstrained=res.samples.cpu().numpy(),
        logp=logp.cpu().numpy(),
        param_names=ss_mod.param_labels,
        diverging=np.zeros((n_c, n_d), dtype=bool),
        accept_prob=np.repeat(acc[:, None], n_d, axis=1),
        step_size=res.scale.cpu().numpy())
