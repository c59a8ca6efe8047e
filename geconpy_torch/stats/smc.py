"""Sequential Monte Carlo posterior sampling (likelihood tempering).

Mirrors ``geconpy_tpu/stats/smc.py`` (``SMCResult`` :39, ``_ess_of`` :62,
``fit_smc`` :70): Herbst & Schorfheide (2014, JAE), "Sequential Monte Carlo
sampling for DSGE models".  The inner loop is nothing but batched
log-likelihood sweeps (``DSGEStateSpace.build_batched_loglik``) with host
control between them.

Algorithm: particles start at the prior; a tempering schedule
phi_0 = 0 < ... < phi_K = 1 raises the likelihood's weight, chosen
adaptively so that each stage's incremental importance weights keep the
effective sample size near ``target_ess``; each stage is correction
(reweight) -> selection (systematic resample when the ESS drops) ->
mutation (random-walk Metropolis with the weighted particle covariance as
proposal, its scale adapted toward 25% acceptance).  The accumulated
correction terms estimate the marginal data density.

Where things run: the particles, the proposals, the accept draws and the
sweep live on the state space's device, drawn from one ``torch.Generator``
there; the tempering bisection, the evidence increment, the weighted
covariance and its Cholesky factor stay on the host in numpy float64, as in
the reference, at one transfer of the log-likelihoods per stage.  ``mesh``
splits the particle axis of every sweep over its devices
(:func:`~geconpy_torch.parallel.pvmap`, the sweep built once per distinct
device); the tempering stays where it is, so the result equals the run
without a mesh.  ``interpret`` (the reference's Pallas interpret mode) is
accepted and changes nothing.  ``policy`` goes to the sweep as in the reference (default
``"xla"``, the adaptive float64 solve; ``"pallas"`` the cycle-reduction
kernel K1), the keyword-only ``settle`` picks the sweep's settle (default
``"xla"``, the reference's), and ``dtype`` is explicit where JAX reads its
global x64 flag.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from ..ops.particle_filter import systematic_resample

_log = logging.getLogger(__name__)

__all__ = ["SMCResult", "fit_smc"]


class SMCResult(NamedTuple):
    samples: np.ndarray        # (n_particles, dim) constrained, equal-weight
    unconstrained: np.ndarray  # (n_particles, dim)
    log_evidence: float        # marginal data density estimate
    phi_schedule: np.ndarray   # adaptive tempering steps (n_stages,)
    accept_rates: np.ndarray   # MH acceptance per stage
    ess_path: np.ndarray       # post-correction ESS per stage
    param_names: list[str]

    def summary(self) -> dict[str, dict[str, float]]:
        """Posterior table as a plain dict: parameter name -> {mean, sd,
        q0.05, q0.5, q0.95}.  The reference returns a ``pandas.DataFrame``
        with these columns; the port imports no pandas."""
        s = self.samples
        q05, q50, q95 = np.quantile(s, [0.05, 0.5, 0.95], axis=0)
        return {name: {"mean": float(s[:, j].mean()), "sd": float(s[:, j].std()),
                       "q0.05": float(q05[j]), "q0.5": float(q50[j]),
                       "q0.95": float(q95[j])}
                for j, name in enumerate(self.param_names)}


def _ess_of(dphi, ll, logw):
    """Effective sample size after an incremental reweight by dphi*ll."""
    lw = logw + dphi * ll
    lw = lw - lw.max()
    w = np.exp(lw)
    return float(w.sum() ** 2 / (w * w).sum())


def _prior_cloud(ss_mod, generator: torch.Generator, n_particles: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """(n_particles, dim) unconstrained draws from the priors, parameter by
    parameter from ``generator``."""
    return torch.stack(
        [p.prior.to_unconstrained(p.prior.sample(generator, (n_particles,)))
         for p in ss_mod.estimated], dim=1).to(dtype)


def _build_loglik(ss_mod, f_post):
    """``U -> (ll, lp)``: the data log-likelihood (-inf for a failed draw)
    and the log-prior with its Jacobian, both in U's dtype, from the
    sweep's log-posterior ``f_post``."""
    priors = [p.prior for p in ss_mod.estimated]

    def loglik(U: torch.Tensor):
        U64 = U.to(torch.float64)
        lp = U64.new_zeros(U.shape[:-1])
        for i, prior in enumerate(priors):
            x, logjac = prior.from_unconstrained(U64[..., i])
            lp = lp + prior.logpdf(x) + logjac
        lp = lp.to(U.dtype)
        lpost = f_post(U)
        # failed draws: -inf posterior with finite prior
        ll = torch.where(torch.isfinite(lpost), lpost - lp,
                         torch.full_like(lpost, -torch.inf))
        return ll, lp

    return loglik


def fit_smc(
    ss_mod,
    data: np.ndarray,
    n_particles: int = 2048,
    target_ess: float = 0.5,
    resample_ess: float = 0.5,
    n_mh: int = 2,
    seed: int = 0,
    policy: str = "xla",
    max_stages: int = 200,
    kalman_settle: int = 32,
    interpret: bool = False,
    mesh=None,
    mesh_axis: str = "batch",
    *,
    settle: str = "xla",
    dtype: torch.dtype = torch.float32,
) -> SMCResult:
    """Sample the posterior by adaptive likelihood-tempered SMC.

    Every likelihood evaluation is one batched sweep over the whole cloud,
    ``ss_mod.build_batched_loglik(data, n_settle=kalman_settle,
    policy=policy, settle=settle)`` (``policy="pallas"``: the
    cycle-reduction kernel K1), on ``ss_mod``'s device in ``dtype``: 1 for the prior cloud, then ``n_mh``
    per stage.  ``target_ess`` and ``resample_ess``
    are fractions of ``n_particles``.  The same ``seed`` gives the same
    result on the same device.  ``mesh`` (a
    :class:`~geconpy_torch.parallel.Mesh` whose first device is the state
    space's, axis ``mesh_axis``) splits every sweep's particles over its
    devices; ``n_particles`` must divide by the mesh size.

    Returns equal-weight posterior particles plus the log marginal data
    density (the tempering's by-product).
    """
    del interpret
    if not 0 < target_ess < 1:
        raise ValueError("target_ess must be in (0, 1)")
    if mesh is not None and n_particles % mesh.size:
        raise ValueError(f"n_particles ({n_particles}) must be divisible "
                         f"by the mesh size ({mesh.size})")
    dim = len(ss_mod.estimated)
    names = ss_mod.param_labels
    device = ss_mod._device()
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def sweep(ss):
        return ss.build_batched_loglik(data, n_settle=kalman_settle,
                                       policy=policy, settle=settle)

    if mesh is None:
        f_post = sweep(ss_mod)
    else:
        from ..parallel.mesh import pvmap

        f_post = pvmap(ss_mod._built_on_mesh(mesh, sweep), mesh, mesh_axis)
    loglik = _build_loglik(ss_mod, f_post)

    def mh_sweep(U, ll, lp, phi, L_prop, scale):
        """One RW-Metropolis sweep over all particles."""
        eps = torch.randn(U.shape, generator=gen, device=device, dtype=dtype)
        prop = U + scale * (eps @ L_prop.mT)
        ll_p, lp_p = loglik(prop)
        log_alpha = (lp_p + phi * ll_p) - (lp + phi * ll)
        accept = torch.log(torch.rand(U.shape[0], generator=gen, device=device,
                                      dtype=dtype)) < log_alpha
        U = torch.where(accept[:, None], prop, U)
        ll = torch.where(accept, ll_p, ll)
        lp = torch.where(accept, lp_p, lp)
        return U, ll, lp, float(accept.to(dtype).mean())

    # ---- stage 0: the prior cloud
    U = _prior_cloud(ss_mod, gen, n_particles, dtype)
    ll_dev, lp = loglik(U)
    ll = ll_dev.cpu().numpy().astype(np.float64)
    n_bad = int((~np.isfinite(ll)).sum())
    if n_bad:
        _log.info("SMC: %d/%d prior particles unsolvable (weight 0)",
                  n_bad, n_particles)
    ll_dev = torch.where(torch.isfinite(ll_dev), ll_dev,
                         torch.full_like(ll_dev, -1e30))

    phi = 0.0
    logw = np.zeros(n_particles)
    logZ = 0.0
    scale = 2.38 / np.sqrt(dim)
    phis, accs, esss = [], [], []

    for _stage in range(max_stages):
        # ---- adaptive tempering step: bisect dphi to hit target ESS
        ll_host = np.where(np.isfinite(ll), ll, -1e30)
        lo, hi = 0.0, 1.0 - phi
        if _ess_of(hi, ll_host, logw) >= target_ess * n_particles:
            dphi = hi
        else:
            for _ in range(50):
                mid = 0.5 * (lo + hi)
                if _ess_of(mid, ll_host, logw) >= target_ess * n_particles:
                    lo = mid
                else:
                    hi = mid
            dphi = lo if lo > 0 else hi
        phi_new = phi + dphi

        # ---- correction: evidence increment + reweight
        lw_n = logw - (logw.max() + np.log(np.exp(logw - logw.max()).sum()))
        inc = lw_n + dphi * ll_host
        m = inc.max()
        logZ += m + np.log(np.exp(inc - m).sum())
        logw = logw + dphi * ll_host
        ess = _ess_of(0.0, ll_host * 0.0, logw)
        phis.append(phi_new)
        esss.append(ess)

        # ---- selection
        if ess < resample_ess * n_particles:
            U, ll_dev, lp = systematic_resample(
                gen, torch.as_tensor(logw, device=device), (U, ll_dev, lp))
            logw = np.zeros(n_particles)

        # ---- mutation: RW-MH at the new temperature
        w = np.exp(logw - logw.max())
        w = w / w.sum()
        Un = U.cpu().numpy().astype(np.float64)
        mu = w @ Un
        cov = (Un - mu).T @ ((Un - mu) * w[:, None]) + 1e-10 * np.eye(dim)
        L_prop = torch.as_tensor(np.linalg.cholesky(cov), device=device).to(dtype)

        acc_stage = []
        for _ in range(n_mh):
            U, ll_dev, lp, acc = mh_sweep(U, ll_dev, lp, phi_new, L_prop, scale)
            acc_stage.append(acc)
        acc_mean = float(np.mean(acc_stage))
        accs.append(acc_mean)
        ll = ll_dev.cpu().numpy().astype(np.float64)
        # Robbins-Monro-flavored scale adaptation toward 25% acceptance
        scale = float(np.clip(scale * np.exp(2.0 * (acc_mean - 0.25)),
                              1e-3, 10.0))

        _log.info("SMC stage %d: phi=%.4f ess=%.0f accept=%.2f scale=%.3f",
                  _stage + 1, phi_new, ess, acc_mean, scale)
        phi = phi_new
        if phi >= 1.0:
            break
    else:
        raise RuntimeError(f"SMC did not reach phi=1 in {max_stages} stages")

    # final equal-weight cloud
    U, ll_dev, lp = systematic_resample(
        gen, torch.as_tensor(logw, device=device), (U, ll_dev, lp))
    return SMCResult(
        samples=ss_mod.constrain(U).cpu().numpy(),
        unconstrained=U.cpu().numpy(),
        log_evidence=float(logZ),
        phi_schedule=np.asarray(phis),
        accept_rates=np.asarray(accs),
        ess_path=np.asarray(esss),
        param_names=names,
    )
