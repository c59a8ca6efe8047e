"""Posterior mode search and marginal data density (model evidence).

Mirrors ``geconpy_tpu/stats/model_comparison.py``: ``find_map`` (:98),
Adam to the basin then Newton; of ``neg_hessian_fn`` (:37) its
central-difference branch (``fd_hessian``, :80-88); ``laplace_evidence``
(:144), ``modified_harmonic_mean`` (:157), ``marginal_likelihood`` (:203)
and ``compare_models`` (:229).

- **Laplace approximation** at the posterior mode:
  log p(y) ~= log p(y, theta*) + d/2 log(2 pi) - 1/2 log |-H(theta*)|.
- **Modified harmonic mean** (Geweke 1999) over posterior draws, with the
  fitted Gaussian truncated to its central ``tau`` probability ellipsoid:
  the reference's numpy and scipy code on host arrays, unchanged.

The reference takes the exact ``jax.hessian`` where forward mode traces
and passes its check, else central differences of the exact gradient.
The port always takes the central differences (accurate to about
eps^(2/3) relative), so its Laplace evidence differs from the reference's
by that rounding of the log-determinant.

The mode search and the Hessian take a batched ``value_and_grad(U (B,
dim)) -> (logpost (B,), grad (B, dim))``
(``DSGEStateSpace.build_batched_logpost_and_grad`` or
``build_logpost_and_grad``) and run in the start point's dtype and on its
device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.precision import highest_precision

__all__ = ["find_map", "laplace_evidence", "modified_harmonic_mean",
           "marginal_likelihood", "neg_hessian_fn", "compare_models",
           "ModelComparison"]

_LOG2PI = 1.8378770664093453

ValueAndGrad = Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


def neg_hessian_fn(value_and_grad: ValueAndGrad):
    """``u -> Hessian of -logpost`` by central differences of the exact
    gradient: the 2 x dim shifted draws go in ONE batched call, steps
    ``eps^(1/3) max(1, |u_i|)``, and the result is symmetrised."""

    def fd_hessian(u: torch.Tensor) -> torch.Tensor:
        eps = torch.finfo(u.dtype).eps
        h = eps ** (1.0 / 3.0) * torch.clamp(torch.abs(u), min=1.0)
        E = torch.eye(u.shape[0], dtype=u.dtype, device=u.device) * h[:, None]
        _, g = value_and_grad(torch.cat([u + E, u - E]))
        g_plus, g_minus = -g[:u.shape[0]], -g[u.shape[0]:]
        H = (g_plus - g_minus) / (2.0 * h[:, None])
        return 0.5 * (H + H.T)

    return fd_hessian


def find_map(value_and_grad: ValueAndGrad, u0: torch.Tensor,
             adam_steps: int = 500, newton_steps: int = 5,
             learning_rate: float = 0.02) -> torch.Tensor:
    """Posterior mode in unconstrained space: Adam to the basin, Newton to
    machine precision.  Newton steps that are non-finite or do not improve
    the log posterior (an indefinite Hessian far from the mode) are
    rejected.  Each Adam step is one value+grad call at a batch of one;
    each Newton step two, and one of 2 x dim draws for the Hessian."""
    u0 = torch.as_tensor(u0)

    def neg(u):
        vals, grads = value_and_grad(u[None])
        return -vals[0], -grads[0]

    neg_hess = neg_hessian_fn(value_and_grad)

    u = u0.clone()
    m = torch.zeros_like(u)
    v = torch.zeros_like(u)
    for i in range(adam_steps):
        _, g = neg(u)
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat = m / (1 - 0.9 ** (i + 1))
        vhat = v / (1 - 0.999 ** (i + 1))
        u = u - learning_rate * mhat / (torch.sqrt(vhat) + 1e-8)

    with highest_precision():
        for _ in range(newton_steps):
            f, g = neg(u)
            H = neg_hess(u)
            # a singular H gives a non-finite step (rejected), as in JAX,
            # not an exception
            delta, info = torch.linalg.solve_ex(H, g)
            delta = torch.where(info != 0, torch.full_like(delta, torch.nan),
                                delta)
            u_new = u - delta
            f_new, _ = neg(u_new)
            better = (torch.isfinite(f_new) & (f_new <= f)
                      & torch.all(torch.isfinite(u_new)))
            u = torch.where(better, u_new, u)
    return u


def laplace_evidence(value_and_grad: ValueAndGrad, u_mode: torch.Tensor
                     ) -> float:
    """log p(y) by Laplace approximation at the (unconstrained) mode; NaN
    where the negative Hessian is not positive definite."""
    u_mode = torch.as_tensor(u_mode)
    d = u_mode.shape[0]
    with highest_precision():
        H = neg_hessian_fn(value_and_grad)(u_mode)
        sign, logdet = torch.linalg.slogdet(H)
    logp = value_and_grad(u_mode[None])[0][0]
    if float(sign) <= 0:
        return float("nan")
    return float(logp + 0.5 * d * _LOG2PI - 0.5 * logdet)


def modified_harmonic_mean(unconstrained, logp, tau: float = 0.5) -> float:
    """Geweke's modified-harmonic-mean log evidence from posterior draws.

    ``unconstrained`` is the (draws, dim) or (chains, draws, dim) posterior
    sample in the unconstrained space, ``logp`` the matching unnormalized
    log posterior (``PosteriorResult.logp``), ``tau`` the probability
    content of the Gaussian truncation ellipsoid.  Host numpy.
    """
    from scipy.stats import chi2

    u = np.asarray(unconstrained, dtype=np.float64).reshape(
        -1, np.shape(unconstrained)[-1])
    lp = np.asarray(logp, dtype=np.float64).reshape(-1)
    finite = np.isfinite(lp)
    u, lp = u[finite], lp[finite]
    n, d = u.shape

    mu = u.mean(axis=0)
    S = np.cov(u.T, ddof=1).reshape(d, d)
    Sinv = np.linalg.inv(S)
    _, logdetS = np.linalg.slogdet(S)

    delta = u - mu
    quad = np.einsum("ij,jk,ik->i", delta, Sinv, delta)
    thresh = chi2.ppf(tau, df=d)
    inside = quad <= thresh

    # log f(theta): truncated multivariate normal, renormalized by tau
    log_f = -0.5 * (d * _LOG2PI + logdetS + quad) - np.log(tau)
    # 1/p(y) = mean over draws of exp(log f - logp) restricted to the
    # ellipsoid; log-sum-exp for stability
    w = log_f[inside] - lp[inside]
    if w.size == 0:
        return float("nan")
    m = w.max()
    log_inv_evidence = m + np.log(np.exp(w - m).sum()) - np.log(n)
    return float(-log_inv_evidence)


def marginal_likelihood(ss_mod, data, result=None, method: str = "laplace",
                        **kwargs) -> float:
    """Log marginal data density for a configured ``DSGEStateSpace``.

    ``method="laplace"`` needs no posterior sample: the mode is searched
    (``find_map``, ``kwargs`` its options) from the prior initial position,
    or from the posterior mean when ``result`` is given, on the value+grad
    of ``ss_mod.build_logpost(data)`` in float64.  ``method="harmonic"``
    needs ``result`` from ``fit``.
    """
    if method == "laplace":
        vag = ss_mod.build_logpost_and_grad(np.asarray(data))
        if result is not None:
            u0 = torch.as_tensor(
                np.asarray(result.unconstrained, dtype=np.float64).reshape(
                    -1, np.shape(result.unconstrained)[-1]).mean(axis=0),
                device=ss_mod._device())
        else:
            u0 = ss_mod.initial_position()
        u_mode = find_map(vag, u0, **kwargs)
        return laplace_evidence(vag, u_mode)
    if method == "harmonic":
        if result is None:
            raise ValueError("method='harmonic' requires a fit() result")
        return modified_harmonic_mean(result.unconstrained, result.logp,
                                      **kwargs)
    raise ValueError(f"method must be 'laplace' or 'harmonic', got {method!r}")


class ModelComparison(NamedTuple):
    """What :func:`compare_models` returns: the reference's frame, its rows
    sorted by ``log_ml`` (best first)."""

    names: list[str]
    log_ml: torch.Tensor            # (n_models,) float64
    log_bayes_factor: torch.Tensor  # against the best model
    posterior_prob: torch.Tensor


def compare_models(candidates: dict, data, method: str = "laplace",
                   prior_probs: dict | None = None, **kwargs
                   ) -> ModelComparison:
    """Evidence table for competing models of the SAME dataset.

    ``candidates``: ``{name: DSGEStateSpace}`` (each configured with its
    own observables mapped to the columns of ``data``).  Returns the names
    sorted by log marginal likelihood, with log Bayes factors against the
    best model and posterior model probabilities (a uniform model prior
    unless ``prior_probs`` gives one weight per name); ``kwargs`` go to
    :func:`marginal_likelihood`.
    """
    if prior_probs is None:
        prior_probs = {k: 1.0 / len(candidates) for k in candidates}
    if set(prior_probs) != set(candidates):
        raise ValueError("prior_probs keys must match candidates")
    rows = {name: marginal_likelihood(ss_mod, data, method=method, **kwargs)
            for name, ss_mod in candidates.items()}
    # pandas' sort_values: descending, stable, NaN last
    names = sorted(rows, key=lambda n: (np.isnan(rows[n]), -rows[n]
                                        if not np.isnan(rows[n]) else 0.0))
    log_ml = np.asarray([rows[n] for n in names])
    logw = log_ml + np.log(np.asarray([prior_probs[n] for n in names]))
    w = np.exp(logw - np.nanmax(logw))
    return ModelComparison(names, torch.as_tensor(log_ml),
                           torch.as_tensor(log_ml - log_ml[0]),
                           torch.as_tensor(w / w.sum()))
