"""Prior sampling: Monte-Carlo and quasi-Monte-Carlo parameter sweeps.

Mirrors ``geconpy_tpu/stats/sampling.py``: ``bounds_from_priors`` (:25),
``sample_from_priors`` (:31), ``_qmc_engine`` (:42), ``sample_uniform``
(:57), ``sample_uniform_from_priors`` (:80) and ``sample_from_priors_qmc``
(:95).  The space-filling and inverse-CDF samplers are the reference's
numpy and ``scipy.stats.qmc`` code on the host, so the same seed gives the
same numpy arrays.  ``sample_from_priors`` draws from a ``torch.Generator``
seeded with the reference's ``seed`` on ``device`` (where the reference
splits a JAX key), parameter by parameter, and returns float64 tensors on
that device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dists import Distribution

__all__ = [
    "bounds_from_priors",
    "sample_from_priors",
    "sample_uniform",
    "sample_uniform_from_priors",
    "sample_from_priors_qmc",
]


def bounds_from_priors(priors: dict[str, Distribution], mass: float = 0.99
                       ) -> dict[str, tuple[float, float]]:
    """Central-interval bounds per prior (for uniform/LHS sweeps)."""
    return {name: d.hdi(mass) for name, d in priors.items()}


def sample_from_priors(priors: dict[str, Distribution], n_draws: int = 1000,
                       seed: int = 0, device: str | torch.device = "cuda"
                       ) -> dict[str, torch.Tensor]:
    """Independent Monte-Carlo draws from every prior, in the dict's order,
    from a ``torch.Generator`` on ``device`` seeded with ``seed``, as
    float64 tensors on that device."""
    generator = torch.Generator(device=device).manual_seed(seed)
    return {name: d.sample(generator, (n_draws,)) for name, d in priors.items()}


def _qmc_engine(method: str, dim: int, seed: int):
    from scipy.stats import qmc

    method = method.lower()
    if method in ("lhs", "latin", "latin_hypercube"):
        return qmc.LatinHypercube(d=dim, seed=seed)
    if method == "sobol":
        return qmc.Sobol(d=dim, seed=seed)
    if method == "halton":
        return qmc.Halton(d=dim, seed=seed)
    if method in ("poisson", "poisson_disk"):
        return qmc.PoissonDisk(d=dim, seed=seed)
    raise ValueError(f"unknown QMC method {method!r}; use lhs/sobol/halton/poisson")


def sample_uniform(param_bounds: dict[str, tuple[float, float]],
                   n_draws: int = 256, method: str = "lhs", seed: int = 0
                   ) -> dict[str, np.ndarray]:
    """Space-filling (or plain-random) draws within explicit per-parameter
    bounds.  ``method`` is one of ``"random"``, ``"lhs"``, ``"sobol"``,
    ``"halton"``, ``"poisson"``/``"poisson_disk"``."""
    names = list(param_bounds)
    lows = np.array([param_bounds[n][0] for n in names], dtype=float)
    highs = np.array([param_bounds[n][1] for n in names], dtype=float)
    if np.any(highs <= lows):
        bad = [n for n in names if param_bounds[n][1] <= param_bounds[n][0]]
        raise ValueError(f"upper bound must exceed lower bound for {bad}")
    if method.lower() == "random":
        unit = np.random.default_rng(seed).uniform(size=(n_draws, len(names)))
    else:
        unit = _qmc_engine(method, len(names), seed).random(n_draws)
    scaled = lows + unit * (highs - lows)
    return {n: scaled[:, i] for i, n in enumerate(names)}


def sample_uniform_from_priors(priors: dict[str, Distribution],
                               n_draws: int = 256, method: str = "lhs",
                               mass: float = 0.99, seed: int = 0
                               ) -> dict[str, np.ndarray]:
    """Space-filling draws over each prior's central-mass box."""
    names = list(priors)
    bounds = bounds_from_priors(priors, mass)
    lows = np.array([bounds[n][0] for n in names])
    highs = np.array([bounds[n][1] for n in names])
    engine = _qmc_engine(method, len(names), seed)
    unit = engine.random(n_draws)
    scaled = lows + unit * (highs - lows)
    return {n: scaled[:, i] for i, n in enumerate(names)}


def sample_from_priors_qmc(priors: dict[str, Distribution],
                           n_draws: int = 256, method: str = "sobol",
                           seed: int = 0) -> dict[str, np.ndarray]:
    """QMC draws mapped through each prior's inverse CDF (low-discrepancy
    draws *from the prior itself*, not a uniform box)."""
    names = list(priors)
    engine = _qmc_engine(method, len(names), seed)
    unit = np.clip(engine.random(n_draws), 1e-12, 1 - 1e-12)
    return {
        n: np.asarray(priors[n].ppf(unit[:, i]))
        for i, n in enumerate(names)
    }
