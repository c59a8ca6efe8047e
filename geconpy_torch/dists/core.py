"""Torch probability distributions for priors and shock laws.

Mirrors ``geconpy_tpu/dists/core.py``: the same families, fields, registry
and host-side helpers (``Truncated``, ``maxent``), so the port's copy of
``dists/from_ast.py`` builds these classes from GCN prior statements.  Each family provides ``logpdf`` (tensor in, tensor out; -inf
outside the support), ``from_unconstrained`` with its log-Jacobian,
``sample(generator, shape)`` from an explicit ``torch.Generator``, host
``ppf``/``mean``/``std``.  Distribution parameters are host floats, so the
normalising constants are computed once in float64 with :mod:`math`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import numpy as np
import torch

__all__ = [
    "Distribution", "Normal", "HalfNormal", "TruncatedNormal", "Beta",
    "Gamma", "InverseGamma", "Uniform", "LogNormal", "Exponential",
    "PartialCorrelation",
    "StudentT", "Truncated", "maxent", "DIST_REGISTRY", "get_distribution_class",
]

_LOG2PI = 1.8378770664093453
_SAMPLE_DTYPE = torch.float64


def _normal(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator,
                       device=generator.device, dtype=_SAMPLE_DTYPE)


def _uniform(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=generator,
                      device=generator.device, dtype=_SAMPLE_DTYPE)


def _std_gamma(generator: torch.Generator, alpha: float, shape) -> torch.Tensor:
    conc = torch.full(tuple(shape), float(alpha), device=generator.device,
                      dtype=_SAMPLE_DTYPE)
    return torch._standard_gamma(conc, generator=generator)


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


@dataclasses.dataclass(frozen=True)
class Distribution:
    """Base: scalar continuous distribution with fixed (host-side) params."""

    #: support bounds; None = unbounded on that side
    lower: ClassVar[float | None] = None
    upper: ClassVar[float | None] = None

    name: ClassVar[str] = "Distribution"

    def logpdf(self, x):
        """Log density at ``x`` (-inf outside the support)."""
        raise NotImplementedError

    def sample(self, generator: torch.Generator, shape=()):
        """Draw ``shape``-shaped float64 samples on ``generator``'s device."""
        raise NotImplementedError

    def ppf(self, q):
        """Quantile function (host numpy)."""
        raise NotImplementedError

    def mean(self):
        """Distribution mean (host-side float)."""
        raise NotImplementedError

    def std(self):
        """Standard deviation (host-side float)."""
        return float(np.sqrt(self.variance()))

    def variance(self):
        """Variance (host-side float)."""
        raise NotImplementedError

    # ---- support / transforms ------------------------------------------------
    def support(self) -> tuple[float, float]:
        """(lower, upper) support bounds, +-inf when unbounded."""
        lo = self.lower if self.lower is not None else -np.inf
        hi = self.upper if self.upper is not None else np.inf
        return (lo, hi)

    def to_unconstrained(self, x):
        """Map a value in the support to R."""
        x = _tensor(x)
        lo, hi = self.support()
        if np.isfinite(lo) and np.isfinite(hi):
            p = torch.clamp((x - lo) / (hi - lo), 1e-12, 1 - 1e-12)
            return torch.log(p) - torch.log1p(-p)
        if np.isfinite(lo):
            return torch.log(torch.clamp(x - lo, min=1e-300))
        if np.isfinite(hi):
            return torch.log(torch.clamp(hi - x, min=1e-300))
        return x

    def from_unconstrained(self, u):
        """Inverse of :meth:`to_unconstrained`; returns (x, log|dx/du|)."""
        lo, hi = self.support()
        if np.isfinite(lo) and np.isfinite(hi):
            x = lo + (hi - lo) * torch.sigmoid(u)
            logjac = math.log(hi - lo) + torch.nn.functional.logsigmoid(u) \
                + torch.nn.functional.logsigmoid(-u)
            return x, logjac
        if np.isfinite(lo):
            return lo + torch.exp(u), u
        if np.isfinite(hi):
            return hi - torch.exp(u), u
        return u, torch.zeros_like(u)

    def hdi(self, mass: float = 0.94) -> tuple[float, float]:
        """Central interval of the given mass (used for prior sweep bounds)."""
        a = (1 - mass) / 2
        return float(self.ppf(a)), float(self.ppf(1 - a))


@dataclasses.dataclass(frozen=True)
class Normal(Distribution):
    mu: float = 0.0
    sigma: float = 1.0
    name: ClassVar[str] = "Normal"

    def logpdf(self, x):
        z = (x - self.mu) / self.sigma
        return -0.5 * (z * z + _LOG2PI) - math.log(self.sigma)

    def sample(self, generator, shape=()):
        return self.mu + self.sigma * _normal(generator, shape)

    def ppf(self, q):
        from scipy.special import ndtri

        return self.mu + self.sigma * ndtri(q)

    def mean(self):
        return self.mu

    def variance(self):
        return self.sigma**2


@dataclasses.dataclass(frozen=True)
class HalfNormal(Distribution):
    sigma: float = 1.0
    lower: ClassVar[float] = 0.0
    name: ClassVar[str] = "HalfNormal"

    def logpdf(self, x):
        z = x / self.sigma
        base = 0.5 * math.log(2.0 / math.pi) - math.log(self.sigma) - 0.5 * z * z
        return torch.where(x >= 0, base, -math.inf)

    def sample(self, generator, shape=()):
        return torch.abs(self.sigma * _normal(generator, shape))

    def ppf(self, q):
        from scipy.special import ndtri

        return self.sigma * ndtri((1.0 + np.asarray(q)) / 2.0)

    def mean(self):
        return self.sigma * float(np.sqrt(2 / np.pi))

    def variance(self):
        return self.sigma**2 * (1 - 2 / np.pi)


@dataclasses.dataclass(frozen=True)
class Uniform(Distribution):
    lower_: float = 0.0
    upper_: float = 1.0
    name: ClassVar[str] = "Uniform"

    def support(self):
        return (self.lower_, self.upper_)

    def logpdf(self, x):
        inside = (x >= self.lower_) & (x <= self.upper_)
        return torch.where(inside, -math.log(self.upper_ - self.lower_),
                           -math.inf).to(x.dtype)

    def sample(self, generator, shape=()):
        return self.lower_ + (self.upper_ - self.lower_) * _uniform(generator, shape)

    def ppf(self, q):
        return self.lower_ + (self.upper_ - self.lower_) * np.asarray(q)

    def mean(self):
        return 0.5 * (self.lower_ + self.upper_)

    def variance(self):
        return (self.upper_ - self.lower_) ** 2 / 12


@dataclasses.dataclass(frozen=True)
class Beta(Distribution):
    alpha: float = 1.0
    beta: float = 1.0
    lower: ClassVar[float] = 0.0
    upper: ClassVar[float] = 1.0
    name: ClassVar[str] = "Beta"

    @classmethod
    def from_moments(cls, mu: float, sigma: float) -> "Beta":
        """Beta with the given mean and standard deviation (moment matching)."""
        nu = mu * (1 - mu) / sigma**2 - 1
        return cls(alpha=mu * nu, beta=(1 - mu) * nu)

    def logpdf(self, x):
        a, b = self.alpha, self.beta
        norm = math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
        inside = (x > 0) & (x < 1)
        xs = torch.clamp(x, 1e-12, 1 - 1e-12)
        return torch.where(
            inside, norm + (a - 1) * torch.log(xs) + (b - 1) * torch.log1p(-xs),
            -math.inf)

    def sample(self, generator, shape=()):
        ga = _std_gamma(generator, self.alpha, shape)
        gb = _std_gamma(generator, self.beta, shape)
        return ga / (ga + gb)

    def ppf(self, q):
        from scipy.stats import beta as sp_beta

        return sp_beta.ppf(q, self.alpha, self.beta)

    def mean(self):
        return self.alpha / (self.alpha + self.beta)

    def variance(self):
        a, b = self.alpha, self.beta
        return a * b / ((a + b) ** 2 * (a + b + 1))


@dataclasses.dataclass(frozen=True)
class PartialCorrelation(Distribution):
    """Scaled Beta on (-1, 1): x = 2 B - 1 with B ~ Beta(alpha, alpha), the
    marginal of a canonical partial correlation under the LKJ(eta)
    correlation prior (the prior of ``configure(full_shock_covariance=True)``'s
    correlation parameters)."""

    alpha: float = 1.0
    lower: ClassVar[float] = -1.0
    upper: ClassVar[float] = 1.0
    name: ClassVar[str] = "PartialCorrelation"

    @classmethod
    def lkj_marginal(cls, eta: float, dim: int, order: int
                     ) -> "PartialCorrelation":
        """Marginal of the ``order``-th canonical partial correlation under
        LKJ(eta) in dimension ``dim``: a = eta + (dim - 2 - order) / 2."""
        return cls(alpha=eta + (dim - 2 - order) / 2.0)

    def logpdf(self, x):
        a = self.alpha
        norm = math.lgamma(2 * a) - 2 * math.lgamma(a)
        inside = (x > -1) & (x < 1)
        b = torch.clamp((x + 1) / 2, 1e-12, 1 - 1e-12)
        # the Beta(a, a) density at (x + 1) / 2, times d b / d x = 1/2
        return torch.where(
            inside,
            norm + (a - 1) * (torch.log(b) + torch.log1p(-b)) - math.log(2.0),
            -math.inf)

    def sample(self, generator, shape=()):
        ga = _std_gamma(generator, self.alpha, shape)
        gb = _std_gamma(generator, self.alpha, shape)
        return 2.0 * ga / (ga + gb) - 1.0

    def ppf(self, q):
        from scipy.stats import beta as sp_beta

        return 2.0 * sp_beta.ppf(q, self.alpha, self.alpha) - 1.0

    def mean(self):
        return 0.0

    def variance(self):
        return 1.0 / (2.0 * self.alpha + 1.0)


@dataclasses.dataclass(frozen=True)
class Gamma(Distribution):
    alpha: float = 2.0          # shape
    beta: float = 1.0           # rate
    lower: ClassVar[float] = 0.0
    name: ClassVar[str] = "Gamma"

    @classmethod
    def from_moments(cls, mu: float, sigma: float) -> "Gamma":
        """Gamma with the given mean and standard deviation."""
        return cls(alpha=(mu / sigma) ** 2, beta=mu / sigma**2)

    def logpdf(self, x):
        a, b = self.alpha, self.beta
        xs = torch.clamp(x, min=1e-300)
        val = a * math.log(b) - math.lgamma(a) + (a - 1) * torch.log(xs) - b * xs
        return torch.where(x > 0, val, -math.inf)

    def sample(self, generator, shape=()):
        return _std_gamma(generator, self.alpha, shape) / self.beta

    def ppf(self, q):
        from scipy.stats import gamma as sp_gamma

        return sp_gamma.ppf(q, self.alpha, scale=1.0 / self.beta)

    def mean(self):
        return self.alpha / self.beta

    def variance(self):
        return self.alpha / self.beta**2


@dataclasses.dataclass(frozen=True)
class InverseGamma(Distribution):
    alpha: float = 3.0
    beta: float = 1.0            # scale
    lower: ClassVar[float] = 0.0
    name: ClassVar[str] = "InverseGamma"

    @classmethod
    def from_moments(cls, mu: float, sigma: float) -> "InverseGamma":
        """InverseGamma with the given mean and standard deviation."""
        alpha = mu**2 / sigma**2 + 2
        return cls(alpha=alpha, beta=mu * (alpha - 1))

    def logpdf(self, x):
        a, b = self.alpha, self.beta
        xs = torch.clamp(x, min=1e-300)
        val = a * math.log(b) - math.lgamma(a) - (a + 1) * torch.log(xs) - b / xs
        return torch.where(x > 0, val, -math.inf)

    def sample(self, generator, shape=()):
        return self.beta / _std_gamma(generator, self.alpha, shape)

    def ppf(self, q):
        from scipy.stats import invgamma

        return invgamma.ppf(q, self.alpha, scale=self.beta)

    def mean(self):
        if self.alpha <= 1:
            return np.nan
        return self.beta / (self.alpha - 1)

    def variance(self):
        if self.alpha <= 2:
            return np.nan
        return self.beta**2 / ((self.alpha - 1) ** 2 * (self.alpha - 2))


@dataclasses.dataclass(frozen=True)
class LogNormal(Distribution):
    mu: float = 0.0
    sigma: float = 1.0
    lower: ClassVar[float] = 0.0
    name: ClassVar[str] = "LogNormal"

    def logpdf(self, x):
        xs = torch.clamp(x, min=1e-300)
        z = (torch.log(xs) - self.mu) / self.sigma
        val = -0.5 * (z * z + _LOG2PI) - math.log(self.sigma) - torch.log(xs)
        return torch.where(x > 0, val, -math.inf)

    def sample(self, generator, shape=()):
        return torch.exp(self.mu + self.sigma * _normal(generator, shape))

    def ppf(self, q):
        from scipy.special import ndtri

        return np.exp(self.mu + self.sigma * ndtri(q))

    def mean(self):
        return float(np.exp(self.mu + self.sigma**2 / 2))

    def variance(self):
        s2 = self.sigma**2
        return float((np.exp(s2) - 1) * np.exp(2 * self.mu + s2))


@dataclasses.dataclass(frozen=True)
class Exponential(Distribution):
    lam: float = 1.0
    lower: ClassVar[float] = 0.0
    name: ClassVar[str] = "Exponential"

    def logpdf(self, x):
        return torch.where(x >= 0, math.log(self.lam) - self.lam * x, -math.inf)

    def sample(self, generator, shape=()):
        return -torch.log1p(-_uniform(generator, shape)) / self.lam

    def ppf(self, q):
        return -np.log1p(-np.asarray(q)) / self.lam

    def mean(self):
        return 1.0 / self.lam

    def variance(self):
        return 1.0 / self.lam**2


@dataclasses.dataclass(frozen=True)
class StudentT(Distribution):
    nu: float = 5.0
    mu: float = 0.0
    sigma: float = 1.0
    name: ClassVar[str] = "StudentT"

    def logpdf(self, x):
        nu, mu, s = self.nu, self.mu, self.sigma
        z = (x - mu) / s
        return (math.lgamma((nu + 1) / 2) - math.lgamma(nu / 2)
                - 0.5 * math.log(nu * math.pi) - math.log(s)
                - (nu + 1) / 2 * torch.log1p(z * z / nu))

    def sample(self, generator, shape=()):
        z = _normal(generator, shape)
        chi2 = 2.0 * _std_gamma(generator, self.nu / 2.0, shape)
        return self.mu + self.sigma * z / torch.sqrt(chi2 / self.nu)

    def ppf(self, q):
        from scipy.stats import t as sp_t

        return sp_t.ppf(q, self.nu, loc=self.mu, scale=self.sigma)

    def mean(self):
        return self.mu

    def variance(self):
        return self.sigma**2 * self.nu / (self.nu - 2) if self.nu > 2 else np.nan


@dataclasses.dataclass(frozen=True)
class TruncatedNormal(Distribution):
    mu: float = 0.0
    sigma: float = 1.0
    lower_: float = -np.inf
    upper_: float = np.inf
    name: ClassVar[str] = "TruncatedNormal"

    def support(self):
        return (self.lower_, self.upper_)

    def _std_bounds(self):
        return ((self.lower_ - self.mu) / self.sigma,
                (self.upper_ - self.mu) / self.sigma)

    def _log_z(self):
        from scipy.special import ndtr

        a, b = self._std_bounds()
        return math.log(ndtr(b) - ndtr(a))

    def logpdf(self, x):
        z = (x - self.mu) / self.sigma
        base = -0.5 * (z * z + _LOG2PI) - math.log(self.sigma) - self._log_z()
        inside = (x >= self.lower_) & (x <= self.upper_)
        return torch.where(inside, base, -math.inf)

    def sample(self, generator, shape=()):
        from scipy.special import ndtr

        a, b = self._std_bounds()
        pa, pb = float(ndtr(a)), float(ndtr(b))
        u = _uniform(generator, shape)
        return self.mu + self.sigma * torch.special.ndtri(pa + u * (pb - pa))

    def ppf(self, q):
        from scipy.stats import truncnorm

        a, b = self._std_bounds()
        return truncnorm.ppf(q, a, b, loc=self.mu, scale=self.sigma)

    def mean(self):
        from scipy.stats import truncnorm

        a, b = self._std_bounds()
        return float(truncnorm.mean(a, b, loc=self.mu, scale=self.sigma))

    def variance(self):
        from scipy.stats import truncnorm

        a, b = self._std_bounds()
        return float(truncnorm.var(a, b, loc=self.mu, scale=self.sigma))


def Truncated(dist: Distribution, lower: float | None = None,
              upper: float | None = None) -> Distribution:
    """Generic truncation wrapper (renormalized via the base CDF)."""
    if isinstance(dist, Normal):
        return TruncatedNormal(
            mu=dist.mu, sigma=dist.sigma,
            lower_=lower if lower is not None else -np.inf,
            upper_=upper if upper is not None else np.inf)
    return _TruncatedGeneric(dist, lower, upper)


@dataclasses.dataclass(frozen=True)
class _TruncatedGeneric(Distribution):
    base: Distribution = None  # type: ignore[assignment]
    lower_: float | None = None
    upper_: float | None = None
    name: ClassVar[str] = "Truncated"

    def support(self):
        lo, hi = self.base.support()
        if self.lower_ is not None:
            lo = max(lo, self.lower_)
        if self.upper_ is not None:
            hi = min(hi, self.upper_)
        return (lo, hi)

    def _mass(self):
        lo, hi = self.support()
        base_lo, base_hi = self.base.support()
        q_lo = 0.0 if lo <= base_lo else self._cdf_host(lo)
        q_hi = 1.0 if hi >= base_hi else self._cdf_host(hi)
        return q_lo, q_hi

    def _cdf_host(self, x):
        from scipy.optimize import brentq

        return brentq(lambda q: float(self.base.ppf(q)) - x, 1e-12, 1 - 1e-12)

    def logpdf(self, x):
        q_lo, q_hi = self._mass()
        lo, hi = self.support()
        inside = (x >= lo) & (x <= hi)
        return torch.where(inside,
                           self.base.logpdf(x) - math.log(q_hi - q_lo),
                           -math.inf)

    def sample(self, generator, shape=()):
        q_lo, q_hi = self._mass()
        u = q_lo + (q_hi - q_lo) * _uniform(generator, shape)
        return torch.as_tensor(np.asarray(self.base.ppf(u.cpu().numpy())),
                               dtype=_SAMPLE_DTYPE, device=generator.device)

    def ppf(self, q):
        q_lo, q_hi = self._mass()
        return self.base.ppf(q_lo + np.asarray(q) * (q_hi - q_lo))

    def mean(self):
        return float(self.ppf(0.5))

    def variance(self):
        qs = self.ppf(np.linspace(0.005, 0.995, 199))
        return float(np.var(qs))


# ---------------------------------------------------------------- maxent fit

_MAXENT_FITTERS = {
    "Beta": ("alpha", "beta", Beta),
    "Gamma": ("alpha", "beta", Gamma),
    "InverseGamma": ("alpha", "beta", InverseGamma),
    "Normal": ("mu", "sigma", Normal),
    "LogNormal": ("mu", "sigma", LogNormal),
}


def maxent(dist: Distribution, lower: float, upper: float, mass: float = 0.99
           ) -> Distribution:
    """Maximum-entropy member of ``dist``'s family with
    P(lower < X < upper) = mass (host-side scipy fit at model build; the
    same procedure as the reference's ``maxent``)."""
    import scipy.optimize as opt
    import scipy.stats as st

    family = type(dist).name
    if family not in _MAXENT_FITTERS:
        raise ValueError(f"maxent not supported for {family}")
    p1, p2, cls = _MAXENT_FITTERS[family]

    def scipy_frozen(a, b):
        if family == "Beta":
            return st.beta(a, b)
        if family == "Gamma":
            return st.gamma(a, scale=1.0 / b)
        if family == "InverseGamma":
            return st.invgamma(a, scale=b)
        if family == "Normal":
            return st.norm(a, b)
        return st.lognorm(b, scale=np.exp(a))

    def neg_entropy_penalized(params):
        a, b = params
        if family in ("Beta", "Gamma", "InverseGamma") and (a <= 0 or b <= 0):
            return 1e6
        if family in ("Normal", "LogNormal") and b <= 0:
            return 1e6
        fr = scipy_frozen(a, b)
        interval_mass = fr.cdf(upper) - fr.cdf(lower)
        penalty = 5000.0 * (interval_mass - mass) ** 2
        try:
            ent = fr.entropy()
        except (ValueError, FloatingPointError, OverflowError):
            return 1e6
        return -float(ent) + penalty

    mid = 0.5 * (lower + upper)
    spread = max((upper - lower) / 4, 1e-3)
    if family == "Beta":
        mid_c = float(np.clip(mid, 0.01, 0.99))
        sd_c = float(min(spread, np.sqrt(mid_c * (1 - mid_c)) * 0.9))
        b0 = Beta.from_moments(mid_c, sd_c)
        x0 = np.array([b0.alpha, b0.beta])
    elif family == "Gamma":
        g0 = Gamma.from_moments(max(mid, 1e-3), spread)
        x0 = np.array([g0.alpha, g0.beta])
    elif family == "InverseGamma":
        ig0 = InverseGamma.from_moments(max(mid, 1e-3), spread)
        x0 = np.array([ig0.alpha, ig0.beta])
    elif family == "LogNormal":
        x0 = np.array([np.log(max(mid, 1e-3)), 0.5])
    else:
        x0 = np.array([mid, spread])

    res = opt.minimize(neg_entropy_penalized, x0, method="Nelder-Mead",
                       options={"maxiter": 2000, "xatol": 1e-10, "fatol": 1e-12})
    a, b = res.x
    return cls(**{p1: float(a), p2: float(b)})


DIST_REGISTRY: dict[str, type] = {
    "normal": Normal,
    "halfnormal": HalfNormal,
    "truncatednormal": TruncatedNormal,
    "beta": Beta,
    "gamma": Gamma,
    "inversegamma": InverseGamma,
    "invgamma": InverseGamma,
    "uniform": Uniform,
    "lognormal": LogNormal,
    "exponential": Exponential,
    "studentt": StudentT,
    "t": StudentT,
}


def get_distribution_class(name: str):
    """Distribution class by GCN name (KeyError on unknown names)."""
    cls = DIST_REGISTRY.get(name.lower())
    if cls is None:
        raise KeyError(name)
    return cls
