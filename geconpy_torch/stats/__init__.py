"""Estimation layer (mirrors ``geconpy_tpu/stats``): the state space with its
single-draw log posterior, batched likelihood sweep and value+gradient, the
SMC sampler on the sweep, and NUTS (``fit``) with its mode search and
diagnostics."""

from .estimation import PosteriorResult, fit
from .smc import SMCResult, fit_smc
from .statespace import DSGEStateSpace, EstimatedParameter

__all__ = ["DSGEStateSpace", "EstimatedParameter", "PosteriorResult",
           "SMCResult", "fit", "fit_smc"]
