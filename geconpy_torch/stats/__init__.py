"""Estimation layer (mirrors ``geconpy_tpu/stats``): the state space with its
batched likelihood sweep and value+gradient, and the SMC sampler on the
sweep."""

from .smc import SMCResult, fit_smc
from .statespace import DSGEStateSpace, EstimatedParameter

__all__ = ["DSGEStateSpace", "EstimatedParameter", "SMCResult", "fit_smc"]
