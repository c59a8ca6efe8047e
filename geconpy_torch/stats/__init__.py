"""Estimation layer (mirrors ``geconpy_tpu/stats``): the state space with its
single-draw log posterior, batched likelihood sweep and value+gradient, the
SMC sampler on the sweep, NUTS (``fit``) with its mode search and
diagnostics, and the posterior's smoothed states and mixed-frequency data
grid."""

from .estimation import PosteriorResult, fit
from .posterior import posterior_smoothed_states, prepare_mixed_frequency_data
from .smc import SMCResult, fit_smc
from .statespace import DSGEStateSpace, EstimatedParameter

__all__ = ["DSGEStateSpace", "EstimatedParameter", "PosteriorResult",
           "SMCResult", "fit", "fit_smc", "posterior_smoothed_states",
           "prepare_mixed_frequency_data"]
