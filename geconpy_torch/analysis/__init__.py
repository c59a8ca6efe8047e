"""Analysis of a solved model: impulse responses and stochastic
simulation (:mod:`~geconpy_torch.analysis.simulate`), nonlinear
perfect-foresight transitions
(:mod:`~geconpy_torch.analysis.perfect_foresight`) and occasionally-binding
constraints (:mod:`~geconpy_torch.analysis.occbin`)."""

from .occbin import OccbinIRF, OccbinResult, occbin_irf, solve_occbin
from .perfect_foresight import PerfectForesightResult, solve_perfect_foresight
from .simulate import (impulse_response, impulse_response_function,
                       impulse_response_second_order, simulate,
                       simulate_linear, simulate_second_order)

__all__ = ["OccbinIRF", "OccbinResult", "solve_occbin", "occbin_irf",
           "PerfectForesightResult", "solve_perfect_foresight",
           "impulse_response", "impulse_response_function", "simulate",
           "simulate_linear", "simulate_second_order",
           "impulse_response_second_order"]
