"""Analysis of a solved model: impulse responses and stochastic
simulation (:mod:`~geconpy_torch.analysis.simulate`), nonlinear
perfect-foresight transitions
(:mod:`~geconpy_torch.analysis.perfect_foresight`), occasionally-binding
constraints (:mod:`~geconpy_torch.analysis.occbin`), the Dynare export
(:mod:`~geconpy_torch.analysis.dynare`) and the plots
(:mod:`~geconpy_torch.analysis.plotting`, imported by name: it needs
matplotlib)."""

from .dynare import DynarePrinter, make_mod_file
from .occbin import OccbinIRF, OccbinResult, occbin_irf, solve_occbin
from .perfect_foresight import PerfectForesightResult, solve_perfect_foresight
from .simulate import (impulse_response, impulse_response_function,
                       impulse_response_second_order, simulate,
                       simulate_linear, simulate_second_order)

__all__ = ["DynarePrinter", "make_mod_file", "OccbinIRF", "OccbinResult", "solve_occbin", "occbin_irf",
           "PerfectForesightResult", "solve_perfect_foresight",
           "impulse_response", "impulse_response_function", "simulate",
           "simulate_linear", "simulate_second_order",
           "impulse_response_second_order"]
