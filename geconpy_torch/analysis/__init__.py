"""Analysis of a solved model: impulse responses and stochastic
simulation (:mod:`~geconpy_torch.analysis.simulate`)."""

from .simulate import (impulse_response, impulse_response_function,
                       impulse_response_second_order, simulate,
                       simulate_linear, simulate_second_order)

__all__ = ["impulse_response", "impulse_response_function", "simulate",
           "simulate_linear", "simulate_second_order",
           "impulse_response_second_order"]
