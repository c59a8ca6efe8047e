"""Model layer (mirrors ``geconpy_tpu/models``): the compiled model, the
analytic and numeric steady state, the linearization and the first-order
solution."""

from .model import Model, PolicySolution, model_from_gcn
from .perturbation import make_linearizer, spectral_radius
from .steady_state import (SteadyStateSolution, make_fixed_value_solver,
                           make_steady_state_solver)

__all__ = ["Model", "PolicySolution", "model_from_gcn", "make_linearizer", "spectral_radius",
           "SteadyStateSolution", "make_steady_state_solver",
           "make_fixed_value_solver"]
