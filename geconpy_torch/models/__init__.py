"""Model layer (mirrors ``geconpy_tpu/models``): the compiled model, the
analytic and numeric steady state, the linearization and the first-order
solution."""

from .block import Block, BlockEquation
from .model import Model, PolicySolution, model_from_gcn
from .perturbation import (make_linearizer, solve_policy_backward,
                           spectral_radius)
from .primitives import (ModelPrimitives, load_gcn, load_gcn_file,
                         propagate_steady_state_through_identities,
                         system_to_steady_state)
from .registry import dispatch_block, register_block
from .special_blocks import CESBlock, CobbDouglasBlock
from .steady_state import (SteadyStateSolution, make_fixed_value_solver,
                           make_steady_state_solver)

__all__ = [
    "Block", "BlockEquation", "Model", "PolicySolution", "model_from_gcn",
    "make_linearizer", "solve_policy_backward", "spectral_radius",
    "ModelPrimitives", "load_gcn", "load_gcn_file",
    "propagate_steady_state_through_identities", "system_to_steady_state",
    "dispatch_block", "register_block", "CESBlock", "CobbDouglasBlock",
    "SteadyStateSolution", "make_fixed_value_solver",
    "make_steady_state_solver",
]
