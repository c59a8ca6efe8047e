"""sympy -> torch code generation (mirrors ``geconpy_tpu/codegen``)."""

from .lower import CompiledFunction, lower_to_torch
from .model_functions import ModelFunctions, build_model_functions

__all__ = ["CompiledFunction", "lower_to_torch", "ModelFunctions",
           "build_model_functions"]
