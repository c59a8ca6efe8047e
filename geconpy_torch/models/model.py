"""The compiled model object, as far as the batched sweep needs it.

Mirrors ``geconpy_tpu/models/model.py`` (``Model``, ``model_from_gcn``),
as a subset: ``functions``, ``ss_solver``, ``linearizer``,
``static_reduction``, ``default_theta``, ``default_loglin`` and
``param_names``.  No pandas: the labelled host-side reports of the
reference are not ported.
"""

from __future__ import annotations

from functools import cached_property

import torch

from ..codegen.model_functions import ModelFunctions, build_model_functions
from .perturbation import make_linearizer
from .primitives import load_gcn, load_gcn_file
from .steady_state import make_steady_state_solver

__all__ = ["Model", "model_from_gcn"]


class Model:
    """A compiled DSGE model (torch numeric layer over shared primitives)."""

    def __init__(self, primitives):
        self.primitives = primitives
        self._linearizers: dict = {}

    @cached_property
    def functions(self) -> ModelFunctions:
        return build_model_functions(self.primitives)

    @cached_property
    def ss_solver(self):
        return make_steady_state_solver(self.functions)

    @property
    def default_loglin(self) -> bool:
        """Linear models (GCN ``options { linear = TRUE; }``) are already in
        deviations; log-linearization scaling is skipped for them."""
        return not self.primitives.is_linear

    def linearizer(self, loglin_variables="auto"):
        """Cached ``(x_ss, theta_full) -> LinearizationResult``."""
        if loglin_variables == "auto":
            loglin_variables = self.default_loglin
        key = (loglin_variables if isinstance(loglin_variables, bool)
               else tuple(sorted(loglin_variables)))
        if key not in self._linearizers:
            self._linearizers[key] = make_linearizer(self.functions,
                                                     loglin_variables)
        return self._linearizers[key]

    @property
    def param_names(self) -> list[str]:
        """Free parameter names, the order of ``default_theta``."""
        return [p.name for p in self.functions.free_params]

    @cached_property
    def static_reduction(self):
        """Structural static/dynamic split for the reduced policy solve."""
        from ..ops.static_reduction import plan_static_reduction

        return plan_static_reduction(self.primitives.equations,
                                     self.functions.variables)

    def default_theta(self, **updates) -> torch.Tensor:
        """Free-parameter vector from GCN calibration, with overrides."""
        values = {p.name: float(v) for p, v in self.primitives.param_dict.items()}
        unknown = set(updates) - set(values)
        if unknown:
            raise KeyError(f"unknown parameter(s): {sorted(unknown)}; "
                           f"free parameters are {sorted(values)}")
        values.update({k: float(v) for k, v in updates.items()})
        return torch.tensor([values[p.name] for p in self.functions.free_params],
                            dtype=torch.float64)

    def __repr__(self):
        mf = self.functions
        return (f"Model(variables={mf.n_variables}, shocks={mf.n_shocks}, "
                f"free_params={len(mf.free_params)}, "
                f"calibrated={len(mf.calibrated_params)})")


def model_from_gcn(source_or_path, **kwargs) -> Model:
    """Build a Model from GCN source text or a ``.gcn`` file path."""
    text = str(source_or_path)
    if "\n" not in text and text.endswith(".gcn"):
        primitives = load_gcn_file(text, **kwargs)
    else:
        primitives = load_gcn(text, **kwargs)
    return Model(primitives)
