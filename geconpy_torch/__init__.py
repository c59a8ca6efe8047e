"""geconpy_torch — the PyTorch/CUDA port of :mod:`geconpy_tpu` for NVIDIA
Hopper GPUs.

The JAX package stays the reference; this package mirrors its module names
and is held against it in ``tests/test_torch_*.py``.  Its first slice is the
batched forward likelihood sweep (``DSGEStateSpace.build_batched_loglik``)
with hand-written CUDA kernels for cycle reduction, the Riccati settle and
the constant-gain filter tail.  The sympy front-end is the reference's own,
loaded without JAX by :mod:`geconpy_torch._frontend`.  This package imports
``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

from ._frontend import get_example_gcn
from .models.model import Model, model_from_gcn
from .stats.statespace import DSGEStateSpace

__all__ = ["DSGEStateSpace", "Model", "get_example_gcn", "model_from_gcn"]
