"""geconpy_torch — the PyTorch/CUDA port of :mod:`geconpy_tpu` for NVIDIA
Hopper GPUs.

The JAX package stays the reference; this package mirrors its module names
and is held against it in ``tests/test_torch_*.py``.  It carries its own
copy of the sympy front-end (``lang/``, ``symbolic/``, the model primitives
and ``dists/from_ast.py``) and of the bundled example models (``data/``),
and imports ``torch``, never ``jax`` nor anything of ``geconpy_tpu``.

Ported so far: the steady state of every bundled model, analytic or
numeric (``Model.steady_state``; the batched root finders of
``ops/newton.py`` with the implicit-function gradient of
``ops/implicit.py``), the solved model (``Model.solve_model`` with cycle
reduction, the device gensys of ``ops/gensys_jax.py``, the host gensys and
the backward solver, returning a ``PolicySolution``; ``linearize_model``
and ``check_bk_condition``), its impulse responses, simulations and
moments (``analysis/simulate.py``, ``stats/covariance.py``), the
``statespace_from_gcn`` front door, the single-draw log posterior on the sequential
Kalman filter with the XLA policy (``DSGEStateSpace.build_logpost``, the
twin of the reference's ``entry()``), the batched forward likelihood sweep
(``build_batched_loglik`` with its ``"xla"`` and ``"pallas"`` policies and
``"xla"``, ``"pallas"`` and ``"fused"`` settles), the batched
value+gradient (``build_batched_logpost_and_grad``), SMC estimation on the
sweep (``fit_smc``) and NUTS estimation (``fit``, ``policy="xla"`` or
``"pallas"``: one batched value+gradient call for all chains per leapfrog
step), every filter of the likelihood (sequential, parallel,
Chandrasekhar, steady state, and stationary with the Hewer, SDA and auto
settles, which routes mixed-frequency data to the cyclostationary filter),
the smoothers behind ``DSGEStateSpace.filter_data``, the posterior tools
(IRF, autocorrelation, FEVD and predictive bands, solver diagnostics,
smoothed states, the historical shock decomposition, unconditional and
conditional forecasts), the model evidence (Laplace and modified harmonic
mean, ``compare_models``) and maximum likelihood (``fit_ml``), the
solvability, Blanchard-Kahn and prior predictive sweeps with the
eigenvalue sensitivities, the prior samplers and ``check_steady_state``,
the other estimators (GMM, IRF matching, DSGE-VAR, Iskrev identification,
the detrending filters) and the deterministic paths (nonlinear perfect
foresight with its block-tridiagonal and Newton-Krylov solvers, OccBin),
checkpointed NUTS (``stats/checkpoint.py``), device meshes for the
chains, particles and sweeps (``parallel``), the persistent cache of the
kernels' build (``utils/compile_cache.py``, ``GECONPY_TORCH_CACHE_DIR``),
profiler and memory tables (``utils/profiling.py``, ``utils/memory.py``),
the reports, the Dynare export and the plots (``utils/reporting.py``,
``analysis/dynare.py``, ``analysis/plotting.py``), with hand-written CUDA
kernels for cycle reduction, the Riccati settle, the filter tail, the
fused settle + tail and the DARE settle: every TPU kernel of the reference
has its counterpart.
A ``DSGEStateSpace`` runs on the GPU unless it is built with
``device="cpu"``, and ``Model.steady_state``, ``Model.solve_model`` and
``statespace_from_gcn`` unless they are given ``device="cpu"``; results
with labels are tensors with name lists (no pandas).
"""

__version__ = "0.1.0"

import os as _os
import pathlib as _pathlib

from . import parallel
from .analysis.dynare import make_mod_file
from .analysis.occbin import OccbinResult, solve_occbin
from .analysis.perfect_foresight import (PerfectForesightResult,
                                         solve_perfect_foresight)
from .analysis.simulate import impulse_response_function, simulate
from .lang import parse_gcn, print_model
from .models.model import Model, PolicySolution, model_from_gcn
from .models.primitives import ModelPrimitives, load_gcn, load_gcn_file
from .models.validation import check_steady_state
from .stats.covariance import (autocorrelation_matrix, autocovariance_matrix,
                               build_Q_matrix, stationary_covariance_matrix)
from .stats.estimation import PosteriorResult, fit
from .stats.forecast import conditional_forecast, posterior_forecast
from .stats.perturbation_diagnostics import (bk_condition_sweep,
                                             check_bk_condition,
                                             eigenvalue_sensitivity,
                                             prior_solvability_check,
                                             solvability_check,
                                             summarize_perturbation_solution)
from .stats.posterior import prepare_mixed_frequency_data
from .stats.sampling import (bounds_from_priors, sample_from_priors,
                             sample_from_priors_qmc, sample_uniform,
                             sample_uniform_from_priors)
from .stats.smc import SMCResult, fit_smc
from .stats.statespace import (DSGEStateSpace, data_from_prior,
                               statespace_from_gcn)
from .symbolic import SteadyStateResults, SymbolDictionary, TimeAwareSymbol
from .utils.compile_cache import (enable_persistent_cache,
                                  persistent_cache_enabled)
from .utils.formatting import matrix_to_dataframe
from .utils.reporting import print_gcn_file, print_steady_state

# GECONPY_TORCH_CACHE_DIR set before import turns on the persistent cache of
# the CUDA kernels' build there (the reference's env tier)
if _os.environ.get("GECONPY_TORCH_CACHE_DIR"):
    enable_persistent_cache()

__all__ = ["DSGEStateSpace", "Model", "ModelPrimitives", "OccbinResult",
           "PerfectForesightResult", "PolicySolution", "PosteriorResult",
           "SMCResult", "SteadyStateResults", "SymbolDictionary",
           "TimeAwareSymbol", "autocorrelation_matrix",
           "autocovariance_matrix", "bk_condition_sweep",
           "bounds_from_priors", "build_Q_matrix", "check_bk_condition",
           "check_steady_state", "conditional_forecast", "data_from_prior",
           "eigenvalue_sensitivity", "enable_persistent_cache", "fit",
           "fit_smc", "get_example_gcn", "impulse_response_function",
           "load_gcn", "load_gcn_file", "make_mod_file",
           "matrix_to_dataframe", "model_from_gcn", "parallel", "parse_gcn",
           "persistent_cache_enabled", "posterior_forecast",
           "prepare_mixed_frequency_data", "print_gcn_file", "print_model",
           "print_steady_state", "prior_solvability_check",
           "sample_from_priors", "sample_from_priors_qmc", "sample_uniform",
           "sample_uniform_from_priors", "simulate", "solvability_check",
           "solve_occbin", "solve_perfect_foresight",
           "stationary_covariance_matrix", "statespace_from_gcn",
           "summarize_perturbation_solution"]


def get_example_gcn(name: str = "rbc") -> str:
    """Return the source of a bundled example model (``geconpy_torch/data``;
    mirrors ``geconpy_tpu/__init__.py:59``)."""
    data_dir = _pathlib.Path(__file__).parent / "data"
    path = data_dir / f"{name}.gcn"
    if not path.exists():
        available = sorted(p.stem for p in data_dir.glob("*.gcn"))
        raise FileNotFoundError(f"no example model {name!r}; available: {available}")
    return path.read_text()
