"""Numeric building blocks and the hand-written CUDA kernels' wrappers
(mirrors ``geconpy_tpu/ops``): the reference's exports, under its names;
the kernels' wrappers are imported by module."""

from .bijectors import VectorBijector, make_bijector
from .block_tridiag import solve_block_tridiagonal
from .cycle_reduction import (CycleReductionResult, cycle_reduction,
                              selection_matrix, solve_policy_cycle_reduction)
from .gensys_jax import GensysJaxResult, gensys_jax, make_gensys_solver
from .gensys_np import gensys, gensys_setup, interpret_eu, solve_policy_gensys
from .implicit import implicit_root
from .kalman import (KalmanFilterResult, KalmanSmootherResult, kalman_filter,
                     kalman_loglik, kalman_smoother,
                     steady_state_kalman_loglik)
from .lyapunov import solve_discrete_lyapunov
from .newton import (RootResult, dogleg_solve, levenberg_marquardt_solve,
                     newton_solve, root)
from .parallel_kalman import parallel_kalman_filter, parallel_kalman_loglik
from .particle_filter import (ParticleFilterResult, particle_filter_loglik,
                              systematic_resample)
from .qz_disk import DiskSplitResult, disk_function_split
from .ukf import (CLUKFResult, UKFResult, UKFSmootherResult, cl_ukf_loglik,
                  ukf_loglik, ukf_smoother)

__all__ = [
    "VectorBijector", "make_bijector", "solve_block_tridiagonal",
    "CycleReductionResult", "cycle_reduction", "selection_matrix",
    "solve_policy_cycle_reduction",
    "GensysJaxResult", "gensys_jax", "make_gensys_solver",
    "gensys", "gensys_setup", "interpret_eu", "solve_policy_gensys",
    "implicit_root",
    "KalmanFilterResult", "KalmanSmootherResult", "kalman_filter",
    "kalman_loglik", "kalman_smoother", "steady_state_kalman_loglik",
    "parallel_kalman_filter", "parallel_kalman_loglik",
    "solve_discrete_lyapunov",
    "RootResult", "dogleg_solve", "levenberg_marquardt_solve",
    "newton_solve", "root",
    "DiskSplitResult", "disk_function_split",
    "ParticleFilterResult", "particle_filter_loglik", "systematic_resample",
    "UKFResult", "UKFSmootherResult", "CLUKFResult", "ukf_loglik",
    "ukf_smoother", "cl_ukf_loglik",
]
