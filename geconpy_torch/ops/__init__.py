"""Numeric building blocks and the hand-written CUDA kernels' wrappers
(mirrors ``geconpy_tpu/ops``).  The reference's exports of the smoother,
the parallel filter, the particle filter and the unscented filters are
re-exported here; the other modules are imported
by name."""

from .kalman import KalmanSmootherResult, kalman_smoother
from .parallel_kalman import parallel_kalman_filter, parallel_kalman_loglik
from .particle_filter import (ParticleFilterResult, particle_filter_loglik,
                              systematic_resample)
from .ukf import (CLUKFResult, UKFResult, UKFSmootherResult, cl_ukf_loglik,
                  ukf_loglik, ukf_smoother)

__all__ = ["KalmanSmootherResult", "kalman_smoother",
           "parallel_kalman_filter", "parallel_kalman_loglik",
           "ParticleFilterResult", "particle_filter_loglik",
           "systematic_resample", "UKFResult", "UKFSmootherResult",
           "CLUKFResult", "ukf_loglik", "ukf_smoother", "cl_ukf_loglik"]
