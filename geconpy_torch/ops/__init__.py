"""Numeric building blocks and the hand-written CUDA kernels' wrappers
(mirrors ``geconpy_tpu/ops``).  The reference's exports of the smoother and
the parallel filter are re-exported here; the other modules are imported
by name."""

from .kalman import KalmanSmootherResult, kalman_smoother
from .parallel_kalman import parallel_kalman_filter, parallel_kalman_loglik

__all__ = ["KalmanSmootherResult", "kalman_smoother",
           "parallel_kalman_filter", "parallel_kalman_loglik"]
