"""Numeric building blocks and the hand-written CUDA kernels' wrappers
(mirrors ``geconpy_tpu/ops``)."""
