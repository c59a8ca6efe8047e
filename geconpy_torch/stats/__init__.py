"""Estimation layer (mirrors ``geconpy_tpu/stats``): the state space and its
batched likelihood sweep."""

from .statespace import DSGEStateSpace, EstimatedParameter

__all__ = ["DSGEStateSpace", "EstimatedParameter"]
