"""Analysis of a solved model: impulse responses and stochastic
simulation (:mod:`~geconpy_torch.analysis.simulate`)."""
