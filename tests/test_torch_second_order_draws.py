"""The given normals of the second-order card tests, on the CPU.

``tests/test_torch_cuda.py`` runs the particle filter on given standard
normals (``build_pf_loglik_second_order(...).from_draws``) and the GIRF
paths (``posterior._girf_paths``) of ``rbc_estimation`` on the card and on
the CPU.  Their shock normals need one column per shock of the model
(``rbc_estimation`` has one).  Here the same inputs, built the same way,
go through the same functions on the CPU, so that a fault of their shapes
shows without a card: the filter accepts both draws with finite,
reproducible log-likelihoods, and the GIRF paths are finite, one
(periods, variables) path a draw.  CPU, float64.
"""

import numpy as np
import pytest
import torch

import geconpy_torch
from geconpy_torch.stats import nonlinear, posterior
from geconpy_torch.stats.estimation import PosteriorResult
from geconpy_torch.stats.statespace import DSGEStateSpace

PERIODS, PARTICLES, GIRF_PERIODS, N_MC = 40, 256, 6, 8


@pytest.fixture(scope="module")
def rbc_posterior():
    """``rbc_estimation`` with Y and C observed with measurement error, 40
    periods of data and 2 x 4 jittered draws (the card tests' fixture, on
    the CPU)."""
    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"))
    ss = DSGEStateSpace(model, device="cpu").configure(
        observed_states=["Y", "C"], measurement_error=["Y", "C"])
    data, draw = ss.data_from_prior(torch.Generator().manual_seed(0),
                                    periods=PERIODS)
    u0 = ss.unconstrain(draw).numpy()
    us = u0[None, None] + 0.04 * np.random.default_rng(0).standard_normal(
        (2, 4, len(u0)))
    result = PosteriorResult(
        samples=us, unconstrained=us, logp=np.zeros((2, 4)),
        param_names=ss.param_labels, diverging=np.zeros((2, 4), bool),
        accept_prob=np.ones((2, 4)), step_size=np.full(2, 0.1))
    return ss, result, data


def test_particle_filter_from_draws_takes_the_models_shock_count(
        rbc_posterior):
    ss, result, data = rbc_posterior
    U = torch.as_tensor(result.unconstrained.reshape(-1, len(ss.estimated)))
    nz = 2 * ss.model.functions.n_variables
    n_shocks = len(ss.model.functions.shock_names)
    g_ = torch.Generator().manual_seed(4)
    init = torch.randn((2, PARTICLES, nz), generator=g_, dtype=torch.float64)
    us = torch.rand((PERIODS, 2), generator=g_, dtype=torch.float64)
    eps = torch.randn((PERIODS, 2, PARTICLES, n_shocks), generator=g_,
                      dtype=torch.float64)
    pf = ss.build_pf_loglik_second_order(data, n_particles=PARTICLES)
    runs = [pf.from_draws(U[:2], init, lambda t: (us[t], eps[t]))
            for _ in range(2)]
    ll, ok = runs[0]
    assert ll.shape == (2,) and bool(ok.all())
    assert bool(torch.isfinite(ll).all())
    assert torch.equal(ll, runs[1][0])


def test_girf_paths_take_the_models_shock_count(rbc_posterior):
    ss, result, _data = rbc_posterior
    us = posterior._flat_draws(ss, result, None)
    n_shocks = len(ss.model.functions.shock_names)
    normals = torch.randn((us.shape[0], N_MC, GIRF_PERIODS, n_shocks),
                          generator=torch.Generator().manual_seed(5),
                          dtype=torch.float64)
    paths = posterior._girf_paths(nonlinear._solution_fn(ss)(us), 0, None,
                                  normals)
    assert paths.shape == (us.shape[0], GIRF_PERIODS,
                           ss.model.functions.n_variables)
    assert bool(torch.isfinite(paths).all())
