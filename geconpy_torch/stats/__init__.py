"""Estimation layer (mirrors ``geconpy_tpu/stats``): the state space with its
single-draw log posterior, batched likelihood sweep and value+gradient, the
SMC sampler on the sweep, NUTS (``fit``, first or second order) with its
mode search and diagnostics, the second-order likelihoods and PMMH, maximum likelihood and the model evidence, the posterior
tools and forecasts, the solvability, BK and prior predictive sweeps, the
prior samplers, the minimum-distance estimators (GMM, IRF matching), the
DSGE-VAR, Iskrev identification, the detrending filters
(``stats.detrend``) and resumable NUTS (``stats.checkpoint``)."""

from .checkpoint import (fit_with_checkpointing, load_checkpoint,
                         save_checkpoint)
from .covariance import (autocorrelation, autocovariance,
                         autocovariance_matrix, fevd, stationary_covariance,
                         stationary_covariance_matrix)
from .diagnostics import effective_sample_size, split_rhat, summarize_chains
from .dsge_var import (dsge_var_lambda_profile, dsge_var_marginal_likelihood,
                       dsge_var_moments)
from .estimation import PosteriorResult, fit, fit_pmmh
from .forecast import conditional_forecast, posterior_forecast
from .identification import IdentificationResult, iskrev_identification
from .irf_matching import IRFMatchResult, build_irf_fn, fit_irf_matching
from .ml import MLResult, fit_ml
from .moment_matching import (MomentMatchResult, fit_moment_matching,
                              model_moments)
from .model_comparison import (compare_models, find_map, laplace_evidence,
                               marginal_likelihood, modified_harmonic_mean)
from .nuts import NUTSResult, nuts_kernel, sample_nuts
from .nonlinear import (build_logpost_second_order,
                        build_pf_loglik_second_order,
                        build_second_order_solution_fn,
                        filter_data_second_order, quadratic_drive_covariance)
from .perturbation_diagnostics import (bk_condition_sweep,
                                       eigenvalue_sensitivity,
                                       make_bk_count_fn,
                                       prior_solvability_check,
                                       solvability_check,
                                       spectral_radius_sensitivity,
                                       summarize_perturbation_solution)
from .posterior import (posterior_autocorrelation, posterior_diagnostics,
                        posterior_fevd, posterior_girfs, posterior_irfs,
                        posterior_predictive, posterior_smoothed_states,
                        prepare_mixed_frequency_data)
from .pmmh import PMMHResult, sample_pmmh
from .prior_predictive import prior_predictive_sweep
from .sampling import (bounds_from_priors, sample_from_priors,
                       sample_from_priors_qmc, sample_uniform_from_priors)
from .smc import SMCResult, fit_smc
from .statespace import DSGEStateSpace, EstimatedParameter, LogPostExtras

__all__ = [
    "DSGEStateSpace", "EstimatedParameter", "LogPostExtras",
    "PosteriorResult", "fit", "fit_with_checkpointing",
    "load_checkpoint", "save_checkpoint",
    "NUTSResult", "nuts_kernel", "sample_nuts",
    "fit_pmmh", "PMMHResult", "sample_pmmh",
    "build_logpost_second_order", "build_pf_loglik_second_order",
    "build_second_order_solution_fn", "filter_data_second_order",
    "quadratic_drive_covariance",
    "posterior_forecast", "conditional_forecast",
    "SMCResult", "fit_smc",
    "dsge_var_marginal_likelihood", "dsge_var_lambda_profile",
    "dsge_var_moments",
    "IRFMatchResult", "build_irf_fn", "fit_irf_matching",
    "MomentMatchResult", "fit_moment_matching", "model_moments",
    "IdentificationResult", "iskrev_identification",
    "MLResult", "fit_ml", "compare_models", "find_map", "laplace_evidence",
    "marginal_likelihood", "modified_harmonic_mean",
    "effective_sample_size", "split_rhat", "summarize_chains",
    "stationary_covariance", "stationary_covariance_matrix",
    "autocovariance", "autocovariance_matrix", "autocorrelation", "fevd",
    "eigenvalue_sensitivity", "spectral_radius_sensitivity",
    "prior_solvability_check", "solvability_check",
    "summarize_perturbation_solution", "bk_condition_sweep", "make_bk_count_fn",
    "posterior_irfs", "posterior_autocorrelation", "posterior_fevd",
    "posterior_smoothed_states", "posterior_diagnostics",
    "posterior_predictive", "posterior_girfs", "prior_predictive_sweep",
    "prepare_mixed_frequency_data",
    "bounds_from_priors", "sample_from_priors", "sample_from_priors_qmc",
    "sample_uniform_from_priors",
]
