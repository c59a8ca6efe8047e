"""DSGE state-space model: the single-draw log posterior, the batched
likelihood sweep and the batched value+gradient.

Mirrors ``geconpy_tpu/stats/statespace.py`` (``DSGEStateSpace``) as a
subset: ``configure`` (:102-336, the reference's keywords and defaults;
every filter and settle method), the
observation equations (``_setup_observation_equations``, :340, and
``aggregated_obs_equation``, :1335), the full shock covariance (:652-669,
``_vine_cholesky_np``, :1318), the cache of
built functions (:45, here ``_cached_build``), ``LogPostExtras`` (:74),
``unconstrain``/``constrain``/``initial_position`` (:501, a
``torch.Generator`` in place of a key)/``param_labels``, ``build_logpost``
(:516), ``build_solution_fn`` (:525), ``_solution_pieces`` (:544, with the
XLA policy step ``solve_policy_reduced``), ``_data_and_loglik`` (:717-797,
every filter: the sequential and parallel ones with and without
``p0_init="diffuse"``, Chandrasekhar, steady state, and the stationary one,
which routes data with periodic missingness to the cyclostationary
filter), ``build_logpost_extras`` (:800), ``filter_data`` (:1202),
``_build_design`` (:394), ``_augment_lags`` (:457),
``_static_pivot_order`` (:1092), ``_build_pallas_policy_batch`` (:1154, here
:meth:`_build_policy_batch`), ``_build_pallas_policy_batch_diff`` (:1109,
here :meth:`_build_policy_batch_diff`), ``build_batched_loglik`` (:860),
``build_batched_logpost`` (:965), ``build_batched_logpost_and_grad``
(:1076), the second-order builders (:832-857, with the batched
``build_logpost_and_grad_second_order``), ``sample_prior`` (:1244) and ``data_from_prior`` (:1252, with
``pct_missing``), and the module-level ``statespace_from_gcn`` (:1355) and
``data_from_prior`` (:1372).  The policy step routes ``solver`` as the
reference's does (``"cycle_reduction"``, ``"gensys"`` on the device disk
split of :mod:`~geconpy_torch.ops.gensys_jax`, ``"backward"``).

The single-draw functions (``build_logpost``, ``build_logpost_extras``,
``build_solution_fn``) take ``u`` of shape (dim,), as the reference's do,
or (B, dim): a single draw runs as a batch of one through the same batched
code that ``fit(policy="xla")`` and ``build_batched_loglik(policy="xla")``
call.  Where the reference's ``vmap`` maps data-dependent loops (the
adaptive cycle reduction, the Lyapunov doubling, the Sylvester adjoint),
the port runs them over the batch with a per-draw freeze mask, so that
every draw takes the iterations it takes alone; so does the numeric
steady state's root finder (:mod:`~geconpy_torch.models.steady_state`).

A state space lives on one device, the GPU unless it is built with
``device="cpu"``: its results are put there, and an input on another device
raises.  The sweep ``f(U) -> (B,)`` runs batched torch code for the priors,
the steady state (analytic, or numeric with its implicit adjoint), the
linearization and the static reduction, then the CUDA kernels: cycle reduction
(:mod:`~geconpy_torch.ops.batched_cycle_reduction`), then either the
Riccati settle (:mod:`~geconpy_torch.ops.batched_settle`) and the
constant-gain tail (:mod:`~geconpy_torch.ops.batched_filter`), or the one
fused kernel for both (``settle="fused"``).  The value+grad path runs the
cycle-reduction kernel K4 and, with ``settle="pallas"``, the DARE kernel
(:mod:`~geconpy_torch.ops.batched_dare`); gradients re-attach through the
implicit policy and DARE adjoints.  The XLA policy (``policy="xla"``, the
reference's default) is plain batched PyTorch in float64, as it is XLA
code, outside every Pallas kernel, in the reference.  On CPU tensors the
kernels' plain PyTorch versions run instead.  Failed draws (steady state,
policy, stability, settle, non-finite likelihood) get -inf; failures are flags,
never exceptions.  The TPU-only knobs (``cr_tile``, ``pallas_tile``,
``interpret``) are gone.
"""

from __future__ import annotations

import copy
import functools
import hashlib
import logging
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..dists import from_ast
from ..dists.core import Distribution, HalfNormal, PartialCorrelation
from ..models.model import Model
from ..models.perturbation import (_ZERO_TOL, make_loglin_mask,
                                   solve_policy_backward, spectral_radius)
from ..ops.batched_cycle_reduction import (cycle_reduction,
                                           cycle_reduction_policy,
                                           static_pivot_order)
from ..ops.batched_dare import dare_settle
from ..ops.batched_filter import filter_tail
from ..ops.batched_settle import settle_filter_loglik, settle_parts
from ..ops.gensys_jax import attach_policy_gradient
from ..ops.chandrasekhar import chandrasekhar_loglik
from ..ops.cyclo_kalman import (cyclostationary_kalman_loglik,
                                detect_mask_period)
from ..ops.kalman import (dare_residual_settled, kalman_filter,
                          kalman_loglik_t, kalman_smoother,
                          stationary_kalman_loglik, stationary_loglik_from_P,
                          steady_state_filter_parts,
                          steady_state_kalman_loglik)
from ..ops.lyapunov import amax_abs
from ..ops.parallel_kalman import parallel_kalman_filter
from ..ops.precision import highest_precision
from ..ops.static_reduction import (expand_reduced_policy,
                                    finalize_reduced_policy,
                                    policy_from_reduced, reduce_pencil,
                                    solve_policy_reduced)
from ..ops.tolerances import success_tol
from ..symbolic import TimeAwareSymbol

_log = logging.getLogger(__name__)

__all__ = ["DSGEStateSpace", "EstimatedParameter", "FilteredStates",
           "LogPostExtras",
           "CR_ITERS", "aggregated_obs_equation", "statespace_from_gcn",
           "data_from_prior"]

#: cycle-reduction doublings of the sweep's policy solve (the reference's
#: ``cr_iters`` default)
CR_ITERS = 14


def _cached_build(method):
    """Memoize a ``build_*(data, **kwargs)`` method on (data, kwargs), as
    the reference does (``statespace.py:45``): the same function object for
    the same inputs, so that ``fit``'s memo of the posterior mode (keyed on
    the value+grad function) hits on a repeat fit.  ``configure`` clears
    the cache."""
    @functools.wraps(method)
    def wrapper(self, data, **kwargs):
        arr = np.asarray(data)
        try:
            cache_kwargs = tuple(sorted(kwargs.items()))
            hash(cache_kwargs)
        except TypeError:           # unhashable kwarg: skip caching
            return method(self, data, **kwargs)
        key = (method.__name__, arr.shape, arr.dtype.str,
               hashlib.sha1(arr.tobytes()).hexdigest(), cache_kwargs)
        cache = self.__dict__.setdefault("_build_cache", {})
        if key not in cache:
            cache[key] = method(self, data, **kwargs)
        return cache[key]
    return wrapper


@dataclass(frozen=True)
class EstimatedParameter:
    name: str
    prior: Distribution
    kind: str                     # "model" | "measurement_error"
    initial: float | None = None


class LogPostExtras(NamedTuple):
    """Per-draw diagnostics beside the log posterior (the reference's
    ``LogPostExtras``, ``statespace.py:74``)."""

    logpost: torch.Tensor
    loglik: torch.Tensor
    logprior: torch.Tensor
    ss_success: torch.Tensor
    solver_success: torch.Tensor
    deterministic_norm: torch.Tensor
    stochastic_norm: torch.Tensor
    spectral_radius: torch.Tensor


class FilteredStates(NamedTuple):
    """What :meth:`DSGEStateSpace.filter_data` returns."""

    paths: torch.Tensor             # (periods, n_variables)
    variable_names: list[str]
    loglik: torch.Tensor            # () the data's log-likelihood


def _one_or_many(fn):
    """Run ``fn(U (B, dim))`` on ``u`` (dim,) as a batch of one and drop
    the batch dimension of every tensor it returns."""
    @functools.wraps(fn)
    def wrapper(u: torch.Tensor):
        if u.ndim != 1:
            return fn(u)
        out = fn(u[None])
        if isinstance(out, torch.Tensor):
            return out[0]
        if isinstance(out, dict):
            return {k: v[0] for k, v in out.items()}
        return type(out)(*(v[0] for v in out))
    return wrapper


def _value_and_grad(f):
    """``U -> (f(U), d f / d U)`` by one backward pass over the batch;
    non-finite gradient rows (rejected draws) are zeroed, the NUTS
    kernel's convention."""
    def value_and_grad(U: torch.Tensor, record: dict | None = None):
        U = U.detach().requires_grad_(True)
        with torch.enable_grad():
            vals = f(U) if record is None else f(U, record)
            grads = None
            if vals.requires_grad:
                # None where the value does not depend on U (no
                # estimated parameter)
                (grads,) = torch.autograd.grad(vals, U, torch.ones_like(vals),
                                               allow_unused=True)
        if grads is None:
            grads = torch.zeros_like(U)
        grads = torch.where(torch.isfinite(grads), grads,
                            torch.zeros_like(grads))
        return vals.detach(), grads

    return value_and_grad


class DSGEStateSpace:
    """Estimation-ready state-space wrapper around a :class:`Model`.

    ``device`` (default ``"cuda"``) is where every result is put and every
    input must lie; without a GPU a ``"cuda"`` state space raises on first
    use, and never carries on on the CPU.
    """

    def __init__(self, model: Model, device: str | torch.device = "cuda"):
        self.model = model
        self.device = torch.device(device)
        self._configured = False

    # --------------------------------------------------------------- device
    def _device(self) -> torch.device:
        """The state space's device, resolved (raises without a GPU)."""
        dev = self.device
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DSGEStateSpace is on 'cuda' but no CUDA device is "
                    "available; build it with device='cpu' to run on the CPU")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        return dev

    def _on_device(self, device) -> "DSGEStateSpace":
        """This state space on ``device``: itself there, else a twin with
        the same model and configuration and its own built functions
        (made once, kept)."""
        device = torch.device(device)
        if device == self._device():
            return self
        twins = self.__dict__.setdefault("_twins", {})
        if device not in twins:
            twin = copy.copy(self)
            twin.__dict__.pop("_build_cache", None)
            twin.__dict__.pop("_twins", None)
            twin.device = device
            twins[device] = twin
        return twins[device]

    def _built_on_mesh(self, mesh, build) -> dict:
        """``build(state space)`` once per distinct device of ``mesh``:
        on this state space on its own device, on its twin elsewhere.  The
        mesh's first device must be this state space's."""
        from ..parallel.mesh import functions_per_device

        if mesh.devices[0] != self._device():
            raise ValueError(f"the mesh starts on {mesh.devices[0]}, but the "
                             f"state space is on {self._device()}")
        return functions_per_device(
            lambda dev: build(self._on_device(dev)), mesh)

    def _check_device(self, t: torch.Tensor, name: str) -> None:
        dev = self._device()
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, but this state space "
                             f"is on {dev}; move it there first")

    def _check_generator(self, generator: torch.Generator) -> None:
        device = self._device()
        gen_device = generator.device
        if gen_device.type == "cuda" and gen_device.index is None:
            gen_device = torch.device("cuda", torch.cuda.current_device())
        if gen_device != device:
            raise ValueError(f"the generator is on {generator.device}, but "
                             f"this state space is on {device}")

    # ------------------------------------------------------------- configure
    def configure(
        self,
        observed_states: list[str],
        measurement_error: list[str] | dict | None = None,
        shock_std: dict | float | None = None,
        solver: str = "cycle_reduction",
        filter_type: str = "sequential",
        kalman_settle: int = 48,
        kalman_settle_method: str = "hewer",
        loglin_variables="auto",
        cycle_reduction_tol: float = 1e-10,
        cycle_reduction_maxiter: int = 100,
        me_prior: Distribution | None = None,
        constant_params: list[str] | None = None,
        observation_equations: dict[str, str] | None = None,
        aggregate: dict[str, tuple[str, str, int]] | None = None,
        ss_obs_intercept: bool = False,
        full_shock_covariance: bool = False,
        lkj_eta: float = 1.0,
        p0_init: str = "stationary",
        diffuse_kappa: float = 1e6,
        diffuse_presample: int = 0,
    ) -> "DSGEStateSpace":
        """Choose observables, measurement error and estimated parameters.

        The same rules as the reference: parameters with GCN priors are
        estimated unless frozen by ``constant_params``; shock standard
        deviations come from GCN shock priors (hyper-parameter links) or
        ``shock_std``; ``measurement_error`` is a list of observed names
        (each with an estimated std, prior ``me_prior``, default
        HalfNormal(0.1)) or a dict name -> float | Distribution.
        ``filter_type`` is ``"sequential"`` (the default: the exact Kalman
        filter with missing data, from the unconditional covariance or,
        with ``p0_init="diffuse"``, from ``diffuse_kappa``·I, dropping the
        first ``diffuse_presample`` periods), ``"parallel"`` (the same
        filter as an associative scan over the periods, ``p0_init``
        honoured), ``"chandrasekhar"`` (the exact filter by the
        Chandrasekhar recursions, fully observed data), ``"steady_state"``
        (``kalman_settle`` exact steps, then constant gain; fully observed
        data) or ``"stationary"`` (constant gain from the DARE fixed point,
        reached by ``kalman_settle_method`` ``"hewer"``, ``"sda"`` or
        ``"auto"``; data whose missingness repeats with a period, such as
        mixed-frequency data from ``prepare_mixed_frequency_data``, take
        the cyclostationary filter).  The keywords and defaults are the
        reference's, and so are ``observation_equations`` (GCN
        expressions in the model's variables, lags allowed: the filter
        state gets one block per lag), ``aggregate`` and
        ``full_shock_covariance`` (Q = S L Lᵀ S, L from estimated partial
        correlations with an LKJ(``lkj_eta``) prior).  ``solver`` picks the
        policy solve of ``build_logpost``, ``build_solution_fn`` and
        ``build_batched_loglik(policy="xla")``, as the reference's
        ``policy`` step does (``statespace.py:597-613``):
        ``"cycle_reduction"`` (the adaptive solve, with
        ``cycle_reduction_tol`` and ``cycle_reduction_maxiter``),
        ``"gensys"`` (the device disk split) or ``"backward"`` (T = -B⁻¹A);
        the kernel paths (``policy="pallas"``, ``build_batched_logpost``)
        need ``"cycle_reduction"`` and run a fixed number of doublings, as
        the reference's do.  With any other solver the filter runs over
        every variable, not the dynamic core.
        """
        if p0_init not in ("stationary", "diffuse"):
            raise ValueError(f"p0_init must be 'stationary' or 'diffuse', "
                             f"got {p0_init!r}")
        if p0_init == "diffuse" and filter_type not in ("sequential",
                                                        "parallel"):
            raise ValueError("p0_init='diffuse' requires filter_type="
                             "'sequential' or 'parallel' (the constant-gain "
                             "filters assume stationarity)")
        if filter_type not in ("sequential", "parallel", "steady_state",
                               "stationary", "chandrasekhar"):
            raise ValueError("filter_type must be 'sequential', 'parallel', "
                             "'steady_state', 'stationary' or 'chandrasekhar'")
        if solver not in ("cycle_reduction", "backward", "gensys"):
            raise ValueError("solver must be 'cycle_reduction', 'backward' "
                             f"or 'gensys', got {solver!r}")
        if kalman_settle_method not in ("auto", "sda", "hewer"):
            raise ValueError("kalman_settle_method must be 'auto', 'sda' or "
                             f"'hewer', got {kalman_settle_method!r}")
        model = self.model
        mf = model.functions

        observation_equations = dict(observation_equations or {})
        for obs_name, (var, method, period) in (aggregate or {}).items():
            observation_equations[obs_name] = aggregated_obs_equation(
                var, method, period)
        unknown_obs = set(observed_states) - set(mf.variable_names) \
            - set(observation_equations)
        if unknown_obs:
            raise ValueError(f"observed_states not in model: {sorted(unknown_obs)}")
        self.observed_states = list(observed_states)
        self.filter_type = filter_type
        self.kalman_settle = int(kalman_settle)
        self.kalman_settle_method = kalman_settle_method
        self.solver = solver
        self.p0_init = p0_init
        self.diffuse_kappa = float(diffuse_kappa)
        self.diffuse_presample = int(diffuse_presample)
        self._cr_tol = cycle_reduction_tol
        self._cr_maxiter = cycle_reduction_maxiter
        self.ss_obs_intercept = ss_obs_intercept
        self.loglin_variables = loglin_variables
        self._setup_observation_equations(observation_equations)

        param_priors, shock_dists = from_ast.resolve_priors(
            model.primitives.priors, model.primitives.shock_priors)
        constant = set(constant_params or ())

        self.estimated: list[EstimatedParameter] = []
        free_names = [p.name for p in mf.free_params]
        defaults = model.default_theta().numpy()
        self._theta_default = defaults
        est_idx: list[int] = []
        for i, name in enumerate(free_names):
            if name in param_priors and name not in constant:
                self.estimated.append(EstimatedParameter(
                    name, param_priors[name], "model", float(defaults[i])))
                est_idx.append(i)
        self._est_idx = np.asarray(est_idx, dtype=np.int64) if est_idx else None

        sigma_source: list[tuple[str, object]] = []
        for s in mf.shock_names:
            dist = shock_dists.get(s)
            if isinstance(dist, from_ast.CompositeDistribution) and dist.sigma_param:
                pname = dist.sigma_param
                if pname not in free_names:
                    raise ValueError(
                        f"shock {s!r} references hyper-parameter {pname!r} "
                        f"which is not a model parameter")
                sigma_source.append(("param", free_names.index(pname)))
            elif isinstance(dist, Distribution):
                sigma_source.append(("fixed", float(dist.std())))
            elif isinstance(shock_std, dict):
                sigma_source.append(("fixed", float(shock_std.get(s, 0.01))))
            elif shock_std is not None:
                sigma_source.append(("fixed", float(shock_std)))
            else:
                sigma_source.append(("fixed", 0.01))
        self._sigma_source = sigma_source

        me_prior = me_prior or HalfNormal(sigma=0.1)
        self._me_fixed: dict[int, float] = {}
        me_estimated: list[tuple[int, EstimatedParameter]] = []
        if measurement_error:
            if isinstance(measurement_error, dict):
                items = measurement_error.items()
            else:
                items = [(name, me_prior) for name in measurement_error]
            for name, spec in items:
                if name not in self.observed_states:
                    raise ValueError(
                        f"measurement error on {name!r} but it is not observed")
                j = self.observed_states.index(name)
                if isinstance(spec, (int, float)):
                    self._me_fixed[j] = float(spec)
                else:
                    me_estimated.append((j, EstimatedParameter(
                        f"sigma_obs_{name}", spec, "measurement_error")))
        self._me_estimated = me_estimated
        self.estimated.extend(p for _, p in me_estimated)

        # a full shock covariance: one partial correlation per (i, j), i > j,
        # with the LKJ(lkj_eta) vine marginal as its prior
        corr_params: list[EstimatedParameter] = []
        if full_shock_covariance:
            m = mf.n_shocks
            for i in range(1, m):
                for j in range(i):
                    corr_params.append(EstimatedParameter(
                        f"corr_{mf.shock_names[i]}_{mf.shock_names[j]}",
                        PartialCorrelation.lkj_marginal(lkj_eta, m, j),
                        "shock_corr", 0.0))
        self.full_shock_covariance = bool(full_shock_covariance)
        self._n_corr = len(corr_params)
        self.estimated.extend(corr_params)

        n_me = len(self._me_fixed) + len(me_estimated)
        if len(self.observed_states) > mf.n_shocks + n_me:
            raise ValueError(
                f"stochastic singularity: {len(self.observed_states)} observables "
                f"but only {mf.n_shocks} shocks + {n_me} measurement errors. "
                f"Add shocks or measurement error.")

        # the Kalman state is the dynamic core when every variable an
        # observable refers to is dynamic (statics are outputs, not states)
        plan = model.static_reduction
        dynamic_names = {mf.variable_names[i] for i in plan.dynamic_idx}
        obs_refs = {name for name in self.observed_states
                    if name not in self._obs_fns}
        for expr in self._obs_exprs.values():
            obs_refs |= {a.base_name for a in expr.atoms(TimeAwareSymbol)}
        if solver == "cycle_reduction" and obs_refs <= dynamic_names \
                and len(plan.static_idx):
            self._filter_core = np.asarray(plan.dynamic_idx)
        else:
            self._filter_core = np.arange(mf.n_variables)
        self._pivot_order = None
        self.__dict__.pop("_build_cache", None)   # built fns are now stale
        self.__dict__.pop("_twins", None)
        self._configured = True
        _log.info("configured: %d observables, %d estimated parameters "
                  "(%d model + %d meas. error)", len(self.observed_states),
                  len(self.estimated), len(est_idx), len(me_estimated))
        return self

    # ------------------------------------------------- observation equations
    def _setup_observation_equations(self, observation_equations: dict
                                     ) -> None:
        """Parse each observation equation (a GCN expression in the model's
        variables, lags allowed) and lower it to ``g(y_0, ..., y_L,
        theta)``, where ``y_j`` is the variables at lag j and L the deepest
        lag used (``statespace.py:340-392``)."""
        from ..codegen.lower import lower_to_torch
        from ..lang.parser import parse_expression
        from ..lang.sympify import SympyConverter

        mf = self.model.functions
        self._obs_fns, self._obs_exprs, self._obs_max_lag = {}, {}, 0
        if not observation_equations:
            return
        converter = SympyConverter(self.model.primitives.assumptions)
        var_names = set(mf.variable_names)
        max_lag = 0
        for name, src in observation_equations.items():
            expr = converter.convert(parse_expression(src))
            for atom in expr.atoms(TimeAwareSymbol):
                if atom.base_name not in var_names:
                    raise ValueError(
                        f"observation equation {name!r} references unknown "
                        f"variable {atom.base_name!r}")
                if atom.time_index == "ss":
                    continue
                if atom.time_index > 0:
                    raise ValueError(
                        f"observation equation {name!r} may not reference "
                        f"future values ({atom})")
                max_lag = max(max_lag, -atom.time_index)
            self._obs_exprs[name] = expr
        self._obs_max_lag = max_lag
        lag_groups = [(f"y_lag{j}", [v.set_t(-j) for v in mf.variables])
                      for j in range(max_lag + 1)]
        theta_syms = [*mf.free_params, *mf.deterministic_params,
                      *mf.calibrated_params]
        self._obs_fns = {
            name: lower_to_torch([expr], lag_groups + [("theta", theta_syms)],
                                 name=f"obs_{name}")
            for name, expr in self._obs_exprs.items()}

    # ------------------------------------------------------------ design
    def _build_design(self, x_ss, theta_full, scale, core):
        """(Z (..., k, (L+1) n_core), d (..., k)): the design over the
        lag-augmented filter state and the steady-state intercept
        (``statespace.py:394-455``).  A directly observed variable loads on
        its own state with intercept log(v_ss) (log-linearized with a
        positive steady state) or v_ss; an observation equation's row is
        the ``torch.func.jacfwd`` of its lowered function at the steady
        state in each lag block, times the log-linearization scale, and its
        intercept the equation's value there.  d is zero unless
        ``ss_obs_intercept``."""
        mf = self.model.functions
        lv = self.loglin_variables
        if isinstance(lv, str) and lv == "auto":
            lv = self.model.default_loglin
        loglin_mask = make_loglin_mask(mf, lv)
        core = list(np.asarray(core))
        core_t = torch.as_tensor(core, dtype=torch.int64, device=x_ss.device)
        n_core, L = len(core), self._obs_max_lag
        batch = x_ss.shape[:-1]
        rows, intercepts = [], []
        for name in self.observed_states:
            if name in self._obs_fns:
                fn = self._obs_fns[name].fn
                blocks = [x_ss] * (L + 1)
                grads = [torch.func.vmap(torch.func.jacfwd(fn, argnums=j))(
                    *(b.reshape(-1, b.shape[-1]) for b in blocks),
                    theta_full.reshape(-1, theta_full.shape[-1]))[:, 0]
                    .reshape(batch + x_ss.shape[-1:]) for j in range(L + 1)]
                rows.append(torch.cat([(g * scale)[..., core_t]
                                       for g in grads], dim=-1))
                intercepts.append(fn(*blocks, theta_full)[..., 0])
                continue
            idx = mf.variable_names.index(name)
            row = x_ss.new_zeros(batch + ((L + 1) * n_core,))
            if idx in core:
                row[..., core.index(idx)] = 1.0
            rows.append(row)
            x_v = x_ss[..., idx]
            if loglin_mask[idx]:
                x_v = torch.where(x_v > _ZERO_TOL,
                                  torch.log(torch.clamp(x_v, min=1e-30)), x_v)
            intercepts.append(x_v)
        Z = torch.stack(rows, dim=-2)
        if self.ss_obs_intercept:
            d = torch.stack(intercepts, dim=-1)
        else:
            d = x_ss.new_zeros(batch + (len(self.observed_states),))
        return Z, d

    @staticmethod
    def _augment_lags(T, R, L):
        """Companion augmentation, state [y_t, y_{t-1}, ..., y_{t-L}]
        (``statespace.py:457-472``), over leading batch dimensions."""
        if L == 0:
            return T, R
        n = T.shape[-1]
        batch = T.shape[:-2]
        eye = torch.eye(L * n, dtype=T.dtype, device=T.device).expand(
            batch + (L * n, L * n))
        top = torch.cat([T, T.new_zeros(batch + (n, L * n))], dim=-1)
        below = torch.cat([eye, T.new_zeros(batch + (L * n, n))], dim=-1)
        T_aug = torch.cat([top, below], dim=-2)
        R_aug = torch.cat([R, R.new_zeros(batch + (L * n, R.shape[-1]))],
                          dim=-2)
        return T_aug, R_aug

    # ----------------------------------------------------------------- sizes
    @property
    def param_labels(self) -> list[str]:
        """Estimated-parameter names, the column order of draws."""
        return [p.name for p in self.estimated]

    # ------------------------------------------------------------ transforms
    def unconstrain(self, values) -> torch.Tensor:
        """Constrained parameter values (array or name dict, on the host) ->
        unconstrained float64 vector on the state space's device."""
        if isinstance(values, dict):
            values = [values[p.name] for p in self.estimated]
        if isinstance(values, torch.Tensor):
            self._check_device(values, "values")
            values = values.detach().cpu()
        vals = np.asarray(values, dtype=np.float64)
        if not self.estimated:
            return torch.zeros(0, dtype=torch.float64, device=self._device())
        u = torch.stack([p.prior.to_unconstrained(torch.as_tensor(v))
                         for p, v in zip(self.estimated, vals)])
        return u.to(self._device())

    def constrain(self, u: torch.Tensor) -> torch.Tensor:
        """Unconstrained vector (..., n_est) -> constrained values."""
        self._check_device(u, "u")
        if not self.estimated:
            return u.new_zeros(u.shape[:-1] + (0,))
        return torch.stack([p.prior.from_unconstrained(u[..., i])[0]
                            for i, p in enumerate(self.estimated)], dim=-1)

    def initial_position(self, jitter: float = 0.0,
                         generator: torch.Generator | None = None
                         ) -> torch.Tensor:
        """Unconstrained start: GCN initial value or prior mean, plus
        ``jitter`` x N(0, 1) drawn from ``generator`` when both are given
        (the generator must be on the state space's device)."""
        vals = []
        for p in self.estimated:
            v = p.initial if p.initial is not None else p.prior.mean()
            if not np.isfinite(v):
                v = float(p.prior.ppf(0.5))
            vals.append(v)
        u = self.unconstrain(np.asarray(vals))
        if jitter and generator is not None:
            self._check_generator(generator)
            u = u + jitter * torch.randn(u.shape, generator=generator,
                                         dtype=u.dtype, device=u.device)
        return u

    # ------------------------------------------------------------------ logp
    @_cached_build
    def build_logpost(self, data: np.ndarray):
        """data (periods, k_obs), NaN = missing -> ``logpost(u)``: ``u``
        (dim,) gives a scalar, (B, dim) gives (B,), on the state space's
        device in u's dtype (the algebra runs in float64).  Differentiable
        by ``torch.autograd``."""
        extras_fn = self.build_logpost_extras(data)

        def logpost(u: torch.Tensor) -> torch.Tensor:
            return extras_fn(u).logpost

        return logpost

    def build_solution_fn(self, full_state: bool = False):
        """``u -> dict`` of the state-space solution: theta_full, x_ss, the
        policy (T, R), the filter's (T_aug, R_aug), Z, d, Q, H, logprior,
        the success flags and the residual norms.  ``u`` is (dim,) or
        (B, dim), float64 algebra; the policy is the XLA solve
        (``solve_policy_reduced`` with ``cycle_reduction_tol`` and
        ``cycle_reduction_maxiter``).  ``full_state`` filters over every
        variable, not the dynamic core."""
        pre_policy, policy, post_policy = self._solution_pieces(full_state)

        @_one_or_many
        def solve_draw(U: torch.Tensor) -> dict:
            self._check_device(U, "u")
            pre = pre_policy(U.to(torch.float64))
            T, R, solver_ok = policy(pre)
            return post_policy(pre, T, R, solver_ok)

        return solve_draw

    @_cached_build
    def build_logpost_extras(self, data: np.ndarray):
        """``u -> LogPostExtras``: the log posterior and the per-draw
        diagnostics (success flags, residual norms, spectral radius), for
        ``u`` (dim,) or (B, dim).  The floating fields are in u's dtype."""
        y, _loglik = self._data_and_loglik(data)
        solve_draw = self.build_solution_fn()

        @_one_or_many
        @highest_precision()
        def extras(U: torch.Tensor) -> LogPostExtras:
            sol = solve_draw(U)
            loglik = _loglik(y, sol["T_aug"], sol["R_aug"], sol["Q"],
                             sol["Z"], sol["H"], d=sol["d"])
            logprior = sol["logprior"]
            ok = sol["ss_success"] & sol["solver_success"] & sol["stable"] \
                & torch.isfinite(loglik) & torch.isfinite(logprior)
            logpost = torch.where(ok, loglik + logprior,
                                  torch.full_like(loglik, -math.inf))
            dt = U.dtype
            return LogPostExtras(
                logpost=logpost.to(dt), loglik=loglik.to(dt),
                logprior=logprior.to(dt), ss_success=sol["ss_success"],
                solver_success=sol["solver_success"],
                deterministic_norm=sol["deterministic_norm"].to(dt),
                stochastic_norm=sol["stochastic_norm"].to(dt),
                spectral_radius=sol["spectral_radius"].to(dt))

        return extras

    @_cached_build
    def build_logpost_and_grad(self, data: np.ndarray):
        """``f(U) -> (logpost (B,), grad (B, dim))`` of :meth:`build_logpost`
        by one backward pass over the batch, non-finite gradient rows
        zeroed: the value+grad of ``fit(policy="xla")``, where the
        reference differentiates its single-draw log posterior per chain
        under ``vmap``."""
        return _value_and_grad(self.build_logpost(data))

    # ------------------------------------------------------ solution pieces
    def _solution_pieces(self, full_state: bool = False):
        """The batched solution pipeline split at the policy solve:
        (pre_policy, policy, post_policy), all over a leading batch
        dimension; ``policy`` is the XLA solve."""
        if not self._configured:
            raise RuntimeError("call .configure(...) first")
        model = self.model
        ss_solver = model.ss_solver
        linearize = model.linearizer(self.loglin_variables)
        k = len(self.observed_states)
        n_model_est = len([p for p in self.estimated if p.kind == "model"])
        est_idx = self._est_idx
        priors = [p.prior for p in self.estimated]
        sigma_source = self._sigma_source
        me_fixed = self._me_fixed
        me_estimated = self._me_estimated
        filter_core = (np.arange(model.functions.n_variables) if full_state
                       else self._filter_core)
        core = torch.as_tensor(filter_core, dtype=torch.int64)
        plan = model.static_reduction
        cr_tol, cr_maxiter = self._cr_tol, self._cr_maxiter
        use_backward = self.solver == "backward"
        gensys_solver = model.gensys_solver if self.solver == "gensys" \
            else None
        diffuse = self.p0_init == "diffuse"
        n_corr, n_shocks = self._n_corr, model.functions.n_shocks

        @highest_precision()
        def pre_policy(U: torch.Tensor) -> dict:
            batch = U.shape[:-1]
            logprior = U.new_zeros(batch)
            xs = []
            for i, prior in enumerate(priors):
                x_i, logjac = prior.from_unconstrained(U[..., i])
                logprior = logprior + prior.logpdf(x_i) + logjac
                xs.append(x_i)
            x = torch.stack(xs, dim=-1) if xs else U.new_zeros(batch + (0,))
            theta_free = torch.as_tensor(self._theta_default, dtype=U.dtype,
                                         device=U.device).expand(
                batch + (len(self._theta_default),)).clone()
            if est_idx is not None:
                theta_free[..., torch.as_tensor(est_idx, device=U.device)] = \
                    x[..., :n_model_est]
            ss = ss_solver(theta_free)
            lin = linearize(ss.x_ss, ss.theta_full)
            return {"x": x, "logprior": logprior, "theta_full": ss.theta_full,
                    "x_ss": ss.x_ss, "ss_success": ss.success,
                    "A": lin.A, "B": lin.B, "C": lin.C, "D": lin.D,
                    "loglin_scale": lin.loglin_scale}

        @highest_precision()
        def policy(pre: dict):
            A, B, C, D = (pre[m] for m in "ABCD")
            if use_backward:
                T, R, solver_ok = solve_policy_backward(A, B, D)
            elif gensys_solver is not None:
                # the disk split is primal only; T and R re-attach to the
                # pencil through the implicit policy adjoint
                with torch.no_grad():
                    gres = gensys_solver(A.detach(), B.detach(), C.detach(),
                                         D.detach())
                T, R = attach_policy_gradient(A, B, C, D, gres.T, gres.R)
                solver_ok = gres.success
            else:
                T, R, solver_ok, _n_iter, _resid = solve_policy_reduced(
                    A, B, C, D, plan, tol=cr_tol, maxiter=cr_maxiter)
            return T, R, solver_ok

        @highest_precision()
        def post_policy(pre: dict, T, R, solver_ok) -> dict:
            x = pre["x"]
            batch = x.shape[:-1]
            rho = spectral_radius(T.detach())
            # diffuse init admits unit roots but not explosive dynamics; the
            # Gelfand estimate overshoots on defective unit eigenvalues
            rho_max = 1.0 + 1e-3 if diffuse else 1.0 - 1e-9
            stable = torch.isfinite(rho) & (rho < rho_max)
            A, B, C, D = (pre[m].detach() for m in "ABCD")
            Td, Rd = T.detach(), R.detach()
            det_norm = amax_abs(A + B @ Td + C @ Td @ Td)
            stoch_norm = amax_abs((B + C @ Td) @ Rd + D)
            if diffuse:
                # cycle reduction converges only linearly at unit roots, so
                # its criterion can fail an exact solvent: the residual
                # decides, and the stability gate rejects explosive ones
                tol = success_tol(x.dtype, 1e-7)
                exact = (det_norm < tol) & (stoch_norm < tol) \
                    & torch.isfinite(Td).all(dim=(-2, -1)) \
                    & torch.isfinite(Rd).all(dim=(-2, -1))
                solver_ok = solver_ok | (exact & stable)
            sigmas = []
            for kind, val in sigma_source:
                if kind == "param":
                    sigmas.append(pre["theta_full"][..., val])
                else:
                    sigmas.append(x.new_full(batch, val))
            sig = torch.stack(sigmas, dim=-1)
            if n_corr:
                # Q = S L Lᵀ S with the vine Cholesky factor L of the
                # correlations, from the trailing n_corr partial correlations
                Lq = sig[..., :, None] * _vine_cholesky(
                    x[..., x.shape[-1] - n_corr:], n_shocks)
                Q = Lq @ Lq.mT
            else:
                Q = torch.diag_embed(sig ** 2)
            h_diag = x.new_zeros(batch + (k,))
            for j, v in me_fixed.items():
                h_diag[..., j] = v**2
            for slot, (j, _p) in enumerate(me_estimated):
                h_diag[..., j] = x[..., n_model_est + slot] ** 2
            H = torch.diag_embed(h_diag)
            c = core.to(T.device)
            T_f = T[..., c[:, None], c]
            R_f = R[..., c, :]
            Z, d_vec = self._build_design(pre["x_ss"], pre["theta_full"],
                                          pre["loglin_scale"], filter_core)
            T_safe = torch.where(stable[..., None, None], T_f,
                                 torch.zeros_like(T_f))
            T_aug, R_aug = self._augment_lags(T_safe, R_f, self._obs_max_lag)
            return {"x": x, "theta_full": pre["theta_full"],
                    "x_ss": pre["x_ss"], "T": T, "R": R, "T_aug": T_aug,
                    "R_aug": R_aug, "Z": Z, "d": d_vec, "Q": Q, "H": H,
                    "logprior": pre["logprior"],
                    "ss_success": pre["ss_success"],
                    "solver_success": solver_ok, "stable": stable,
                    "deterministic_norm": det_norm,
                    "stochastic_norm": stoch_norm, "spectral_radius": rho}

        return pre_policy, policy, post_policy

    def _static_pivot_order(self) -> np.ndarray:
        """Host-side static GJ row ordering from the calibration pencil."""
        if self._pivot_order is None:
            pre_policy, _, _ = self._solution_pieces()
            pre = pre_policy(self.initial_position()[None])
            plan = self.model.static_reduction
            if len(plan.static_idx) > 0:
                red = reduce_pencil(pre["A"], pre["B"], pre["C"], pre["D"], plan)
                B2 = red.B2[0].cpu().numpy()
            else:
                B2 = pre["B"][0].cpu().numpy()
            self._pivot_order = static_pivot_order(B2)
        return self._pivot_order

    def _build_policy_batch(self):
        """Batched policy solve: QR static reduction -> one cycle-reduction
        kernel launch over the whole batch (T, R, flags) -> static
        back-substitution.  The kernel's pivot/tail/residual flags carry the
        success evidence; only the stability check runs outside."""
        plan = self.model.static_reduction
        order = self._static_pivot_order()
        n = self.model.functions.n_variables
        has_statics = len(plan.static_idx) > 0

        @highest_precision()
        def solve_batch(pre, kernel_dtype: torch.dtype | None = None,
                        record: dict | None = None):
            """The pencil's algebra runs in its own dtype; the kernel in
            ``kernel_dtype`` (default: the same)."""
            A, B, C, D = pre["A"], pre["B"], pre["C"], pre["D"]
            if has_statics:
                red = reduce_pencil(A, B, C, D, plan)
                A2, B2, C2, D2 = red.A2, red.B2, red.C2, red.D2
            else:
                A2, B2, C2, D2 = A, B, C, D
            pencil = tuple(X.to(kernel_dtype or A.dtype) for X in (A2, B2, C2, D2))
            if record is not None:
                idx = torch.as_tensor(order, dtype=torch.int64, device=A.device)
                record["cycle_reduction_policy"] = tuple(
                    X[..., idx, :].contiguous() for X in pencil)
            T_d, R_d, cr_ok, _resid = cycle_reduction_policy(
                *pencil, order=order, n_iter=CR_ITERS)
            T_d, R_d = T_d.to(A.dtype), R_d.to(A.dtype)
            rho = spectral_radius(T_d)
            stable_ok = torch.isfinite(rho) & (rho < 1.0 + 1e-6)
            if has_statics:
                T, R = expand_reduced_policy(T_d, R_d, red, plan, n)
            else:
                T, R = T_d, R_d
            success = cr_ok & stable_ok & torch.isfinite(R).all(dim=(-2, -1))
            return T, R, success

        return solve_batch

    # ----------------------------------------------------- batched sweep
    def build_batched_loglik(self, data: np.ndarray, n_settle: int = 32,
                             policy: str = "xla", settle: str = "xla"):
        """Gradient-free batched log-posterior ``f(U) -> (B,)`` for sweeps.

        ``U`` is (B, n_estimated) unconstrained draws on the state space's
        device; the result is there in U's dtype.  The kernels work in
        U's dtype; the algebra around them (priors, steady state,
        linearization, static reduction, covariances) runs in float64:
        in float32 that algebra alone moved the SW-2007 likelihood by
        ~3e-4 relative, where the float32 kernels fed float64 algebra
        stay near 1e-4 (see PERF.md).  Pipeline: batched priors,
        steady state and linearization -> the policy -> the settle over
        ``data[:n_settle]`` and the constant-gain tail over the rest.
        ``policy`` and ``settle`` take the reference's values and defaults.
        ``policy="xla"`` (the default) solves the batch through
        :meth:`build_solution_fn` (the adaptive cycle reduction, float64,
        plain PyTorch); ``policy="pallas"`` runs the static reduction and
        the cycle-reduction kernel K1 (``CR_ITERS`` doublings).
        ``settle="pallas"`` is the settle kernel then
        the tail kernel; ``"fused"`` is one kernel for both
        (:func:`~geconpy_torch.ops.batched_settle.settle_filter_loglik`),
        which never writes M, TK and F^{-1} to device memory; ``"xla"`` (the
        default) is the plain batched Cholesky settle
        (:func:`~geconpy_torch.ops.kalman.steady_state_filter_parts`, part
        of the float64 algebra) then the tail kernel.  Rejected draws get
        -inf.
        """
        data = np.asarray(data)
        if data.ndim != 2 or data.shape[1] != len(self.observed_states):
            raise ValueError(f"data must be (periods, "
                             f"{len(self.observed_states)}), got {data.shape}")
        if bool(np.isnan(data).any()):
            raise ValueError("build_batched_loglik requires fully observed data")
        if policy not in ("xla", "pallas"):
            raise ValueError(
                f"policy must be 'xla' or 'pallas', got {policy!r}")
        if settle not in ("xla", "pallas", "fused"):
            raise ValueError(
                f"settle must be 'xla', 'pallas' or 'fused', got {settle!r}")
        if policy == "pallas" and self.solver != "cycle_reduction":
            raise ValueError("policy='pallas' requires solver='cycle_reduction'")
        pre_policy, policy_fn, post_policy = self._solution_pieces()
        if policy == "pallas":
            solve_batch = self._build_policy_batch()
        else:
            def solve_batch(pre, _kernel_dtype, _record):
                with torch.no_grad():
                    return policy_fn(pre)
        y_np = np.ascontiguousarray(data, dtype=np.float64)

        @highest_precision()
        def batched(U: torch.Tensor, record: dict | None = None
                    ) -> torch.Tensor:
            """``record``, when given, receives each kernel's inputs (for
            kernel-vs-plain checks at the sweep's own shapes)."""
            self._check_device(U, "U")
            kdt = U.dtype
            y64 = torch.as_tensor(y_np, device=U.device)
            y = y64.to(kdt)
            pre = pre_policy(U.to(torch.float64))
            T, R, solver_ok = solve_batch(pre, kdt, record)
            sol = post_policy(pre, T, R, solver_ok)
            rec = {} if record is None else record
            rec["accepted"] = ok = (sol["ss_success"] & sol["solver_success"]
                                    & sol["stable"])
            R_aug = sol["R_aug"]
            to_kernel = lambda *Xs: tuple(  # noqa: E731
                X.to(kdt).contiguous() for X in Xs)
            if settle == "xla":
                head = to_kernel(*steady_state_filter_parts(
                    y64[:n_settle], sol["T_aug"], R_aug, sol["Q"], sol["Z"],
                    sol["H"], sol["d"]))
                Z_k, d_k = to_kernel(sol["Z"], sol["d"])
            else:
                RQR = R_aug @ sol["Q"] @ R_aug.transpose(-1, -2)
                mats = to_kernel(sol["T_aug"], RQR, sol["Z"], sol["H"],
                                 sol["d"])
                Z_k, d_k = mats[2], mats[4]
            if settle == "fused":
                rec["settle_filter_loglik"] = (y,) + mats
                ll_data = settle_filter_loglik(y, *mats, n_settle=n_settle)
            else:
                if settle == "pallas":
                    rec["settle_parts"] = (y[:n_settle],) + mats
                    head = settle_parts(*rec["settle_parts"])
                ll_head, x_pred0, M, TK, Finv, const = head
                rec["filter_tail"] = (y[n_settle:], M, TK, Z_k, d_k, Finv,
                                      const, x_pred0)
                ll_data = ll_head.to(torch.float64) \
                    + filter_tail(*rec["filter_tail"]).to(torch.float64)
            ll = ll_data.to(torch.float64) + sol["logprior"]
            return torch.where(ok & torch.isfinite(ll), ll,
                               torch.full_like(ll, -math.inf)).to(kdt)

        return batched

    # ------------------------------------------- batched value + gradient
    def _data_and_loglik(self, data: np.ndarray):
        """Validate the dataset and pick the differentiable Kalman
        log-likelihood of the configured filter (``statespace.py:717-797``):
        the sequential or parallel filter (NaN = missing), from the
        unconditional covariance or, with ``p0_init="diffuse"``, from
        ``diffuse_kappa``·I with the first ``diffuse_presample`` periods
        dropped; the Chandrasekhar and steady-state filters on fully
        observed data; the stationary filter, or on data whose missingness
        repeats with a period the cyclostationary filter."""
        data = np.asarray(data, dtype=np.float64)
        if data.ndim != 2 or data.shape[1] != len(self.observed_states):
            raise ValueError(f"data must be (periods, "
                             f"{len(self.observed_states)}), got {data.shape}")
        y = torch.as_tensor(data, device=self._device())
        filter_type = self.filter_type
        n_settle = self.kalman_settle
        if filter_type in ("steady_state", "stationary", "chandrasekhar") \
                and bool(np.isnan(data).any()):
            if filter_type != "stationary":
                raise ValueError(
                    f"filter_type={filter_type!r} requires fully observed "
                    "data (no NaN); use 'sequential' or 'stationary' "
                    "(periodic patterns only)")
            finite_mask = np.isfinite(data)
            p = detect_mask_period(finite_mask)
            if p is None:
                raise ValueError(
                    "filter_type='stationary' with missing data requires a "
                    "periodic missingness pattern (mixed-frequency, see "
                    "prepare_mixed_frequency_data); use 'sequential' for "
                    "arbitrary missingness")
            pattern = finite_mask[:p]

            def _loglik(y_, T_, R_, Q_, Z_, H_, d=None):
                return cyclostationary_kalman_loglik(
                    y_, T_, R_, Q_, Z_, H_, d=d, mask_pattern=pattern,
                    n_settle=n_settle)
        elif filter_type == "stationary":
            method = self.kalman_settle_method

            def _loglik(y_, T_, R_, Q_, Z_, H_, d=None):
                return stationary_kalman_loglik(y_, T_, R_, Q_, Z_, H_, d=d,
                                                n_settle=n_settle,
                                                settle_method=method)
        elif filter_type == "chandrasekhar":
            _loglik = chandrasekhar_loglik
        elif filter_type == "steady_state":
            def _loglik(y_, T_, R_, Q_, Z_, H_, d=None):
                return steady_state_kalman_loglik(y_, T_, R_, Q_, Z_, H_,
                                                  d=d, n_settle=n_settle)
        else:
            if filter_type == "parallel":
                def loglik_t(*args, **kw):
                    return parallel_kalman_filter(*args, **kw).loglik_t
            else:
                loglik_t = kalman_loglik_t
            if self.p0_init == "diffuse":
                kappa, pre = self.diffuse_kappa, self.diffuse_presample

                def _loglik(y_, T_, R_, Q_, Z_, H_, d=None):
                    eye = torch.eye(T_.shape[-1], dtype=T_.dtype,
                                    device=T_.device)
                    P0 = (kappa * eye).expand(T_.shape)
                    return loglik_t(y_, T_, R_, Q_, Z_, H_, d=d,
                                    P0=P0)[..., pre:].sum(-1)
            else:
                def _loglik(y_, T_, R_, Q_, Z_, H_, d=None):
                    return loglik_t(y_, T_, R_, Q_, Z_, H_, d=d).sum(-1)
        return y, _loglik

    def _build_policy_batch_diff(self, cr_iters: int):
        """Differentiable batched policy solve: the QR reduction and the
        cycle-reduction kernel K4 run on detached pencils (primal only);
        gradients re-attach at the full-system level through the implicit
        policy adjoint, and R comes from the differentiable selection solve
        (``finalize_reduced_policy``)."""
        plan = self.model.static_reduction
        order = self._static_pivot_order()
        n = self.model.functions.n_variables
        has_statics = len(plan.static_idx) > 0

        @highest_precision()
        def solve_batch(pre, kernel_dtype: torch.dtype | None = None,
                        record: dict | None = None):
            """The pencil's algebra runs in its own dtype; K4 in
            ``kernel_dtype`` (default: the same)."""
            A, B, C, D = pre["A"], pre["B"], pre["C"], pre["D"]
            As, Bs, Cs = (X.detach() for X in (A, B, C))
            if has_statics:
                red = reduce_pencil(As, Bs, Cs, D.detach(), plan)
                pencil = (red.A2, red.B2, red.C2)
            else:
                pencil = (As, Bs, Cs)
            pencil = tuple(X.to(kernel_dtype or A.dtype) for X in pencil)
            if record is not None:
                idx = torch.as_tensor(order, dtype=torch.int64, device=A.device)
                record["cycle_reduction"] = tuple(
                    X[..., idx, :].contiguous() for X in pencil)
            T_d, cr_ok = cycle_reduction(*pencil, order=order, n_iter=cr_iters)
            T_primal = T_d.to(A.dtype)
            if has_statics:
                T_primal = policy_from_reduced(T_primal, red, plan, n)
            T, R, success, _resid = finalize_reduced_policy(
                A, B, C, D, T_primal, T_d, cr_ok)
            return T, R, success

        return solve_batch

    @_cached_build
    def build_batched_logpost(self, data: np.ndarray, cr_iters: int = CR_ITERS,
                              settle: str = "xla"):
        """Differentiable batched log-posterior ``f(U) -> (B,)``.

        ``U`` is (B, n_estimated) unconstrained draws on the state space's
        device; the result is there in U's dtype.  The forward pass runs the
        cycle-reduction kernel K4 (``cr_iters`` doublings) and the
        configured filter.  With ``filter_type="sequential"`` that is the
        exact filter with missing data (``settle`` changes nothing, as in
        the reference).  With ``"stationary"`` and ``settle="pallas"`` the
        DARE fixed point comes from the DARE kernel K6, gated per draw by
        ``dare_residual_settled`` (un-settled draws get -inf), and with
        ``settle="xla"`` (the default) from the adaptive Hewer settle.  The
        backward pass is the implicit policy (and DARE) adjoints plus
        autograd of the filter's recursion.  The whole path runs in float64,
        the kernels' inputs and outputs included, and U's dtype sets only the
        result's: rounding the kernels' float64 inputs to float32 moved the
        SW-2007 log-posterior by up to 1.2e-3 (K4's reduced pencil) and
        8.0e-4 (K6's system) relative to the float64 path, over the 5e-4
        bar, while their recursions are float64 anyway (see PERF.md).
        """
        if self.solver != "cycle_reduction":
            raise ValueError("build_batched_logpost requires "
                             "solver='cycle_reduction'")
        if settle not in ("pallas", "xla"):
            raise ValueError(f"settle must be 'pallas' or 'xla', got {settle!r}")
        y, _loglik = self._data_and_loglik(data)
        pre_policy, _, post_policy = self._solution_pieces()
        solve_batch = self._build_policy_batch_diff(cr_iters)
        # missing data take the cyclostationary filter, never the DARE
        # kernel, whose fixed point assumes every series observed
        use_dare = (settle == "pallas" and self.filter_type == "stationary"
                    and not bool(np.isnan(np.asarray(data, dtype=np.float64))
                                 .any()))

        @highest_precision()
        def batched(U: torch.Tensor, record: dict | None = None
                    ) -> torch.Tensor:
            """``record``, when given, receives each kernel's inputs (for
            kernel-vs-plain checks at the path's own shapes)."""
            self._check_device(U, "U")
            pre = pre_policy(U.to(torch.float64))
            T, R, solver_ok = solve_batch(pre, record=record)
            sol = post_policy(pre, T, R, solver_ok)
            ok = sol["ss_success"] & sol["solver_success"] & sol["stable"]
            if use_dare:
                R_aug, T_aug = sol["R_aug"], sol["T_aug"]
                RQR = R_aug @ sol["Q"] @ R_aug.mT
                dare_in = tuple(X.detach().contiguous()
                                for X in (T_aug, RQR, sol["Z"], sol["H"]))
                if record is not None:
                    record["dare_settle"] = dare_in
                P = dare_settle(*dare_in)
                # the fixed-length schedule cannot stop per draw: un-settled
                # draws are rejected, never returned biased
                ok = ok & dare_residual_settled(*dare_in, P)
                loglik = stationary_loglik_from_P(
                    y, T_aug, RQR, sol["Z"], sol["H"], sol["d"], None, P)
            else:
                loglik = _loglik(y, sol["T_aug"], sol["R_aug"], sol["Q"],
                                 sol["Z"], sol["H"], d=sol["d"])
            logprior = sol["logprior"]
            ok = ok & torch.isfinite(loglik) & torch.isfinite(logprior)
            if record is not None:
                record["accepted"] = ok
            out = torch.where(ok, loglik + logprior,
                              torch.full_like(loglik, -math.inf))
            return out.to(U.dtype)

        return batched

    @_cached_build
    def build_batched_logpost_and_grad(self, data: np.ndarray, **kwargs):
        """``f(U) -> (logpost (B,), grad (B, dim))``: one forward pass over
        the batch and one backward pass.  Non-finite gradient rows (rejected
        draws) are zeroed, the NUTS kernel's convention.  ``kwargs`` go to
        :meth:`build_batched_logpost`."""
        return _value_and_grad(self.build_batched_logpost(data, **kwargs))

    # ------------------------------------------------ second-order estimation
    @_cached_build
    def build_logpost_second_order(self, data: np.ndarray, **kwargs):
        """Differentiable log posterior of the pruned second-order solution
        by the unscented filter, ``u (dim,) or (B, dim) -> () or (B,)``
        (``stats/nonlinear.py::build_logpost_second_order``, whose keywords
        ``kwargs`` takes); the same gate as :meth:`build_logpost`."""
        from .nonlinear import build_logpost_second_order

        return build_logpost_second_order(self, data, **kwargs)

    @_cached_build
    def build_logpost_and_grad_second_order(self, data: np.ndarray,
                                            **kwargs):
        """``f(U) -> (logpost (B,), grad (B, dim))`` of
        :meth:`build_logpost_second_order` by one backward pass over the
        batch, non-finite gradient rows zeroed: the value+grad of
        ``fit(order=2)``."""
        return _value_and_grad(self.build_logpost_second_order(data,
                                                               **kwargs))

    def build_pf_loglik_second_order(self, data: np.ndarray, **kwargs):
        """``(u, generator) -> (loglik, success)``, the particle filter's
        unbiased marginal likelihood of the pruned second-order system
        (``stats/nonlinear.py::build_pf_loglik_second_order``)."""
        from .nonlinear import build_pf_loglik_second_order

        return build_pf_loglik_second_order(self, data, **kwargs)

    def build_second_order_solution_fn(self):
        """``u -> dict`` of the pruned second-order solution
        (``stats/nonlinear.py::build_second_order_solution_fn``)."""
        from .nonlinear import build_second_order_solution_fn

        return build_second_order_solution_fn(self)

    # ------------------------------------------------------ filter/smoother
    def filter_data(self, data: np.ndarray, params: dict | None = None,
                    smoother: bool = False) -> "FilteredStates":
        """Kalman-filter (or RTS-smooth) ``data`` at one parameter point
        (``statespace.py:1202-1243``).  ``params`` maps estimated-parameter
        names to constrained values; the others (all, by default) take
        their GCN initial value or prior mean.  The filter runs over every
        variable, from the XLA policy.  Returns :class:`FilteredStates`:
        the filtered (or smoothed) paths (periods, n_variables) on the
        state space's device, the variable names, and the log-likelihood
        (the reference returns a DataFrame with it in ``attrs``)."""
        if params is None:
            u = self.initial_position()
        else:
            vals = []
            for p_ in self.estimated:
                if p_.name in params:
                    vals.append(float(params[p_.name]))
                else:
                    v = p_.initial if p_.initial is not None \
                        else p_.prior.mean()
                    vals.append(float(v))
            u = self.unconstrain(np.asarray(vals))
        sol = self.build_solution_fn(full_state=True)(u)
        y = torch.as_tensor(np.asarray(data, dtype=np.float64),
                            device=self._device())
        args = (y, sol["T_aug"], sol["R_aug"], sol["Q"], sol["Z"], sol["H"])
        res = kalman_filter(*args, d=sol["d"])
        n = self.model.functions.n_variables
        means = kalman_smoother(*args, d=sol["d"]).smoothed_mean \
            if smoother else res.filtered_mean
        return FilteredStates(means[:, :n],
                              list(self.model.functions.variable_names),
                              res.loglik)

    # ------------------------------------------------------- prior utilities
    def sample_prior(self, generator: torch.Generator, n_draws: int = 1000
                     ) -> dict[str, np.ndarray]:
        """``n_draws`` prior draws of each estimated parameter (constrained
        space), parameter by parameter from ``generator`` (on the state
        space's device), as host numpy arrays by name."""
        self._check_generator(generator)
        return {p.name: p.prior.sample(generator, (n_draws,)).cpu().numpy()
                for p in self.estimated}

    def data_from_prior(self, generator: torch.Generator, periods: int = 200,
                        params: dict | None = None, pct_missing: float = 0.0):
        """Simulate an artificial dataset from one prior draw.

        Draws every estimated parameter from its prior with ``generator``
        (``params`` pins chosen ones; the generator must be on the state
        space's device), solves the model at that point in float64 through
        the port's own policy solve, and simulates ``periods`` observations.  A prior draw without
        a stable first-order solution is replaced by the generator's next
        draw (at most 100 draws; then it raises).  ``pct_missing`` of the
        cells become NaN, uniformly at random, from a mask that the
        generator draws after everything else: the cells it leaves are the
        ``pct_missing=0`` run's at the same generator state.  Returns
        (data (periods, k_obs) numpy float64, draw dict).
        """
        if not 0.0 <= pct_missing < 1.0:
            raise ValueError(f"pct_missing must be in [0, 1), got {pct_missing}")
        device = self._device()
        self._check_generator(generator)
        mf = self.model.functions
        free_names = [p.name for p in mf.free_params]
        solve_batch = self._build_policy_batch()
        max_draws = 100
        for _ in range(max_draws):
            draw = {p.name: float(p.prior.sample(generator, ()))
                    for p in self.estimated}
            if params:
                unknown = set(params) - set(draw)
                if unknown:
                    raise ValueError(
                        f"params not estimated here: {sorted(unknown)}")
                draw.update({k_: float(v) for k_, v in params.items()})
            theta_free = self._theta_default.copy()
            for p in self.estimated:
                if p.kind == "model":
                    theta_free[free_names.index(p.name)] = draw[p.name]
            with highest_precision():
                theta = torch.as_tensor(theta_free, device=device)[None]
                ss = self.model.ss_solver(theta)
                lin = self.model.linearizer(self.loglin_variables)(
                    ss.x_ss, ss.theta_full)
                T, R, ok = solve_batch({"A": lin.A, "B": lin.B, "C": lin.C,
                                        "D": lin.D})
            if bool(ss.success[0]) and bool(ok[0]) \
                    and float(spectral_radius(T)[0]) < 1.0 - 1e-9:
                break
        else:
            raise RuntimeError(f"data_from_prior: no prior draw of {max_draws} "
                               "has a stable first-order solution")
        with highest_precision():
            T, R = T[0], R[0]
            sigmas = torch.tensor(
                [float(ss.theta_full[0, val]) if kind == "param" else val
                 for kind, val in self._sigma_source],
                dtype=T.dtype, device=device)
            eps = torch.randn((periods, mf.n_shocks), generator=generator,
                              device=device, dtype=T.dtype)
            if self._n_corr:
                z = [draw[p.name] for p in self.estimated
                     if p.kind == "shock_corr"]
                L = torch.as_tensor(_vine_cholesky_np(z, mf.n_shocks),
                                    dtype=T.dtype, device=device)
                eps = eps @ (sigmas[:, None] * L).T
            else:
                eps = eps * sigmas
            T_aug, R_aug = self._augment_lags(T, R, self._obs_max_lag)
            Z, d = self._build_design(ss.x_ss, ss.theta_full,
                                      lin.loglin_scale,
                                      np.arange(mf.n_variables))
            Z, d = Z[0], d[0]
            x = T_aug.new_zeros(T_aug.shape[-1])
            path = []
            for t in range(periods):
                x = T_aug @ x + R_aug @ eps[t]
                path.append(x)
            data = torch.stack(path) @ Z.T + d
            for j, v in self._me_fixed.items():
                data[:, j] += v * torch.randn(periods, generator=generator,
                                              device=device, dtype=T.dtype)
            for j, p in self._me_estimated:
                data[:, j] += draw[p.name] * torch.randn(
                    periods, generator=generator, device=device, dtype=T.dtype)
            if pct_missing > 0.0:
                mask = torch.rand(data.shape, generator=generator,
                                  device=device, dtype=T.dtype) < pct_missing
                data = torch.where(mask, torch.full_like(data, torch.nan),
                                   data)
        return data.cpu().numpy(), draw


def _vine_cholesky(z, m: int) -> torch.Tensor:
    """(..., m, m) correlation Cholesky factors from the canonical partial
    correlations ``z`` (..., m (m - 1) / 2), row by row: L[i, j] = z w with
    w = prod sqrt(1 - z²) of the row's earlier entries, L[i, i] = w
    (``statespace.py:652-669``)."""
    ones = z.new_ones(z.shape[:-1])
    rows, slot = [], 0
    for i in range(m):
        row, w = [], ones
        for _ in range(i):
            zz = z[..., slot]
            slot += 1
            row.append(zz * w)
            w = w * torch.sqrt(torch.clamp(1.0 - zz * zz, min=1e-12))
        row += [w] + [torch.zeros_like(w)] * (m - i - 1)
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2)


def _vine_cholesky_np(z_flat, m: int) -> np.ndarray:
    """Host twin of :func:`_vine_cholesky` for one draw (``:1318``)."""
    L = np.zeros((m, m))
    L[0, 0] = 1.0
    slot = 0
    for i in range(1, m):
        w = 1.0
        for j in range(i):
            z = float(z_flat[slot])
            slot += 1
            L[i, j] = z * w
            w *= np.sqrt(max(1.0 - z * z, 1e-12))
        L[i, i] = w
    return L


def aggregated_obs_equation(var: str, method: str, period: int) -> str:
    """GCN expression of a temporally aggregated observable (``:1335``):
    ``"sum"`` and ``"mean"`` aggregate a flow over ``period`` sub-periods
    by the lag polynomial, ``"last"`` observes the current value and
    ``"first"`` the oldest lag."""
    lags = [f"{var}[]" if j == 0 else f"{var}[-{j}]" for j in range(period)]
    if method == "sum":
        return " + ".join(lags)
    if method == "mean":
        return "(" + " + ".join(lags) + f") / {period}"
    if method == "last":
        return lags[0]
    if method == "first":
        return lags[-1]
    raise ValueError(f"unknown aggregation method {method!r}")


def statespace_from_gcn(source_or_path, verbose: bool = True, *,
                        device: str | torch.device = "cuda",
                        **configure_kwargs) -> DSGEStateSpace:
    """Build a Model from GCN and wrap it for estimation in one call
    (``statespace.py:1355``), on ``device``.  With ``configure_kwargs``
    (at least ``observed_states``) ``configure`` runs at once; otherwise
    call it yourself."""
    from ..models.model import model_from_gcn

    model = model_from_gcn(source_or_path, verbose=verbose)
    ss = DSGEStateSpace(model, device=device)
    if configure_kwargs:
        ss.configure(**configure_kwargs)
    return ss


def data_from_prior(statespace: DSGEStateSpace,
                    generator: torch.Generator | None = None,
                    periods: int = 200, params: dict | None = None):
    """Module-level form of :meth:`DSGEStateSpace.data_from_prior`
    (``statespace.py:1372``); without a ``generator``, one on the state
    space's device seeded with 0 (the reference's default key is
    ``PRNGKey(0)``)."""
    if generator is None:
        generator = torch.Generator(
            device=statespace._device()).manual_seed(0)
    return statespace.data_from_prior(generator, periods=periods,
                                      params=params)
