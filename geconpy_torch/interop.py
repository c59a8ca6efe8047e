"""Carry parameter draws and particle clouds from the JAX reference to the
port by name.

The tests hand both packages the same numpy arrays.  The reference's
``DSGEStateSpace`` describes its draws by ``param_labels``,
``_theta_default``, its estimated index ``_est_idx`` and its static/dynamic
plan; :func:`state_from_reference` checks each against the port's own
``configure`` and refuses any mismatch, so both sides are known to compute
the same thing.  :func:`particles_from_reference` does the same for an SMC
particle cloud (the draws with their log-likelihoods and log-priors), and
:func:`adaptation_from_reference` for a NUTS sampler's adaptation state
with its chains' positions, and :func:`posterior_from_reference` for a
posterior sample (the reference's ``PosteriorResult`` fields).  This
module imports no JAX: it takes numpy arrays only.
"""

from __future__ import annotations

import numpy as np
import torch

from .stats.estimation import PosteriorResult
from .stats.nuts import WindowedAdaptation

__all__ = ["state_from_reference", "particles_from_reference",
           "adaptation_from_reference", "posterior_from_reference"]

_KEYS = ("param_labels", "theta_default", "est_idx", "static_idx",
         "dynamic_idx", "U")


def state_from_reference(arrays: dict[str, np.ndarray], port_ss
                         ) -> dict[str, torch.Tensor]:
    """Map the reference's unconstrained draws onto ``port_ss``.

    ``arrays`` holds ``param_labels`` (names, in the reference's column
    order), ``theta_default``, ``est_idx``, ``static_idx``, ``dynamic_idx``
    and ``U`` (B, n_estimated).  Returns ``{"U", "theta_default",
    "est_idx"}`` as float64/int64 tensors in the port's column order.
    Raises ``ValueError`` on any mismatch in names, order, defaults,
    estimated index or static/dynamic plan.
    """
    missing = [k for k in _KEYS if k not in arrays]
    if missing:
        raise ValueError(f"state_from_reference: missing arrays {missing}")
    port_labels = _checked_labels(arrays["param_labels"], port_ss)
    theta = np.asarray(arrays["theta_default"], dtype=np.float64)
    if not np.array_equal(theta, port_ss._theta_default):
        raise ValueError("default parameter vectors differ")
    est_ref = np.asarray(arrays["est_idx"], dtype=np.int64).reshape(-1)
    est_port = (np.zeros(0, np.int64) if port_ss._est_idx is None
                else np.asarray(port_ss._est_idx, dtype=np.int64))
    if not np.array_equal(est_ref, est_port):
        raise ValueError(f"estimated index differs: reference {est_ref}, "
                         f"port {est_port}")
    plan = port_ss.model.static_reduction
    for key, port_idx in (("static_idx", plan.static_idx),
                          ("dynamic_idx", plan.dynamic_idx)):
        if not np.array_equal(np.asarray(arrays[key], dtype=np.int64),
                              np.asarray(port_idx, dtype=np.int64)):
            raise ValueError(f"static/dynamic plan differs in {key}")
    return {"U": torch.as_tensor(_checked_draws(arrays["U"], port_labels)),
            "theta_default": torch.tensor(theta),
            "est_idx": torch.as_tensor(est_port)}


def particles_from_reference(arrays: dict[str, np.ndarray], port_ss
                             ) -> dict[str, torch.Tensor]:
    """Map a particle cloud of the reference's SMC sampler onto ``port_ss``.

    ``arrays`` holds ``param_labels`` (the reference's column order), ``U``
    (N, n_estimated) unconstrained particles, and their data
    log-likelihoods ``ll`` (N,) and log-priors ``lp`` (N,).  Returns
    ``{"U", "ll", "lp"}`` as float64 tensors in the port's column order.
    Raises ``ValueError`` on a mismatch in names or order, or when ``ll`` or
    ``lp`` is not one value per particle.
    """
    missing = [k for k in ("param_labels", "U", "ll", "lp") if k not in arrays]
    if missing:
        raise ValueError(f"particles_from_reference: missing arrays {missing}")
    U = _checked_draws(arrays["U"], _checked_labels(arrays["param_labels"],
                                                    port_ss))
    out = {"U": torch.as_tensor(U)}
    for key in ("ll", "lp"):
        v = np.array(arrays[key], dtype=np.float64)
        if v.shape != (U.shape[0],):
            raise ValueError(f"{key} must be ({U.shape[0]},), one value per "
                             f"particle, got {v.shape}")
        out[key] = torch.as_tensor(v)
    return out


def adaptation_from_reference(arrays: dict[str, np.ndarray], port_ss
                              ) -> dict[str, object]:
    """Map a reference NUTS adaptation state and its chains onto
    ``port_ss``.

    ``arrays`` holds ``param_labels`` (the reference's column order), ``q``
    (C, n_estimated) chain positions, and the fields of the reference's
    ``WindowedAdaptation`` as numpy arrays: scalars with a pooled state, a
    leading chain dimension with an unpooled one.  Returns ``{"q",
    "adapt"}``: float64 positions and a
    :class:`~geconpy_torch.stats.nuts.WindowedAdaptation` (``count`` and
    ``welford_n`` int32).  Raises ``ValueError`` on a mismatch in names or
    order, or when a field's shape does not fit ``q``'s dimension.
    """
    fields = WindowedAdaptation._fields
    missing = [k for k in ("param_labels", "q") + fields if k not in arrays]
    if missing:
        raise ValueError(f"adaptation_from_reference: missing arrays {missing}")
    labels = _checked_labels(arrays["param_labels"], port_ss)
    q = _checked_draws(arrays["q"], labels)
    dim = len(labels)
    vals = {k: np.asarray(arrays[k]) for k in fields}
    lead = vals["log_eps"].shape
    dense = vals["welford_m2"].ndim == len(lead) + 2
    want = {"welford_mean": lead + (dim,),
            "welford_m2": lead + ((dim, dim) if dense else (dim,)),
            "inv_mass": lead + ((dim, dim) if dense else (dim,))}
    want.update({k: lead for k in ("log_eps_bar", "h_bar", "mu", "count",
                                   "welford_n")})
    for k, shape in want.items():
        if vals[k].shape != shape:
            raise ValueError(f"{k} must be {shape}, got {vals[k].shape}")
    adapt = WindowedAdaptation(**{
        k: torch.as_tensor(np.array(v, dtype=np.int32 if k in (
            "count", "welford_n") else np.float64)) for k, v in vals.items()})
    return {"q": torch.as_tensor(q), "adapt": adapt}


def posterior_from_reference(arrays: dict, port_ss) -> PosteriorResult:
    """Map a reference ``PosteriorResult``'s fields onto ``port_ss``.

    ``arrays`` holds ``param_names`` (the reference's column order),
    ``samples`` and ``unconstrained`` (chains, draws, n_estimated), ``logp``
    (chains, draws), ``diverging``, ``accept_prob`` and ``step_size``.
    Returns the port's ``PosteriorResult`` over the same draws (float64,
    numpy).  Raises ``ValueError`` on a mismatch in names or order, or when
    a field's shape does not fit the draws.
    """
    fields = ("param_names", "samples", "unconstrained", "logp",
              "diverging", "accept_prob", "step_size")
    missing = [k for k in fields if k not in arrays]
    if missing:
        raise ValueError(f"posterior_from_reference: missing arrays {missing}")
    labels = _checked_labels(arrays["param_names"], port_ss)
    draws = {k: np.array(arrays[k], dtype=np.float64)
             for k in ("samples", "unconstrained")}
    for k, v in draws.items():
        if v.ndim != 3 or v.shape[-1] != len(labels):
            raise ValueError(f"{k} must be (chains, draws, {len(labels)}), "
                             f"got {v.shape}")
    lead = draws["unconstrained"].shape[:2]
    if draws["samples"].shape[:2] != lead:
        raise ValueError(f"samples {draws['samples'].shape} and unconstrained "
                         f"{draws['unconstrained'].shape} differ")
    per_draw = {k: np.asarray(arrays[k]) for k in ("logp", "diverging",
                                                    "accept_prob")}
    for k, v in per_draw.items():
        if v.shape != lead:
            raise ValueError(f"{k} must be {lead}, one value per draw, got "
                             f"{v.shape}")
    return PosteriorResult(
        samples=draws["samples"], unconstrained=draws["unconstrained"],
        logp=per_draw["logp"].astype(np.float64), param_names=labels,
        diverging=per_draw["diverging"].astype(bool),
        accept_prob=per_draw["accept_prob"].astype(np.float64),
        step_size=np.asarray(arrays["step_size"], dtype=np.float64))


def _checked_labels(param_labels, port_ss) -> list[str]:
    """The port's estimated-parameter names, after checking that the
    reference's are the same names in the same order."""
    ref_labels = [str(s) for s in np.asarray(param_labels).tolist()]
    port_labels = list(port_ss.param_labels)
    if set(ref_labels) != set(port_labels) or len(ref_labels) != len(port_labels):
        raise ValueError(
            f"estimated parameters differ: reference only "
            f"{sorted(set(ref_labels) - set(port_labels))}, port only "
            f"{sorted(set(port_labels) - set(ref_labels))}")
    if ref_labels != port_labels:
        raise ValueError(f"estimated-parameter order differs: reference "
                         f"{ref_labels}, port {port_labels}")
    return port_labels


def _checked_draws(U, port_labels: list[str]) -> np.ndarray:
    """A float64 copy of the draws, after checking their shape."""
    U = np.array(U, dtype=np.float64)
    if U.ndim != 2 or U.shape[1] != len(port_labels):
        raise ValueError(f"U must be (B, {len(port_labels)}), got {U.shape}")
    return U
