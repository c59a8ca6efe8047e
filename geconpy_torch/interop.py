"""Carry parameter draws from the JAX reference to the port by name.

The tests hand both packages the same numpy arrays.  The reference's
``DSGEStateSpace`` describes its draws by ``param_labels``,
``_theta_default``, its estimated index ``_est_idx`` and its static/dynamic
plan; :func:`state_from_reference` checks each against the port's own
``configure`` and refuses any mismatch, so both sides are known to compute
the same thing.  This module imports no JAX: it takes numpy arrays only.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_from_reference"]

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
    ref_labels = [str(s) for s in np.asarray(arrays["param_labels"]).tolist()]
    port_labels = list(port_ss.param_labels)
    if set(ref_labels) != set(port_labels) or len(ref_labels) != len(port_labels):
        raise ValueError(
            f"estimated parameters differ: reference only "
            f"{sorted(set(ref_labels) - set(port_labels))}, port only "
            f"{sorted(set(port_labels) - set(ref_labels))}")
    if ref_labels != port_labels:
        raise ValueError(f"estimated-parameter order differs: reference "
                         f"{ref_labels}, port {port_labels}")
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
    U = np.asarray(arrays["U"], dtype=np.float64)
    if U.ndim != 2 or U.shape[1] != len(port_labels):
        raise ValueError(f"U must be (B, {len(port_labels)}), got {U.shape}")
    col = [ref_labels.index(name) for name in port_labels]
    return {"U": torch.as_tensor(U[:, col]),
            "theta_default": torch.tensor(theta),
            "est_idx": torch.as_tensor(est_port)}
