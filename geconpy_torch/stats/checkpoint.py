"""Checkpoint / resume for long NUTS runs.

Mirrors ``geconpy_tpu/stats/checkpoint.py``: ``SamplerCheckpoint`` (:24),
``save_checkpoint`` (:35), ``load_checkpoint`` (:51) and
``fit_with_checkpointing`` (:68).  The warmup runs once through
:func:`~geconpy_torch.stats.nuts.sample_nuts`; sampling then runs in
segments of ``checkpoint_every`` transitions of the batched
:func:`~geconpy_torch.stats.nuts.nuts_kernel` with the adapted step size
and metric, on the batched log posterior that ``fit(policy="xla")`` uses
(``DSGEStateSpace.build_logpost_and_grad``), and the sampler state is saved
after each segment.  A transition is a function of the positions, the
random numbers, the step size and the metric, so a checkpoint is those
plus the state of the sampler's one ``torch.Generator`` (where the
reference keeps a JAX key): a run stopped after a segment and called again
gives the draws of the unbroken run, bit for bit on one device.

Departures: the generator state is a uint8 array in the npz (the
reference's ``rng_key``); the result's ``logp``, ``accept_prob`` and
``diverging`` come from the transitions (the reference returns zeros, ones
and ``False``), and the checkpoint keeps them beside the draws; ``dtype``
is the chains' dtype, as in ``fit``.
"""

from __future__ import annotations

import json
import os
import pathlib
from dataclasses import asdict, dataclass

import numpy as np
import torch

__all__ = ["SamplerCheckpoint", "save_checkpoint", "load_checkpoint",
           "fit_with_checkpointing"]


@dataclass
class SamplerCheckpoint:
    positions: np.ndarray          # (chains, dim) current unconstrained states
    step_size: np.ndarray          # (chains,)
    inv_mass: np.ndarray           # (chains, dim)
    rng_state: np.ndarray          # uint8: the sampler's generator state
    n_completed: int               # draws already collected
    param_names: list[str]
    samples: np.ndarray | None = None      # optionally the draws so far
    logp: np.ndarray | None = None         # (chains, n_completed)
    accept_prob: np.ndarray | None = None  # (chains, n_completed)
    diverging: np.ndarray | None = None    # (chains, n_completed)


def _replace_atomically(path: pathlib.Path, write) -> None:
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as fh:
        write(fh)
    os.replace(tmp, path)


def save_checkpoint(path, ckpt: SamplerCheckpoint) -> None:
    """Write a sampler checkpoint: ``arrays.npz``, then ``meta.json``, each
    written to a temporary file and renamed over the old one, so a write
    that fails midway leaves the previous checkpoint loadable."""
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    arrays = {k: v for k, v in asdict(ckpt).items()
              if isinstance(v, np.ndarray)}
    _replace_atomically(path / "arrays.npz",
                        lambda fh: np.savez(fh, **arrays))
    meta = {"n_completed": ckpt.n_completed, "param_names": ckpt.param_names,
            "has_samples": ckpt.samples is not None}
    _replace_atomically(path / "meta.json",
                        lambda fh: fh.write(json.dumps(meta).encode()))


def load_checkpoint(path) -> SamplerCheckpoint:
    """Load a sampler checkpoint written by :func:`save_checkpoint`."""
    path = pathlib.Path(path)
    meta = json.loads((path / "meta.json").read_text())
    with np.load(path / "arrays.npz", allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    return SamplerCheckpoint(
        positions=arrays["positions"],
        step_size=arrays["step_size"],
        inv_mass=arrays["inv_mass"],
        rng_state=arrays["rng_state"],
        n_completed=int(meta["n_completed"]),
        param_names=list(meta["param_names"]),
        samples=arrays.get("samples"),
        logp=arrays.get("logp"),
        accept_prob=arrays.get("accept_prob"),
        diverging=arrays.get("diverging"),
    )


def _segment(vag, generator: torch.Generator, q: torch.Tensor, step_size,
             inv_mass, n_draws: int, max_depth: int):
    """``n_draws`` transitions from ``q``, starting with a fresh value+grad
    at ``q``: (draws (C, n, dim), logp, accept_prob, diverging (C, n))."""
    from .nuts import _finite_grad, nuts_kernel

    vag = _finite_grad(vag)
    logp, grad = vag(q)
    qs, logps, accepts, divs = [], [], [], []
    for _ in range(n_draws):
        q, logp, grad, info = nuts_kernel(vag, q, logp, grad, step_size,
                                          inv_mass, max_depth,
                                          generator=generator)
        qs.append(q)
        logps.append(logp)
        accepts.append(info["accept_prob"])
        divs.append(info["diverging"])
    return tuple(torch.stack(x, dim=1).cpu().numpy()
                 for x in (qs, logps, accepts, divs))


def fit_with_checkpointing(
    ss_mod, data, checkpoint_dir, num_chains: int = 4,
    num_warmup: int = 500, num_samples: int = 1000,
    checkpoint_every: int = 250, seed: int = 0, max_depth: int = 8,
    *, dtype: torch.dtype = torch.float32,
):
    """Like :func:`~geconpy_torch.stats.estimation.fit`, but resumable.

    The warmup runs once (its adapted step size and metric are part of the
    checkpoint); sampling proceeds in ``checkpoint_every``-sized segments,
    each saved to ``checkpoint_dir``.  Calling again with the same
    arguments resumes from the last completed segment.  ``ss_mod`` needs
    ``build_logpost_and_grad``, ``initial_position``, ``param_labels`` and
    ``constrain`` (a ``DSGEStateSpace`` has them).  ``seed`` seeds one
    ``torch.Generator`` on the state space's device, which jitters each
    chain's start by 0.5 N(0, 1) around ``ss_mod.initial_position()`` and
    draws every random number of the sampler.
    """
    from .estimation import PosteriorResult
    from .nuts import sample_nuts

    checkpoint_dir = pathlib.Path(checkpoint_dir)
    vag = ss_mod.build_logpost_and_grad(data)
    anchor = ss_mod.initial_position()
    device, dim = anchor.device, anchor.shape[-1]
    generator = torch.Generator(device=device)

    if (checkpoint_dir / "meta.json").exists():
        ckpt = load_checkpoint(checkpoint_dir)
    else:
        generator.manual_seed(seed)
        inits = torch.stack([
            ss_mod.initial_position(jitter=0.5, generator=generator)
            for _ in range(num_chains)]).to(dtype)
        warm = sample_nuts(vag, inits, generator, num_warmup=num_warmup,
                           num_samples=1, max_depth=max_depth,
                           segment_size=checkpoint_every)
        empty = np.zeros((num_chains, 0))
        ckpt = SamplerCheckpoint(
            positions=warm.samples[:, -1, :].cpu().numpy(),
            step_size=warm.step_size.cpu().numpy(),
            inv_mass=warm.inv_mass.cpu().numpy(),
            rng_state=generator.get_state().numpy(),
            n_completed=0,
            param_names=ss_mod.param_labels,
            samples=np.zeros((num_chains, 0, dim)),
            logp=empty, accept_prob=empty,
            diverging=empty.astype(bool),
        )
        save_checkpoint(checkpoint_dir, ckpt)

    while ckpt.n_completed < num_samples:
        n_seg = min(checkpoint_every, num_samples - ckpt.n_completed)
        generator.set_state(torch.from_numpy(ckpt.rng_state))
        qs, logp, accept, div = _segment(
            vag, generator, torch.as_tensor(ckpt.positions, device=device),
            torch.as_tensor(ckpt.step_size, device=device),
            torch.as_tensor(ckpt.inv_mass, device=device), n_seg, max_depth)
        ckpt = SamplerCheckpoint(
            positions=qs[:, -1],
            step_size=ckpt.step_size,
            inv_mass=ckpt.inv_mass,
            rng_state=generator.get_state().numpy(),
            n_completed=ckpt.n_completed + n_seg,
            param_names=ckpt.param_names,
            samples=np.concatenate([ckpt.samples, qs], axis=1),
            logp=np.concatenate([ckpt.logp, logp], axis=1),
            accept_prob=np.concatenate([ckpt.accept_prob, accept], axis=1),
            diverging=np.concatenate([ckpt.diverging, div], axis=1),
        )
        save_checkpoint(checkpoint_dir, ckpt)

    constrained = ss_mod.constrain(
        torch.as_tensor(ckpt.samples, dtype=torch.float64, device=device))
    return PosteriorResult(
        samples=constrained.cpu().numpy(),
        unconstrained=ckpt.samples,
        logp=ckpt.logp,
        param_names=ckpt.param_names,
        diverging=ckpt.diverging,
        accept_prob=ckpt.accept_prob,
        step_size=ckpt.step_size,
    )
