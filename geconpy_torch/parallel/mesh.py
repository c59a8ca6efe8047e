"""Device meshes: the batch axis of a batched call split over devices.

Mirrors ``geconpy_tpu/parallel/mesh.py`` (``make_mesh`` :27,
``shard_batch`` :35, ``pvmap`` :41, ``sharded_prior_sweep`` :61).  The
reference shards a ``vmap``ped per-example function over a
``jax.sharding.Mesh`` with ``shard_map``.  A port mesh is a tuple of
``torch.device``s with one axis name.  :func:`pvmap` takes a *batched*
function, because the port's paths are batched natively and their host
reads (the adaptive loops' ``bool(done.all())``) cannot run under
``torch.func.vmap``: it splits the leading axis into one equal chunk per
device, runs the function on each chunk on its device (one thread per
device when the mesh spans several), and concatenates the outputs on the
mesh's first device.  Every draw of the port's batched paths is computed
on its own, so a call under a mesh gives the draws the results of the
unsplit call.

A function whose constants live on one device (a state space's built
value+grad, say) cannot run on another: :func:`functions_per_device`
builds it once per distinct device of the mesh, and :func:`pvmap` takes
that mapping in place of one function.

``make_mesh`` defaults to the visible CUDA devices and raises when there
are none; CPU work names its devices, e.g. ``make_mesh(devices=("cpu",) *
8)``, the port's counterpart of the reference tests' eight virtual CPU
devices.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable

import torch

__all__ = ["Mesh", "make_mesh", "shard_batch", "pvmap", "sharded_prior_sweep",
           "functions_per_device"]


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices`` along the axis ``axis_name``."""

    devices: tuple[torch.device, ...]
    axis_name: str = "batch"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axis_names(self) -> tuple[str]:
        return (self.axis_name,)

    def distinct_devices(self) -> list[torch.device]:
        """The mesh's devices, each once, in mesh order."""
        return list(dict.fromkeys(self.devices))


def _resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int | None = None, axis_name: str = "batch",
              devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default: every
    visible CUDA device; raises when there is none)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass devices= "
                "(e.g. ('cpu',) * 8) to build a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(_resolve(d) for d in devices)
    if n_devices is None:
        n_devices = len(devices)
    if not 1 <= n_devices <= len(devices):
        raise ValueError(f"n_devices={n_devices} but the mesh has "
                         f"{len(devices)} devices")
    return Mesh(devices[:n_devices], axis_name)


def _check_axis(mesh: Mesh, axis_name: str) -> None:
    if axis_name != mesh.axis_name:
        raise ValueError(f"axis {axis_name!r} is not the mesh's axis "
                         f"{mesh.axis_name!r}")


def shard_batch(x: torch.Tensor, mesh: Mesh, axis_name: str = "batch"
                ) -> tuple[torch.Tensor, ...]:
    """Split the leading axis of ``x`` into ``mesh.size`` equal chunks,
    each on its device (the reference returns one sharded array)."""
    _check_axis(mesh, axis_name)
    if x.shape[0] % mesh.size:
        raise ValueError(f"leading axis {x.shape[0]} is not divisible by the "
                         f"mesh size {mesh.size}")
    return tuple(chunk.to(dev) for chunk, dev in
                 zip(torch.chunk(x, mesh.size, dim=0), mesh.devices))


def functions_per_device(build: Callable[[torch.device], Callable],
                         mesh: Mesh) -> dict[torch.device, Callable]:
    """``build(device)`` once per distinct device of ``mesh``."""
    return {dev: build(dev) for dev in mesh.distinct_devices()}


def _concat(outs: list, device: torch.device):
    """Concatenate same-structured outputs along their leading axis."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(device) for o in outs], dim=0)
    if isinstance(first, dict):
        return {k: _concat([o[k] for o in outs], device) for k in first}
    if isinstance(first, tuple):
        parts = [_concat([o[i] for o in outs], device)
                 for i in range(len(first))]
        return type(first)(*parts) if hasattr(first, "_fields") \
            else tuple(parts)
    raise TypeError(f"pvmap: cannot concatenate an output of type "
                    f"{type(first).__name__}")


def pvmap(fn, mesh: Mesh, axis_name: str = "batch") -> Callable:
    """Run the batched ``fn`` over a leading axis split across ``mesh``.

    ``fn`` maps a batch (B, ...) to a tensor, a tuple or a dict of tensors
    with leading axis B; or it is a mapping from each distinct device of
    the mesh to such a function (:func:`functions_per_device`).  The
    returned function takes a batch whose leading axis divides by the mesh
    size and returns ``fn``'s outputs for the whole batch on the mesh's
    first device.  A mesh of one device calls ``fn`` on the whole batch.
    """
    _check_axis(mesh, axis_name)
    fns = fn if isinstance(fn, dict) else \
        {dev: fn for dev in mesh.distinct_devices()}
    missing = [d for d in mesh.distinct_devices() if d not in fns]
    if missing:
        raise ValueError(f"pvmap: no function for the devices {missing}")
    threads = len(mesh.distinct_devices()) > 1

    def run(chunk: torch.Tensor, dev: torch.device):
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                return fns[dev](chunk)
        return fns[dev](chunk)

    def sharded(x: torch.Tensor):
        if mesh.size == 1:
            return run(x.to(mesh.devices[0]), mesh.devices[0])
        chunks = shard_batch(x, mesh, axis_name)
        if threads:
            with ThreadPoolExecutor(max_workers=mesh.size) as pool:
                outs = list(pool.map(run, chunks, mesh.devices))
        else:
            outs = [run(c, d) for c, d in zip(chunks, mesh.devices)]
        return _concat(outs, mesh.devices[0])

    return sharded


def sharded_prior_sweep(per_draw_fn, draws: torch.Tensor, mesh: Mesh,
                        axis_name: str = "batch"):
    """Run the batched ``per_draw_fn`` over ``draws`` (N, ...) split
    across ``mesh``: the draw count is padded up to a multiple of the mesh
    size with copies of the last draw, whose rows are dropped from the
    output, as in the reference."""
    n = draws.shape[0]
    pad = (-n) % mesh.size
    if pad:
        draws = torch.cat([draws, draws[-1:].expand((pad,) + draws.shape[1:])])
    out = pvmap(per_draw_fn, mesh, axis_name)(draws)
    if pad:
        out = _take(out, n)
    return out


def _take(out, n: int):
    if isinstance(out, torch.Tensor):
        return out[:n]
    if isinstance(out, dict):
        return {k: _take(v, n) for k, v in out.items()}
    parts = [_take(v, n) for v in out]
    return type(out)(*parts) if hasattr(out, "_fields") else tuple(parts)
