"""Device-memory accounting of one call.

Mirrors ``geconpy_tpu/utils/memory.py`` (``program_memory`` :42,
``format_bytes`` :51), where XLA's buffer assignment gives a compiled
program's argument, output, temporary and peak bytes without running it.
The port compiles no program, so :func:`program_memory` runs the function
once on its inputs' device and measures: on a GPU from the caching
allocator's statistics (``torch.cuda.reset_peak_memory_stats`` and
``max_memory_allocated``), on the CPU from ``torch.profiler``'s memory
events.  ``compiled_memory_summary`` (which reads an XLA executable) has
no counterpart.
"""

from __future__ import annotations

import torch

__all__ = ["program_memory", "format_bytes"]


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _nbytes(obj) -> int:
    """Bytes of the distinct storages of the tensors in ``obj``."""
    seen, total = set(), 0
    for t in _tensors(obj):
        storage = t.untyped_storage()
        key = (t.device, storage.data_ptr())
        if key not in seen:
            seen.add(key)
            total += storage.nbytes()
    return total


def _device_of(args, kwargs) -> torch.device:
    for t in _tensors((args, kwargs)):
        return t.device
    return torch.device("cpu")


def program_memory(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once on its inputs' device and return
    its bytes: ``argument_bytes`` (the inputs' tensors), ``output_bytes``
    (the outputs' tensors), ``peak_bytes`` (the most the call held beyond
    what was allocated before it, plus the arguments), ``temp_bytes``
    (peak less arguments and outputs) and ``code_bytes`` (0: no compiled
    program).  The device is that of the first tensor argument (the CPU
    when there is none)."""
    device = _device_of(args, kwargs)
    arg_bytes = _nbytes((args, kwargs))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        out = fn(*args, **kwargs)
        torch.cuda.synchronize(device)
        extra = torch.cuda.max_memory_allocated(device) - base
    else:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU],
                     profile_memory=True) as prof:
            out = fn(*args, **kwargs)
        extra = _cpu_peak(prof)
    out_bytes = _nbytes(out)
    peak = arg_bytes + max(int(extra), 0)
    return {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "temp_bytes": max(peak - arg_bytes - out_bytes, 0),
            "code_bytes": 0, "peak_bytes": peak}


def _cpu_peak(prof) -> int:
    """The running maximum of the CPU bytes allocated minus freed over the
    profiler's memory events, in time order."""
    events = []
    for ev in prof.events():
        delta = getattr(ev, "self_cpu_memory_usage", 0)
        if delta:
            events.append((ev.time_range.start, delta))
    running = peak = 0
    for _start, delta in sorted(events):
        running += delta
        peak = max(peak, running)
    return peak


def format_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.2f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n:.2f} GiB"
