"""Profiler-trace aggregation: ``torch.profiler`` traces -> per-op tables.

Mirrors ``geconpy_tpu/utils/profiling.py`` (``load_trace_events`` :41,
``summarize_trace`` :73), which reads ``jax.profiler`` dumps.  The port
reads the Chrome traces that ``torch.profiler`` writes
(``prof.export_chrome_trace(path)``, or ``tensorboard_trace_handler``'s
``*.pt.trace.json[.gz]``) and returns a :class:`TraceTable`, columns as
numpy arrays with a name list, where the reference returns a
``pandas.DataFrame``.

A CUDA trace puts the kernels on tracks named ``stream <n>`` of a
process named ``GPU <n>`` with the category ``kernel`` (copies and sets:
``gpu_memcpy``, ``gpu_memset``); the reference's device filter already
matches ``stream`` by name, and the port also keeps those categories.

Typical loop::

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        sweep(batch)
    prof.export_chrome_trace("trace/sweep.trace.json")
    print(summarize_trace("trace", top=20))
"""

from __future__ import annotations

import gzip
import json
import re
from pathlib import Path

import numpy as np

__all__ = ["TraceTable", "load_trace_events", "summarize_trace"]

_DEVICE_TRACK = re.compile(r"TPU|/device|XLA Op|Stream|GPU", re.IGNORECASE)
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class TraceTable:
    """Named columns of equal length, with an optional row ``index``."""

    def __init__(self, columns: dict[str, np.ndarray],
                 index: np.ndarray | None = None):
        self.data = columns
        self.columns = list(columns)
        self.index = index

    def __getitem__(self, name: str) -> np.ndarray:
        return self.data[name]

    def __len__(self) -> int:
        return len(next(iter(self.data.values()))) if self.data else 0

    def rows(self, mask) -> "TraceTable":
        return TraceTable({k: v[mask] for k, v in self.data.items()},
                          None if self.index is None else self.index[mask])

    def __repr__(self) -> str:
        head = [("" if self.index is None else "name", *self.columns)]
        for i in range(min(len(self), 20)):
            label = "" if self.index is None else str(self.index[i])[:60]
            head.append((label, *(str(self.data[c][i]) for c in self.columns)))
        widths = [max(len(r[j]) for r in head) for j in range(len(head[0]))]
        return "\n".join("  ".join(c.ljust(w) for c, w in zip(r, widths))
                         for r in head)


def _find_trace_files(trace_dir) -> list[Path]:
    root = Path(trace_dir)
    if root.is_file():
        return [root]
    files = sorted(root.rglob("*.trace.json.gz")) \
        + sorted(root.rglob("*.trace.json"))
    if not files:
        raise FileNotFoundError(
            f"no *.trace.json[.gz] under {root}: write one with "
            f"torch.profiler's export_chrome_trace first")
    return files


def load_trace_events(trace_dir) -> TraceTable:
    """Flatten every complete ('X') trace event of the traces under
    ``trace_dir`` (or of that one file) into columns: name, dur_us, ts,
    pid, tid, track (the thread's or else the process's name) and cat."""
    rows = []
    for path in _find_trace_files(trace_dir):
        opener = gzip.open if path.suffix == ".gz" else open
        with opener(path, "rt") as fh:
            data = json.load(fh)
        events = data.get("traceEvents", []) if isinstance(data, dict) \
            else data
        # metadata: map (pid, tid) -> human-readable track names
        pid_names, tid_names = {}, {}
        for ev in events:
            if ev.get("ph") == "M":
                if ev.get("name") == "process_name":
                    pid_names[ev.get("pid")] = ev["args"].get("name", "")
                elif ev.get("name") == "thread_name":
                    tid_names[(ev.get("pid"), ev.get("tid"))] = \
                        ev["args"].get("name", "")
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            pid, tid = ev.get("pid"), ev.get("tid")
            track = tid_names.get((pid, tid)) or pid_names.get(pid, "")
            rows.append((ev.get("name", "?"), float(ev["dur"]),
                         float(ev.get("ts", 0.0)), pid, tid, track,
                         ev.get("cat", "")))
    if not rows:
        raise ValueError(f"trace under {trace_dir} contains no events")
    names = ["name", "dur_us", "ts", "pid", "tid", "track", "cat"]
    cols = list(zip(*rows))
    return TraceTable({
        name: (np.asarray(col, dtype=np.float64)
               if name in ("dur_us", "ts") else
               np.asarray(col, dtype=object))
        for name, col in zip(names, cols)})


def summarize_trace(trace_dir, device_only: bool = True,
                    top: int | None = None, rounded: bool = True
                    ) -> TraceTable:
    """Per-op cost table of a trace, sorted by total time.

    ``device_only=True`` keeps the device's rows (GPU kernels, copies and
    sets; the reference's TPU tracks) when the trace has any, else every
    row (a CPU trace, where the compute is on the host).  Rows are the op
    names (``index``); columns: calls, total_us, mean_us, share (of the
    summed total).  ``rounded`` rounds total_us and mean_us to 2 decimals
    and share to 4, as the reference does; ``rounded=False`` keeps them
    exact.
    """
    table = load_trace_events(trace_dir)
    if device_only:
        tracks = np.asarray([bool(_DEVICE_TRACK.search(str(t)))
                             for t in table["track"]])
        device = tracks | np.isin(table["cat"], _DEVICE_CATEGORIES)
        if device.any():
            table = table.rows(device)
    names, inverse = np.unique(table["name"].astype(str), return_inverse=True)
    calls = np.bincount(inverse, minlength=len(names))
    total = np.bincount(inverse, weights=table["dur_us"], minlength=len(names))
    mean = total / calls
    order = np.argsort(-total, kind="stable")
    share = total / max(total.sum(), 1e-12)
    cols = {"calls": calls[order], "total_us": total[order],
            "mean_us": mean[order], "share": share[order]}
    if rounded:
        cols["total_us"] = np.round(cols["total_us"], 2)
        cols["mean_us"] = np.round(cols["mean_us"], 2)
        cols["share"] = np.round(cols["share"], 4)
    out = TraceTable(cols, names[order])
    return out.rows(slice(0, top)) if top else out
