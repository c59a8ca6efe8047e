"""Profiler tables and device-memory accounting (``utils/profiling.py``,
``utils/memory.py``) on the CPU.

- On the same synthetic trace files (a TPU-style device track, and the
  ``GPU <n>`` / ``stream <n>`` tracks with ``kernel`` events that
  ``torch.profiler`` writes for CUDA), the port's ``summarize_trace`` and
  ``load_trace_events`` give the reference's table (pandas on this box):
  the same op names in the same order, calls, totals, means and shares,
  with ``device_only`` on and off and with ``top``.
- A real CPU ``torch.profiler`` trace of a small port call: every row is
  kept (no device track), the unrounded shares sum to 1 within 1e-6, the
  rounded table rounds the unrounded one.
- The missing-directory error.
- ``program_memory``'s keys and bytes on the CPU (from the profiler's
  memory events), and ``format_bytes`` equal to the reference's.
"""

import gzip
import json

import numpy as np
import pytest
import torch

from geconpy_torch.utils import memory as port_memory
from geconpy_torch.utils import profiling as port_prof
from geconpy_tpu.utils import memory as ref_memory
from geconpy_tpu.utils import profiling as ref_prof


def _event(name, dur, ts, pid, tid, cat="Op"):
    return {"ph": "X", "name": name, "dur": dur, "ts": ts, "pid": pid,
            "tid": tid, "cat": cat}


def _meta(kind, pid, tid, name):
    ev = {"ph": "M", "name": kind, "pid": pid, "args": {"name": name}}
    if tid is not None:
        ev["tid"] = tid
    return ev


def _tpu_trace():
    events = [_meta("process_name", 1, None, "/device:TPU:0"),
              _meta("thread_name", 1, 2, "XLA Ops"),
              _meta("process_name", 7, None, "/host:CPU"),
              _meta("thread_name", 7, 8, "python3")]
    rng = np.random.default_rng(0)
    for i, (name, n, base) in enumerate([("fusion.1", 5, 40.0),
                                         ("cholesky", 3, 25.0),
                                         ("while.7", 2, 110.0),
                                         ("copy", 7, 3.0)]):
        for j in range(n):
            events.append(_event(name, float(base + rng.uniform()), 10.0 * j,
                                 1, 2))
    for j in range(4):
        events.append(_event("PjitFunction", 500.0 + j, 5.0 * j, 7, 8,
                             "python"))
    return {"traceEvents": events}


def _cuda_trace():
    """As ``torch.profiler``'s export for a CUDA run: CPU ops and runtime
    calls on the host process, kernels on ``stream 7`` of ``GPU 0``."""
    events = [_meta("process_name", 4242, None, "python3 4242"),
              _meta("thread_name", 4242, 4242, "thread 4242 (python3)"),
              _meta("process_name", 0, None, "GPU 0"),
              _meta("thread_name", 0, 7, "stream 7 ")]
    for j in range(3):
        events.append(_event("aten::matmul", 30.0 + j, 100.0 * j, 4242, 4242,
                             "cpu_op"))
        events.append(_event("cudaLaunchKernel", 5.0 + j, 100.0 * j + 1,
                             4242, 4242, "cuda_runtime"))
        events.append(_event("void cr_kernel<float, true, true>(...)",
                             3400.0 + j, 100.0 * j + 2, 0, 7, "kernel"))
        events.append(_event("void settle_kernel<float, false>(...)",
                             3700.0 + 2 * j, 100.0 * j + 3, 0, 7, "kernel"))
    events.append(_event("Memcpy HtoD (Pageable -> Device)", 12.0, 900.0, 0,
                         7, "gpu_memcpy"))
    return {"traceEvents": events}


def _write(dirpath, name, trace, gz=False):
    dirpath.mkdir(parents=True, exist_ok=True)
    path = dirpath / name
    if gz:
        with gzip.open(path, "wt") as fh:
            json.dump(trace, fh)
    else:
        path.write_text(json.dumps(trace))
    return path


def _assert_table_equal(got, want):
    assert list(got.index) == list(want.index)
    assert got.columns == list(want.columns)
    for col in want.columns:
        np.testing.assert_array_equal(got[col], want[col].to_numpy())


@pytest.mark.parametrize("kind", ["tpu", "cuda"])
@pytest.mark.parametrize("device_only, top", [(True, None), (False, None),
                                              (True, 2)])
def test_summary_equals_reference(tmp_path, kind, device_only, top):
    trace = _tpu_trace() if kind == "tpu" else _cuda_trace()
    _write(tmp_path / "run", f"{kind}.trace.json.gz", trace, gz=True)
    want = ref_prof.summarize_trace(tmp_path, device_only=device_only, top=top)
    got = port_prof.summarize_trace(tmp_path, device_only=device_only, top=top)
    _assert_table_equal(got, want)
    if kind == "cuda" and device_only:
        assert not any(n.startswith(("aten::", "cuda"))
                       for n in got.index)


def test_events_equal_reference(tmp_path):
    _write(tmp_path, "a.trace.json", _tpu_trace())
    _write(tmp_path / "sub", "b.pt.trace.json", _cuda_trace())
    want = ref_prof.load_trace_events(tmp_path)
    got = port_prof.load_trace_events(tmp_path)
    assert got.columns[:6] == list(want.columns)
    assert len(got) == len(want)
    for col in want.columns:
        assert list(got[col]) == want[col].tolist(), col
    assert set(got["cat"]) >= {"kernel", "cpu_op", "Op"}


def test_real_cpu_profile_of_a_port_call(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from geconpy_torch.ops.lyapunov import solve_discrete_lyapunov

    rng = np.random.default_rng(0)
    T = torch.as_tensor(0.3 * rng.standard_normal((16, 6, 6)))
    Q = torch.eye(6, dtype=torch.float64).expand(16, 6, 6)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solve_discrete_lyapunov(T, Q)
    prof.export_chrome_trace(str(tmp_path / "lyap.trace.json"))
    raw = port_prof.summarize_trace(tmp_path, rounded=False)
    every = port_prof.summarize_trace(tmp_path, device_only=False,
                                      rounded=False)
    assert list(raw.index) == list(every.index)      # no device track
    assert abs(raw["share"].sum() - 1.0) < 1e-6
    assert any("matmul" in n for n in raw.index)
    assert (np.diff(raw["total_us"]) <= 0).all()
    rounded = port_prof.summarize_trace(tmp_path / "lyap.trace.json", top=5)
    assert len(rounded) == 5
    np.testing.assert_array_equal(rounded["share"],
                                  np.round(raw["share"][:5], 4))
    np.testing.assert_array_equal(rounded["calls"], raw["calls"][:5])
    assert "name" in repr(rounded)


def test_missing_directory(tmp_path):
    with pytest.raises(FileNotFoundError, match="no \\*.trace.json"):
        port_prof.summarize_trace(tmp_path / "nothing")
    _write(tmp_path / "empty", "x.trace.json", {"traceEvents": []})
    with pytest.raises(ValueError, match="no events"):
        port_prof.load_trace_events(tmp_path / "empty")


def test_program_memory_on_the_cpu():
    x = torch.ones((500, 100), dtype=torch.float64)

    def fn(x):
        y = x @ x.T                # 2,000,000 B
        z = y * 2.0                # 2,000,000 B
        return z.sum(0)            # 4,000 B

    out = port_memory.program_memory(fn, x)
    assert set(out) == {"argument_bytes", "output_bytes", "temp_bytes",
                        "code_bytes", "peak_bytes"}
    assert out["argument_bytes"] == 400_000
    assert out["output_bytes"] == 4_000
    assert out["code_bytes"] == 0
    assert out["peak_bytes"] == 400_000 + 4_000_000 + 4_000
    assert out["temp_bytes"] == 4_000_000
    views = port_memory.program_memory(lambda a, b: a + b, x, b=x[:, :1])
    assert views["argument_bytes"] == 400_000      # one storage, counted once


@pytest.mark.parametrize("n", [0, 512, 1023, 1024, 5 * 2**20 + 7, 3 * 2**30,
                               2**42])
def test_format_bytes_equals_reference(n):
    assert port_memory.format_bytes(n) == ref_memory.format_bytes(n)
