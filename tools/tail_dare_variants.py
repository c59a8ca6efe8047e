#!/usr/bin/env python3
"""Time build variants of the filter-tail (K3) and DARE (K6) kernels on one
GPU.

Run from the root of a checkout:

    python3 tools/tail_dare_variants.py [--batch 4096] [--vg-batch 512] VARIANT ...

A variant is ``base`` (the sources as they are), a comma-separated list of
settings of compile-time constants, for example ``TAIL_DRAWS=8`` (each
``NAME`` is ``GCP_<NAME>`` in ``geconpy_torch/csrc/filter_tail.cu`` or
``dare.cu``), or ``src=DIR``:
the two sources of another checkout's ``DIR/geconpy_torch/csrc`` (say, an
unpacked parent commit), whose C entry points ``gcp_filter_tail`` and
``gcp_dare`` take the same arguments.  Every variant's two sources are
compiled on their own, all started together, into ``build/tail_dare_variants/``.

The inputs are synthetic, made from a seed, at SW-2007's shapes (n = 26
states, k = 7 observables): a tail of 168 steps with M of spectral radius
0.9, and DARE inputs with T of spectral radius 0.9, R Q R' and H positive
definite.  Every variant is first held against the plain PyTorch versions
on 67 draws in float64 (K3 rel 1e-12, K6 rel 1e-11), then the variants are
timed in turns, forwards and backwards, with CUDA events: K3 at ``--batch``
in float32 (the sweep's launch) and K6 at ``--vg-batch`` in float64 (the
value+grad path's).  The line of a variant gives its registers and spills
per kernel instance and both turns, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, K, STEPS = 26, 7, 168
SOURCES = ("filter_tail.cu", "dare.cu")


def tail_inputs(n, k, batch, steps, seed):
    """numpy float64 (y, M, TK, Z, d, F^{-1}, const, x0) of a stable tail."""
    import numpy as np

    rng = np.random.default_rng(seed)
    M = rng.standard_normal((batch, n, n))
    M *= 0.9 / np.abs(np.linalg.eigvals(M)).max(axis=-1)[:, None, None]
    E = rng.standard_normal((batch, k, k))
    return (rng.standard_normal((steps, k)), M,
            0.3 * rng.standard_normal((batch, n, k)),
            rng.standard_normal((batch, k, n)),
            0.1 * rng.standard_normal((batch, k)),
            E @ E.transpose(0, 2, 1) / k + np.eye(k),
            rng.standard_normal(batch), rng.standard_normal((batch, n)))


def dare_inputs(n, k, batch, seed):
    """numpy float64 (T, R Q R', Z, H) of a stable system."""
    import numpy as np

    rng = np.random.default_rng(seed)
    T = rng.standard_normal((batch, n, n))
    T *= 0.9 / np.abs(np.linalg.eigvals(T)).max(axis=-1)[:, None, None]
    G = rng.standard_normal((batch, n, n))
    E = rng.standard_normal((batch, k, k))
    return (T, G @ G.transpose(0, 2, 1) / n + 0.1 * np.eye(n),
            rng.standard_normal((batch, k, n)),
            E @ E.transpose(0, 2, 1) / k + 0.1 * np.eye(k))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("variants", nargs="+")
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--vg-batch", type=int, default=512)
    parser.add_argument("--reps", type=int, default=10)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("tail_dare_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from geconpy_torch.ops import _cuda
    from geconpy_torch.ops.batched_dare import (HEWER_ITERS, INNER_ITERS,
                                                LYAP_ITERS, _dare_plain)
    from geconpy_torch.ops.batched_filter import _filter_tail_plain

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    out_dir = ROOT / "build" / "tail_dare_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for idx, variant in enumerate(opts.variants):
        csrc, flags = _cuda.CSRC, []
        if variant.startswith("src="):
            csrc = pathlib.Path(variant[4:]).resolve() / "geconpy_torch" / "csrc"
        elif variant != "base":
            flags = [f"-DGCP_{item}" for item in variant.split(",")]
        for src in SOURCES:
            lib_path = out_dir / f"v{idx}_{src[:-3]}.so"
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *flags, "-I", str(csrc),
                   "-o", str(lib_path), str(csrc / src)]
            procs.append((variant, src, lib_path, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    libs: dict = {}
    info: dict = {}
    for variant, src, lib_path, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"{variant} {src}: nvcc failed\n{log[-3000:]}", flush=True)
            libs[variant] = None
            continue
        if variant in libs and libs[variant] is None:
            continue
        lib = ctypes.CDLL(str(lib_path))
        name = "gcp_filter_tail" if src == "filter_tail.cu" else "gcp_dare"
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _cuda._SIGNATURES[name]
        libs.setdefault(variant, {})[src] = fn
        # per kernel instance: registers and spill stores
        kernels = re.findall(r"Compiling entry function '(\w+)'", log)
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        info.setdefault(variant, []).append(
            f"{src}: regs {'/'.join(regs)} for {len(kernels)} kernels, spill "
            f"stores {'/'.join(spills)}")
    libs = {v: fns for v, fns in libs.items() if fns and len(fns) == 2}
    if not libs:
        return 1

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def k3(fn, args):
        y, M = args[:2]
        bn, n, k = M.shape[0], M.shape[-1], y.shape[-1]
        ll = torch.empty((bn,), dtype=M.dtype, device=dev)
        rc = fn(_cuda.dtype_code(M.dtype), *(X.data_ptr() for X in args),
                ll.data_ptr(), bn, n, k, y.shape[0], stream)
        assert rc == 0, rc
        return ll

    def k6(fn, args):
        T, _RQR, Z, _H = args
        bn, n, k = T.shape[0], T.shape[-1], Z.shape[-2]
        P = torch.empty_like(T)
        rc = fn(_cuda.dtype_code(T.dtype), *(X.data_ptr() for X in args),
                P.data_ptr(), bn, n, k, LYAP_ITERS, HEWER_ITERS, INNER_ITERS,
                stream)
        assert rc == 0, rc
        return P

    def on_card(arrays, dtype):
        return tuple(torch.as_tensor(X, device=dev, dtype=dtype).contiguous()
                     for X in arrays)

    def rel(a, b):
        assert torch.equal(torch.isfinite(a), torch.isfinite(b))
        return float(((a - b).abs() / (1 + b.abs())).max())

    tail_small = on_card(tail_inputs(N, K, 67, STEPS, 0), torch.float64)
    dare_small = on_card(dare_inputs(N, K, 67, 0), torch.float64)
    ll0 = _filter_tail_plain(*tail_small)
    P0 = _dare_plain(*dare_small)
    failed = []
    for variant, fns in libs.items():
        e3 = rel(k3(fns["filter_tail.cu"], tail_small), ll0)
        e6 = rel(k6(fns["dare.cu"], dare_small), P0)
        torch.cuda.synchronize()
        print(f"{variant}: float64 vs plain on 67 draws: K3 rel {e3:.2e}, K6 "
              f"rel {e6:.2e}", flush=True)
        if not (e3 < 1e-12 and e6 < 1e-11):
            failed.append(variant)
    for variant in failed:
        del libs[variant]

    tail_big = on_card(tail_inputs(N, K, opts.batch, STEPS, 1), torch.float32)
    dare_big = on_card(dare_inputs(N, K, opts.vg_batch, 2), torch.float64)

    def timed(fn):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(opts.reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / opts.reps

    times = {v: [] for v in libs}
    for variant in list(libs) + list(reversed(libs)):
        fns = libs[variant]
        times[variant].append(
            (timed(lambda: k3(fns["filter_tail.cu"], tail_big)),
             timed(lambda: k6(fns["dare.cu"], dare_big))))
    for variant in libs:
        turns = "; ".join(f"K3 {a:.4f} K6 {b:.4f}" for a, b in times[variant])
        print(f"{variant}: {'; '.join(info[variant])}; ms (K3 batch "
              f"{opts.batch} f32, K6 batch {opts.vg_batch} f64), two turns: "
              f"{turns} [{card}]", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
