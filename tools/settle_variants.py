#!/usr/bin/env python3
"""Time build variants of the settle kernels (K2, K5) on one GPU.

Run from the root of a checkout:

    python3 tools/settle_variants.py [--batch 4096] VARIANT [VARIANT ...]

A variant is a comma-separated list of settings of the compile-time
constants ``GCP_SETTLE_<NAME>`` of ``geconpy_torch/csrc/settle.cu``, for
example ``DRAWS=2`` or ``DRAWS=1,MIN_BLOCKS=5``; ``base`` is the source as
it is.  Each variant is compiled on its own (all started together) into
``build/settle_variants/``.  The inputs are synthetic stable systems at
SW-2007's shapes (n = 26, k = 7, 32 settle steps of 200 periods, float32
I/O) made from a seed.  Every variant is first held against the plain
PyTorch version on 67 draws in float64 (rel 1e-9), then the variants are
timed in turns, forwards and backwards, with CUDA events; the line of a
variant gives its registers, its draws per block, its shared memory and the
K2 and K5 times of both turns, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, K, N_SETTLE, N_OBS = 26, 7, 32, 200
SETTLE_FNS = ("gcp_settle", "gcp_settle_filter", "gcp_settle_smem_bytes",
              "gcp_settle_draws_per_block")


def stable_system(n, k, batch, n_obs, seed, device, dtype):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    T = rng.standard_normal((batch, n, n))
    T *= 0.9 / np.abs(np.linalg.eigvals(T)).max(axis=-1)[:, None, None]
    G = rng.standard_normal((batch, n, n))
    RQR = G @ G.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    Z = rng.standard_normal((batch, k, n))
    E = rng.standard_normal((batch, k, k))
    H = E @ E.transpose(0, 2, 1) / k + 0.1 * np.eye(k)
    d = 0.1 * rng.standard_normal((batch, k))
    y = rng.standard_normal((n_obs, k))
    return tuple(torch.as_tensor(a, device=device, dtype=dtype).contiguous()
                 for a in (y, T, RQR, Z, H, d))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("variants", nargs="+")
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--reps", type=int, default=10)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("settle_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from geconpy_torch.ops import _cuda
    from geconpy_torch.ops.batched_settle import (LYAP_ITERS,
                                                  _settle_filter_plain,
                                                  _settle_plain)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    out_dir = ROOT / "build" / "settle_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for idx, variant in enumerate(opts.variants):
        flags = [] if variant == "base" else [
            f"-DGCP_SETTLE_{item}" for item in variant.split(",")]
        lib_path = out_dir / f"v{idx}.so"
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *flags, "-I", str(_cuda.CSRC),
               "-o", str(lib_path), str(_cuda.CSRC / "settle.cu")]
        procs.append((variant, lib_path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for variant, lib_path, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"{variant}: nvcc failed\n{log[-3000:]}")
            continue
        lib = ctypes.CDLL(str(lib_path))
        for name in SETTLE_FNS:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = _cuda._SIGNATURES[name]
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        libs[variant] = (lib, f"regs {'/'.join(regs)} spill {'/'.join(spills)}")

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def k2(lib, args):
        y, T, RQR, Z, H, d = args
        bn = T.shape[0]
        code = _cuda.dtype_code(T.dtype)
        new = lambda *s: torch.empty(s, dtype=T.dtype, device=dev)  # noqa: E731
        outs = (new(bn), new(bn, N), new(bn, N, N), new(bn, N, K),
                new(bn, K, K), new(bn))
        rc = lib.gcp_settle(code, *(a.data_ptr() for a in (T, RQR, Z, H, d, y)),
                            *(o.data_ptr() for o in outs), bn, N, K, N_SETTLE,
                            LYAP_ITERS, stream)
        assert rc == 0, rc
        return outs

    def k5(lib, args):
        y, T, RQR, Z, H, d = args
        bn = T.shape[0]
        ll = torch.empty((bn,), dtype=T.dtype, device=dev)
        rc = lib.gcp_settle_filter(
            _cuda.dtype_code(T.dtype),
            *(a.data_ptr() for a in (T, RQR, Z, H, d, y)), ll.data_ptr(), bn,
            N, K, N_SETTLE, N_OBS, LYAP_ITERS, stream)
        assert rc == 0, rc
        return ll

    def rel(a, b):
        return float(((a - b).abs() / (1 + b.abs())).max())

    small = stable_system(N, K, 67, N_OBS, 0, dev, torch.float64)
    head = (small[0][:N_SETTLE],) + small[1:]
    ref2 = _settle_plain(*head, LYAP_ITERS)
    ref5 = _settle_filter_plain(*small, N_SETTLE, LYAP_ITERS)
    for variant, (lib, _info) in libs.items():
        e2 = max(rel(g, r) for g, r in zip(k2(lib, head), ref2))
        e5 = rel(k5(lib, small), ref5)
        torch.cuda.synchronize()
        print(f"{variant}: float64 vs plain on 67 draws: K2 rel {e2:.2e}, "
              f"K5 rel {e5:.2e}", flush=True)
        assert e2 < 1e-9 and e5 < 1e-9

    big = stable_system(N, K, opts.batch, N_OBS, 1, dev, torch.float32)
    big_head = (big[0][:N_SETTLE],) + big[1:]

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
    order = list(libs) + list(reversed(libs))
    for variant in order:
        lib = libs[variant][0]
        times[variant].append((timed(lambda: k2(lib, big_head)),
                               timed(lambda: k5(lib, big))))
    for variant, (lib, info) in libs.items():
        draws = lib.gcp_settle_draws_per_block(0, N, K, N_OBS)
        smem = lib.gcp_settle_smem_bytes(0, N, K, N_OBS)
        turns = "; ".join(f"K2 {a:.3f} K5 {b:.3f}" for a, b in times[variant])
        print(f"{variant}: {info}; {draws} draws/block, {smem} B smem (K5); "
              f"ms at batch {opts.batch}, float32 I/O, two turns: {turns} "
              f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
