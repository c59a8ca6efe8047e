#!/usr/bin/env python3
"""Time build variants of the cycle-reduction kernels (K1, K4) on one GPU.

Run from the root of a checkout:

    python3 tools/cr_variants.py [--batch 4096] [--vg-batch 512] VARIANT ...

A variant is a comma-separated list of settings of the compile-time
constants ``GCP_CR_<NAME>`` of ``geconpy_torch/csrc/cycle_reduction.cu``,
for example ``DRAWS=2`` or ``DRAWS=1,MIN_BLOCKS=3``; ``base`` is the source
as it is.  Each variant is compiled on its own (all started together) into
``build/cr_variants/``.  The inputs are synthetic pencils at SW-2007's
shapes (n = 26, m = 7) made from a seed, each with a stable solvent (see
:func:`stable_pencil`).  Every variant is first held against the plain
PyTorch versions on 67 draws in float64 (rel 1e-9, min |pivot| aside: a
near tie may pivot on another row at rounding level), then the variants
are timed in turns, forwards and backwards, with CUDA events: K1 at
``--batch`` with float32 I/O (the sweep's launch) and K4 at ``--vg-batch``
with float64 I/O (the value+grad path's).  The line of a variant gives its
registers, the functions that spill, draws per block and shared memory per
block, with the card's name and power limit.  A build with ``PROBE=1``
(``GCP_CR_PROBE``) also prints the clocks of one draw by phase, for K1 and
K4.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, M, N_ITER = 26, 7, 14
CR_FNS = ("gcp_cr_policy", "gcp_cr", "gcp_cr_policy_smem_bytes",
          "gcp_cr_smem_bytes")


def stable_pencil(n, m, batch, seed):
    """numpy float64 (A, B, C, D) with A + B T + C T^2 = 0 for a T of
    spectral radius 0.8: B = Mx - C T and A = -Mx T with Mx = 2 I + noise
    and C small, so A + B z + C z^2 = (C z + Mx)(z I - T) keeps its other n
    roots far outside the unit circle and cycle reduction converges."""
    import numpy as np

    rng = np.random.default_rng(seed)
    T = rng.standard_normal((batch, n, n))
    T *= 0.8 / np.abs(np.linalg.eigvals(T)).max(axis=-1)[:, None, None]
    C = 0.3 * rng.standard_normal((batch, n, n)) / np.sqrt(n)
    Mx = 2.0 * np.eye(n) + 0.3 * rng.standard_normal((batch, n, n)) / np.sqrt(n)
    B = Mx - C @ T
    A = -Mx @ T
    D = rng.standard_normal((batch, n, m))
    return A, B, C, D


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("variants", nargs="+")
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--vg-batch", type=int, default=512)
    parser.add_argument("--reps", type=int, default=10)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("cr_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from geconpy_torch.ops import _cuda
    from geconpy_torch.ops.batched_cycle_reduction import (_cr_plain,
                                                           _cr_policy_plain)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    out_dir = ROOT / "build" / "cr_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for idx, variant in enumerate(opts.variants):
        flags = [] if variant == "base" else [
            f"-DGCP_CR_{item}" for item in variant.split(",")]
        lib_path = out_dir / f"v{idx}.so"
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *flags, "-I", str(_cuda.CSRC),
               "-o", str(lib_path), str(_cuda.CSRC / "cycle_reduction.cu")]
        procs.append((variant, lib_path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for variant, lib_path, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"{variant}: nvcc failed\n{log[-3000:]}", flush=True)
            continue
        lib = ctypes.CDLL(str(lib_path))
        for name in CR_FNS:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = _cuda._SIGNATURES[name]
        lib.gcp_cr_draws_per_block.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.gcp_cr_draws_per_block.restype = ctypes.c_int
        regs = re.findall(r"Used (\d+) registers", log)
        # functions that spill: "Function properties for F", then its line
        # of stack frame and spill bytes
        spilled = re.findall(r"Function properties for (\S+)\n\s*(\d+) bytes "
                             r"stack frame, (\d+) bytes spill stores", log)
        spills = {f: int(st) for f, _fr, st in spilled if int(st)}
        libs[variant] = (lib, f"regs {'/'.join(regs)}, spill stores {spills}")
    if not libs:
        return 1

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def k1(lib, args):
        A, B, C, D = args
        bn = A.shape[0]
        T = torch.empty((bn, N, N), dtype=A.dtype, device=dev)
        R = torch.empty((bn, N, M), dtype=A.dtype, device=dev)
        flags = torch.empty((bn, 3), dtype=A.dtype, device=dev)
        ptrs = (X.data_ptr() for X in (A, B, C, D, T, R, flags))
        rc = lib.gcp_cr_policy(_cuda.dtype_code(A.dtype), *ptrs, bn, N, M,
                               N_ITER, stream)
        assert rc == 0, rc
        return T, R, flags

    def k4(lib, args):
        A, B, C = args[:3]
        bn = A.shape[0]
        T = torch.empty((bn, N, N), dtype=A.dtype, device=dev)
        flags = torch.empty((bn, 2), dtype=A.dtype, device=dev)
        rc = lib.gcp_cr(_cuda.dtype_code(A.dtype),
                        *(X.data_ptr() for X in (A, B, C, T, flags)), bn, N,
                        N_ITER, stream)
        assert rc == 0, rc
        return T, flags

    def rel(a, b):
        assert torch.equal(torch.isfinite(a), torch.isfinite(b))
        return float(((a - b).abs() / (1 + b.abs())).max())

    def pencil(batch, seed, dtype):
        return tuple(torch.as_tensor(X, device=dev, dtype=dtype).contiguous()
                     for X in stable_pencil(N, M, batch, seed))

    small = pencil(67, 0, torch.float64)
    T0, R0, f0 = _cr_policy_plain(*small, N_ITER)
    T4, f4 = _cr_plain(*small[:3], N_ITER)
    failed = []
    for variant, (lib, _info) in libs.items():
        T, R, f = k1(lib, small)
        Tk, fk = k4(lib, small)
        torch.cuda.synchronize()
        e1 = max(rel(T, T0), rel(R, R0), rel(f[:, 1:], f0[:, 1:]))
        e4 = max(rel(Tk, T4), rel(fk[:, 1:], f4[:, 1:]))
        print(f"{variant}: float64 vs plain on 67 draws: K1 rel {e1:.2e}, "
              f"K4 rel {e4:.2e}; min|pivot| rel {rel(f[:, 0], f0[:, 0]):.2e}",
              flush=True)
        if not (e1 < 1e-9 and e4 < 1e-9):
            failed.append(variant)
    for variant in failed:
        del libs[variant]

    big = pencil(opts.batch, 1, torch.float32)
    vg = pencil(opts.vg_batch, 2, torch.float64)

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
        lib = libs[variant][0]
        times[variant].append((timed(lambda: k1(lib, big)),
                               timed(lambda: k4(lib, vg))))
    phases = ("eliminations", "products 1", "products 2", "updates",
              "T solve", "inputs", "rest", "of which cr_solve_regs's warp 0")
    for variant, (lib, _info) in libs.items():
        if not hasattr(lib, "gcp_cr_probe_read"):
            continue
        # built with GCP_CR_PROBE=1: clocks by phase of block 0's first draw
        clocks = (ctypes.c_ulonglong * 8)()
        for label, fn, args in (("K1", k1, big), ("K4", k4, vg)):
            assert lib.gcp_cr_probe_reset() == 0
            fn(lib, args)
            torch.cuda.synchronize()
            assert lib.gcp_cr_probe_read(clocks) == 0
            parts = ", ".join(f"{name} {clocks[i]}"
                              for i, name in enumerate(phases))
            print(f"{variant}: {label} clocks of block 0's first draw: "
                  f"{parts}; total {sum(clocks[:7])}", flush=True)
    for variant, (lib, info) in libs.items():
        draws = lib.gcp_cr_draws_per_block(N, M)
        smem = lib.gcp_cr_policy_smem_bytes(N, M)
        turns = "; ".join(f"K1 {a:.3f} K4 {b:.3f}" for a, b in times[variant])
        print(f"{variant}: {info}; {draws} draws/block, {smem} B smem a block; "
              f"ms (K1 batch {opts.batch} f32 I/O, K4 batch {opts.vg_batch} "
              f"f64 I/O), two turns: {turns} [{card}]", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
