#!/usr/bin/env python3
"""Time build variants of the cycle-reduction kernels (K1, K4) on one GPU.

Run from the root of a checkout:

    python3 tools/cr_variants.py [--n 26 --m 7] [--batch 4096]
        [--vg-batch 512] [--tiers auto] VARIANT ...

A variant is a comma-separated list of settings of the compile-time
constants ``GCP_CR_<NAME>`` of ``geconpy_torch/csrc/cycle_reduction.cu``
and ``cycle_reduction_tiers.cu`` (built together),
for example ``DRAWS=2``, ``DRAWS=1,MIN_BLOCKS=3`` or ``PROBE=1``; ``base``
is the source as it is, and ``src=DIR`` the two sources of another
checkout's ``DIR/geconpy_torch/csrc`` (say, a copy with one change
unpacked under ``build/``, which ``.gitignore`` covers; both files must be
there).
Each variant is compiled on its own (all started together) into
``build/cr_variants/``.  The inputs are synthetic pencils at (``--n``,
``--m``), SW-2007's shapes (26, 7) by default, made from a seed, each with
a stable solvent (see :func:`stable_pencil`).  ``--tiers`` names the
kernels to run, comma-separated: ``small`` (``cr_kernel``, n <= 48),
``onchip`` (``cr_onchip_kernel``: one draw a CTA in shared memory),
``cluster`` (``cr_cluster_kernel``: one draw a thread-block cluster, held
to the plain version in panels), ``workspace`` (``cr_large_kernel``: each
draw's buffers in device memory)
or ``auto``, the tier the wrappers take at that shape
(``ops/batched_cycle_reduction.py::cr_tier``).  Every variant and tier is
first held against the plain PyTorch versions on 67 draws in float64 (rel
1e-9, min |pivot| aside: a near tie may pivot on another row at rounding
level), then timed in turns, forwards and backwards, with CUDA events: K1
at ``--batch`` with float32 I/O (the sweep's launch) and K4 at
``--vg-batch`` with float64 I/O (the value+grad path's), both with
``CR_ITERS`` = 14 doublings (``stats/statespace.py``).  The line of a
variant gives its registers, the functions that spill and each tier's
shared memory per block, with the card's name and power limit.  A build
with ``PROBE=1`` (``GCP_CR_PROBE``) also prints the clocks of one draw by
phase, for K1 and K4 in each tier (the cluster tier's as CTA 0 sees it),
and for the on-chip and device-memory tiers the bytes a draw's
eliminations and products read and write of its buffers
(:func:`draw_traffic`) over the kernel's time.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_ITER = 14
CR_FNS = ("gcp_cr_policy", "gcp_cr", "gcp_cr_policy_smem_bytes",
          "gcp_cr_smem_bytes", "gcp_cr_policy_large", "gcp_cr_large",
          "gcp_cr_large_work_bytes", "gcp_cr_fits")
ONCHIP_FNS = ("gcp_cr_policy_onchip", "gcp_cr_onchip",
              "gcp_cr_onchip_smem_bytes", "gcp_cr_policy_cluster",
              "gcp_cr_cluster", "gcp_cr_cluster_ctas",
              "gcp_cr_cluster_smem_bytes")


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


def draw_traffic(n: int, m: int, n_iter: int, select: bool) -> dict:
    """Bytes one draw's recursion reads and writes of its own float64
    buffers above n = 32 (``cr_eliminate`` and ``tile_mm``), by phase.  An
    elimination step k reads and writes each of the n rows of every column
    it updates (the left block's n - k - 1 and the right-hand ones); a
    product reads a 16-row panel of A and a 16-column panel of B for each
    16 x 16 item of its result, which it writes.  The pivot column's
    broadcast reads are not counted."""
    nr, n8 = (n + 15) // 16 * 16, (n + 7) // 8 * 8

    def eliminate(n_right: int) -> int:
        return sum(16 * n * ((n - k - 1) + n_right) for k in range(n))

    items = (nr // 16) * ((n8 + 15) // 16)
    product = 8 * (items * (16 * n8 + n8 * 16) + nr * n8)
    solves = eliminate(n) + (eliminate(m) if select else 0)
    return {"doublings' eliminations": n_iter * eliminate(2 * n),
            "final solves": solves,
            "products": n_iter * 4 * product + (2 * product if select else 0)}


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("variants", nargs="+")
    parser.add_argument("--n", type=int, default=26)
    parser.add_argument("--m", type=int, default=7)
    parser.add_argument("--tiers", default="auto")
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--vg-batch", type=int, default=512)
    parser.add_argument("--reps", type=int, default=10)
    opts = parser.parse_args()
    N, M = opts.n, opts.m
    if not torch.cuda.is_available():
        print("cr_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from geconpy_torch.ops import _cuda
    from geconpy_torch.ops.batched_cycle_reduction import (CR_PANEL,
                                                           _cr_plain,
                                                           _cr_policy_plain)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    out_dir = ROOT / "build" / "cr_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for idx, variant in enumerate(opts.variants):
        csrc, flags = _cuda.CSRC, []
        if variant.startswith("src="):
            csrc = pathlib.Path(variant[4:]).resolve() / "geconpy_torch" / "csrc"
        elif variant != "base":
            flags = [f"-DGCP_CR_{item}" for item in variant.split(",")]
        lib_path = out_dir / f"v{idx}.so"
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *flags, "-I", str(csrc),
               "-o", str(lib_path), str(csrc / "cycle_reduction.cu"),
               str(csrc / "cycle_reduction_tiers.cu")]
        procs.append((variant, lib_path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for variant, lib_path, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"{variant}: nvcc failed\n{log[-3000:]}", flush=True)
            continue
        lib = ctypes.CDLL(str(lib_path))
        for name in CR_FNS + (ONCHIP_FNS if hasattr(lib, ONCHIP_FNS[0])
                              else ()):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = _cuda._SIGNATURES[name]
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

    def tier_of(lib, m: int) -> str:
        if lib.gcp_cr_fits(N, m):
            return "small"
        from geconpy_torch.ops.batched_cycle_reduction import cr_tier

        return cr_tier(N, m, torch.cuda.get_device_properties(
            dev).shared_memory_per_block_optin)

    tiers = [t for t in opts.tiers.split(",")]

    def k1(lib, args, tier):
        A, B, C, D = args
        bn = A.shape[0]
        T = torch.empty((bn, N, N), dtype=A.dtype, device=dev)
        R = torch.empty((bn, N, M), dtype=A.dtype, device=dev)
        flags = torch.empty((bn, 3), dtype=A.dtype, device=dev)
        ptrs = [X.data_ptr() for X in (A, B, C, D, T, R, flags)]
        code = _cuda.dtype_code(A.dtype)
        if tier == "auto":
            tier = tier_of(lib, M)
        if tier == "small":
            rc = lib.gcp_cr_policy(code, *ptrs, bn, N, M, N_ITER, stream)
        elif tier in ("onchip", "cluster"):
            rc = getattr(lib, f"gcp_cr_policy_{tier}")(code, *ptrs, bn, N, M,
                                                       N_ITER, stream)
        else:
            nbytes = lib.gcp_cr_large_work_bytes(code, 1, N, M, bn)
            work = _cuda.workspace(nbytes, dev)
            rc = lib.gcp_cr_policy_large(code, *ptrs, work.data_ptr(), nbytes,
                                         bn, N, M, N_ITER, stream)
        assert rc == 0, rc
        return T, R, flags

    def k4(lib, args, tier):
        A, B, C = args[:3]
        bn = A.shape[0]
        T = torch.empty((bn, N, N), dtype=A.dtype, device=dev)
        flags = torch.empty((bn, 2), dtype=A.dtype, device=dev)
        ptrs = [X.data_ptr() for X in (A, B, C, T, flags)]
        code = _cuda.dtype_code(A.dtype)
        if tier == "auto":
            tier = tier_of(lib, 0)
        if tier == "small":
            rc = lib.gcp_cr(code, *ptrs, bn, N, N_ITER, stream)
        elif tier in ("onchip", "cluster"):
            rc = getattr(lib, f"gcp_cr_{tier}")(code, *ptrs, bn, N, N_ITER,
                                                stream)
        else:
            nbytes = lib.gcp_cr_large_work_bytes(code, 0, N, 0, bn)
            work = _cuda.workspace(nbytes, dev)
            rc = lib.gcp_cr_large(code, *ptrs, work.data_ptr(), nbytes, bn, N,
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
    failed = []
    runs = [(v, t) for v in libs for t in tiers]
    for variant, tier in runs:
        lib = libs[variant][0]
        # the cluster tier's plain twin is the panel schedule
        panel = CR_PANEL if (tier if tier != "auto" else tier_of(lib, M)) \
            == "cluster" else None
        T0, R0, f0 = _cr_policy_plain(*small, N_ITER, panel)
        T4, f4 = _cr_plain(*small[:3], N_ITER, panel)
        T, R, f = k1(lib, small, tier)
        Tk, fk = k4(lib, small, tier)
        torch.cuda.synchronize()
        e1 = max(rel(T, T0), rel(R, R0), rel(f[:, 1:], f0[:, 1:]))
        e4 = max(rel(Tk, T4), rel(fk[:, 1:], f4[:, 1:]))
        print(f"{variant} {tier}: float64 vs plain on 67 draws at n = {N}, "
              f"m = {M}: K1 rel {e1:.2e}, K4 rel {e4:.2e}; min|pivot| rel "
              f"{rel(f[:, 0], f0[:, 0]):.2e}", flush=True)
        if not (e1 < 1e-9 and e4 < 1e-9):
            failed.append((variant, tier))
    runs = [r for r in runs if r not in failed]

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

    times = {r: [] for r in runs}
    for variant, tier in runs + list(reversed(runs)):
        lib = libs[variant][0]
        times[(variant, tier)].append(
            (timed(lambda: k1(lib, big, tier)),
             timed(lambda: k4(lib, vg, tier))))
    phases = ("eliminations", "products 1", "products 2", "updates",
              "T solve", "inputs", "rest",
              "of which the pivot warp (small: cr_record; on-chip: publish "
              "and search) or the cluster barriers (cluster)")
    for variant, tier in runs:
        lib = libs[variant][0]
        if not hasattr(lib, "gcp_cr_probe_read"):
            continue
        # built with GCP_CR_PROBE=1: clocks by phase of draw 0, in the
        # source of the tier (cycle_reduction_tiers.cu: on-chip, cluster)
        clocks = (ctypes.c_ulonglong * 8)()
        for label, fn, args, t_ms, select in (
                ("K1", k1, big, times[(variant, tier)][0][0], True),
                ("K4", k4, vg, times[(variant, tier)][0][1], False)):
            resolved = tier if tier != "auto" else tier_of(
                lib, M if select else 0)
            probe = "gcp_cr_tier_probe" if resolved in ("onchip", "cluster") \
                else "gcp_cr_probe"
            assert getattr(lib, f"{probe}_reset")() == 0
            fn(lib, args, tier)
            torch.cuda.synchronize()
            assert getattr(lib, f"{probe}_read")(clocks) == 0
            parts = ", ".join(f"{name} {clocks[i]}"
                              for i, name in enumerate(phases))
            total = sum(clocks[:7])
            line = (f"{variant} {tier}: {label} clocks of draw 0: {parts}; "
                    f"total {total} ({total / sm_mhz * 1e-3:.3f} ms at the "
                    f"{sm_mhz:.0f} MHz maximum SM clock)")
            if N > 32 and resolved != "cluster":
                bn = args[0].shape[0]
                traffic = draw_traffic(N, M if select else 0, N_ITER, select)
                per_draw = sum(traffic.values())
                elim_s = clocks[0] / (sm_mhz * 1e6)
                line += (f"; draw buffer traffic {traffic} B a draw, "
                         f"{per_draw * bn / (t_ms * 1e-3) / 1e12:.2f} TB/s "
                         f"over the kernel ({bn} draws in {t_ms:.3f} ms), "
                         f"draw 0's eliminations "
                         f"{traffic["doublings' eliminations"] / elim_s / 1e9:.1f} "
                         f"GB/s")
            print(line, flush=True)
    for variant, tier in runs:
        lib = libs[variant][0]
        smem = {"small": lib.gcp_cr_policy_smem_bytes(N, M)}
        if hasattr(lib, "gcp_cr_onchip_smem_bytes"):
            smem["onchip"] = lib.gcp_cr_onchip_smem_bytes(N, M)
            smem["cluster (a CTA)"] = lib.gcp_cr_cluster_smem_bytes(N, M)
            smem["cluster CTAs"] = lib.gcp_cr_cluster_ctas(N, M)
        turns = "; ".join(f"K1 {a:.3f} K4 {b:.3f}"
                          for a, b in times[(variant, tier)])
        print(f"{variant} {tier}: {libs[variant][1]}; smem a block {smem} B; "
              f"ms (n = {N}, m = {M}, {N_ITER} doublings; K1 batch "
              f"{opts.batch} f32 I/O, K4 batch {opts.vg_batch} f64 I/O), two "
              f"turns: {turns} [{card}]", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
