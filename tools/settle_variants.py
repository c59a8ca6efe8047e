#!/usr/bin/env python3
"""Time build variants of the settle kernels (K2, K5) on one GPU.

Run from the root of a checkout:

    python3 tools/settle_variants.py [--n 26] [--batch 4096] VARIANT [...]

A variant is a comma-separated list of settings of the compile-time
constants ``GCP_SETTLE_<NAME>`` of ``geconpy_torch/csrc/settle.cuh`` and
the three tiers' sources ``settle.cu``, ``settle_cluster.cu`` and
``settle_large.cu`` (built together), for
example ``DRAWS=2``, ``DRAWS=1,MIN_BLOCKS=5`` or, for the cluster kernel,
``PROBE=1`` (one draw's clocks by phase; the probe build puts a CTA barrier
between T P and x_pred, so its schedule differs slightly from the one that
ships); ``base`` is the source as it is.  Each variant is compiled on
its own (all started together) into ``build/settle_variants/``.  The inputs
are synthetic stable systems with n states (SW-2007's 26 by default; 104 is
its filter state with year-on-year inflation), k = 7, 32 settle steps of
200 periods, made from a seed.  The tiers the shape takes run: at n = 26
the small-state kernel; above the small-state plan the cluster kernel where
its plan fits and the large-state kernel on its device-memory workspace
(``gcp_settle_large``, ``gcp_settle_filter_large``), both, side by side.
Every variant's tiers are first held against the plain PyTorch version on
67 draws in float64 (rel 1e-9), then timed in turns, forwards and
backwards, with CUDA events at ``--batch`` draws in float32 I/O; the line
of a variant gives its registers and spills, the plan (draws per block, or
CTAs a cluster and the resident clusters), its shared memory and the K2
and K5 times of both turns of each tier, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
K, N_SETTLE, N_OBS = 7, 32, 200
SETTLE_FNS = ("gcp_settle", "gcp_settle_filter", "gcp_settle_smem_bytes",
              "gcp_settle_draws_per_block", "gcp_settle_fits",
              "gcp_settle_large", "gcp_settle_filter_large",
              "gcp_settle_large_work_bytes", "gcp_settle_cluster",
              "gcp_settle_filter_cluster", "gcp_settle_cluster_ctas",
              "gcp_settle_cluster_smem_bytes", "gcp_settle_cluster_resident")


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


def tier_calls(lib, n):
    """{tier: (K2, K5)} for the tiers that shape ``n`` takes: functions of
    the float32 or float64 inputs (y, T, R Q R', Z, H, d) that launch one
    tier's kernel of ``lib`` through its C entry point and return its
    outputs."""
    from geconpy_torch.ops.batched_settle import _launch

    def calls(tier):
        return (lambda args: _launch(lib, tier, False, *args,
                                     args[0].shape[0], LYAP),
                lambda args: _launch(lib, tier, True, *args, N_SETTLE, LYAP))

    if lib.gcp_settle_fits(1, n, K, N_OBS):
        return {"small": calls("small")}
    tiers = ("cluster", "workspace") \
        if lib.gcp_settle_cluster_ctas(1, n, K, N_OBS) else ("workspace",)
    return {tier: calls(tier) for tier in tiers}


LYAP = 10


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("variants", nargs="+")
    parser.add_argument("--n", type=int, default=26)
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

    assert LYAP == LYAP_ITERS
    n = opts.n
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
               "-o", str(lib_path),
               *(str(_cuda.CSRC / f"settle{tier}.cu")
                 for tier in ("", "_cluster", "_large"))]
        procs.append((variant, lib_path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for variant, lib_path, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"{variant}: nvcc failed\n{log[-6000:]}", flush=True)
            continue
        lib = ctypes.CDLL(str(lib_path))
        for name in SETTLE_FNS:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = _cuda._SIGNATURES[name]
        # registers and spills by kernel (ptxas lists each kernel's
        # properties after its name)
        info, kernel, spilled = [], None, "?"
        for line in log.splitlines():
            found = re.search(r"entry function '_ZN3gcp\d+(\w+?_kernel)"
                              r"I(\w)Lb([01])E", line)
            if found:
                io = "f32" if found.group(2) == "f" else "f64"
                fused = ", fused" if found.group(3) == "1" else ""
                kernel = f"{found.group(1)}<{io}{fused}>"
            spill = re.search(r"(\d+) bytes spill stores", line)
            if spill:
                spilled = spill.group(1)
            regs = re.search(r"Used (\d+) registers", line)
            if kernel and regs:
                info.append(f"{kernel} regs {regs.group(1)} spill {spilled}")
                kernel = None
        libs[variant] = (lib, "; ".join(info))

    dev = torch.device("cuda", 0)

    def rel(a, b):
        both = torch.isfinite(a) & torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), torch.isfinite(b))
        return float(((a - b).abs() / (1 + b.abs()))[both].max())

    small = stable_system(n, K, 67, N_OBS, 0, dev, torch.float64)
    head = (small[0][:N_SETTLE],) + small[1:]
    ref2 = _settle_plain(*head, LYAP_ITERS)
    ref5 = _settle_filter_plain(*small, N_SETTLE, LYAP_ITERS)
    for variant, (lib, _info) in libs.items():
        for tier, (k2, k5) in tier_calls(lib, n).items():
            e2 = max(rel(g, r) for g, r in zip(k2(head), ref2))
            e5 = rel(k5(small), ref5)
            torch.cuda.synchronize()
            print(f"{variant} {tier}: float64 vs plain on 67 draws at n = "
                  f"{n}: K2 rel {e2:.2e}, K5 rel {e5:.2e}", flush=True)
            assert e2 < 1e-9 and e5 < 1e-9, variant

    big = stable_system(n, K, opts.batch, N_OBS, 1, dev, torch.float32)
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

    times = {}
    order = list(libs) + list(reversed(libs))
    for variant in order:
        lib = libs[variant][0]
        for tier, (k2, k5) in tier_calls(lib, n).items():
            times.setdefault((variant, tier), []).append(
                (timed(lambda: k2(big_head)), timed(lambda: k5(big))))
    probe_labels = ["inputs", "Lyapunov A P", "Lyapunov P += (A P) A'",
                    "Lyapunov A A", "T P", "P_pred", "P_pred Z'",
                    "v, F, its elimination", "K", "I - K Z, K H, x",
                    "(I - K Z) P_pred", "Joseph sum", "frozen gain", "tail",
                    "x_pred", "T P of step 0"]
    for variant, (lib, _info) in libs.items():
        if not hasattr(lib, "gcp_settle_probe_read"):
            continue
        # built with GCP_SETTLE_PROBE=1: clocks by phase of the first draw
        # of cluster 0, with the card's resident clusters busy and at
        # --batch
        lib.gcp_settle_probe_reset.restype = ctypes.c_int
        lib.gcp_settle_probe_read.argtypes = [ctypes.c_void_p]
        lib.gcp_settle_probe_read.restype = ctypes.c_int
        k5 = tier_calls(lib, n)["cluster"][1]
        resident = lib.gcp_settle_cluster_resident(0, 1, n, K, N_OBS)
        for bn in (resident, opts.batch):
            clocks = (ctypes.c_ulonglong * len(probe_labels))()
            assert lib.gcp_settle_probe_reset() == 0
            k5((big[0],) + tuple(a[:bn] for a in big[1:]))
            torch.cuda.synchronize()
            assert lib.gcp_settle_probe_read(clocks) == 0
            total = sum(clocks)
            parts = ", ".join(f"{lab} {c} ({c / total:.3f})"
                              for lab, c in zip(probe_labels, clocks))
            print(f"{variant} probe, K5 cluster at n = {n}, batch {bn}: "
                  f"{total} clocks a draw: {parts} [{card}]", flush=True)

    for (variant, tier), turns in times.items():
        lib, info = libs[variant]
        if tier == "small":
            plan = (f"{lib.gcp_settle_draws_per_block(0, n, K, N_OBS)} draws "
                    f"a block, {lib.gcp_settle_smem_bytes(0, n, K, N_OBS)} B "
                    f"smem (K5)")
        elif tier == "cluster":
            plan = (f"{lib.gcp_settle_cluster_ctas(0, n, K, N_OBS)} CTAs a "
                    f"cluster, "
                    f"{lib.gcp_settle_cluster_smem_bytes(0, n, K, N_OBS)} B "
                    f"smem a CTA, resident clusters K2 "
                    f"{lib.gcp_settle_cluster_resident(0, 0, n, K, N_SETTLE)}"
                    f", K5 {lib.gcp_settle_cluster_resident(0, 1, n, K, N_OBS)}")
        else:
            plan = (f"workspace "
                    f"{lib.gcp_settle_large_work_bytes(0, 1, n, K, N_OBS, opts.batch)}"
                    f" B (K5)")
        ms = "; ".join(f"K2 {a:.3f} K5 {b:.3f}" for a, b in turns)
        print(f"{variant} {tier}: {plan}; ms at n = {n}, batch {opts.batch}, "
              f"float32 I/O, two turns: {ms} [{card}]", flush=True)
        print(f"{variant} resources: {info}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
