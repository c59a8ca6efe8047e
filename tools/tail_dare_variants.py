#!/usr/bin/env python3
"""Time build variants of the filter-tail (K3) and DARE (K6) kernels on one
GPU.

Run from the root of a checkout:

    python3 tools/tail_dare_variants.py [--batch 4096] [--vg-batch 512]
        [--n 26 --k 7 | --own] [--tiers auto] VARIANT ...

A variant is ``base`` (the sources as they are), a comma-separated list of
settings of compile-time constants, for example ``TAIL_DRAWS=8`` or
``DARE_PROBE=1`` (each ``NAME`` is ``GCP_<NAME>`` in
``geconpy_torch/csrc/filter_tail.cu`` or ``dare.cu``), or ``src=DIR``:
the two sources of another checkout's ``DIR/geconpy_torch/csrc`` (say, an
unpacked parent commit), whose C entry points ``gcp_filter_tail`` and
``gcp_dare`` take the same arguments.  Every variant's two sources are
compiled on their own, all started together, into ``build/tail_dare_variants/``.

The inputs are synthetic, made from a seed: K3 at SW-2007's shapes (n = 26
states, k = 7 observables), a tail of 168 steps with M of spectral radius
0.9; K6 at (``--n``, ``--k``), SW-2007's shapes by default, with T of
spectral radius 0.9, R Q R' and H positive definite.  ``--own`` times K6
on the inputs of ``chip_smoke.py``'s phase 16b instead (SW-2007 with
year-on-year inflation, filter state 104, a measurement-error std of 0.002:
the first ``--vg-batch`` of its draws; this builds the whole kernel library
and the model).  ``--tiers`` names K6's kernels to run, comma-separated:
``small`` (``dare_kernel``, one draw a block), ``cluster``
(``dare_cluster_kernel``, one draw a thread-block cluster), ``workspace``
(``dare_large_kernel``, each draw's buffers in device memory) or ``auto``,
the tier the wrapper takes (``ops/batched_dare.py::dare_tier``).  Every
variant is first held against the plain PyTorch versions on 67 draws in
float64 (K3 rel 1e-12, K6 rel 1e-11 in every tier named), then the variants
are timed in turns, forwards and backwards, with CUDA events: K3 at
``--batch`` in float32 (the sweep's launch) and K6 at ``--vg-batch`` in
float64 (the value+grad path's).  The line of a variant gives its
registers and spills per kernel instance and both turns, with the card's
name and power limit.  A build with ``DARE_PROBE=1`` also prints, for each
K6 tier, the clocks of one draw by phase (``dare.cu``'s ``dare_probe``: the
inputs, the Lyapunov start, the Hewer steps' products, S and its
elimination, the inner doublings, symmetrise, the output; the cluster
tier's as thread 0 of CTA 0 sees them, with the clocks it waits at cluster
barriers), and for the device-memory tier the bytes a draw's products and
symmetrise read and write of its buffers (:func:`dare_traffic`) over the
kernel's time.
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
DARE_FNS = ("gcp_dare", "gcp_dare_large", "gcp_dare_large_work_bytes",
            "gcp_dare_fits", "gcp_dare_smem_bytes")
DARE_CLUSTER_FNS = ("gcp_dare_cluster", "gcp_dare_cluster_fits",
                    "gcp_dare_cluster_ctas", "gcp_dare_cluster_smem_bytes",
                    "gcp_dare_cluster_resident")
PROBE_PHASES = ("inputs", "Lyapunov start", "Hewer products",
                "S and its elimination", "inner doublings", "symmetrise",
                "output", "of which waiting at cluster barriers")


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


def own_dare_inputs(batch: int):
    """K6's float64 inputs (T, R Q R', Z, H) on the card in phase 16b of
    ``chip_smoke.py``: SW-2007 with year-on-year inflation and a fixed
    measurement-error std on each observable, its first ``batch`` draws."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import geconpy_torch
    from geconpy_torch.stats.statespace import DSGEStateSpace

    dev = torch.device("cuda", 0)
    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("sw2007"), verbose=False)
    kw = dict(observed_states=cs.SW_YOY_OBS,
              observation_equations=cs.SW_YOY_EQS,
              constant_params=[p for p in model.param_names
                               if p not in cs.SW_ESTIMATED],
              kalman_settle=cs.N_SETTLE)
    ss = DSGEStateSpace(model, device="cuda").configure(
        filter_type="steady_state", **kw)
    data, draw = ss.data_from_prior(
        torch.Generator(device="cuda").manual_seed(0), periods=cs.PERIODS)
    u0 = ss.unconstrain(draw).to(torch.float32)
    U = u0[None, :] + 0.05 * torch.randn(
        (cs.BATCH, u0.shape[0]), device=dev, dtype=torch.float32,
        generator=torch.Generator(device="cuda").manual_seed(1))
    me = {o: cs.LARGE_ME_STD for o in cs.SW_YOY_OBS}
    ss_vg = DSGEStateSpace(model, device="cuda").configure(
        filter_type="stationary", measurement_error=me, **kw)
    rec: dict = {}
    ss_vg.build_batched_logpost(data, settle="pallas")(U[:batch].double(),
                                                       record=rec)
    return rec["dare_settle"]


def dare_traffic(n: int, k: int) -> dict:
    """Bytes one draw's schedule reads and writes of its own float64
    buffers (``dare_draw``: products by ``tile_mm``, and symmetrise), by
    phase, with the reference's 12 + 8 x 16 doublings.  A product reads a
    panel of A (32 rows in the doublings, 16 in the Hewer step) and a
    16-column panel of B for each item of its result, which it writes (an
    epilogue matrix read beside it); symmetrise reads and writes both
    entries of each pair.  R Q R' comes from the caller's arrays and is
    not counted."""
    from geconpy_torch.ops.batched_dare import (HEWER_ITERS, INNER_ITERS,
                                                LYAP_ITERS)

    def c8(v):
        return (v + 7) // 8 * 8

    def product(r, c, m, item_rows, epilogue=False):
        items = -(-r // item_rows) * -(-c8(m) // 16)
        out = item_rows * 16 * (2 if epilogue else 1)
        return 8 * items * ((item_rows + 16) * c8(c) + out)

    # A P, A A, then P += (A P) A'
    doubling = 2 * product(n, n, n, 32) + product(n, n, n, 32, True)
    hewer = (product(n, n, k, 16) + product(k, n, k, 16, True)
             + product(n, k, k, 16) + product(n, n, k, 16)
             + product(n, k, n, 16, True) + product(n, k, k, 16)
             + product(n, k, n, 16))
    sym = 8 * 4 * (n * (n + 1) // 2)
    return {"Lyapunov start": LYAP_ITERS * doubling,
            "Hewer products": HEWER_ITERS * hewer,
            "inner doublings": HEWER_ITERS * INNER_ITERS * doubling,
            "symmetrise": 2 * HEWER_ITERS * sym}


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("variants", nargs="+")
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--vg-batch", type=int, default=512)
    parser.add_argument("--n", type=int, default=N)
    parser.add_argument("--k", type=int, default=K)
    parser.add_argument("--own", action="store_true")
    parser.add_argument("--tiers", default="auto")
    parser.add_argument("--reps", type=int, default=10)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("tail_dare_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from geconpy_torch.ops import _cuda
    from geconpy_torch.ops.batched_dare import (_dare_plain, _launch,
                                                dare_tier)
    from geconpy_torch.ops.batched_filter import _filter_tail_plain

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
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
        names = ("gcp_filter_tail",) if src == "filter_tail.cu" else (
            DARE_FNS + (DARE_CLUSTER_FNS if hasattr(lib, DARE_CLUSTER_FNS[0])
                        else ()))
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = _cuda._SIGNATURES[name]
        libs.setdefault(variant, {})[src] = lib
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

    def k3(lib, args):
        y, M = args[:2]
        bn, n, k = M.shape[0], M.shape[-1], y.shape[-1]
        ll = torch.empty((bn,), dtype=M.dtype, device=dev)
        rc = lib.gcp_filter_tail(_cuda.dtype_code(M.dtype),
                                 *(X.data_ptr() for X in args), ll.data_ptr(),
                                 bn, n, k, y.shape[0], stream)
        assert rc == 0, rc
        return ll

    def resolved(lib, tier, n, k):
        return dare_tier(lib, n, k) if tier == "auto" else tier

    def k6(lib, args, tier):
        n, k = args[0].shape[-1], args[2].shape[-2]
        return _launch(lib, resolved(lib, tier, n, k), *args)

    def on_card(arrays, dtype):
        return tuple(torch.as_tensor(X, device=dev, dtype=dtype).contiguous()
                     for X in arrays)

    def rel(a, b):
        assert torch.equal(torch.isfinite(a), torch.isfinite(b))
        return float(((a - b).abs() / (1 + b.abs())).max())

    if opts.own:
        dare_big = tuple(X.contiguous() for X in own_dare_inputs(opts.vg_batch))
        n6, k6_ = dare_big[0].shape[-1], dare_big[2].shape[-2]
        label = f"16b's own inputs (n = {n6}, k = {k6_})"
    else:
        n6, k6_ = opts.n, opts.k
        dare_big = on_card(dare_inputs(n6, k6_, opts.vg_batch, 2),
                           torch.float64)
        label = f"synthetic n = {n6}, k = {k6_}"
    tiers = opts.tiers.split(",")
    tail_small = on_card(tail_inputs(N, K, 67, STEPS, 0), torch.float64)
    dare_small = on_card(dare_inputs(n6, k6_, 67, 0), torch.float64)
    ll0 = _filter_tail_plain(*tail_small)
    P0 = _dare_plain(*dare_small)
    failed = []
    for variant, fns in libs.items():
        e3 = rel(k3(fns["filter_tail.cu"], tail_small), ll0)
        e6 = {t: rel(k6(fns["dare.cu"], dare_small, t), P0) for t in tiers}
        torch.cuda.synchronize()
        print(f"{variant}: float64 vs plain on 67 draws: K3 rel {e3:.2e}, K6 "
              f"(n = {n6}, k = {k6_}) rel {e6}", flush=True)
        if not (e3 < 1e-12 and all(e < 1e-11 for e in e6.values())):
            failed.append(variant)
    for variant in failed:
        del libs[variant]

    tail_big = on_card(tail_inputs(N, K, opts.batch, STEPS, 1), torch.float32)

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
             {t: timed(lambda t=t: k6(fns["dare.cu"], dare_big, t))
              for t in tiers}))
    for variant, fns in libs.items():
        lib = fns["dare.cu"]
        if not hasattr(lib, "gcp_dare_probe_read"):
            continue
        lib.gcp_dare_probe_reset.argtypes = []
        lib.gcp_dare_probe_reset.restype = ctypes.c_int
        lib.gcp_dare_probe_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
        lib.gcp_dare_probe_read.restype = ctypes.c_int
        clocks = (ctypes.c_ulonglong * len(PROBE_PHASES))()
        for tier in tiers:
            assert lib.gcp_dare_probe_reset() == 0
            k6(lib, dare_big, tier)
            torch.cuda.synchronize()
            assert lib.gcp_dare_probe_read(clocks) == 0
            total = sum(clocks[:7])
            parts = ", ".join(f"{name} {clocks[i]}"
                              for i, name in enumerate(PROBE_PHASES))
            t_ms = times[variant][0][1][tier]
            line = (f"{variant} {resolved(lib, tier, n6, k6_)}: K6 clocks of "
                    f"draw 0 on {label}: {parts}; total {total} "
                    f"({total / sm_mhz * 1e-3:.3f} ms at the {sm_mhz:.0f} MHz "
                    f"maximum SM clock)")
            if resolved(lib, tier, n6, k6_) == "workspace":
                traffic = dare_traffic(n6, k6_)
                per_draw = sum(traffic.values())
                bn = dare_big[0].shape[0]
                line += (f"; draw buffer traffic {traffic} B a draw "
                         f"({per_draw} B), "
                         f"{per_draw * bn / (t_ms * 1e-3) / 1e12:.2f} TB/s "
                         f"over the kernel ({bn} draws in {t_ms:.3f} ms), "
                         f"draw 0 alone "
                         f"{per_draw / (total / (sm_mhz * 1e6)) / 1e9:.1f} "
                         f"GB/s")
            print(line, flush=True)
    for variant, fns in libs.items():
        lib = fns["dare.cu"]
        plan = {"small smem": lib.gcp_dare_smem_bytes(n6, k6_),
                "workspace at this batch": lib.gcp_dare_large_work_bytes(
                    1, n6, k6_, dare_big[0].shape[0])}
        if hasattr(lib, "gcp_dare_cluster_ctas"):
            plan.update(cluster_ctas=lib.gcp_dare_cluster_ctas(n6, k6_),
                        cluster_smem=lib.gcp_dare_cluster_smem_bytes(n6, k6_),
                        resident_clusters=lib.gcp_dare_cluster_resident(
                            1, n6, k6_))
        turns = "; ".join(
            f"K3 {a:.4f} K6 " + ", ".join(f"{t} {ms:.4f}" for t, ms in b.items())
            for a, b in times[variant])
        print(f"{variant}: {'; '.join(info[variant])}; K6 plan {plan}; ms "
              f"(K3 batch {opts.batch} f32, K6 batch {dare_big[0].shape[0]} "
              f"f64 on {label}), two turns: {turns} [{card}]", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
