#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``geconpy_torch``) on one GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases, one line each (plus one line per kernel in phase 3):

1. the card (``nvidia-smi`` name and power limit) and the torch, CUDA,
   sympy and nvcc versions;
2. the build of the CUDA kernels from ``geconpy_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, on SW-2007's
   own intermediates at batch 4096: float64 (max rel diff <= 1e-9, equal
   success flags) and float32 (rel <= 5e-4 on the likelihood pieces,
   success flags equal on >= 99% of draws), with both times;
4. the slice: the SW-2007 batched likelihood sweep (22 estimated
   parameters, 7 observables, steady-state filter, 32 settle steps, 200
   periods, batch 4096, float32) through ``build_batched_loglik``; every
   kernel's launch count over that run must be > 0, >= 99% of draws finite,
   the first 512 within rel 5e-4 of the port's plain float64 path on the
   CPU; then evals/s over 20 repetitions and the peak device memory.

Any failure raises (nonzero exit).  Without a GPU, or without the rest of
the repository beside it, the script fails and prints no result.  The last
line is ``{"ok": true, "device": {...}}``; the line before the ``nvidia-smi``
line is one JSON object with each kernel's launches, error and times.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SW_OBS = ["y", "c", "inve", "w", "pinf", "r", "lab"]
SW_ESTIMATED = [
    "crhoa", "crhob", "crhog", "crhoqs", "crhoms", "crhopinf", "crhow",
    "cmap", "cmaw", "cgy", "sigma_ea", "sigma_eb", "sigma_eg", "sigma_eqs",
    "sigma_em", "sigma_epinf", "sigma_ew", "crpi", "crr", "cry", "chabb",
    "csigma"]
BATCH, PERIODS, N_SETTLE, N_REPS, N_CHECK = 4096, 200, 32, 20, 512

KERNELS = {
    "cycle_reduction_policy": (
        "geconpy_torch/csrc/cycle_reduction.cu",
        "geconpy_tpu/ops/pallas_cycle_reduction.py:176"),
    "settle_parts": (
        "geconpy_torch/csrc/settle.cu",
        "geconpy_tpu/ops/pallas_settle.py:40"),
    "filter_tail": (
        "geconpy_torch/csrc/filter_tail.cu",
        "geconpy_tpu/ops/pallas_filter.py:34"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def compare(a, b) -> tuple[float, float]:
    """(max |a - b| / (1 + |b|) over entries finite in both, share of
    entries whose finiteness agrees)."""
    import torch

    fa, fb = torch.isfinite(a), torch.isfinite(b)
    agree = int((fa == fb).sum()) / fa.numel() if fa.numel() else 1.0
    both = fa & fb
    if not bool(both.any()):
        return 0.0, agree
    d = (a - b).abs() / (1.0 + b.abs())
    return float(d[both].max()), agree


def cuda_time_ms(fn, reps: int) -> float:
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import sympy

    import geconpy_torch
    from geconpy_torch.ops import _cuda
    from geconpy_torch.ops.batched_cycle_reduction import (
        _cr_policy_plain, cr_policy_raw, cycle_reduction_policy)
    from geconpy_torch.ops.batched_filter import _filter_tail_plain, filter_tail
    from geconpy_torch.ops.batched_settle import (LYAP_ITERS, _settle_plain,
                                                  settle_parts)
    from geconpy_torch.ops.tolerances import success_tol
    from geconpy_torch.stats.statespace import CR_ITERS, DSGEStateSpace

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # ---- phase 1: the card and the software
    nvcc = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"phase 1 card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} sympy {sympy.__version__} nvcc {nvcc}",
          flush=True)

    # ---- phase 2: build the kernels from the checkout's sources
    t0 = time.perf_counter()
    cached = (_cuda._build_dir() / _cuda._LIB_NAME).exists()
    _cuda.library()
    print(f"phase 2 build: {time.perf_counter() - t0:.1f} s "
          f"({'cached' if cached else 'nvcc'}; {_cuda._build_dir()})",
          flush=True)

    # ---- the SW-2007 configuration of the sweep
    model = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn("sw2007"))
    constant = [p for p in model.param_names if p not in SW_ESTIMATED]
    ss = DSGEStateSpace(model).configure(
        observed_states=SW_OBS, constant_params=constant,
        filter_type="steady_state", kalman_settle=N_SETTLE)
    data, draw = ss.data_from_prior(
        torch.Generator(device="cuda").manual_seed(0), periods=PERIODS)
    u0 = ss.unconstrain(draw).to(dev, torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = u0[None, :] + 0.05 * torch.randn(
        (BATCH, u0.shape[0]), generator=gen, device=dev, dtype=torch.float32)
    data32 = data.astype("float32")
    sweep = ss.build_batched_loglik(data32, n_settle=N_SETTLE)

    # ---- phase 3: each kernel against its plain version, same inputs
    report = {}
    plain = {
        "cycle_reduction_policy": lambda *a: _cr_policy_plain(*a, CR_ITERS),
        "settle_parts": lambda *a: _settle_plain(*a, LYAP_ITERS),
        "filter_tail": _filter_tail_plain,
    }
    kernel = {
        "cycle_reduction_policy": lambda *a: cr_policy_raw(*a, CR_ITERS),
        "settle_parts": settle_parts,
        "filter_tail": filter_tail,
    }

    def cr_success(flags, dtype):
        tol = 200 * float(torch.finfo(dtype).eps)
        return (torch.isfinite(flags[:, 1]) & (flags[:, 1] < tol)
                & (flags[:, 0] > 1e-7) & torch.isfinite(flags[:, 2])
                & (flags[:, 2] < success_tol(dtype, 1e-6)))

    outputs = {"cycle_reduction_policy": ("T", "R", "flags"),
               "settle_parts": ("ll_head", "x_pred0", "M", "TK", "Finv",
                                "const"),
               "filter_tail": ("ll_tail",)}
    failures = []
    for dtype in (torch.float64, torch.float32):
        f64 = dtype == torch.float64
        tag = "f64" if f64 else "f32"
        rec: dict = {}
        sweep(batch.to(dtype), record=rec)
        torch.cuda.synchronize()
        for name in KERNELS:
            args = rec[name]
            got = kernel[name](*args)
            ref = plain[name](*args)
            torch.cuda.synchronize()
            got = dict(zip(outputs[name], got if isinstance(got, tuple) else (got,)))
            ref = dict(zip(outputs[name], ref if isinstance(ref, tuple) else (ref,)))
            if name == "cycle_reduction_policy":
                ok_k = cr_success(got["flags"], dtype)
                ok_p = cr_success(ref["flags"], dtype)
                agree = int((ok_k == ok_p).sum()) / ok_k.numel()
                detail = f"success flags agree on {agree:.4f} of draws"
                both = ok_k & ok_p
                for d in (got, ref):
                    flags = d.pop("flags")
                    d.update(minpiv=flags[:, 0], tail=flags[:, 1],
                             resid=flags[:, 2])
                    for key in d:
                        d[key] = d[key][both]
            else:
                # the draws the sweep accepts (the rest become -inf)
                acc = rec["accepted"]
                for d in (got, ref):
                    for key in d:
                        d[key] = d[key][acc]
                agree = min(compare(got[k_], ref[k_])[1] for k_ in got)
                differ = {k_: int((torch.isfinite(got[k_])
                                   != torch.isfinite(ref[k_])).sum())
                          for k_ in got}
                detail = (f"{int(acc.sum())} accepted draws, entries finite in "
                          f"one only: {sum(differ.values())} {differ}")
            errs = {k_: compare(got[k_], ref[k_])[0] for k_ in got}
            abs_err = max(float((got[k_] - ref[k_])[
                torch.isfinite(got[k_]) & torch.isfinite(ref[k_])].abs().max())
                for k_ in got)
            # float64: every output but min|pivot| (near-tied pivots may
            # take another row at rounding level; T and R are checked);
            # float32: the success flags (K1) and the likelihood (K2, K3)
            if f64:
                checked = {k_: v for k_, v in errs.items() if k_ != "minpiv"}
            else:
                checked = {k_: v for k_, v in errs.items() if k_.startswith("ll")}
            bound = 1e-9 if f64 else 5e-4
            if agree < (1.0 if f64 else 0.99):
                failures.append(f"{name} {tag}: {detail}")
            if checked and max(checked.values()) > bound:
                failures.append(f"{name} {tag}: rel diff {checked} > {bound}")
            entry = report.setdefault(name, {})
            entry[f"abs_{tag}"] = abs_err
            ms = cuda_time_ms(lambda: kernel[name](*args), 10)
            plain_ms = cuda_time_ms(lambda: plain[name](*args), 3)
            if not f64:   # the sweep's working dtype goes into the JSON line
                entry["ms"], entry["plain_ms"] = ms, plain_ms
            rels = ", ".join(f"{k_} {v:.2e}" for k_, v in errs.items())
            print(f"phase 3 {name} {tag}: max rel [{rels}], max abs "
                  f"{abs_err:.3e}, {detail}; kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms at batch {BATCH} [{card}]", flush=True)
    if failures:
        raise AssertionError("kernel vs plain: " + "; ".join(failures))

    # ---- phase 4: the slice, through the user's entry point
    for fn in (cycle_reduction_policy, settle_parts, filter_tail):
        fn.launches = 0
    out = sweep(batch)
    torch.cuda.synchronize()
    launches = {"cycle_reduction_policy": cycle_reduction_policy.launches,
                "settle_parts": settle_parts.launches,
                "filter_tail": filter_tail.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path did not launch: {launches}")
    if out.shape != (BATCH,) or out.dtype != torch.float32:
        raise AssertionError(f"sweep output {tuple(out.shape)} {out.dtype}")
    frac = float(torch.isfinite(out).float().mean())
    if frac < 0.99:
        raise AssertionError(f"only {frac:.4f} of draws finite")
    ref = sweep(batch[:N_CHECK].double().cpu())
    got = out[:N_CHECK].double().cpu()
    both = torch.isfinite(ref) & torch.isfinite(got)
    if float(both.double().mean()) < 0.99:
        raise AssertionError(f"finiteness mismatch ({float(both.double().mean()):.3f})")
    rel = float(((got - ref).abs() / (1.0 + ref.abs()))[both].max())
    if rel >= 5e-4:
        raise AssertionError(f"float32 sweep off the float64 path by rel {rel:.3e}")
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(N_REPS):
        out = sweep(batch)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(dev)
    evals = N_REPS * BATCH / elapsed
    print(f"phase 4 sweep: launches {launches}; finite {frac:.4f}; rel vs "
          f"float64 plain path {rel:.3e} on {int(both.sum())}/{N_CHECK}; "
          f"{evals:.1f} evals/s ({N_REPS} reps of batch {BATCH}, "
          f"{elapsed:.3f} s); peak device memory {peak} B [{card}]",
          flush=True)

    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": tpu,
                "launches": launches[name],
                "max_abs_err": report[name]["abs_f64"],
                "ms": report[name]["ms"], "plain_ms": report[name]["plain_ms"]}
               for name, (src, tpu) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
