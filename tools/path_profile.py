#!/usr/bin/env python3
"""Device time of one SW-2007 sweep and one value+grad call, on one GPU.

Run from anywhere:

    python3 tools/path_profile.py [--root DIR] [--reps 3]

imports ``geconpy_torch`` from the checkout at ``--root`` (default: this
one; an unpacked parent commit compares two versions in one call) and
builds its kernels there.  It then runs the configurations of
``chip_smoke.py`` phases 4 and 5: the forward sweep with
``settle="pallas"`` (K1, K2, K3) at batch 4096 in float32, and the
value+grad call with ``settle="pallas"`` (K4, K6) at batch 512.  After one
warm-up call, each is profiled ``--reps`` times, one call per
``torch.profiler`` run.  For each run it prints the host wall time, the
device's kernel time and its share of the wall time, the launch count,
and the device time of the path's hand-written kernels.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

SW_OBS = ["y", "c", "inve", "w", "pinf", "r", "lab"]
SW_ESTIMATED = [
    "crhoa", "crhob", "crhog", "crhoqs", "crhoms", "crhopinf", "crhow",
    "cmap", "cmaw", "cgy", "sigma_ea", "sigma_eb", "sigma_eg", "sigma_eqs",
    "sigma_em", "sigma_epinf", "sigma_ew", "crpi", "crr", "cry", "chabb",
    "csigma"]
BATCH, VG_BATCH, PERIODS, N_SETTLE = 4096, 512, 200, 32
KERNELS = ("cr_kernel", "settle_kernel", "filter_tail_kernel", "dare_kernel")


def profile(fn, torch) -> tuple[float, float, int, dict]:
    """(wall ms, device kernel ms, kernel launches, device ms by kernel
    family) of one call of ``fn``."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_us, launches, by_kernel = 0.0, 0, {}
    for ev in prof.key_averages():
        t_us = getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0))
        if t_us > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            dev_us += t_us
            launches += ev.count
            for name in KERNELS:
                if name in ev.key:
                    by_kernel[name] = by_kernel.get(name, 0.0) + t_us / 1e3
    return wall, dev_us / 1e3, launches, by_kernel


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(pathlib.Path(__file__)
                                              .resolve().parents[1]))
    parser.add_argument("--reps", type=int, default=3)
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("path_profile: no CUDA device", file=sys.stderr)
        return 2
    root = pathlib.Path(opts.root).resolve()
    sys.path.insert(0, str(root))
    import geconpy_torch
    from geconpy_torch.stats.statespace import DSGEStateSpace

    assert pathlib.Path(geconpy_torch.__file__).resolve().is_relative_to(root)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    model = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn("sw2007"))
    constant = [p for p in model.param_names if p not in SW_ESTIMATED]
    runs = {}
    for label, filter_type, batch in (("sweep", "steady_state", BATCH),
                                      ("value+grad", "stationary", VG_BATCH)):
        ss = DSGEStateSpace(model, device="cuda").configure(
            observed_states=SW_OBS, constant_params=constant,
            filter_type=filter_type, kalman_settle=N_SETTLE)
        data, draw = ss.data_from_prior(
            torch.Generator(device="cuda").manual_seed(0), periods=PERIODS)
        u0 = ss.unconstrain(draw).to(torch.float32)
        U = u0[None, :] + 0.05 * torch.randn(
            (batch, u0.shape[0]), device=dev, dtype=torch.float32,
            generator=torch.Generator(device="cuda").manual_seed(1))
        if label == "sweep":
            fn = ss.build_batched_loglik(data.astype("float32"),
                                         n_settle=N_SETTLE, policy="pallas",
                                         settle="pallas")
        else:
            fn = ss.build_batched_logpost_and_grad(data, settle="pallas")
        runs[label] = (fn, U)
    for label, (fn, U) in runs.items():
        fn(U)
        torch.cuda.synchronize()
        for rep in range(opts.reps):
            wall, dev_ms, launches, by_kernel = profile(lambda: fn(U), torch)
            kernels = ", ".join(f"{k} {v:.3f}" for k, v in by_kernel.items())
            print(f"path_profile {label} settle=pallas run {rep} ({root}): "
                  f"wall {wall:.3f} ms, device kernel time {dev_ms:.3f} ms, "
                  f"busy share {dev_ms / wall:.3f}, {launches} kernel "
                  f"launches; hand-written kernels (ms): {kernels} [{card}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
