#!/usr/bin/env python3
"""Where a draw's time goes inside the fused settle + tail kernel (K5).

Run from the root of a checkout, on a machine with one GPU:

    python3 tools/settle_phase_probe.py [--batch 132 4096]

It writes an instrumented copy of ``geconpy_torch/csrc/settle.cu`` (the
small-state tier, with ``settle.cuh`` written in) into
``build/settle_phase_probe/``: after every barrier of a draw, thread 0 of
the first draw of block 0 reads ``clock64()`` and adds the clocks since its
last reading to that phase's counter (in registers; written to device memory
at the end).  The copy is built alone and run at SW-2007's shapes (n = 26,
k = 7, 32 settle steps of 200 periods, float32 I/O, synthetic stable systems
from a seed), once per batch size: 132 is one draw per SM of an H100, a
draw alone with its chain of dependent steps; 4096 is the sweep's batch.
One line per batch gives each phase's clocks summed over the draw's life,
with the card's name and power limit.  The instrumentation follows the
source by its text; it refuses to run when the barriers it expects are not
there.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

# one label per counter, and the counter of each draw barrier in the order
# the barriers appear in the source
LABELS = ["inputs", "Lyapunov: A P", "Lyapunov: P += (A P) A'",
          "Lyapunov: A A", "T P and x_pred", "P_pred = (T P) T' + RQR",
          "P_pred Z' and v", "F, its elimination, ll (one warp)",
          "K = PZt Finv", "I - K Z, K H, x", "(I - K Z) P_pred",
          "Joseph sum", "frozen-gain quantities", "tail"]
SLOT_OF_BARRIER = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
                   12, 12, 12, 12, 12, 13, 13]
PROBE = ("if (probe_on) { const long long c_ = clock64(); "
         "pacc[%d] += c_ - plast; plast = c_; }")


def instrumented_source() -> str:
    csrc = ROOT / "geconpy_torch" / "csrc"
    src = (csrc / "settle.cu").read_text().replace(
        '#include "settle.cuh"', (csrc / "settle.cuh").read_text(), 1)
    count = len(re.findall(r"draw_barrier\(draw\);", src))
    if count != len(SLOT_OF_BARRIER):
        raise SystemExit(f"settle_phase_probe: expected "
                         f"{len(SLOT_OF_BARRIER)} draw barriers in settle.cuh "
                         f"and settle.cu, "
                         f"found {count}: bring SLOT_OF_BARRIER up to date")
    order = iter(SLOT_OF_BARRIER)
    src = re.sub(r"draw_barrier\(draw\);",
                 lambda m: m.group(0) + " " + PROBE % next(order), src)
    n = len(LABELS)
    src = src.replace(
        "  extern __shared__ __align__(16) unsigned char smem_raw[];",
        "  extern __shared__ __align__(16) unsigned char smem_raw[];\n"
        "  const bool probe_on = threadIdx.x == 0 && blockIdx.x == 0;\n"
        f"  long long pacc[{n}] = {{}};\n  long long plast = clock64();", 1)
    end = "      if (lane == 0) gll[b] = S(ll);"
    if src.count(end) != 1:
        raise SystemExit("settle_phase_probe: the end of the fused tail has "
                         "moved in settle.cuh")
    src = src.replace(end, "      " + PROBE % (n - 1) + "\n" + end + "\n"
                      f"      if (probe_on) for (int q = 0; q < {n}; ++q) "
                      "g_probe[q] = pacc[q];")
    src = src.replace("namespace gcp {\n", "namespace gcp {\n"
                      f"__device__ long long g_probe[{n}];\n", 1)
    return src + (
        '\nextern "C" int gcp_probe_read(long long* out) {\n'
        "  return (int)cudaMemcpyFromSymbol(out, gcp::g_probe, "
        f"sizeof(long long) * {n});\n}}\n")


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, nargs="+", default=[132, 4096])
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("settle_phase_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from settle_variants import K, N, N_OBS, N_SETTLE, stable_system

    from geconpy_torch.ops import _cuda
    from geconpy_torch.ops.batched_settle import LYAP_ITERS

    out_dir = ROOT / "build" / "settle_phase_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "settle_probe.cu").write_text(instrumented_source())
    lib_path = out_dir / "probe.so"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC),
                    "-o", str(lib_path), str(out_dir / "settle_probe.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.gcp_settle_filter.argtypes, lib.gcp_settle_filter.restype = \
        _cuda._SIGNATURES["gcp_settle_filter"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    for batch in opts.batch:
        y, T, RQR, Z, H, d = stable_system(N, K, batch, N_OBS, 1, dev,
                                           torch.float32)
        ll = torch.empty(batch, device=dev)
        for _ in range(2):   # the second launch is the one that is read
            code = lib.gcp_settle_filter(
                0, *(a.data_ptr() for a in (T, RQR, Z, H, d, y)),
                ll.data_ptr(), batch, N, K, N_SETTLE, N_OBS, LYAP_ITERS,
                torch.cuda.current_stream(dev).cuda_stream)
            assert code == 0, code
            torch.cuda.synchronize()
        clocks = (ctypes.c_longlong * len(LABELS))()
        lib.gcp_probe_read(clocks)
        total = sum(clocks)
        parts = "; ".join(f"{name} {c} ({c / total:.1%})"
                          for name, c in zip(LABELS, clocks))
        print(f"K5 at batch {batch}, clocks of draw 0 over {LYAP_ITERS} "
              f"doublings, {N_SETTLE} Riccati steps and {N_OBS - N_SETTLE} "
              f"tail steps: {parts}; total {total} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
