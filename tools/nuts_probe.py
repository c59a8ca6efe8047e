#!/usr/bin/env python3
"""Phase 7 of ``chip_smoke.py`` (NUTS on SW-2007 at full width) alone, at
chosen sizes: the quick loop for sizing that phase and for work on the
sampler's host loop.

Run from the root of a checkout on a GPU:

    python3 tools/nuts_probe.py NUM_WARMUP NUM_SAMPLES ADAM_STEPS

It builds the CUDA kernels, configures SW-2007 as ``chip_smoke.py`` does
(stationary filter, 22 estimated parameters, 7 observables) and runs
``chip_smoke.nuts_phase`` with the given numbers of warmup and sampling
transitions and Adam steps of the mode search, printing its lines (times,
value+grad calls per transition, ms per call, the chains' diagnostics and
the checks of one leapfrog call).
"""

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("nuts_probe: no CUDA device", file=sys.stderr)
        return 2
    warmup, samples, adam = (int(x) for x in argv[1:4])
    import geconpy_torch
    from geconpy_torch.ops import _cuda
    from geconpy_torch.ops.batched_cycle_reduction import cycle_reduction
    from geconpy_torch.ops.batched_dare import dare_settle
    from geconpy_torch.stats.statespace import DSGEStateSpace

    t0 = time.perf_counter()
    _cuda.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    counted = {"cycle_reduction": cycle_reduction, "dare_settle": dare_settle}

    def reset_counts():
        for fn in counted.values():
            fn.launches = 0

    def read_counts():
        return {k: fn.launches for k, fn in counted.items()}

    model = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn("sw2007"))
    kw = dict(observed_states=chip_smoke.SW_OBS, filter_type="stationary",
              kalman_settle=chip_smoke.N_SETTLE,
              constant_params=[p for p in model.param_names
                               if p not in chip_smoke.SW_ESTIMATED])
    ss = DSGEStateSpace(model, device="cuda").configure(**kw)
    ss_cpu = DSGEStateSpace(model, device="cpu").configure(**kw)
    chip_smoke.nuts_phase(ss, ss_cpu, chip_smoke.card_line(), reset_counts,
                          read_counts, warmup, samples, adam)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
