#!/usr/bin/env python3
"""Phase 11 of ``chip_smoke.py`` (every filter of the likelihood, the
smoothers and the posterior tools) alone.

Run from the root of a checkout on a GPU:

    python3 tools/filters_probe.py

It builds the CUDA kernels, makes phase 5's SW-2007 data, generating draw
and float32 draws (stationary filter, batch 512) and runs
``chip_smoke.filters_phase``, printing its lines (11a-11d).
"""

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("filters_probe: no CUDA device", file=sys.stderr)
        return 2
    import geconpy_torch
    from geconpy_torch.ops import _cuda
    from geconpy_torch.ops.batched_cycle_reduction import (
        cycle_reduction, cycle_reduction_policy)
    from geconpy_torch.ops.batched_dare import dare_settle
    from geconpy_torch.ops.batched_filter import filter_tail
    from geconpy_torch.ops.batched_settle import (settle_filter_loglik,
                                                  settle_parts)
    from geconpy_torch.stats.statespace import DSGEStateSpace

    t0 = time.perf_counter()
    _cuda.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    counted = {"cycle_reduction_policy": cycle_reduction_policy,
               "settle_parts": settle_parts, "filter_tail": filter_tail,
               "cycle_reduction": cycle_reduction, "dare_settle": dare_settle,
               "settle_filter_loglik": settle_filter_loglik}

    def reset_counts():
        for fn in counted.values():
            fn.launches = 0

    def read_counts():
        return {k: fn.launches for k, fn in counted.items()}

    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("sw2007"), verbose=False)
    constant = [p for p in model.param_names
                if p not in chip_smoke.SW_ESTIMATED]
    ss = DSGEStateSpace(model, device="cuda").configure(
        observed_states=chip_smoke.SW_OBS, constant_params=constant,
        filter_type="stationary", kalman_settle=chip_smoke.N_SETTLE)
    data, draw = ss.data_from_prior(
        torch.Generator(device="cuda").manual_seed(0),
        periods=chip_smoke.PERIODS)
    u0 = ss.unconstrain(draw).to(torch.float32)
    batch = u0[None, :] + 0.05 * torch.randn(
        (chip_smoke.VG_BATCH, u0.shape[0]),
        generator=torch.Generator(device="cuda").manual_seed(1),
        device="cuda", dtype=torch.float32)
    chip_smoke.filters_phase(chip_smoke.card_line(), reset_counts,
                             read_counts, model, constant, data, draw, batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
