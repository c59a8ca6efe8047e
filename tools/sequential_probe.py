#!/usr/bin/env python3
"""Phase 8 of ``chip_smoke.py`` (the sequential filter and the XLA policy)
alone: the quick loop for work on the single-draw log posterior.

Run from the root of a checkout on a GPU:

    python3 tools/sequential_probe.py

It builds the CUDA kernels, makes phase 4's and phase 5's SW-2007 data and
draws as ``chip_smoke.py`` does, and runs ``chip_smoke.sequential_phase``,
printing its lines (8a-8d).
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
        print("sequential_probe: no CUDA device", file=sys.stderr)
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

    dev = torch.device("cuda", 0)
    model = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn("sw2007"))
    constant = [p for p in model.param_names
                if p not in chip_smoke.SW_ESTIMATED]
    kw = dict(observed_states=chip_smoke.SW_OBS, constant_params=constant,
              kalman_settle=chip_smoke.N_SETTLE)
    ss = DSGEStateSpace(model, device="cuda").configure(
        **kw, filter_type="steady_state")
    data, draw = ss.data_from_prior(
        torch.Generator(device="cuda").manual_seed(0),
        periods=chip_smoke.PERIODS)
    u0 = ss.unconstrain(draw).to(torch.float32)
    batch = u0[None, :] + 0.05 * torch.randn(
        (chip_smoke.XLA_BATCH, u0.shape[0]), device=dev, dtype=torch.float32,
        generator=torch.Generator(device="cuda").manual_seed(1))
    data32 = data.astype("float32")
    sweep = ss.build_batched_loglik(data32, n_settle=chip_smoke.N_SETTLE,
                                    policy="pallas", settle="pallas")
    ss_vg = DSGEStateSpace(model, device="cuda").configure(
        **kw, filter_type="stationary")
    vg_data, vg_draw = ss_vg.data_from_prior(
        torch.Generator(device="cuda").manual_seed(0),
        periods=chip_smoke.PERIODS)
    vg_u0 = ss_vg.unconstrain(vg_draw).to(torch.float32)
    vg_batch = vg_u0[None, :] + 0.05 * torch.randn(
        (chip_smoke.VG_BATCH, vg_u0.shape[0]), device=dev,
        dtype=torch.float32,
        generator=torch.Generator(device="cuda").manual_seed(1))
    chip_smoke.sequential_phase(chip_smoke.card_line(), reset_counts,
                                read_counts, model, constant, vg_data,
                                vg_batch, data32, batch, sweep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
