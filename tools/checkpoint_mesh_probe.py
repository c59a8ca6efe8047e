#!/usr/bin/env python3
"""Phase 15 of ``chip_smoke.py`` (checkpointed NUTS, the mesh, the
profiler and memory tables, the compile cache) alone.

Run from the root of a checkout on a GPU:

    python3 tools/checkpoint_mesh_probe.py

It makes phase 4's SW-2007 sweep configuration (steady-state filter, 22
estimated parameters, 7 observables, 200 periods of ``data_from_prior``,
CUDA generator, seed 0; batch 4096 of float32 draws), builds the kernels,
reads the ``policy="pallas", settle="pallas"`` sweep's peak device memory
as phase 4 does, runs phase 6's SMC for 15b to compare with, then
``chip_smoke.checkpoint_mesh_phase``, printing its lines (15a-15d).
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
        print("checkpoint_mesh_probe: no CUDA device", file=sys.stderr)
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

    counted = {"cycle_reduction_policy": cycle_reduction_policy,
               "settle_parts": settle_parts, "filter_tail": filter_tail,
               "cycle_reduction": cycle_reduction, "dare_settle": dare_settle,
               "settle_filter_loglik": settle_filter_loglik}

    def reset_counts():
        for fn in counted.values():
            fn.launches = 0

    def read_counts():
        return {k: fn.launches for k, fn in counted.items()}

    card = chip_smoke.card_line()
    t0 = time.perf_counter()
    _cuda.library()
    print(f"build {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    dev = torch.device("cuda", 0)
    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("sw2007"), verbose=False)
    constant = [p for p in model.param_names
                if p not in chip_smoke.SW_ESTIMATED]
    ss = DSGEStateSpace(model, device="cuda").configure(
        observed_states=chip_smoke.SW_OBS, constant_params=constant,
        filter_type="steady_state", kalman_settle=chip_smoke.N_SETTLE)
    data, draw = ss.data_from_prior(
        torch.Generator(device="cuda").manual_seed(0),
        periods=chip_smoke.PERIODS)
    u0 = ss.unconstrain(draw).to(torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = u0[None, :] + 0.05 * torch.randn(
        (chip_smoke.BATCH, u0.shape[0]), generator=gen, device=dev,
        dtype=torch.float32)
    data32 = data.astype("float32")
    sweep = ss.build_batched_loglik(data32, n_settle=chip_smoke.N_SETTLE,
                                    policy="pallas", settle="pallas")
    sweep(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    for _ in range(3):
        sweep(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    smc = geconpy_torch.fit_smc(ss, data32, **chip_smoke.SMC_KW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"phase 6's SMC: {len(smc.phi_schedule)} stages, log evidence "
          f"{smc.log_evidence:.3f}, {wall:.3f} s; the sweep's peak {peak} B "
          f"from {base} B [{card}]", flush=True)
    # 15d's first child starts here, beside 15a-15c only (the full script
    # starts it before phase 13)
    cache_run = chip_smoke.start_cache_run()
    try:
        chip_smoke.checkpoint_mesh_phase(card, reset_counts, read_counts,
                                         model, ss, data32, batch, sweep,
                                         (smc, wall), (peak, base), cache_run)
    finally:
        chip_smoke.stop_cache_run(cache_run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
