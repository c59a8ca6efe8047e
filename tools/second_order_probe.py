#!/usr/bin/env python3
"""Phase 13 of ``chip_smoke.py`` (second order at ``nk_sw``'s width, and
GIRF bands) alone.

Run from the root of a checkout on a GPU:

    python3 tools/second_order_probe.py [PROFILE_PERIODS]

It makes phase 7's SW-2007 configuration (stationary filter, 22
estimated parameters) and data (200 periods at the bench's generating
point), and in place of phase 7's NUTS fit a posterior of 128 x 4 draws
jittered around the generating draw (0.05 N(0, 1) in the unconstrained
space, seed 1), then runs ``chip_smoke.second_order_phase``, printing its
lines (13a-13e); ``PROFILE_PERIODS`` (default
``chip_smoke.SO_PROFILE_PERIODS``) sets how many periods 13c's profiled
value+grad call filters.  The cycle-reduction (K4) and DARE (K6) kernels, which
13c's first-order comparison launches, are built from the checkout on
their first call.
"""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("second_order_probe: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) > 1:
        chip_smoke.SO_PROFILE_PERIODS = int(sys.argv[1])
    import geconpy_torch
    from geconpy_torch.ops.batched_cycle_reduction import (
        cycle_reduction, cycle_reduction_policy)
    from geconpy_torch.ops.batched_dare import dare_settle
    from geconpy_torch.ops.batched_filter import filter_tail
    from geconpy_torch.ops.batched_settle import (settle_filter_loglik,
                                                  settle_parts)
    from geconpy_torch.stats.estimation import PosteriorResult
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

    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("sw2007"), verbose=False)
    constant = [p for p in model.param_names
                if p not in chip_smoke.SW_ESTIMATED]
    kw = dict(observed_states=chip_smoke.SW_OBS, constant_params=constant,
              filter_type="stationary", kalman_settle=chip_smoke.N_SETTLE)
    ss = DSGEStateSpace(model, device="cuda").configure(**kw)
    ss_cpu = DSGEStateSpace(model, device="cpu").configure(**kw)
    _data, draw = ss.data_from_prior(
        torch.Generator(device="cuda").manual_seed(0),
        periods=chip_smoke.PERIODS, params=chip_smoke.SW_TRUTH)
    u0 = ss.unconstrain(draw)
    chains, draws = chip_smoke.NUTS_KW["num_chains"], 4
    U = u0[None, :] + 0.05 * torch.randn(
        (chains * draws, u0.shape[0]),
        generator=torch.Generator(device="cuda").manual_seed(1),
        device="cuda", dtype=torch.float64)
    shape = (chains, draws)
    res = PosteriorResult(
        samples=ss.constrain(U).cpu().numpy().reshape(shape + (-1,)),
        unconstrained=U.float().cpu().numpy().reshape(shape + (-1,)),
        logp=np.zeros(shape), param_names=ss.param_labels,
        diverging=np.zeros(shape, bool), accept_prob=np.ones(shape),
        step_size=np.full(chains, 0.1))
    chip_smoke.second_order_phase(chip_smoke.card_line(), reset_counts,
                                  read_counts, ss, ss_cpu, res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
