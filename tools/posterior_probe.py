#!/usr/bin/env python3
"""Phase 12 of ``chip_smoke.py`` (what a user does after ``fit``) alone.

Run from the root of a checkout on a GPU:

    python3 tools/posterior_probe.py

It makes phase 7's SW-2007 configuration (stationary filter, 22
estimated parameters) and data (200 periods at the bench's generating
point), and in place of phase 7's NUTS fit a posterior of 128 x 4 draws
jittered around the generating draw (0.05 N(0, 1) in the unconstrained
space, seed 1, with their log posteriors), then runs
``chip_smoke.posterior_tools_phase``, printing its lines (12a-12d).  No
kernel is built: phase 12 launches none.
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
        print("posterior_probe: no CUDA device", file=sys.stderr)
        return 2
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
    data, draw = ss.data_from_prior(
        torch.Generator(device="cuda").manual_seed(0),
        periods=chip_smoke.PERIODS, params=chip_smoke.SW_TRUTH)
    u0 = ss.unconstrain(draw)
    chains, draws = chip_smoke.NUTS_KW["num_chains"], 4
    U = u0[None, :] + 0.05 * torch.randn(
        (chains * draws, u0.shape[0]),
        generator=torch.Generator(device="cuda").manual_seed(1),
        device="cuda", dtype=torch.float64)
    logp = ss.build_logpost(data)(U)
    shape = (chains, draws)
    res = PosteriorResult(
        samples=ss.constrain(U).cpu().numpy().reshape(shape + (-1,)),
        unconstrained=U.float().cpu().numpy().reshape(shape + (-1,)),
        logp=logp.cpu().numpy().reshape(shape),
        param_names=ss.param_labels, diverging=np.zeros(shape, bool),
        accept_prob=np.ones(shape), step_size=np.full(chains, 0.1))
    chip_smoke.posterior_tools_phase(chip_smoke.card_line(), reset_counts,
                                     read_counts, model, ss, ss_cpu, res,
                                     data.astype("float32"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
