#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` (the other estimators and the
deterministic paths) alone.

Run from the root of a checkout on a GPU:

    python3 tools/estimators_probe.py [ADAM_STEPS NEWTON_STEPS]

It makes phase 5's SW-2007 configuration (stationary filter, 22 estimated
parameters, 7 observables) and data (200 periods of ``data_from_prior``,
CUDA generator, seed 0), then runs ``chip_smoke.estimators_phase``,
printing its lines (14a-14f).  The optional arguments replace
``chip_smoke.EST_CUT``, the cut of the GMM and IRF-matching searches.  No
kernel is built or launched.
"""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("estimators_probe: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) > 2:
        chip_smoke.EST_CUT = {"adam_steps": int(sys.argv[1]),
                              "newton_steps": int(sys.argv[2])}
    import geconpy_torch
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

    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("sw2007"), verbose=False)
    constant = [p for p in model.param_names
                if p not in chip_smoke.SW_ESTIMATED]
    kw = dict(observed_states=chip_smoke.SW_OBS, constant_params=constant,
              filter_type="stationary", kalman_settle=chip_smoke.N_SETTLE)
    ss = DSGEStateSpace(model, device="cuda").configure(**kw)
    ss_cpu = DSGEStateSpace(model, device="cpu").configure(**kw)
    data, _ = ss.data_from_prior(
        torch.Generator(device="cuda").manual_seed(0),
        periods=chip_smoke.PERIODS)
    chip_smoke.estimators_phase(chip_smoke.card_line(), reset_counts,
                                read_counts, ss, ss_cpu, data)
    return 0


if __name__ == "__main__":
    sys.exit(main())
