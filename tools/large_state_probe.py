#!/usr/bin/env python3
"""Phase 16 of ``chip_smoke.py`` (the large-state kernels) alone.

Run from the root of a checkout on a GPU:

    python3 tools/large_state_probe.py

It builds the kernels, makes SW-2007's model and runs
``chip_smoke.large_state_phase`` (16a the sweep with each settle and 16b
the value+grad at a filter state of 104, 16c each kernel above its
small-state plan against its plain version, and beyond what
``chip_smoke.py`` runs, K2 and K5 at the largest n of their cluster plan
and the next (``edges=True``), 16d the device-memory K2 and K5 on two
such economies side by side, filter state 208), printing its lines and
then the JSON rows of the large-state variants and of the cluster tier of
K2, K5 and K6.
"""

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("large_state_probe: no CUDA device", file=sys.stderr)
        return 2
    import geconpy_torch
    from geconpy_torch.ops import _cuda
    from geconpy_torch.ops.batched_cycle_reduction import (
        cycle_reduction, cycle_reduction_policy)
    from geconpy_torch.ops.batched_dare import dare_settle
    from geconpy_torch.ops.batched_filter import filter_tail
    from geconpy_torch.ops.batched_settle import (settle_filter_loglik,
                                                  settle_parts)

    counted = {"cycle_reduction_policy": cycle_reduction_policy,
               "settle_parts": settle_parts, "filter_tail": filter_tail,
               "cycle_reduction": cycle_reduction, "dare_settle": dare_settle,
               "settle_filter_loglik": settle_filter_loglik}

    def reset_counts():
        for fn in counted.values():
            fn.launches = 0
            for tier in ("large_launches", "workspace_launches"):
                if hasattr(fn, tier):
                    setattr(fn, tier, 0)

    def read_counts():
        return {k: fn.launches for k, fn in counted.items()}

    _cuda.library()
    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("sw2007"), verbose=False)
    constant = [p for p in model.param_names
                if p not in chip_smoke.SW_ESTIMATED]
    launches, report = chip_smoke.large_state_phase(
        chip_smoke.card_line(), reset_counts, read_counts, model, constant,
        edges=True)
    print(json.dumps({k: dict(report[k], launches=launches[k])
                      for k in report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
