#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py`` (the large-state K1 and K4) alone.

Run from the root of a checkout on a GPU:

    python3 tools/large_pencil_probe.py

It builds the kernels and runs ``chip_smoke.large_pencil_phase``: on two
SW-2007 economies side by side (a dynamic core of 52 states) 17a the sweep
with each settle and 17b the value+grad, both through the on-chip K1 or
K4; 17c each tier above the small-state plan against its plain version at
n = 49 to 130 and, beyond what ``chip_smoke.py`` runs, at each tier's
largest n and the next (``edges=True``); 17d four economies (a core of
104, the cluster tier) and five (130, the device-memory tier).  It prints
the phase's lines and then the JSON rows of the tier rows.
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
        print("large_pencil_probe: no CUDA device", file=sys.stderr)
        return 2
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
            for tier in ("large_launches", "onchip_launches",
                         "cluster_launches", "workspace_launches"):
                if hasattr(fn, tier):
                    setattr(fn, tier, 0)

    def read_counts():
        return {k: fn.launches for k, fn in counted.items()}

    _cuda.library()
    launches, report = chip_smoke.large_pencil_phase(
        chip_smoke.card_line(), reset_counts, read_counts, edges=True)
    print(json.dumps({row: dict(report[row], launches=launches[row])
                      for row in report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
