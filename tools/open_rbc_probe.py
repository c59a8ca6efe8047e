#!/usr/bin/env python3
"""Phase 9 of ``chip_smoke.py`` (``open_rbc``, the numeric steady state,
end to end) alone: the quick loop for work on the steady state.

Run from the root of a checkout on a GPU:

    python3 tools/open_rbc_probe.py [--lm-tail]

It builds the CUDA kernels and runs ``chip_smoke.open_rbc_phase``,
printing its lines (9a-9e).  ``--lm-tail`` then times what one draw
without a steady state costs a batch: ``open_rbc``'s ``ss_solver`` at
batch 4096 (each parameter moved by 0.5% a draw, from a seed), once as it
is and once with draw 0's alpha at 0.99, where Newton fails and
Levenberg-Marquardt runs its 1,000 iterations on that draw alone.
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
        print("open_rbc_probe: no CUDA device", file=sys.stderr)
        return 2
    from geconpy_torch.ops import _cuda
    from geconpy_torch.ops.batched_cycle_reduction import (
        cycle_reduction, cycle_reduction_policy)
    from geconpy_torch.ops.batched_dare import dare_settle
    from geconpy_torch.ops.batched_filter import filter_tail
    from geconpy_torch.ops.batched_settle import (settle_filter_loglik,
                                                  settle_parts)

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

    card = chip_smoke.card_line()
    chip_smoke.open_rbc_phase(card, reset_counts, read_counts)
    if "--lm-tail" in sys.argv[1:]:
        lm_tail(card)
    return 0


def lm_tail(card: str) -> None:
    import torch

    import geconpy_torch

    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("open_rbc"))
    solve = model.ss_solver
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    theta = model.default_theta().to(dev)[None] * (1 + 0.005 * torch.randn(
        (chip_smoke.BATCH, len(model.param_names)), generator=gen,
        device=dev, dtype=torch.float64))
    bad = theta.clone()
    bad[0, model.param_names.index("alpha")] = 0.99
    out = {}
    for label, th in (("as drawn", theta), ("draw 0 without a steady "
                                            "state", bad)):
        solve(th)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = solve(th)
        torch.cuda.synchronize()
        out[label] = (time.perf_counter() - t0) * 1e3
        print(f"lm tail, {label}: {out[label]:.1f} ms a call (batch "
              f"{chip_smoke.BATCH}); {int(solve.lm_draws)} draws sent to LM; "
              f"success {float(sol.success.double().mean()):.5f}; draw 0: "
              f"{int(sol.n_iter[0])} iterations, success "
              f"{bool(sol.success[0])} [{card}]", flush=True)
    extra = out["draw 0 without a steady state"] - out["as drawn"]
    print(f"lm tail: one unsolvable draw adds {extra:.1f} ms, "
          f"{extra / 1000:.3f} ms an LM iteration [{card}]", flush=True)


if __name__ == "__main__":
    sys.exit(main())
