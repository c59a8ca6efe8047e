"""The CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs an NVIDIA GPU with ``nvcc`` (marker ``gpu``) and
skips elsewhere; the decision is taken inside a fixture, never at import.
On the GPU: ``python -m pytest tests/test_torch_cuda.py -q``.  The inputs
are SW-2007's own kernel inputs from the sweep (K1-K3, K5) and from the
value+grad path (K4, K6) at a small batch; float64 outputs agree at rel
1e-9 (min |pivot| aside: near-tied pivots may take another row at rounding
level) and each wrapper counts its launches.  Every kernel is also run on
synthetic inputs whose sizes are not multiples of its tiles, at batches
that do not fill the last block: K2 and K5, K1 and K4, and K3 (float64
within 1e-12 of the plain version, float32 within the sweep's 5e-4) and K6
(float64 within 1e-11), with a NaN draw that must stay isolated.  K2, K3,
K5 and K6 also run at state sizes beyond their small-state kernels (the
large-state variants: either side of each small-state plan's edge, the
filter state of 104, k > 32 for K3), at the same bars, and a NaN draw
there poisons only itself, also where its workspace slot serves later
draws; so do K1 and K4 beyond their small-state plan (n = 49 to 130, the
two-economy SW-2007 core of 52 among them) in each of their three tiers
there (on-chip, cluster, device-memory), each held to its plain version,
and K6 at the edges of its three tiers (small-state, cluster,
device-memory) with k = 7 and 14, float64 within 1e-9 with the same draws
settled and float32 I/O within 5e-4, its cluster tier equal to its
device-memory tier to the bit.  The
numeric steady state of ``open_rbc`` runs on the card as on the CPU (the
same iterations and flags, x_ss at rel 1e-10), and its implicit gradient
is finite inside the value+grad path at batch 512.
``Model.solve_model`` runs on the card by default and gives the CPU's T
and R (rel 1e-10) under each solver, and
the device gensys over a batch on the card gives each draw's solo CPU run.
Every filter of the likelihood (the SDA and auto settles, steady state,
Chandrasekhar, parallel, the cyclostationary filter of mixed-frequency
data) gives the CPU's log posterior on the card, and so do ``filter_data``,
the disturbance smoother and the historical shock decomposition.  The
tools a user runs after a fit give the CPU's results on the card: the
posterior bands, predictive and forecast paths, the Laplace evidence and
``fit_ml`` at the bars of their CPU tests, and the solvability, BK and
prior predictive sweeps with the policy tables and eigenvalue
sensitivities.  The second-order layer gives the CPU's results on the
card: the blocks of ``solve_model_second_order``, the pruned paths, IRFs,
mean and GIRF (rel 1e-10), the second-order value+grad (1e-8 / 1e-6),
``filter_data_second_order`` and the particle filter on the same normals,
and ``fit(order=2)``, ``fit_pmmh`` and ``posterior_girfs`` run there.
"""

import numpy as np
import pytest
import torch

import geconpy_torch
from geconpy_torch.ops.batched_cycle_reduction import (
    _cr_plain, _cr_policy_plain, cr_policy_raw, cr_raw, cycle_reduction,
    cycle_reduction_policy)
from geconpy_torch.ops.batched_dare import _dare_plain, dare_settle
from geconpy_torch.ops.batched_filter import _filter_tail_plain, filter_tail
from geconpy_torch.ops.batched_settle import (LYAP_ITERS, _settle_filter_plain,
                                              _settle_plain,
                                              settle_filter_loglik,
                                              settle_parts)
from geconpy_torch.ops.kalman import dare_residual_settled
from geconpy_torch.stats.statespace import CR_ITERS, DSGEStateSpace

pytestmark = pytest.mark.gpu

SW_EST = ["crhoa", "sigma_ea", "crr", "crpi", "chabb", "crhob", "sigma_eb"]


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc) to build and run the kernels")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def kernel_inputs(device):
    model = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn("sw2007"))
    kw = dict(observed_states=["y", "c", "inve", "w", "pinf", "r", "lab"],
              kalman_settle=32,
              constant_params=[p for p in model.param_names if p not in SW_EST])
    ss = DSGEStateSpace(model, device=device).configure(**kw)
    data, draw = ss.data_from_prior(
        torch.Generator(device=device).manual_seed(0), periods=80)
    u0 = ss.unconstrain(draw)
    rng = np.random.default_rng(0)
    U = u0[None] + 0.05 * torch.as_tensor(rng.standard_normal((64, len(u0))),
                                          device=device)
    record: dict = {}
    ss.build_batched_loglik(data, n_settle=32, policy="pallas",
                            settle="pallas")(U, record=record)
    ss.build_batched_loglik(data, n_settle=32, policy="pallas",
                            settle="fused")(
        U, record=record)
    ss_vg = DSGEStateSpace(model, device=device).configure(
        **kw, filter_type="stationary")
    ss_vg.build_batched_logpost_and_grad(data, settle="pallas")(
        U, record=record)
    return record


def _rel(a, b):
    both = torch.isfinite(a) & torch.isfinite(b)
    assert torch.equal(torch.isfinite(a), torch.isfinite(b))
    return float(((a - b).abs() / (1 + b.abs()))[both].max())


def test_cycle_reduction_kernel_matches_plain(kernel_inputs):
    args = kernel_inputs["cycle_reduction_policy"]
    before = cycle_reduction_policy.launches
    T, R, flags = cr_policy_raw(*args, CR_ITERS)
    torch.cuda.synchronize()
    assert cycle_reduction_policy.launches == before + 1
    T0, R0, flags0 = _cr_policy_plain(*args, CR_ITERS)
    assert _rel(T, T0) < 1e-9 and _rel(R, R0) < 1e-9
    assert _rel(flags[:, 1:], flags0[:, 1:]) < 1e-9


def test_policy_kernel_matches_plain(kernel_inputs):
    args = kernel_inputs["cycle_reduction"]
    before = cycle_reduction.launches
    T, flags = cr_raw(*args, CR_ITERS)
    torch.cuda.synchronize()
    assert cycle_reduction.launches == before + 1
    T0, flags0 = _cr_plain(*args, CR_ITERS)
    assert _rel(T, T0) < 1e-9
    assert _rel(flags[:, 1:], flags0[:, 1:]) < 1e-9


def test_dare_kernel_matches_plain(kernel_inputs):
    args = kernel_inputs["dare_settle"]
    before = dare_settle.launches
    P = dare_settle(*args)
    torch.cuda.synchronize()
    assert dare_settle.launches == before + 1
    P0 = _dare_plain(*args)
    assert _rel(P, P0) < 1e-9
    assert torch.equal(dare_residual_settled(*args, P),
                       dare_residual_settled(*args, P0))


def test_settle_kernel_matches_plain(kernel_inputs):
    args = kernel_inputs["settle_parts"]
    before = settle_parts.launches
    got = settle_parts(*args)
    torch.cuda.synchronize()
    assert settle_parts.launches == before + 1
    for g, r in zip(got, _settle_plain(*args, LYAP_ITERS)):
        assert _rel(g, r) < 1e-9


def test_fused_settle_tail_kernel_matches_plain(kernel_inputs):
    args = kernel_inputs["settle_filter_loglik"]
    before = settle_filter_loglik.launches
    got = settle_filter_loglik(*args, n_settle=32)
    torch.cuda.synchronize()
    assert settle_filter_loglik.launches == before + 1
    assert _rel(got, _settle_filter_plain(*args, 32, LYAP_ITERS)) < 1e-9
    # float32 I/O around the float64 recursion: the sweep's bar
    got32 = settle_filter_loglik(*[a.float() for a in args], n_settle=32)
    assert got32.dtype == torch.float32
    assert _rel(got32.double(), got) < 5e-4
    # a settle over the whole sample (and beyond) is the settle kernel's
    # head likelihood: the tail is empty and no row past the sample is read
    whole = settle_filter_loglik(*args, n_settle=10**6)
    assert _rel(whole, settle_parts(*args)[0]) < 1e-9


def test_filter_tail_kernel_matches_plain(kernel_inputs):
    args = kernel_inputs["filter_tail"]
    before = filter_tail.launches
    got = filter_tail(*args)
    torch.cuda.synchronize()
    assert filter_tail.launches == before + 1
    assert _rel(got, _filter_tail_plain(*args)) < 1e-9


def test_float32_kernels_agree_with_float64(kernel_inputs):
    args = [x.float() for x in kernel_inputs["filter_tail"]]
    got = filter_tail(*args).double()
    ref = filter_tail(*kernel_inputs["filter_tail"])
    assert _rel(got, ref) < 5e-4


def test_wrappers_refuse_what_the_kernels_do_not_take(kernel_inputs):
    args = list(kernel_inputs["filter_tail"])
    with pytest.raises(TypeError):
        filter_tail(*[a.half() for a in args])
    mixed = [args[0].float()] + args[1:]
    with pytest.raises(TypeError):
        filter_tail(*mixed)
    short = args[:5] + [args[5][:-1]] + args[6:]        # Finv of one draw fewer
    with pytest.raises(ValueError, match="shape"):
        filter_tail(*short)


# ---- K2 and K5 on ragged shapes: synthetic stable systems from a seed

RAGGED_NK = [(n, k) for n in (1, 2, 7, 8, 9, 26, 33) for k in (1, 3, 7, 8)
             if k <= n]
# more than 8 observables: the elimination runs in shared memory
RAGGED_NK += [(9, 9), (26, 12), (33, 17)]
N_OBS = 12


def _stable_system(n, k, batch, n_obs, seed):
    """numpy float64: y (n_obs, k) and per-draw T with spectral radius 0.9,
    R Q R' and H positive definite, Z and d."""
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((batch, n, n))
    T *= 0.9 / np.abs(np.linalg.eigvals(T)).max(axis=-1)[:, None, None]
    G = rng.standard_normal((batch, n, n))
    RQR = G @ G.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    Z = rng.standard_normal((batch, k, n))
    E = rng.standard_normal((batch, k, k))
    H = E @ E.transpose(0, 2, 1) / k + 0.1 * np.eye(k)
    d = 0.1 * rng.standard_normal((batch, k))
    y = rng.standard_normal((n_obs, k))
    return y, T, RQR, Z, H, d


@pytest.mark.parametrize("n_settle", [5, N_OBS])
@pytest.mark.parametrize("batch", [1, 5, 67])
@pytest.mark.parametrize("n,k", RAGGED_NK)
def test_settle_kernels_match_plain_on_ragged_shapes(device, n, k, batch,
                                                     n_settle):
    args = [torch.as_tensor(a, device=device)
            for a in _stable_system(n, k, batch, N_OBS, seed=100 * n + k)]
    y, mats = args[0], args[1:]
    got = settle_parts(y[:n_settle], *mats)
    ref = _settle_plain(y[:n_settle], *mats, LYAP_ITERS)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _rel(g, r) < 1e-9
    ll = settle_filter_loglik(y, *mats, n_settle=n_settle)
    ll_ref = _settle_filter_plain(y, *mats, n_settle, LYAP_ITERS)
    assert ll.shape == (batch,) and _rel(ll, ll_ref) < 1e-9
    # float32 I/O around the float64 recursion: the sweep's bar on the
    # likelihood, against the plain version on the same rounded inputs
    args32 = [a.float() for a in args]
    ll32 = settle_filter_loglik(*args32, n_settle=n_settle)
    head32 = settle_parts(args32[0][:n_settle], *args32[1:])[0]
    assert ll32.dtype == head32.dtype == torch.float32
    assert _rel(ll32, _settle_filter_plain(*args32, n_settle, LYAP_ITERS)) < 5e-4
    assert _rel(head32, _settle_plain(args32[0][:n_settle], *args32[1:],
                                      LYAP_ITERS)[0]) < 5e-4


@pytest.mark.parametrize("n,k", [(26, 7), (9, 3)])
def test_settle_kernels_nan_draw_poisons_only_itself(device, n, k):
    """A NaN draw between good draws (of the same block, where a block holds
    several): the good ones are bitwise what they are without it."""
    args = [torch.as_tensor(a, device=device)
            for a in _stable_system(n, k, 9, N_OBS, seed=7)]
    y, T = args[0], args[1]
    T_bad = T.clone()
    T_bad[1, 0, 0] = float("nan")
    keep = [0, 2, 3, 4, 5, 6, 7, 8]
    clean = settle_parts(y[:5], T, *args[2:])
    got = settle_parts(y[:5], T_bad, *args[2:])
    assert not torch.isfinite(got[0][1])
    for g, c in zip(got, clean):
        assert torch.equal(g[keep], c[keep])
    clean = settle_filter_loglik(y, T, *args[2:], n_settle=5)
    got = settle_filter_loglik(y, T_bad, *args[2:], n_settle=5)
    assert not torch.isfinite(got[1])
    assert torch.equal(got[keep], clean[keep])


def test_settle_kernels_read_a_long_sample_from_device_memory(device):
    """A sample too long to stage in shared memory beside the draws."""
    args = [torch.as_tensor(a, device=device)
            for a in _stable_system(9, 4, 5, 2000, seed=3)]
    y, mats = args[0], args[1:]
    got = settle_parts(y, *mats)
    for g, r in zip(got, _settle_plain(y, *mats, LYAP_ITERS)):
        assert _rel(g, r) < 1e-9
    ll = settle_filter_loglik(y, *mats, n_settle=20)
    assert _rel(ll, _settle_filter_plain(y, *mats, 20, LYAP_ITERS)) < 1e-9


def test_settle_kernels_refuse_more_shared_memory_than_the_device_has(device):
    """A draw whose float64 layout exceeds the device's shared memory (this
    shape raised before the large-state kernels): it runs a tier above the
    small-state plan, within rel 1e-9 of the plain version."""
    args = [torch.as_tensor(a, device=device)
            for a in _stable_system(96, 3, 2, 4, seed=1)]
    before = (settle_parts.large_launches, settle_filter_loglik.large_launches)
    got = settle_parts(*args)
    for g, r in zip(got, _settle_plain(*args, LYAP_ITERS)):
        assert g.shape == r.shape and _rel(g, r) < 1e-9
    ll = settle_filter_loglik(*args, n_settle=2)
    assert _rel(ll, _settle_filter_plain(*args, 2, LYAP_ITERS)) < 1e-9
    assert (settle_parts.large_launches, settle_filter_loglik.large_launches) \
        == (before[0] + 1, before[1] + 1)


def _last_small_n(fits) -> int:
    """The largest n (k = 7) whose small-state plan ``fits(n)`` holds."""
    n = 1
    while fits(n + 1):
        n += 1
    return n


@pytest.mark.parametrize("edge", ["last small", "first large"])
def test_settle_kernels_at_the_edge_of_the_small_state_plan(device, edge):
    """K2 and K5 at the last n (k = 7) whose small-state plan fits the
    device's shared memory and at the next: the variant each wrapper
    records, and rel 1e-9 to the plain version."""
    from geconpy_torch.ops import _cuda

    lib = _cuda.library()
    for name, n_obs in (("settle_parts", 5), ("settle_filter_loglik", N_OBS)):
        n = _last_small_n(lambda m: lib.gcp_settle_fits(1, m, 7, n_obs))
        n += edge == "first large"
        args = [torch.as_tensor(a, device=device)
                for a in _stable_system(n, 7, 3, N_OBS, seed=n)]
        y, mats = args[0], args[1:]
        if name == "settle_parts":
            before = settle_parts.large_launches
            got = settle_parts(y[:5], *mats)
            ref = _settle_plain(y[:5], *mats, LYAP_ITERS)
            large = settle_parts.large_launches - before
        else:
            before = settle_filter_loglik.large_launches
            got = (settle_filter_loglik(y, *mats, n_settle=5),)
            ref = (_settle_filter_plain(y, *mats, 5, LYAP_ITERS),)
            large = settle_filter_loglik.large_launches - before
        assert large == (edge == "first large"), (name, n)
        for g, r in zip(got, ref):
            assert _rel(g, r) < 1e-9, (name, n)


def _settle_tier(fn, call):
    """The tier of the settle kernel that ``call()`` launched through the
    wrapper ``fn``, read from its counters."""
    before = (fn.launches, fn.large_launches, fn.workspace_launches)
    out = call()
    after = (fn.launches, fn.large_launches, fn.workspace_launches)
    delta = tuple(a - b for a, b in zip(after, before))
    tiers = {(1, 0, 0): "small", (1, 1, 0): "cluster", (1, 1, 1): "workspace"}
    assert delta in tiers, delta
    return out, tiers[delta]


def _expected_tier(code, n, k, n_obs) -> str:
    from geconpy_torch.ops import _cuda

    lib = _cuda.library()
    if lib.gcp_settle_fits(code, n, k, n_obs):
        return "small"
    return "cluster" if lib.gcp_settle_cluster_fits(code, n, k, n_obs) \
        else "workspace"


def _settle_edges(k, n_obs) -> dict:
    """The n (float64) where the tiers meet: the last small-state n, the
    first and the last n of the cluster plan, the first n of the
    device-memory tier; and 104, SW-2007's filter state with year-on-year
    inflation."""
    from geconpy_torch.ops import _cuda

    lib = _cuda.library()
    small = _last_small_n(lambda m: lib.gcp_settle_fits(1, m, k, n_obs))
    last = small + 1
    assert lib.gcp_settle_cluster_fits(1, last, k, n_obs)
    while lib.gcp_settle_cluster_fits(1, last + 1, k, n_obs):
        last += 1
    return {"last small": small, "first cluster": small + 1, "n = 104": 104,
            "last cluster": last, "first workspace": last + 1}


TIER_OF_EDGE = {"last small": "small", "first cluster": "cluster",
                "n = 104": "cluster", "last cluster": "cluster",
                "first workspace": "workspace"}


@pytest.mark.parametrize("batch", ["3", "above the resident clusters"])
@pytest.mark.parametrize("k", [7, 14])
@pytest.mark.parametrize("edge", list(TIER_OF_EDGE))
def test_settle_tiers_match_plain(device, edge, k, batch):
    """K2 and K5 at the n where the three tiers meet (small-state, cluster,
    device-memory) and at n = 104, k = 7 and 14, on 3 draws or on more
    draws than the cluster plan's resident clusters (their persistent grid
    strides over the batch): the tier the counters record is the one its
    size takes, float64 within rel 1e-9 of the plain version with the same
    finite draws, float32 I/O within 5e-4 of the plain version on the same
    rounded inputs."""
    from geconpy_torch.ops import _cuda

    lib = _cuda.library()
    for name, n_obs, n_settle in (("settle_parts", 5, 5),
                                  ("settle_filter_loglik", N_OBS, 5)):
        n = _settle_edges(k, n_obs)[edge]
        assert _expected_tier(1, n, k, n_obs) == TIER_OF_EDGE[edge]
        resident = lib.gcp_settle_cluster_resident(
            1, int(name == "settle_filter_loglik"), n, k, n_obs)
        bn = 3 if batch == "3" else (
            resident + 5 if TIER_OF_EDGE[edge] == "cluster" else 67)
        args = [torch.as_tensor(a, device=device)
                for a in _stable_system(n, k, bn, N_OBS, seed=n + k)]
        args32 = [a.float() for a in args]
        if name == "settle_parts":
            fn = settle_parts
            run = lambda a: settle_parts(a[0][:n_settle], *a[1:])  # noqa: E731
            plain = lambda a: _settle_plain(  # noqa: E731
                a[0][:n_settle], *a[1:], LYAP_ITERS)
        else:
            fn = settle_filter_loglik
            run = lambda a: (settle_filter_loglik(  # noqa: E731
                *a, n_settle=n_settle),)
            plain = lambda a: (_settle_filter_plain(  # noqa: E731
                *a, n_settle, LYAP_ITERS),)
        got, tier = _settle_tier(fn, lambda: run(args))
        assert tier == TIER_OF_EDGE[edge], (name, n, k)
        for g, r in zip(got, plain(args)):
            assert g.shape == r.shape and _rel(g, r) < 1e-9, (name, n, k)
        got32, tier32 = _settle_tier(fn, lambda: run(args32))
        assert tier32 == _expected_tier(0, n, k, n_obs), (name, n, k)
        for g, r in zip(got32, plain(args32)):
            assert g.dtype == torch.float32 and _rel(g, r) < 5e-4, (name, n, k)


@pytest.mark.parametrize("tier", ["cluster", "workspace"])
def test_large_settle_kernels_nan_draw_poisons_only_itself(device, tier):
    """K2 and K5 above the small-state plan (k = 3): the cluster kernel at
    n = 90 and the large-state kernel at the first n of its device-memory
    tier, each on more draws than its persistent grid holds at once, so
    that the NaN draw's cluster (or workspace slot) serves later draws:
    every other draw is bitwise what it is without the NaN."""
    from geconpy_torch.ops import _cuda

    lib = _cuda.library()
    if tier == "cluster":
        n = 90
        bn = max(lib.gcp_settle_cluster_resident(1, f, n, 3, N_OBS)
                 for f in (0, 1)) + 40
    else:
        n = _settle_edges(3, N_OBS)["first workspace"]
        bn = lib.gcp_settle_large_work_bytes(1, 1, n, 3, N_OBS, 1 << 20) \
            // lib.gcp_settle_large_work_bytes(1, 1, n, 3, N_OBS, 1) + 40
    assert _expected_tier(1, n, 3, 5) == _expected_tier(1, n, 3, N_OBS) == tier
    args = [torch.as_tensor(a, device=device)
            for a in _stable_system(n, 3, bn, N_OBS, seed=9)]
    y, T = args[0], args[1]
    T_bad = T.clone()
    T_bad[1, 0, 0] = float("nan")
    keep = torch.arange(bn, device=device) != 1
    clean, t1 = _settle_tier(settle_parts,
                             lambda: settle_parts(y[:5], T, *args[2:]))
    got, t2 = _settle_tier(settle_parts,
                           lambda: settle_parts(y[:5], T_bad, *args[2:]))
    assert t1 == t2 == tier
    assert not torch.isfinite(got[0][1])
    for g, c in zip(got, clean):
        assert torch.equal(g[keep], c[keep])
    clean, t1 = _settle_tier(settle_filter_loglik, lambda: settle_filter_loglik(
        y, T, *args[2:], n_settle=5))
    got, t2 = _settle_tier(settle_filter_loglik, lambda: settle_filter_loglik(
        y, T_bad, *args[2:], n_settle=5))
    assert t1 == t2 == tier
    assert not torch.isfinite(got[1])
    assert torch.equal(got[keep], clean[keep])


# ---- K1 and K4 on ragged shapes: synthetic pencils from a seed

# and one size above 32, where the eliminations run in shared memory
CR_NM = [(n, m) for n in (1, 4, 9, 17, 26, 32) for m in (1, 7, 9)] + [(40, 7)]


def _stable_pencil(n, m, batch, seed):
    """numpy float64 (A, B, C, D) with A + B T + C T^2 = 0 for a T of
    spectral radius 0.8 (see tests/test_torch_cycle_reduction.py)."""
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((batch, n, n))
    T *= 0.8 / np.abs(np.linalg.eigvals(T)).max(axis=-1)[:, None, None]
    C = 0.3 * rng.standard_normal((batch, n, n)) / np.sqrt(n)
    M = 2.0 * np.eye(n) + 0.3 * rng.standard_normal((batch, n, n)) / np.sqrt(n)
    D = rng.standard_normal((batch, n, m))
    return -M @ T, M - C @ T, C, D


def _pencil(device, n, m, batch, seed):
    return [torch.as_tensor(a, device=device)
            for a in _stable_pencil(n, m, batch, seed)]


def _cr_tier_raw(tier):
    """K1 and K4 of ``tier`` as raw calls, ``(args, n_iter) -> outputs``:
    ``"chosen"`` the wrappers' own choice (counted), else that tier's C
    entry point whatever the shape (``_launch``, not counted)."""
    from geconpy_torch.ops import _cuda
    from geconpy_torch.ops.batched_cycle_reduction import _launch

    if tier == "chosen":
        return cr_policy_raw, cr_raw
    lib = _cuda.library()
    return (lambda A, B, C, D, it: _launch(lib, tier, A, B, C, D, it),
            lambda A, B, C, it: _launch(lib, tier, A, B, C, None, it))


def _cr_tier_plain(tier):
    """The plain K1 and K4 a tier is held to: the cluster tier's in panels
    of ``CR_PANEL`` pivots, every other tier's the plain recursion."""
    from geconpy_torch.ops.batched_cycle_reduction import CR_PANEL

    panel = CR_PANEL if tier == "cluster" else None
    return (lambda A, B, C, D, it: _cr_policy_plain(A, B, C, D, it, panel),
            lambda A, B, C, it: _cr_plain(A, B, C, it, panel))


@pytest.mark.parametrize("tier", ["chosen", "onchip", "cluster"])
@pytest.mark.parametrize("batch", [1, 5, 67])
@pytest.mark.parametrize("n,m", CR_NM)
def test_cycle_reduction_kernels_match_plain_on_ragged_shapes(device, n, m,
                                                              batch, tier):
    """The tier the wrappers choose (the small-state kernel at these n),
    and the on-chip and cluster tiers' kernels on the same ragged shapes
    (their schedules take any n their layouts fit)."""
    k1, k4 = _cr_tier_raw(tier)
    p1, p4 = _cr_tier_plain(tier)
    args = _pencil(device, n, m, batch, seed=100 * n + m)
    T, R, flags = k1(*args, CR_ITERS)
    T0, R0, flags0 = p1(*args, CR_ITERS)
    assert T.shape == T0.shape and R.shape == R0.shape
    assert _rel(T, T0) < 1e-9 and _rel(R, R0) < 1e-9
    assert _rel(flags[:, 1:], flags0[:, 1:]) < 1e-9
    T4, flags4 = k4(*args[:3], CR_ITERS)
    T40, flags40 = p4(*args[:3], CR_ITERS)
    assert _rel(T4, T40) < 1e-9 and _rel(flags4[:, 1:], flags40[:, 1:]) < 1e-9
    # every draw is solved
    assert bool(cycle_reduction_policy(*args, n_iter=CR_ITERS)[2].all())


@pytest.mark.parametrize("n", [26, 9])
def test_cycle_reduction_kernels_nan_draw_poisons_only_itself(device, n):
    """A NaN draw between good draws of one block, and a draw whose first
    pivot column is zero: both are flagged, not raised, and the other draws
    are bitwise what they are without them."""
    args = _pencil(device, n, 7, 9, seed=5)
    bad = [a.clone() for a in args]
    bad[0][1, 0, 0] = float("nan")
    bad[1][4, :, 0] = 0.0          # B's first column: a zero pivot
    keep = [0, 2, 3, 5, 6, 7, 8]
    clean = cr_policy_raw(*args, CR_ITERS)
    got = cr_policy_raw(*bad, CR_ITERS)
    for g, c in zip(got, clean):
        assert torch.equal(g[keep], c[keep])
    assert not torch.isfinite(got[0][1]).all()
    assert not bool(got[2][4, 0] > 1e-7)   # min |pivot|: 0, or NaN after it
    ok = cycle_reduction_policy(*bad, n_iter=CR_ITERS)[2]
    assert not ok[1] and not ok[4] and bool(ok[keep].all())
    clean4 = cr_raw(*args[:3], CR_ITERS)
    got4 = cr_raw(*bad[:3], CR_ITERS)
    for g, c in zip(got4, clean4):
        assert torch.equal(g[keep], c[keep])
    ok4 = cycle_reduction(*bad[:3], n_iter=CR_ITERS)[1]
    assert not ok4[1] and not ok4[4] and bool(ok4[keep].all())


def _cr_slots(n, m, tier="workspace") -> int:
    """Draws K1 holds at once at (n, m) in ``tier``: the draw slots of the
    device-memory tier's persistent grid, or the on-chip tier's resident
    CTAs."""
    from geconpy_torch.ops import _cuda

    lib = _cuda.library()
    if tier == "onchip":
        return lib.gcp_cr_onchip_resident(1, 1, n, m)
    if tier == "cluster":
        return lib.gcp_cr_cluster_resident(1, 1, n, m)
    return (lib.gcp_cr_large_work_bytes(1, 1, n, m, 1 << 20)
            // lib.gcp_cr_large_work_bytes(1, 1, n, m, 1))


# the large-state K1 and K4: the first n above the small-state plan (49),
# the two-economy SW-2007 core (52), 64, 104, 108 (the cluster tier's cut
# of seven CTAs of 16 rows on an H100) and 130
LARGE_CR_NM = [(n, m) for n in (49, 52, 64, 104, 108, 130) for m in (7, 14)]


@pytest.mark.parametrize("tier", ["onchip", "cluster", "workspace"])
@pytest.mark.parametrize("batch", ["3", "above the slots"])
@pytest.mark.parametrize("n,m", LARGE_CR_NM)
def test_cycle_reduction_kernels_refuse_more_shared_memory_than_the_device_has(
        device, n, m, batch, tier):
    """A pencil whose float64 layout exceeds the device's shared memory
    under the small-state plan (n = 49 raised there before the large-state
    tiers).  Where ``tier`` is the one the shape takes (``cr_tier``), K1
    and K4 launch it through the wrappers, which count it; the device-memory
    tier also runs below its edge through its entry point.  Float64 within
    rel 1e-9 of the plain version with every draw solved, float32 I/O within
    5e-4; at 3 draws, and at more draws than the tier holds at once, so
    that slots or CTAs stride.  Where a tier's layout does not fit (the
    on-chip one from n = 57 on an H100, the cluster one from 129) its entry
    point refuses to launch and raises."""
    from geconpy_torch.ops import _cuda
    from geconpy_torch.ops.batched_cycle_reduction import cr_tier

    lib = _cuda.library()
    assert not lib.gcp_cr_fits(n, m) and not lib.gcp_cr_fits(n, 0)
    chosen = cr_tier(n, m, lib.gcp_smem_optin())
    assert chosen == cr_tier(n, 0, lib.gcp_smem_optin()) != "small"
    k1, k4 = _cr_tier_raw("chosen" if tier == chosen else tier)
    p1, p4 = _cr_tier_plain(tier)
    fits = {"onchip": chosen == "onchip",
            "cluster": lib.gcp_cr_cluster_ctas(n, m) > 0,
            "workspace": True}
    if not fits[tier]:
        args = _pencil(device, n, m, 3, seed=100 * n + m)
        with pytest.raises(RuntimeError, match="invalid argument"):
            k1(*args, CR_ITERS)
        with pytest.raises(RuntimeError, match="invalid argument"):
            k4(*args[:3], CR_ITERS)
        return
    Bn = 3 if batch == "3" else _cr_slots(n, m, tier) + 5
    args = _pencil(device, n, m, Bn, seed=100 * n + m)
    counter = f"{tier}_launches"
    before = (cycle_reduction_policy.large_launches,
              cycle_reduction.large_launches,
              getattr(cycle_reduction_policy, counter),
              getattr(cycle_reduction, counter))
    T, R, flags = k1(*args, CR_ITERS)
    T0, R0, flags0 = p1(*args, CR_ITERS)
    assert _rel(T, T0) < 1e-9 and _rel(R, R0) < 1e-9
    assert _rel(flags[:, 1:], flags0[:, 1:]) < 1e-9
    T4, flags4 = k4(*args[:3], CR_ITERS)
    T40, flags40 = p4(*args[:3], CR_ITERS)
    assert _rel(T4, T40) < 1e-9 and _rel(flags4[:, 1:], flags40[:, 1:]) < 1e-9
    step = int(tier == chosen)
    assert (cycle_reduction_policy.large_launches,
            cycle_reduction.large_launches,
            getattr(cycle_reduction_policy, counter),
            getattr(cycle_reduction, counter)) == tuple(
                b + step for b in before)
    assert bool(cycle_reduction_policy(*args, n_iter=CR_ITERS)[2].all())
    assert bool(cycle_reduction(*args[:3], n_iter=CR_ITERS)[1].all())
    args32 = [a.float() for a in args]
    for got, want in ((k1(*args32, CR_ITERS), p1(*args32, CR_ITERS)),
                      (k4(*args32[:3], CR_ITERS), p4(*args32[:3], CR_ITERS))):
        for g, w in zip(got[:-1], want[:-1]):
            assert g.dtype == torch.float32 and _rel(g, w) < 5e-4


@pytest.mark.parametrize("tier", ["onchip", "cluster", "workspace"])
def test_large_cycle_reduction_kernels_nan_draw_poisons_only_itself(device,
                                                                    tier):
    """K1 and K4 above the small-state plan (n = 52, m = 14) in each tier:
    the on-chip one, which the wrappers take there, and the cluster and
    device-memory ones through their entry points.  On more draws than the
    tier holds at once,
    with a NaN draw and a draw whose first pivot column is zero: both are
    flagged, not raised, and every other draw, also those that reuse a slot
    or a CTA's shared memory, is bitwise what it is without them."""
    k1, k4 = _cr_tier_raw("chosen" if tier == "onchip" else tier)
    Bn = _cr_slots(52, 14, tier) + 5
    args = _pencil(device, 52, 14, Bn, seed=7)
    bad = [a.clone() for a in args]
    bad[0][1, 0, 0] = float("nan")
    bad[1][4, :, 0] = 0.0          # B's first column: a zero pivot
    keep = torch.ones(Bn, dtype=torch.bool, device=device)
    keep[[1, 4]] = False
    before = (cycle_reduction_policy.onchip_launches,
              cycle_reduction.onchip_launches)
    clean, got = k1(*args, CR_ITERS), k1(*bad, CR_ITERS)
    for g, c in zip(got, clean):
        assert torch.equal(g[keep], c[keep])
    assert not torch.isfinite(got[0][1]).all()
    assert not bool(got[2][4, 0] > 1e-7)   # min |pivot|: 0, or NaN after it
    ok = cycle_reduction_policy(*bad, n_iter=CR_ITERS)[2]
    assert not ok[1] and not ok[4] and bool(ok[keep].all())
    clean4, got4 = k4(*args[:3], CR_ITERS), k4(*bad[:3], CR_ITERS)
    for g, c in zip(got4, clean4):
        assert torch.equal(g[keep], c[keep])
    ok4 = cycle_reduction(*bad[:3], n_iter=CR_ITERS)[1]
    assert not ok4[1] and not ok4[4] and bool(ok4[keep].all())
    own = 2 if tier == "onchip" else 0
    assert (cycle_reduction_policy.onchip_launches,
            cycle_reduction.onchip_launches) == (before[0] + own + 1,
                                                 before[1] + own + 1)


def test_cycle_reduction_tiers_follow_the_library(device):
    """``cr_tier``'s reckoning of the two shared-memory layouts equals the
    library's (``gcp_cr_policy_smem_bytes``, ``gcp_cr_onchip_smem_bytes``),
    and its small-state edge is ``gcp_cr_fits``, at every n to 130 and m of
    0, 7, 14 and 120; so does :func:`cr_cluster_plan` the cluster launch's
    cut (``gcp_cr_cluster_ctas``, ``_rows``, ``_smem_bytes``)."""
    from geconpy_torch.ops import _cuda
    from geconpy_torch.ops.batched_cycle_reduction import (cr_cluster_plan,
                                                           cr_layout_bytes,
                                                           cr_tier)

    lib = _cuda.library()
    limit = lib.gcp_smem_optin()
    assert limit == torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    for n in range(1, 131):
        for m in (0, 7, 14, 120):
            size = cr_layout_bytes(n, m)
            assert size["onchip"] == lib.gcp_cr_onchip_smem_bytes(n, m)
            if lib.gcp_cr_draws_per_block(n, m) == 1:
                assert size["small"] == lib.gcp_cr_policy_smem_bytes(n, m)
            assert (cr_tier(n, m, limit) == "small") == bool(
                lib.gcp_cr_fits(n, m))
            plan = cr_cluster_plan(n, m, limit) or (0, 0, 0)
            assert plan == (lib.gcp_cr_cluster_ctas(n, m),
                            lib.gcp_cr_cluster_rows(n, m),
                            lib.gcp_cr_cluster_smem_bytes(n, m))


# ---- K3 on ragged shapes: synthetic stable tails from a seed

TAIL_NK = [(n, k) for n in (1, 7, 26, 32, 33, 64) for k in (1, 7, 9)]
TAIL_STEPS = 40


def _tail_inputs(device, n, k, batch, seed, steps=TAIL_STEPS):
    """float64 (y, M, TK, Z, d, F^{-1}, const, x0) with M of spectral
    radius 0.9 and F^{-1} positive definite."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((batch, n, n))
    M *= 0.9 / np.abs(np.linalg.eigvals(M)).max(axis=-1)[:, None, None]
    TK = 0.3 * rng.standard_normal((batch, n, k))
    Z = rng.standard_normal((batch, k, n))
    d = 0.1 * rng.standard_normal((batch, k))
    E = rng.standard_normal((batch, k, k))
    Finv = E @ E.transpose(0, 2, 1) / k + np.eye(k)
    const = rng.standard_normal(batch)
    x0 = rng.standard_normal((batch, n))
    y = rng.standard_normal((steps, k))
    return [torch.as_tensor(a, device=device)
            for a in (y, M, TK, Z, d, Finv, const, x0)]


@pytest.mark.parametrize("batch", [1, 5, 67])
@pytest.mark.parametrize("n,k", TAIL_NK)
def test_filter_tail_kernel_matches_plain_on_ragged_shapes(device, n, k,
                                                           batch):
    args = _tail_inputs(device, n, k, batch, seed=100 * n + k)
    before = filter_tail.launches
    ll = filter_tail(*args)
    assert filter_tail.launches == before + 1
    assert ll.shape == (batch,) and _rel(ll, _filter_tail_plain(*args)) < 1e-12
    # float32, the sweep's dtype: the sweep's bar against the plain version
    # on the same rounded inputs
    args32 = [a.float() for a in args]
    ll32 = filter_tail(*args32)
    assert ll32.dtype == torch.float32
    assert _rel(ll32, _filter_tail_plain(*args32)) < 5e-4


@pytest.mark.parametrize("n", [26, 64])
def test_filter_tail_kernel_nan_draw_poisons_only_itself(device, n):
    """A NaN draw between good draws of one block: the good ones are
    bitwise what they are without it."""
    args = _tail_inputs(device, n, 7, 9, seed=3)
    bad = [a.clone() for a in args]
    bad[1][2, 0, 0] = float("nan")      # M of draw 2
    clean, got = filter_tail(*args), filter_tail(*bad)
    keep = [0, 1, 3, 4, 5, 6, 7, 8]
    assert torch.isnan(got[2])
    assert torch.equal(got[keep], clean[keep])


def test_filter_tail_kernel_refuses_more_states_than_it_holds(device):
    """n = 65 and k = 33, beyond the small-state kernel's registers (these
    raised before the large-state kernel): both run the large-state variant,
    float64 within 1e-12 of the plain version, float32 within 5e-4."""
    for n, k in ((65, 3), (40, 33)):
        args = _tail_inputs(device, n, k, 5, seed=1)
        before = filter_tail.large_launches
        assert _rel(filter_tail(*args), _filter_tail_plain(*args)) < 1e-12
        assert filter_tail.large_launches == before + 1
        args32 = [a.float() for a in args]
        assert _rel(filter_tail(*args32), _filter_tail_plain(*args32)) < 5e-4


@pytest.mark.parametrize("batch", [1, 67])
@pytest.mark.parametrize("n,k", [(64, 7), (65, 7), (104, 7), (130, 7),
                                 (300, 5), (40, 33)])
def test_filter_tail_kernel_at_large_states(device, n, k, batch):
    """Either side of the small-state kernel's n <= 64, the filter state of
    104 of SW-2007 with year-on-year inflation, a stacked step too large to
    sit in shared memory in float64 (n = 300) and k > 32: the variant the
    wrapper records, float64 within 1e-12 of the plain version."""
    args = _tail_inputs(device, n, k, batch, seed=n + k)
    before = filter_tail.large_launches
    assert _rel(filter_tail(*args), _filter_tail_plain(*args)) < 1e-12
    assert filter_tail.large_launches - before == (n > 64 or k > 32)


def test_large_filter_tail_kernel_nan_draw_poisons_only_itself(device):
    args = _tail_inputs(device, 104, 7, 9, seed=3)
    bad = [a.clone() for a in args]
    bad[1][2, 0, 0] = float("nan")      # M of draw 2
    clean, got = filter_tail(*args), filter_tail(*bad)
    keep = [0, 1, 3, 4, 5, 6, 7, 8]
    assert torch.isnan(got[2])
    assert torch.equal(got[keep], clean[keep])


# ---- K6 on ragged shapes: synthetic stable systems from a seed

DARE_NK = [(n, k) for n in (1, 9, 17, 26, 32, 40) for k in (1, 7, 9)]


def _dare_inputs(device, n, k, batch, seed, h_scale=1.0):
    """float64 (T, R Q R', Z, H): T of spectral radius 0.9, R Q R' positive
    definite, H = h_scale times a positive definite matrix."""
    _y, T, RQR, Z, H, _d = _stable_system(n, k, batch, 1, seed)
    return [torch.as_tensor(a, device=device)
            for a in (T, RQR, Z, h_scale * H)]


@pytest.mark.parametrize("batch", [1, 5, 67])
@pytest.mark.parametrize("n,k", DARE_NK)
def test_dare_kernel_matches_plain_on_ragged_shapes(device, n, k, batch):
    args = _dare_inputs(device, n, k, batch, seed=100 * n + k)
    before = dare_settle.launches
    P = dare_settle(*args)
    assert dare_settle.launches == before + 1
    P0 = _dare_plain(*args)
    assert P.shape == P0.shape and _rel(P, P0) < 1e-11
    assert torch.equal(P, P.mT)      # sym is exact, as in the reference
    # float32 I/O around the float64 recursion: the plain version's P
    # rounded to float32, up to the rounding of a last-place difference
    args32 = [a.float() for a in args]
    P32 = dare_settle(*args32)
    assert P32.dtype == torch.float32
    assert _rel(P32, _dare_plain(*args32)) < 1e-6


@pytest.mark.parametrize("n,k", [(26, 7), (9, 3)])
def test_dare_kernel_without_measurement_error(device, n, k):
    """H = 0, as on SW-2007: the fixed point the open-loop start leads to,
    as the plain version finds it, and settled by the residual gate."""
    args = _dare_inputs(device, n, k, 5, seed=11, h_scale=0.0)
    P = dare_settle(*args)
    P0 = _dare_plain(*args)
    assert _rel(P, P0) < 1e-11
    assert bool(dare_residual_settled(*args, P).all())


def test_dare_kernel_nan_draw_poisons_only_itself(device):
    args = _dare_inputs(device, 26, 7, 9, seed=5)
    bad = [a.clone() for a in args]
    bad[0][1, 0, 0] = float("nan")      # T of draw 1
    clean, got = dare_settle(*args), dare_settle(*bad)
    keep = [0, 2, 3, 4, 5, 6, 7, 8]
    assert not torch.isfinite(got[1]).all()
    assert torch.equal(got[keep], clean[keep])


def _dare_tier(call):
    """The tier of K6 that ``call()`` launched through ``dare_settle``, read
    from its counters, and the call's result."""
    fn = dare_settle
    before = (fn.launches, fn.large_launches, fn.workspace_launches)
    out = call()
    after = (fn.launches, fn.large_launches, fn.workspace_launches)
    delta = tuple(a - b for a, b in zip(after, before))
    tiers = {(1, 0, 0): "small", (1, 1, 0): "cluster", (1, 1, 1): "workspace"}
    assert delta in tiers, delta
    return out, tiers[delta]


def _dare_edges(k) -> dict:
    """The n where K6's tiers meet at k observables: the last small-state
    n, the first and the last n of the cluster plan, the first n of the
    device-memory tier; and 104, SW-2007's filter state with year-on-year
    inflation."""
    from geconpy_torch.ops import _cuda

    lib = _cuda.library()
    small = _last_small_n(lambda m: lib.gcp_dare_fits(m, k))
    last = small + 1
    assert lib.gcp_dare_cluster_fits(last, k)
    while lib.gcp_dare_cluster_fits(last + 1, k):
        last += 1
    return {"last small": small, "first cluster": small + 1, "n = 104": 104,
            "last cluster": last, "first workspace": last + 1}


def test_dare_kernel_refuses_more_shared_memory_than_the_device_has(device):
    """n = 80, whose float64 layout exceeds a block's shared memory (this
    shape raised before the large-state tiers): it runs the cluster tier,
    as its counters show, within rel 1e-11 of the plain version."""
    args = _dare_inputs(device, 80, 7, 2, seed=1)
    P, tier = _dare_tier(lambda: dare_settle(*args))
    assert tier == "cluster"
    assert _rel(P, _dare_plain(*args)) < 1e-11
    assert torch.equal(P, P.mT)


@pytest.mark.parametrize("edge", ["last small", "first large"])
def test_dare_kernel_at_the_edge_of_the_small_state_plan(device, edge):
    from geconpy_torch.ops import _cuda

    lib = _cuda.library()
    n = _last_small_n(lambda m: lib.gcp_dare_fits(m, 7))
    n += edge == "first large"
    args = _dare_inputs(device, n, 7, 3, seed=n)
    before = dare_settle.large_launches
    P = dare_settle(*args)
    assert dare_settle.large_launches - before == (edge == "first large")
    assert _rel(P, _dare_plain(*args)) < 1e-11


def test_large_dare_kernel_nan_draw_poisons_only_itself(device):
    """K6 above its small-state plan (n = 70, the cluster tier) on more
    draws than the persistent grid holds at once: the NaN draw's cluster
    serves later draws, which are bitwise what they are without it."""
    args = _dare_inputs(device, 70, 7, 1100, seed=5)
    bad = [a.clone() for a in args]
    bad[0][1, 0, 0] = float("nan")      # T of draw 1
    before = dare_settle.large_launches
    clean, got = dare_settle(*args), dare_settle(*bad)
    assert dare_settle.large_launches == before + 2
    keep = torch.arange(1100, device=device) != 1
    assert not torch.isfinite(got[1]).all()
    assert torch.equal(got[keep], clean[keep])


DARE_TIER_OF_EDGE = {"last small": "small", "first cluster": "cluster",
                     "n = 104": "cluster", "last cluster": "cluster",
                     "first workspace": "workspace"}


@pytest.mark.parametrize("batch", ["3", "above the resident clusters"])
@pytest.mark.parametrize("k", [7, 14])
@pytest.mark.parametrize("edge", list(DARE_TIER_OF_EDGE))
def test_dare_tiers_match_plain(device, edge, k, batch):
    """K6 at the n where its three tiers meet (small-state, cluster,
    device-memory) and at n = 104, k = 7 and 14, on 3 draws or on more
    draws than the cluster plan's resident clusters (the persistent grid
    strides over the batch): the tier the counters record is the one the
    size takes, float64 within rel 1e-9 of the plain version with the same
    draws settled (``dare_residual_settled``) and P exactly symmetric, and
    float32 I/O within 5e-4 of the plain version on the same rounded
    inputs."""
    from geconpy_torch.ops import _cuda

    lib = _cuda.library()
    n = _dare_edges(k)[edge]
    want = DARE_TIER_OF_EDGE[edge]
    bn = 3 if batch == "3" else (
        lib.gcp_dare_cluster_resident(1, n, k) + 5 if want == "cluster"
        else 67)
    args = _dare_inputs(device, n, k, bn, seed=n + k)
    P, tier = _dare_tier(lambda: dare_settle(*args))
    assert tier == want, (n, k)
    P0 = _dare_plain(*args)
    assert P.shape == P0.shape and _rel(P, P0) < 1e-9, (n, k)
    assert torch.equal(P, P.mT)
    assert torch.equal(dare_residual_settled(*args, P),
                       dare_residual_settled(*args, P0))
    args32 = [a.float() for a in args]
    P32, tier32 = _dare_tier(lambda: dare_settle(*args32))
    assert tier32 == want
    assert P32.dtype == torch.float32
    assert _rel(P32, _dare_plain(*(a.double() for a in args32))) < 5e-4


def test_dare_cluster_tier_equals_the_device_memory_tier(device):
    """The cluster kernel and the device-memory kernel on the same inputs
    (n = 104, k = 7): the same sums in the same order, so the same P to the
    bit, without measurement error too (H = 0)."""
    from geconpy_torch.ops import _cuda
    from geconpy_torch.ops.batched_dare import _launch

    lib = _cuda.library()
    for h_scale in (1.0, 0.0):
        args = _dare_inputs(device, 104, 7, 9, seed=3, h_scale=h_scale)
        assert torch.equal(_launch(lib, "cluster", *args),
                           _launch(lib, "workspace", *args))


def test_dare_workspace_tier_nan_draw_poisons_only_itself(device):
    """K6 at the first n of its device-memory tier (k = 3) on more draws
    than the persistent grid holds at once: the NaN draw's workspace slot
    serves later draws, which are bitwise what they are without it."""
    from geconpy_torch.ops import _cuda

    lib = _cuda.library()
    n = _dare_edges(3)["first workspace"]
    slots = lib.gcp_dare_large_work_bytes(1, n, 3, 1 << 20) \
        // lib.gcp_dare_large_work_bytes(1, n, 3, 1)
    bn = slots + 40
    args = _dare_inputs(device, n, 3, bn, seed=9)
    bad = [a.clone() for a in args]
    bad[0][1, 0, 0] = float("nan")      # T of draw 1
    clean, t1 = _dare_tier(lambda: dare_settle(*args))
    got, t2 = _dare_tier(lambda: dare_settle(*bad))
    assert t1 == t2 == "workspace"
    keep = torch.arange(bn, device=device) != 1
    assert not torch.isfinite(got[1]).all()
    assert torch.equal(got[keep], clean[keep])


def test_fit_runs_its_chains_on_the_card(device):
    """A short ``fit`` on ``rbc_estimation`` on the GPU: the chains are
    finite, the draws came from the card, and K4 launched once for every
    value+grad call of the transitions (plus the start, its finiteness
    check and the curvature seed)."""
    from geconpy_torch.ops.batched_cycle_reduction import cycle_reduction

    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"))
    ss = DSGEStateSpace(model, device=device).configure(
        observed_states=["Y"], constant_params=["alpha", "sigma_C"],
        filter_type="stationary", kalman_settle=12)
    data, _ = ss.data_from_prior(torch.Generator(device=device).manual_seed(0),
                                 periods=48,
                                 params={"rho_A": 0.9, "sigma_A": 0.012})
    seen = []
    vag = ss.build_batched_logpost_and_grad(data)

    def watched(U, record=None):
        seen.append(U.device)
        return vag(U, record)

    ss._build_cache = {k: (watched if v is vag else v)
                         for k, v in ss._build_cache.items()}
    cycle_reduction.launches = 0
    res = geconpy_torch.fit(ss, data, num_chains=8, num_warmup=10,
                            num_samples=5, max_depth=4, policy="pallas",
                            pooled_adaptation=True, mass_init="hessian",
                            seed=0)
    assert res.samples.shape == (8, 5, 2)
    assert np.isfinite(res.samples).all() and np.isfinite(res.logp).all()
    assert res.unconstrained.dtype == np.float32
    assert seen and all(d.type == "cuda" for d in seen)
    assert cycle_reduction.launches == len(seen) + 1
    assert len(seen) == 1 + 1 + int(res.n_calls.sum())


# ---- the sequential filter and the XLA policy on the card

def _rbc_entry(device):
    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"))
    kw = dict(observed_states=["Y"], constant_params=["alpha", "sigma_C"],
              filter_type="sequential")
    ss = DSGEStateSpace(model, device=device).configure(**kw)
    ss_cpu = DSGEStateSpace(model, device="cpu").configure(**kw)
    data, draw = ss.data_from_prior(
        torch.Generator(device=device).manual_seed(0), periods=64)
    return ss, ss_cpu, data, ss.unconstrain(draw)


def test_build_logpost_on_the_card_equals_the_cpu(device):
    """The ``entry()`` twin: value at rel 1e-8, gradient at 1e-6, and no
    kernel launched (the XLA policy and the sequential filter are plain
    PyTorch)."""
    ss, ss_cpu, data, u0 = _rbc_entry(device)
    counted = (cycle_reduction, cycle_reduction_policy, settle_parts,
               filter_tail, settle_filter_loglik, dare_settle)
    for fn in counted:
        fn.launches = 0
    out = []
    for space, u in ((ss, u0), (ss_cpu, u0.cpu())):
        u = u.detach().requires_grad_(True)
        val = space.build_logpost(data)(u)
        (grad,) = torch.autograd.grad(val, u)
        out.append((float(val.detach()), grad.cpu()))
    assert all(fn.launches == 0 for fn in counted)
    (v, g), (v_cpu, g_cpu) = out
    assert np.isfinite(v) and abs(v - v_cpu) <= 1e-8 * abs(v_cpu)
    assert float((g - g_cpu).abs().max()) <= 1e-6 * float(g_cpu.abs().max())


def test_sequential_value_and_grad_on_the_card_equals_the_cpu(device):
    """SW-2007 (7 estimated parameters, 7 observables) on the sequential
    filter, float32 draws: K4 once, values within rel 5e-4 and gradients
    within 1e-3 of the float64 CPU path (phase 8b's bars)."""
    model = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn("sw2007"))
    kw = dict(observed_states=["y", "c", "inve", "w", "pinf", "r", "lab"],
              filter_type="sequential",
              constant_params=[p for p in model.param_names if p not in SW_EST])
    ss = DSGEStateSpace(model, device=device).configure(**kw)
    ss_cpu = DSGEStateSpace(model, device="cpu").configure(**kw)
    data, draw = ss.data_from_prior(
        torch.Generator(device=device).manual_seed(0), periods=60)
    u0 = ss.unconstrain(draw)
    U = (u0[None] + 0.05 * torch.as_tensor(
        np.random.default_rng(0).standard_normal((32, len(u0))),
        device=device)).float()
    cycle_reduction.launches = 0
    vals, grads = ss.build_batched_logpost_and_grad(data)(U)
    assert cycle_reduction.launches == 1
    v_ref, g_ref = ss_cpu.build_batched_logpost_and_grad(data)(
        U.double().cpu())
    ok = torch.isfinite(v_ref)
    assert ok.float().mean() >= 0.99 and torch.isfinite(grads).all()
    rel_v = ((vals.double().cpu() - v_ref).abs() / (1 + v_ref.abs()))[ok]
    rel_g = ((grads.double().cpu() - g_ref).abs().amax(-1)
             / (1 + g_ref.abs().amax(-1)))[ok]
    assert float(rel_v.max()) <= 5e-4 and float(rel_g.max()) <= 1e-3


def test_xla_policy_sweep_launches_the_settle_kernels_only(device):
    """``build_batched_loglik(policy="xla", settle="pallas")``: K2 and K3
    launch, K1 does not, and the values agree with the
    ``policy="pallas"`` sweep at rel 5e-4 (float32)."""
    model = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn("sw2007"))
    ss = DSGEStateSpace(model, device=device).configure(
        observed_states=["y", "c", "inve", "w", "pinf", "r", "lab"],
        filter_type="steady_state", kalman_settle=32,
        constant_params=[p for p in model.param_names if p not in SW_EST])
    data, draw = ss.data_from_prior(
        torch.Generator(device=device).manual_seed(0), periods=80)
    u0 = ss.unconstrain(draw)
    U = (u0[None] + 0.05 * torch.as_tensor(
        np.random.default_rng(1).standard_normal((64, len(u0))),
        device=device)).float()
    for fn in (cycle_reduction_policy, settle_parts, filter_tail):
        fn.launches = 0
    out = ss.build_batched_loglik(data, n_settle=32, policy="xla",
                                  settle="pallas")(U)
    assert settle_parts.launches == 1 and filter_tail.launches == 1
    assert cycle_reduction_policy.launches == 0
    ref = ss.build_batched_loglik(data, n_settle=32, policy="pallas",
                                  settle="pallas")(U)
    both = torch.isfinite(out) & torch.isfinite(ref)
    assert both.float().mean() >= 0.99
    rel = ((out.double() - ref.double()).abs() / (1 + ref.double().abs()))[both]
    assert float(rel.max()) <= 5e-4


def test_batched_newton_on_the_card_equals_the_cpu(device):
    """The numeric steady state of ``open_rbc`` (10 unknowns) at 64 draws
    around its calibration: the same iterations, flags and draws sent to
    LM as on the CPU, x_ss at rel 1e-10 (each parameter moved by 0.5%
    a draw, from a seed)."""
    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("open_rbc"))
    theta = model.default_theta()[None] * (1 + 0.005 * torch.as_tensor(
        np.random.default_rng(0).standard_normal((64, len(model.param_names))),
        dtype=torch.float64))
    solve = model.ss_solver
    got = solve(theta.to(device))
    lm_card = int(solve.lm_draws)
    want = solve(theta)
    assert lm_card == int(solve.lm_draws)
    assert torch.equal(got.success.cpu(), want.success)
    assert torch.equal(got.n_iter.cpu(), want.n_iter)
    assert bool(want.success.all())
    rel = (got.x_ss.cpu() - want.x_ss).abs() / want.x_ss.abs().clamp(min=1e-12)
    assert float(rel.max()) <= 1e-10


def test_implicit_gradient_is_finite_at_batch_512(device):
    """The steady state's implicit adjoint inside the value+grad path:
    ``open_rbc`` on the stationary filter with K4 and K6, batch 512, every
    gradient finite."""
    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("open_rbc"))
    ss = DSGEStateSpace(model, device=device).configure(
        observed_states=["Y"], filter_type="stationary")
    data, draw = ss.data_from_prior(
        torch.Generator(device=device).manual_seed(0), periods=64)
    u0 = ss.unconstrain(draw)
    U = u0[None] + 0.05 * torch.as_tensor(
        np.random.default_rng(0).standard_normal((512, len(u0))),
        device=device)
    cycle_reduction.launches = dare_settle.launches = 0
    vals, grads = ss.build_batched_logpost_and_grad(data, settle="pallas")(U)
    assert cycle_reduction.launches == 1 and dare_settle.launches == 1
    assert torch.isfinite(vals).float().mean() >= 0.99
    assert bool(torch.isfinite(grads).all())


@pytest.mark.parametrize("name", ["rbc", "sw2007"])
@pytest.mark.parametrize("solver", ["cycle_reduction", "gensys",
                                    "gensys_host"])
def test_solve_model_on_the_card_equals_the_cpu(device, name, solver):
    """``solve_model`` runs on the card by default; T and R there are the
    CPU's within rel 1e-10, with the same flags."""
    model = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn(name),
                                         verbose=False)
    gpu = model.solve_model(solver=solver, verbose=False)
    cpu = model.solve_model(solver=solver, verbose=False, device="cpu")
    assert gpu.T.device.type == "cuda" and gpu.success and cpu.success
    assert (gpu.solver, gpu.eu) == (cpu.solver, cpu.eu)
    for a, b in ((gpu.T, cpu.T), (gpu.R, cpu.R)):
        gap = float((a.cpu() - b).abs().max() / b.abs().max())
        assert gap < 1e-10, (name, solver, gap)


def test_backward_solve_model_on_the_card_equals_the_cpu(device):
    import pathlib

    path = pathlib.Path(__file__).parent / "_gcn_fixtures" / "backward_var.gcn"
    model = geconpy_torch.model_from_gcn(path, verbose=False)
    gpu = model.solve_model(verbose=False)
    cpu = model.solve_model(verbose=False, device="cpu")
    assert gpu.solver == "backward" and gpu.T.device.type == "cuda"
    torch.testing.assert_close(gpu.T.cpu(), cpu.T, rtol=1e-12, atol=1e-14)


def test_batched_gensys_on_the_card_equals_solo_cpu_runs(device):
    """The device gensys over a batch of ``nk_3eq`` pencils (determinate,
    indeterminate and singular draws) on the card: each draw's T, R and
    flags as its solo run on the CPU (rel 1e-10)."""
    from geconpy_torch.ops.gensys_jax import make_gensys_solver

    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("nk_3eq"), verbose=False)
    lins = [model.linearize_model(device="cpu", **kw) for kw in
            (dict(), dict(phi_pi=2.0), dict(phi_pi=0.5, phi_x=0.0))]
    pencils = [tuple(lin[k] for k in "ABCD") for lin in lins]
    pencils.append(tuple(torch.zeros_like(X) for X in pencils[0]))
    solve = make_gensys_solver(model.n_variables, model.lead_var_idx,
                               model.n_shocks)
    batch = solve(*(torch.stack([p[i] for p in pencils]).to(device)
                    for i in range(4)))
    assert batch.success.tolist() == [True, True, False, False]
    for b, p in enumerate(pencils):
        solo = solve(*p)
        for key in ("existence", "uniqueness", "success", "split_dim"):
            assert getattr(batch, key)[b].item() == getattr(solo, key).item()
        if bool(solo.success):
            for X, Y in ((batch.T[b], solo.T), (batch.R[b], solo.R)):
                assert float((X.cpu() - Y).abs().max() / Y.abs().max()) < 1e-10


FILTER_CONFIGS = {
    "stationary_sda": dict(filter_type="stationary",
                           kalman_settle_method="sda"),
    "stationary_auto": dict(filter_type="stationary",
                            kalman_settle_method="auto"),
    "steady_state": dict(filter_type="steady_state"),
    "chandrasekhar": dict(filter_type="chandrasekhar"),
    "parallel": dict(filter_type="parallel"),
    "parallel_diffuse": dict(filter_type="parallel", p0_init="diffuse",
                             diffuse_kappa=1e4, diffuse_presample=2),
    "mixed_frequency": dict(filter_type="stationary", observed_states=["Y_q"],
                            aggregate={"Y_q": ("Y", "sum", 3)}),
}


@pytest.mark.parametrize("config", list(FILTER_CONFIGS))
def test_filters_on_the_card_equal_the_cpu(device, config):
    """Every filter of the likelihood on ``rbc_estimation`` (Y, or its
    quarterly sum observed every third period): ``build_logpost``'s value
    at rel 1e-8 and gradient at 1e-6 of the same call on the CPU, no kernel
    launched; ``build_batched_logpost(settle="pallas")`` over 16 draws at
    rel 1e-8, K4 once and, on the mixed-frequency data, K6 never."""
    from geconpy_torch.stats.posterior import prepare_mixed_frequency_data

    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"))
    kw = dict(dict(observed_states=["Y"],
                   constant_params=["alpha", "sigma_C"]),
              **FILTER_CONFIGS[config])
    ss = DSGEStateSpace(model, device=device).configure(**kw)
    ss_cpu = DSGEStateSpace(model, device="cpu").configure(**kw)
    data, draw = ss.data_from_prior(
        torch.Generator(device=device).manual_seed(0), periods=60)
    if config == "mixed_frequency":
        data = prepare_mixed_frequency_data(data[2::3], period=3,
                                            n_high_freq=60)
    u0 = ss.unconstrain(draw)
    counted = (cycle_reduction, cycle_reduction_policy, settle_parts,
               filter_tail, settle_filter_loglik, dare_settle)
    for fn in counted:
        fn.launches = 0
    out = []
    for space, u in ((ss, u0), (ss_cpu, u0.cpu())):
        u = u.detach().requires_grad_(True)
        val = space.build_logpost(data)(u)
        (grad,) = torch.autograd.grad(val, u)
        out.append((float(val.detach()), grad.cpu()))
    assert all(fn.launches == 0 for fn in counted)
    (v, g), (v_cpu, g_cpu) = out
    assert np.isfinite(v) and abs(v - v_cpu) <= 1e-8 * abs(v_cpu)
    assert float((g - g_cpu).abs().max()) <= 1e-6 * float(g_cpu.abs().max())
    if config == "parallel_diffuse":
        return
    U = u0[None] + 0.05 * torch.as_tensor(
        np.random.default_rng(0).standard_normal((16, len(u0))), device=device)
    vals = ss.build_batched_logpost(data, settle="pallas")(U)
    assert cycle_reduction.launches == 1
    assert dare_settle.launches == (1 if config.startswith("stationary")
                                    else 0)
    ref = ss_cpu.build_batched_logpost(data, settle="pallas")(U.cpu())
    ok = torch.isfinite(ref)
    assert ok.all() and torch.isfinite(vals).all()
    assert float(((vals.cpu() - ref).abs() / ref.abs()).max()) <= 1e-8


def test_smoothers_and_posterior_tools_on_the_card_equal_the_cpu(device):
    """``filter_data`` (filtered and smoothed), ``disturbance_smoother``
    and ``historical_shock_decomposition`` on the card within rel 1e-10 of
    the CPU on ``rbc_estimation`` with Y and C observed."""
    from geconpy_torch.ops.kalman import disturbance_smoother
    from geconpy_torch.stats.estimation import PosteriorResult
    from geconpy_torch.stats.posterior import historical_shock_decomposition

    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"))
    kw = dict(observed_states=["Y", "C"], measurement_error=["Y", "C"])
    ss = DSGEStateSpace(model, device=device).configure(**kw)
    ss_cpu = DSGEStateSpace(model, device="cpu").configure(**kw)
    data, draw = ss.data_from_prior(
        torch.Generator(device=device).manual_seed(0), periods=40)

    def gap(a, b):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        return float((a - b).abs().max() / b.abs().max())

    for smoother in (False, True):
        got = ss.filter_data(data, params=draw, smoother=smoother)
        want = ss_cpu.filter_data(data, params=draw, smoother=smoother)
        assert got.paths.device.type == "cuda"
        assert gap(got.paths, want.paths) <= 1e-10
        assert abs(float(got.loglik) - float(want.loglik)) \
            <= 1e-10 * abs(float(want.loglik))
    sol = ss.build_solution_fn(full_state=True)(ss.unconstrain(draw))
    sol_cpu = {k_: v_.cpu() for k_, v_ in sol.items()}
    args = ("T_aug", "R_aug", "Q", "Z", "H")
    y = torch.as_tensor(data, device=device)
    got = disturbance_smoother(y, *(sol[a] for a in args), d=sol["d"])
    want = disturbance_smoother(y.cpu(), *(sol_cpu[a] for a in args),
                                d=sol_cpu["d"])
    for a, b in zip(got, want):
        assert gap(a, b) <= 1e-10
    u0 = ss.unconstrain(draw).cpu().numpy()
    us = u0[None, None] + 0.04 * np.random.default_rng(0).standard_normal(
        (1, 6, len(u0)))
    result = PosteriorResult(
        samples=us, unconstrained=us, logp=np.zeros((1, 6)),
        param_names=ss.param_labels, diverging=np.zeros((1, 6), bool),
        accept_prob=np.ones((1, 6)), step_size=np.full(1, 0.1))
    dec = historical_shock_decomposition(ss, result, data)
    dec_cpu = historical_shock_decomposition(ss_cpu, result, data)
    for a, b in zip(dec[:3], dec_cpu[:3]):
        assert gap(a, b) <= 1e-10


def _rel_max(a, b):
    """max |a - b| / max |b|, the finiteness equal."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    assert torch.equal(torch.isfinite(a), torch.isfinite(b))
    ok = torch.isfinite(b)
    return float((a - b)[ok].abs().max() / b[ok].abs().max().clamp(min=1e-300))


def _float_fields(out):
    if isinstance(out, torch.Tensor):
        return [out] if out.is_floating_point() else []
    if isinstance(out, tuple):
        return [t for x in out for t in _float_fields(x)]
    return []


@pytest.fixture(scope="module")
def rbc_posterior(device):
    """``rbc_estimation`` with Y and C observed with measurement error, on
    the card and the CPU, 40 periods of data and 2 x 4 jittered draws."""
    from geconpy_torch.stats.estimation import PosteriorResult

    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"))
    kw = dict(observed_states=["Y", "C"], measurement_error=["Y", "C"])
    ss = DSGEStateSpace(model, device=device).configure(**kw)
    ss_cpu = DSGEStateSpace(model, device="cpu").configure(**kw)
    data, draw = ss.data_from_prior(
        torch.Generator(device=device).manual_seed(0), periods=40)
    u0 = ss.unconstrain(draw).cpu().numpy()
    us = u0[None, None] + 0.04 * np.random.default_rng(0).standard_normal(
        (2, 4, len(u0)))
    result = PosteriorResult(
        samples=us, unconstrained=us, logp=np.zeros((2, 4)),
        param_names=ss.param_labels, diverging=np.zeros((2, 4), bool),
        accept_prob=np.ones((2, 4)), step_size=np.full(2, 0.1))
    return ss, ss_cpu, result, data


@pytest.mark.parametrize("name", ["posterior_irfs", "posterior_autocorrelation",
                                  "posterior_fevd", "posterior_diagnostics"])
def test_posterior_bands_on_the_card_equal_the_cpu(rbc_posterior, name):
    """Each band function on the card within rel 1e-10 of the CPU on the
    same draws, no kernel launched."""
    from geconpy_torch.stats import posterior

    ss, ss_cpu, result, _ = rbc_posterior
    fn = getattr(posterior, name)
    cycle_reduction.launches = 0
    got, want = fn(ss, result), fn(ss_cpu, result)
    assert cycle_reduction.launches == 0
    assert all(t.device.type == "cuda" for t in _float_fields(got))
    for a, b in zip(_float_fields(got), _float_fields(want)):
        if name == "posterior_diagnostics":     # rounding-level norms
            a = a.cpu()
            assert float(((a - b).abs() / (1 + b.abs())).max()) <= 1e-10
        else:
            assert _rel_max(a, b) <= 1e-10
    if name == "posterior_diagnostics":
        for f in ("ss_success", "solver_success", "stable"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f))


def test_predictive_and_forecasts_on_the_card_equal_the_cpu(rbc_posterior,
                                                            device):
    """``posterior_predictive``'s and ``posterior_forecast``'s paths on the
    same normals, and the terminal filtered state, within rel 1e-10 / 1e-8
    of the CPU; both reproduce bitwise under one seed on the card;
    ``conditional_forecast`` within rel 1e-8 and on its conditions."""
    from geconpy_torch.stats import forecast, posterior

    ss, ss_cpu, result, data = rbc_posterior
    sols = [s.build_solution_fn()(posterior._flat_draws(s, result, None))
            for s in (ss, ss_cpu)]
    g = torch.Generator().manual_seed(3)
    eps = torch.randn((8, 20, 1), generator=g, dtype=torch.float64)
    eta = torch.randn((8, 20, 2), generator=g, dtype=torch.float64)
    assert _rel_max(posterior._predictive_paths(sols[0], eps.to(device),
                                            eta.to(device)),
                posterior._predictive_paths(sols[1], eps, eta)) <= 1e-10
    runs = [posterior.posterior_predictive(
        ss, result, torch.Generator(device=device).manual_seed(1),
        periods=20) for _ in range(2)]
    assert torch.equal(runs[0].quantiles, runs[1].quantiles)
    full = [s.build_solution_fn(full_state=True)(
        posterior._flat_draws(s, result, None)) for s in (ss, ss_cpu)]
    term = [forecast._terminal_state(s, sol, data)
            for s, sol in zip((ss, ss_cpu), full)]
    for a, b in zip(*term):
        assert _rel_max(a, b) <= 1e-8
    fans = [forecast.posterior_forecast(ss, result, data, horizon=6, seed=2)
            for _ in range(2)]
    assert torch.equal(fans[0].mean, fans[1].mean)
    assert fans[0].mean.device.type == "cuda"
    cond = {"Y": np.full(3, float(data[-1, 0]))}
    kw = dict(horizon=6, quantiles=(0.0, 0.5, 1.0))
    got = forecast.conditional_forecast(ss, result, data, cond, **kw)
    want = forecast.conditional_forecast(ss_cpu, result, data, cond, **kw)
    for a, b in zip(_float_fields(got), _float_fields(want)):
        assert _rel_max(a, b) <= 1e-8
    assert float((got[0].quantiles[:, 0, :3] - cond["Y"][0]).abs().max()) \
        <= 1e-8 * (1 + abs(cond["Y"][0]))


def test_evidence_and_ml_on_the_card_equal_the_cpu(device):
    """The Laplace evidence at the card's mode on both devices, within
    0.5 d κ(H) 1e-6 (the CPU tests' bar); ``fit_ml`` on the card with the
    CPU's log-likelihood (rel 1e-8) and standard errors (κ(H) 1e-6) at its
    maximum; ``compare_models`` probabilities sum to 1."""
    from geconpy_torch.stats.ml import _gated_loglik, _standard_errors, fit_ml
    from geconpy_torch.stats.model_comparison import (compare_models,
                                                      find_map,
                                                      laplace_evidence,
                                                      neg_hessian_fn)

    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"))
    kw = dict(observed_states=["Y"], constant_params=["alpha", "sigma_C"],
              filter_type="stationary", kalman_settle=12)
    ss = DSGEStateSpace(model, device=device).configure(**kw)
    ss_cpu = DSGEStateSpace(model, device="cpu").configure(**kw)
    data, _ = ss.data_from_prior(torch.Generator(device=device).manual_seed(2),
                                 periods=60, params={"rho_A": 0.6})
    cut = dict(adam_steps=30, learning_rate=0.1)
    vag = ss.build_logpost_and_grad(data)
    u = find_map(vag, ss.initial_position(), **cut)
    vag_cpu = ss_cpu.build_logpost_and_grad(data)
    H = neg_hessian_fn(vag_cpu)(u.cpu()).numpy()
    bar = 0.5 * len(u) * np.linalg.cond(H) * 1e-6
    assert abs(laplace_evidence(vag, u) - laplace_evidence(vag_cpu, u.cpu())) \
        <= bar
    res = fit_ml(ss, data, **cut)
    u_hat = torch.as_tensor(res.unconstrained)
    ll_cpu = _gated_loglik(ss_cpu, data)
    se, H_ll = _standard_errors(ss_cpu, ll_cpu, u_hat)
    assert abs(res.loglik - float(ll_cpu(u_hat[None])[0][0])) \
        <= 1e-8 * abs(res.loglik)
    got = np.asarray([res.std_errors[k] for k in ss.param_labels])
    np.testing.assert_allclose(got, se, rtol=np.linalg.cond(H_ll) * 1e-6)
    twin = DSGEStateSpace(model, device=device).configure(
        **dict(kw, constant_params=["alpha", "sigma_C", "rho_A"]))
    table = compare_models({"full": ss, "twin": twin}, data, **cut)
    assert abs(float(table.posterior_prob.sum()) - 1.0) < 1e-12


def test_diagnostic_sweeps_on_the_card_equal_the_cpu(device):
    """``solvability_check`` and ``bk_condition_sweep`` flags and counts
    equal to the CPU (norms rel 1e-8 as |a - b| / (1 + |b|)), the P/Q/R/S
    tables and ``spectral_radius_sensitivity`` at rel 1e-10,
    ``eigenvalue_sensitivity``'s finite nonzero roots at rel 1e-8 of the
    largest (derivatives 1e-4 of each root's largest), ``check_steady_state`` true, and the prior
    predictive core at rel 1e-10; ``sample_from_priors`` with its defaults
    draws on the card, as its seed and device say; no kernel launched."""
    from geconpy_torch.models.validation import check_steady_state
    from geconpy_torch.stats import perturbation_diagnostics as pdiag
    from geconpy_torch.stats import prior_predictive
    from geconpy_torch.stats.sampling import sample_from_priors

    nk = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn("nk_3eq"))
    phi = {"phi_pi": np.random.default_rng(1).uniform(0.3, 2.5, size=24)}
    for fn, fields in ((pdiag.solvability_check,
                        ("steady_state", "linearization", "policy_solve",
                         "stability", "residual_norms", "success")),
                       (pdiag.bk_condition_sweep,
                        ("n_unstable", "n_forward", "bk_satisfied", "ok"))):
        got, want = fn(nk, phi, device=device), fn(nk, phi, device="cpu")
        for f in fields:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f))
    a = pdiag.solvability_check(nk, phi, device=device)
    b = pdiag.solvability_check(nk, phi, device="cpu")
    for f in ("spectral_radius", "deterministic_norm", "stochastic_norm"):
        x, y = getattr(a, f).cpu(), getattr(b, f)
        assert float(((x - y).abs() / (1 + y.abs())).max()) <= 1e-8
    rbc = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn("rbc"))
    t_g = rbc.solve_model(verbose=False).summary()
    t_c = rbc.solve_model(verbose=False, device="cpu").summary()
    for x, y in zip(_float_fields(t_g), _float_fields(t_c)):
        assert _rel_max(x, y) <= 1e-10
    assert _rel_max(pdiag.spectral_radius_sensitivity(rbc).d_rho_d_param,
                pdiag.spectral_radius_sensitivity(
                    rbc, device="cpu").d_rho_d_param) <= 1e-10
    e_g = pdiag.eigenvalue_sensitivity(rbc)
    e_c = pdiag.eigenvalue_sensitivity(rbc, device="cpu")
    lam_g, lam_c = e_g.eigenvalues.cpu().numpy(), e_c.eigenvalues.numpy()
    i_g = np.lexsort((lam_g.imag, np.abs(lam_g)))
    i_c = np.lexsort((lam_c.imag, np.abs(lam_c)))
    mod = np.abs(lam_c[i_c])
    keep = (mod > 1e-6) & (mod < 1e6)      # the finite, nonzero roots
    assert np.abs(lam_g[i_g] - lam_c[i_c])[keep].max() <= 1e-8 * mod.max()
    parts = ("real", "imag", "modulus")
    x = np.stack([getattr(e_g, p).cpu().numpy()[i_g][keep] for p in parts], 1)
    y = np.stack([getattr(e_c, p).numpy()[i_c][keep] for p in parts], 1)
    # each root's largest derivative over its parts (a real root's
    # imaginary part has derivatives of rounding size)
    scale = np.abs(y).max(axis=(1, 2), keepdims=True)
    assert (np.abs(x - y) / scale).max() <= 1e-4
    assert check_steady_state(rbc) is True
    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"))
    kw = dict(observed_states=["Y"], measurement_error=["Y"])
    ss = DSGEStateSpace(model, device=device).configure(**kw)
    ss_cpu = DSGEStateSpace(model, device="cpu").configure(**kw)
    U = prior_predictive._prior_draws(
        ss, 32, torch.Generator(device=device).manual_seed(0))
    assert U.device.type == "cuda"
    got = prior_predictive._sweep_core(ss, U, 12, 8, (0.05, 0.5, 0.95))
    want = prior_predictive._sweep_core(ss_cpu, U.cpu(), 12, 8,
                                        (0.05, 0.5, 0.95))
    for x, y in zip(_float_fields(got), _float_fields(want)):
        assert _rel_max(x, y) <= 1e-10
    priors = {p.name: p.prior for p in ss.estimated}
    draws = sample_from_priors(priors, 16)     # the defaults: the card
    again = sample_from_priors(priors, 16, seed=0, device=device)
    assert all(v.device.type == "cuda" for v in draws.values())
    assert all(torch.equal(draws[k], again[k]) for k in priors)


@pytest.mark.parametrize("name", ["rbc", "nk_sw"])
def test_second_order_solve_on_the_card_equals_the_cpu(device, name):
    """``solve_model_second_order`` on the card: the four blocks within rel
    1e-10 of the CPU's (of the largest entry), no kernel launched; the
    pruned paths, IRFs, mean and GIRF (on the same normals) likewise."""
    from geconpy_torch.models import second_order as so

    model = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn(name))
    cycle_reduction.launches = 0
    sol, res2 = model.solve_model_second_order(shock_std=0.01)
    sol_c, res2_c = model.solve_model_second_order(shock_std=0.01,
                                                   device="cpu")
    assert cycle_reduction.launches == 0
    assert res2.G_xx.device.type == "cuda" and bool(res2.success)
    scale = max(float(x.abs().max()) for x in res2_c[:4])
    for a, b in zip(res2[:4], res2_c[:4]):
        assert float((a.cpu() - b).abs().max()) <= 1e-10 * scale
    k = len(sol.shocks)
    eps = 0.01 * torch.randn((4, 30, k), generator=torch.Generator()
                             .manual_seed(0), dtype=torch.float64)
    Q = 1e-4 * torch.eye(k, dtype=torch.float64)
    shock = 0.01 * torch.eye(k, dtype=torch.float64)[0]
    pairs = [
        (so.simulate_pruned(sol.T, sol.R, res2, eps.to(device)),
         so.simulate_pruned(sol_c.T, sol_c.R, res2_c, eps)),
        (so.irf_second_order(sol.T, sol.R, res2, 0.02 * torch.eye(
            k, dtype=torch.float64, device=device)),
         so.irf_second_order(sol_c.T, sol_c.R, res2_c,
                             0.02 * torch.eye(k, dtype=torch.float64))),
        (so.second_order_mean(sol.T, sol.R, res2, Q.to(device)),
         so.second_order_mean(sol_c.T, sol_c.R, res2_c, Q)),
        (so._girf_from_normals(sol.T, sol.R, res2, shock.to(device),
                               Q.to(device), eps[:, :12].to(device)),
         so._girf_from_normals(sol_c.T, sol_c.R, res2_c, shock, Q,
                               eps[:, :12]))]
    for a, b in pairs:
        assert a.device.type == "cuda"
        assert _rel_max(a, b) <= 1e-10


@pytest.mark.parametrize("method", ["marginalized", "full"])
def test_second_order_logpost_on_the_card_equals_the_cpu(rbc_posterior,
                                                         method):
    """The second-order value+grad at 8 draws within rel 1e-8 / 1e-6 of the
    CPU; ``filter_data_second_order`` within rel 1e-8; the particle filter
    on the same normals within rel 1e-10; no kernel launched."""
    from geconpy_torch.stats import nonlinear

    ss, ss_cpu, result, data = rbc_posterior
    U = torch.as_tensor(result.unconstrained.reshape(-1, len(ss.estimated)))
    cycle_reduction.launches = 0
    v, g = ss.build_logpost_and_grad_second_order(data, method=method)(
        U.to(ss.device))
    v_c, g_c = ss_cpu.build_logpost_and_grad_second_order(
        data, method=method)(U)
    assert cycle_reduction.launches == 0
    assert bool(torch.isfinite(v).all())
    assert float(((v.cpu() - v_c).abs() / v_c.abs()).max()) <= 1e-8
    assert float((g.cpu() - g_c).abs().max()) <= 1e-6 * float(
        g_c.abs().max())
    fd = [nonlinear.filter_data_second_order(s, data, smoother=True)
          for s in (ss, ss_cpu)]
    for a, b in zip(_float_fields(fd[0]), _float_fields(fd[1])):
        assert _rel_max(a, b) <= 1e-8
    nz = 2 * ss.model.functions.n_variables
    g_ = torch.Generator().manual_seed(4)
    init = torch.randn((2, 256, nz), generator=g_, dtype=torch.float64)
    us = torch.rand((40, 2), generator=g_, dtype=torch.float64)
    n_shocks = len(ss.model.functions.shock_names)
    eps = torch.randn((40, 2, 256, n_shocks), generator=g_,
                      dtype=torch.float64)
    lls = []
    for s, dev in ((ss, ss.device), (ss_cpu, torch.device("cpu"))):
        pf = s.build_pf_loglik_second_order(data, n_particles=256)
        lls.append(pf.from_draws(U[:2].to(dev), init.to(dev),
                                 lambda t: (us[t].to(dev), eps[t].to(dev))))
    assert bool(lls[0][1].all())
    assert float(((lls[0][0].cpu() - lls[1][0]).abs()
                  / lls[1][0].abs()).max()) <= 1e-10


def test_second_order_estimation_runs_on_the_card(rbc_posterior, device):
    """``fit(order=2)``, ``fit_pmmh`` and ``posterior_girfs`` run their
    chains and draws on the card (finite, reproducible); the GIRF bands on
    the same normals within rel 1e-10 of the CPU."""
    from geconpy_torch.stats import nonlinear, posterior
    from geconpy_torch.stats.estimation import fit, fit_pmmh

    ss, ss_cpu, result, data = rbc_posterior
    res = fit(ss, data, num_chains=4, num_warmup=2, num_samples=2,
              max_depth=2, order=2, dtype=torch.float64)
    assert np.isfinite(res.logp).all()
    pm = fit_pmmh(ss, data, num_chains=2, num_warmup=5, num_samples=5,
                  n_particles=256)
    assert np.isfinite(pm.logp).all()
    us = posterior._flat_draws(ss_cpu, result, None)
    n_shocks = len(ss.model.functions.shock_names)
    normals = torch.randn((us.shape[0], 8, 6, n_shocks),
                          generator=torch.Generator().manual_seed(5),
                          dtype=torch.float64)
    paths = [posterior._girf_paths(nonlinear._solution_fn(s)(
        us.to(s._device())), 0, None, normals.to(s._device()))
        for s in (ss, ss_cpu)]
    assert _rel_max(paths[0], paths[1]) <= 1e-10
    runs = [posterior.posterior_girfs(
        ss, result, ss.model.functions.shock_names[0],
        torch.Generator(device=device).manual_seed(1), periods=6, n_mc=8)
        for _ in range(2)]
    assert torch.equal(runs[0].mean, runs[1].mean)
