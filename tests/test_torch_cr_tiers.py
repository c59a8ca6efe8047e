"""K1 and K4 above the small-state plan: the schedules of the tiers, on the
CPU.

The tiers (``ops/batched_cycle_reduction.py::cr_tier``): the small-state
kernel where one draw fits a block's shared memory (n <= 48), the on-chip
tier (one draw a CTA, n = 49..56 on an H100), the cluster tier (a draw a
thread-block cluster, n = 57..128), the device-memory tier beyond.  Every
tier runs the plain version's recursion (``_cr_recursion``): the same
doublings and pivots; the cluster tier's eliminations sum in panels.

- The plain K1 and K4 against the reference's kernels in interpret mode
  (``pallas_cycle_reduction_policy`` / ``pallas_cycle_reduction``) at
  (n, m) = (49, 7), (52, 14) and (64, 7), stable pencils from a numpy
  seed, at rel 1e-10 with equal success flags.
- The cluster tier eliminates in panels of ``CR_PANEL`` pivots
  (``ops/linalg.py::gj_eliminate_panels``): that schedule, at the kernel's
  panel width and at one pivot a panel, is held to the reference's kernels
  in the same cases, and takes the reference's pivots on ties.
- The on-chip tier's elimination (``csrc/cycle_reduction.cu::
  cr_eliminate_cols``) keeps its rows where they are and follows
  ``_gj_solve``'s row swaps as a permutation between physical rows and
  logical positions.  :func:`_eliminate_unmoved`, a numpy transcription of
  that schedule, equals :func:`_eliminate_moved`, one of the swapping
  schedule (``cr_eliminate``'s, with the kernels' 1 / pivot), to the bit,
  pivot for pivot, on pencils with many tied pivot magnitudes (a tie goes
  to the lower logical row, as ``jnp.argmax`` takes the first maximum) and
  with a NaN; the swapping one is held to the reference's ``_gj_solve`` at
  1e-12.  On a tied pencil the plain K1 meets the reference's kernel at
  1e-10.
- The tier is a pure function of (n, m) and the device's shared memory per
  block, here with the limits passed in (the H100's 232,448 B and others).

CPU, float64, one thread.
"""

import functools
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geconpy_torch.ops.batched_cycle_reduction import (CR_PANEL, _cr_plain,
                                                       _cr_policy_plain,
                                                       cr_cluster_plan,
                                                       cr_layout_bytes,
                                                       cr_tier)
from geconpy_torch.ops.linalg import gj_eliminate_panels
from geconpy_tpu.ops.pallas_cycle_reduction import (
    _gj_solve, pallas_cycle_reduction, pallas_cycle_reduction_policy)

N_ITER = 14
H100_OPTIN = 232_448   # cudaDevAttrMaxSharedMemoryPerBlockOptin, H100
BATCH = 3


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stable_pencil(n, m, batch, seed):
    """numpy float64 (A, B, C, D) with A + B T + C T^2 = 0 for a T of
    spectral radius 0.8 (``tools/cr_variants.py::stable_pencil``)."""
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((batch, n, n))
    T *= 0.8 / np.abs(np.linalg.eigvals(T)).max(axis=-1)[:, None, None]
    C = 0.3 * rng.standard_normal((batch, n, n)) / np.sqrt(n)
    M = 2.0 * np.eye(n) + 0.3 * rng.standard_normal((batch, n, n)) / np.sqrt(n)
    D = rng.standard_normal((batch, n, m))
    return -M @ T, M - C @ T, C, D


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all() and np.isfinite(b).all()
    return float((np.abs(a - b) / (1.0 + np.abs(b))).max())


# the plain schedules: every tier's but the cluster one's (None), the
# cluster tier's panels at the kernel's width and at 1 pivot a panel
SCHEDULES = (None, CR_PANEL, 1)


def _hold_to_reference(pencil):
    """The plain K1 (T, R, residual, success) and K4 (T, success) under
    each schedule against the reference's kernels in interpret mode."""
    T_r, R_r, ok_r, resid_r = jax.jit(functools.partial(
        pallas_cycle_reduction_policy, n_iter=N_ITER, tile=BATCH,
        interpret=True))(*(jnp.asarray(p) for p in pencil))
    T4_r, ok4_r = jax.jit(functools.partial(
        pallas_cycle_reduction, n_iter=N_ITER, tile=BATCH,
        interpret=True))(*(jnp.asarray(p) for p in pencil[:3]))
    assert np.asarray(ok_r).all() and np.asarray(ok4_r).all()
    eps = 200 * np.finfo(np.float64).eps
    args = [torch.as_tensor(p) for p in pencil]
    for panel in SCHEDULES:
        T, R, flags = _cr_policy_plain(*args, N_ITER, panel)
        ok = ((flags[:, 1] < eps) & (flags[:, 0] > 1e-7)
              & (flags[:, 2] < 1e-6)).numpy()
        assert np.array_equal(ok, np.asarray(ok_r)), panel
        assert _rel(T.numpy(), T_r) < 1e-10 and _rel(R.numpy(), R_r) < 1e-10
        assert _rel(flags[:, 2].numpy(), resid_r) < 1e-10
        T4, flags4 = _cr_plain(*args[:3], N_ITER, panel)
        ok4 = ((flags4[:, 1] < eps) & (flags4[:, 0] > 1e-7)).numpy()
        assert np.array_equal(ok4, np.asarray(ok4_r)), panel
        assert _rel(T4.numpy(), T4_r) < 1e-10


@pytest.mark.parametrize("n,m", [(49, 7), (52, 14), (64, 7)])
def test_plain_kernels_match_pallas_interpret_above_the_small_plan(n, m):
    """The recursion every tier above n = 48 runs (the on-chip tier to 56,
    the device-memory one beyond; the cluster tier in panels) against the
    reference's kernels."""
    _hold_to_reference(_stable_pencil(n, m, BATCH, seed=7 * n + m))


def _tied(n, m, seed):
    """A stable pencil whose B has a tie of |pivot| at its first
    elimination: B[1, 0] = 8 and B[3, 0] = -8, above the rest of the
    column; A = -(B + C T) T keeps the solvent T of spectral radius 0.8."""
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((BATCH, n, n))
    T *= 0.8 / np.abs(np.linalg.eigvals(T)).max(axis=-1)[:, None, None]
    C = 0.3 * rng.standard_normal((BATCH, n, n)) / np.sqrt(n)
    B = 2.0 * np.eye(n) + 0.3 * rng.standard_normal((BATCH, n, n)) / np.sqrt(n)
    B[:, 1, 0], B[:, 3, 0] = 8.0, -8.0
    D = rng.standard_normal((BATCH, n, m))
    return -(B + C @ T) @ T, B, C, D


def _wins(v, i, best, bi) -> bool:
    """``pivot_wins`` (``csrc/small_linalg.cuh``): the larger |entry|, a
    tie to the lower row, NaN the largest."""
    if np.isnan(v) or np.isnan(best):
        return bool(np.isnan(v) and (not np.isnan(best) or i < bi))
    return v > best or (v == best and i < bi)


def _eliminate_moved(L, RHS):
    """Gauss-Jordan on [L | RHS] with the rows moved (``_gj_solve``'s
    schedule, ``cr_eliminate``'s arithmetic: r = row_p * (1 / pivot), x - c
    r).  Returns (solution, the original row of each step's pivot)."""
    n = L.shape[0]
    aug = np.concatenate([L, RHS], axis=1)
    orig = np.arange(n)
    pivots = []
    for k in range(n):
        best, p = -1.0, n
        for i in range(k, n):
            if _wins(abs(aug[i, k]), i, best, p):
                best, p = abs(aug[i, k]), i
        pivots.append(int(orig[p]))
        aug[[k, p]] = aug[[p, k]]
        orig[[k, p]] = orig[[p, k]]
        r = aug[k] * (1.0 / aug[k, k])
        col = aug[:, k].copy()
        aug = aug - col[:, None] * r[None, :]
        aug[k] = r
    return aug[:, n:], pivots


def _eliminate_unmoved(L, RHS):
    """``cr_eliminate_cols``'s schedule: rows never move; step k pivots on
    the first maximal |entry| of column k over the rows whose logical
    position is >= k, in logical order (NaN largest), and swaps the logical
    positions of the pivot's row and position k's row; the solution is
    read back by logical position.  Returns (solution, each step's pivot
    row)."""
    n = L.shape[0]
    x = np.concatenate([L, RHS], axis=1)
    lpos, plog = np.arange(n), np.arange(n)
    pivots = []
    for k in range(n):
        best, bl = -1.0, n
        for i in range(n):   # physical order: the rule does not depend on it
            if lpos[i] >= k and _wins(abs(x[i, k]), lpos[i], best, bl):
                best, bl = abs(x[i, k]), lpos[i]
        P, Rk = plog[bl], plog[k]
        pivots.append(int(P))
        plog[k], plog[bl] = P, Rk
        lpos[P], lpos[Rk] = k, bl
        r = x[P] * (1.0 / x[P, k])
        col = x[:, k].copy()
        x = x - col[:, None] * r[None, :]
        x[P] = r
    out = np.empty_like(x[:, n:])
    out[lpos] = x[:, n:]
    return out, pivots


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_onchip_elimination_schedule_equals_the_swapping_one_on_ties(seed):
    """The on-chip tier's unmoved-row elimination against the swapping
    schedule, bitwise and pivot for pivot, on systems of (52, 52 + 104)
    whose entries are multiples of 1/4 (ties at many steps), one of them
    also with a NaN; the swapping schedule against ``_gj_solve``."""
    rng = np.random.default_rng(seed)
    n = 52
    L = np.round(rng.standard_normal((n, n)) * 4) / 4 + 4 * np.eye(n)
    RHS = np.round(rng.standard_normal((n, 2 * n)) * 4) / 4
    ties = sum(int(np.sum(np.abs(L[:, k]) == np.abs(L[:, k]).max()) > 1)
               for k in range(n))
    assert ties > 0
    got, piv_u = _eliminate_unmoved(L, RHS)
    want, piv_m = _eliminate_moved(L, RHS)
    assert piv_u == piv_m and np.array_equal(got, want)
    ref, _mp = _gj_solve(jnp.asarray(L)[..., None], jnp.asarray(RHS)[..., None],
                         n)
    assert _rel(got, np.asarray(ref)[..., 0]) < 1e-12
    # the cluster tier's panels take the same pivots, and agree to rounding
    for panel in (CR_PANEL, 1):
        record = []
        sol, _mp = gj_eliminate_panels(torch.as_tensor(L), torch.as_tensor(RHS),
                                       panel, pivots=record)
        assert [int(p) for p in record] == piv_m
        assert _rel(sol.numpy(), want) < 1e-12
    L[5, 9] = np.nan
    got, piv_u = _eliminate_unmoved(L, RHS)
    want, piv_m = _eliminate_moved(L, RHS)
    assert piv_u == piv_m
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    record = []
    gj_eliminate_panels(torch.as_tensor(L), torch.as_tensor(RHS), CR_PANEL,
                        pivots=record)
    assert [int(p) for p in record] == piv_m


def test_plain_kernels_match_pallas_interpret_on_tied_pivots():
    """A pencil whose first elimination meets a tie of |pivot| in B's first
    column (rows 1 and 3 of equal magnitude): the plain K1 and K4 meet the
    reference's kernels, which take the first maximum."""
    A, B, C, D = _tied(52, 14, seed=3)
    assert np.all(np.abs(B[:, 1, 0]) == np.abs(B[:, 3, 0]))
    assert np.all(np.abs(B[:, :, 0]).max(axis=-1) == 8.0)
    _hold_to_reference((A, B, C, D))


@pytest.mark.parametrize("optin", [H100_OPTIN, 101_376, 166_912])
def test_tier_is_a_function_of_the_shape_and_the_shared_memory(optin):
    """``cr_tier`` at every n to 130 and m of 0, 7 and 14 (K4 is m = 0):
    the small-state plan where its layout fits, else the on-chip tier where
    its layout fits (n <= 56), else the cluster tier where a cut of the
    draw over at most 8 CTAs fits (``cr_cluster_plan``), else the
    device-memory tier.  On an H100 they meet at n = 48 / 49, 56 / 57 and
    128 / 129, the two-economy core of 52 on the on-chip tier and the
    four-economy core of 104 on the cluster tier, in 4 CTAs of 32 rows."""
    for m in (0, 7, 14):
        tiers = [cr_tier(n, m, optin) for n in range(1, 131)]
        for n, t in zip(range(1, 131), tiers):
            size = cr_layout_bytes(n, m)
            plan = cr_cluster_plan(n, m, optin)
            assert (t == "small") == (size["small"] <= optin)
            if t == "onchip":
                assert n <= 56 and size["onchip"] <= optin
            if t in ("cluster", "workspace"):
                assert n > 56 or size["onchip"] > optin
                assert (t == "cluster") == (plan is not None)
            if plan is not None:
                ctas, rows, nbytes = plan
                assert 1 <= ctas <= 8 and rows % 16 == 0 and nbytes <= optin
                assert ctas * rows >= -(-n // 16) * 16 > (ctas - 1) * rows
        if optin == H100_OPTIN:
            assert tiers[47] == "small" and tiers[48] == "onchip"
            assert tiers[55] == "onchip" and tiers[56] == "cluster"
            assert tiers[127] == "cluster" and tiers[128] == "workspace"
    # the layouts of the tiers at the two-economy core (bytes)
    assert cr_layout_bytes(52, 14) == {"small": 242_336, "onchip": 212_544}
    assert cr_tier(52, 14, H100_OPTIN) == "onchip"
    assert cr_cluster_plan(104, 7, H100_OPTIN)[:2] == (4, 32)
    assert cr_tier(130, 7, H100_OPTIN) == "workspace"
    assert cr_tier(26, 7, H100_OPTIN) == "small"
