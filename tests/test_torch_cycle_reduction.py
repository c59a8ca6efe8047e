"""Port parity: the batched cycle-reduction policy solve (kernel K1's plain
version) against the reference's Pallas kernel in interpret mode.

The same reduced pencils (numpy, float64) go to
``geconpy_tpu.ops.pallas_cycle_reduction.pallas_cycle_reduction_policy
(..., interpret=True)`` and to ``geconpy_torch.ops.batched_cycle_reduction
.cycle_reduction_policy`` on CPU tensors.  T, R and the residual agree at
atol 1e-10 (the bar of ``tests/ops/test_pallas_cycle_reduction.py``) and the
success flags are equal, including a divergent (BK-violating) draw.  The
n = 4 ``rbc_estimation`` pencil exercises the reference's n < 8 identity
embedding, which the port drops.
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

import geconpy_torch
from geconpy_torch.ops.batched_cycle_reduction import (cycle_reduction_policy,
                                                       static_pivot_order)
from geconpy_torch.ops.linalg import gj_eliminate
from geconpy_torch.ops.static_reduction import reduce_pencil
from geconpy_torch.stats.statespace import DSGEStateSpace
from geconpy_tpu.ops.pallas_cycle_reduction import (
    pallas_cycle_reduction_policy, static_pivot_order as ref_pivot_order)

N_ITER = 14


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _reduced_pencils(name, configure, batch, scale, seed):
    """Reduced (A2, B2, C2, D2) numpy pencils at ``batch`` perturbed draws
    around the prior-mean point, and the static pivot order."""
    model = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn(name))
    ss = DSGEStateSpace(model, device="cpu").configure(**configure(model))
    pre_policy, _, _ = ss._solution_pieces()
    u0 = ss.initial_position().numpy()
    rng = np.random.default_rng(seed)
    U = u0[None] + scale * rng.standard_normal((batch, u0.shape[0]))
    pre = pre_policy(torch.as_tensor(U))
    red = reduce_pencil(pre["A"], pre["B"], pre["C"], pre["D"],
                        model.static_reduction)
    pencils = tuple(X.numpy() for X in (red.A2, red.B2, red.C2, red.D2))
    return pencils, ss._static_pivot_order()


def _sw_configure(model):
    estimated = ["crhoa", "sigma_ea", "crr", "crpi", "chabb"]
    return dict(observed_states=["y", "pinf", "r"], kalman_settle=16,
                constant_params=[p for p in model.param_names
                                 if p not in estimated])


def _rbc_configure(model):
    return dict(observed_states=["Y", "C"], measurement_error=["Y", "C"],
                kalman_settle=16)


@pytest.fixture(scope="module")
def sw_case():
    (A, B, C, D), order = _reduced_pencils("sw2007", _sw_configure, 8, 0.05, 0)
    # one BK-violating draw, built as in tests/ops/test_pallas_cycle_reduction
    n = A.shape[-1]
    rng = np.random.default_rng(99)
    bad = [M[0] + 0.05 * rng.standard_normal((n, n)) * np.abs(M[0]).max()
           for M in (A, B, C)]
    A, B, C = (np.concatenate([M, b[None]]) for M, b in zip((A, B, C), bad))
    D = np.concatenate([D, D[:1]])
    return (A, B, C, D), order


@pytest.fixture(scope="module")
def rbc_case():
    return _reduced_pencils("rbc_estimation", _rbc_configure, 8, 0.1, 1)


def _reference(pencils, order):
    fn = jax.jit(functools.partial(
        pallas_cycle_reduction_policy, order=order, n_iter=N_ITER,
        tile=pencils[0].shape[0], interpret=True))
    return tuple(np.asarray(x) for x in fn(*(jnp.asarray(p) for p in pencils)))


def _port(pencils, order):
    T, R, ok, resid = cycle_reduction_policy(
        *(torch.as_tensor(p) for p in pencils), order=order, n_iter=N_ITER)
    return T.numpy(), R.numpy(), ok.numpy(), resid.numpy()


@pytest.mark.parametrize("case", ["sw_case", "rbc_case"])
def test_policy_matches_pallas_interpret(case, request):
    pencils, order = request.getfixturevalue(case)
    T_r, R_r, ok_r, resid_r = _reference(pencils, order)
    T_p, R_p, ok_p, resid_p = _port(pencils, order)
    np.testing.assert_array_equal(ok_p, ok_r)
    assert ok_p.sum() >= len(ok_p) - 1
    np.testing.assert_allclose(T_p[ok_p], T_r[ok_r], atol=1e-10)
    np.testing.assert_allclose(R_p[ok_p], R_r[ok_r], atol=1e-10)
    np.testing.assert_allclose(resid_p[ok_p], resid_r[ok_r], atol=1e-10)


def test_divergent_draw_is_flagged(sw_case):
    pencils, order = sw_case
    _T, _R, ok, _resid = _port(pencils, order)
    assert ok[:-1].all() and not ok[-1]


def test_static_pivot_order_is_the_reference_one(sw_case):
    (_A, B, _C, _D), _order = sw_case
    np.testing.assert_array_equal(static_pivot_order(B[0]),
                                  ref_pivot_order(B[0]))


def test_gj_solve_pivots_past_a_zero_leading_entry():
    """A structural zero on the diagonal needs the row swap; the pivots give
    log|det A| and min|pivot|."""
    A = torch.tensor([[0.0, 1.0, 2.0],
                      [-2.0, 3.0, 1.0],
                      [2.0, 0.0, 4.0]])
    sol, minpiv, logdet = gj_eliminate(A[None], torch.eye(3)[None])
    np.testing.assert_allclose(sol[0].numpy(), np.linalg.inv(A.numpy()),
                               atol=1e-14)
    np.testing.assert_allclose(float(logdet[0]),
                               np.log(abs(np.linalg.det(A.numpy()))),
                               rtol=1e-13)
    assert 0.0 < float(minpiv[0]) <= 2.0


def test_nonfinite_draw_poisons_only_itself(sw_case):
    (A, B, C, D), order = sw_case
    A = A.copy()
    A[2, 0, 0] = np.nan
    _T, _R, ok, _resid = _port((A, B, C, D), order)
    assert not ok[2]
    assert ok[[0, 1, 3, 4, 5, 6, 7]].all()


def test_wrapper_rejects_unknown_device(rbc_case):
    pencils, _order = rbc_case
    meta = [torch.as_tensor(p).to("meta") for p in pencils]
    with pytest.raises(ValueError, match="no kernel"):
        cycle_reduction_policy(*meta, n_iter=N_ITER)


# ---- the plain versions of K1 and K4 on ragged shapes: the (n, m) of the
# kernels' GPU tests, from synthetic pencils with a stable solvent

RAGGED_NM = [(n, m) for n in (1, 4, 9, 17, 26, 32) for m in (1, 7, 9)]
RAGGED_NM.append((40, 7))


def _stable_pencil(n, m, batch, seed):
    """numpy float64 (A, B, C, D) with A + B T + C T^2 = 0 for a T of
    spectral radius 0.8: A + B z + C z^2 = (C z + M)(z I - T) with
    M = 2 I + noise and C small keeps the other n roots outside the unit
    circle, so cycle reduction converges."""
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((batch, n, n))
    T *= 0.8 / np.abs(np.linalg.eigvals(T)).max(axis=-1)[:, None, None]
    C = 0.3 * rng.standard_normal((batch, n, n)) / np.sqrt(n)
    M = 2.0 * np.eye(n) + 0.3 * rng.standard_normal((batch, n, n)) / np.sqrt(n)
    D = rng.standard_normal((batch, n, m))
    return -M @ T, M - C @ T, C, D


@pytest.mark.parametrize("n,m", RAGGED_NM)
def test_plain_kernels_match_pallas_interpret_on_ragged_shapes(n, m):
    """K1's plain version at every (n, m), K4's at each n (with m = 1, and
    at n = 40):
    T, R and the flags against the JAX package's kernels in interpret
    mode at 1e-10 (min |pivot| too: the pivots are the same rows)."""
    from geconpy_torch.ops.batched_cycle_reduction import (_cr_plain,
                                                           _cr_policy_plain)
    from geconpy_tpu.ops.pallas_cycle_reduction import pallas_cycle_reduction

    pencil = _stable_pencil(n, m, 3, seed=10 * n + m)
    T_r, R_r, ok_r, resid_r = jax.jit(functools.partial(
        pallas_cycle_reduction_policy, n_iter=N_ITER, tile=3,
        interpret=True))(*(jnp.asarray(p) for p in pencil))
    T, R, flags = _cr_policy_plain(*(torch.as_tensor(p) for p in pencil),
                                   N_ITER)
    assert np.asarray(ok_r).all()
    np.testing.assert_allclose(T.numpy(), np.asarray(T_r), atol=1e-10)
    np.testing.assert_allclose(R.numpy(), np.asarray(R_r), atol=1e-10)
    np.testing.assert_allclose(flags[:, 2].numpy(), np.asarray(resid_r),
                               atol=1e-10)
    if m != 1 and n != 40:
        return
    T4_r, ok4_r = jax.jit(functools.partial(
        pallas_cycle_reduction, n_iter=N_ITER, tile=3, interpret=True))(
        *(jnp.asarray(p) for p in pencil[:3]))
    T4, flags4 = _cr_plain(*(torch.as_tensor(p) for p in pencil[:3]), N_ITER)
    assert np.asarray(ok4_r).all()
    assert bool(((flags4[:, 1] < 200 * np.finfo(np.float64).eps)
                 & (flags4[:, 0] > 1e-7)).all())
    np.testing.assert_allclose(T4.numpy(), np.asarray(T4_r), atol=1e-10)
