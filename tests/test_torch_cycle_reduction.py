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
    pre_policy, _ = ss._solution_pieces()
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
