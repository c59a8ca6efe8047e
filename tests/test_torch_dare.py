"""Port parity: the batched DARE settle (kernel K6's plain version).

- ``batched_dare.dare_settle`` on CPU tensors equals
  ``pallas_dare_settle(..., tile=8, interpret=True)`` at rtol 1e-10, on
  random pencils (a batch that is not a whole tile), on SW-2007's own
  DARE inputs from the value+grad path, and at every (n, k) at which
  ``tests/test_torch_cuda.py`` holds the kernel to the plain version on a
  GPU.
- It meets ``scipy.linalg.solve_discrete_are`` and the predictive Riccati
  fixed point at the tolerances of ``tests/ops/test_pallas_dare.py``.
- ``dare_residual_settled`` passes the full schedule and flags a starved
  one (one Hewer polish) on an ill-conditioned, no-measurement-error draw,
  which twelve polishes settle.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import geconpy_torch
from geconpy_torch.ops.batched_dare import _dare_plain, dare_settle
from geconpy_torch.ops.kalman import _dare_step, dare_residual_settled
from geconpy_torch.stats.statespace import DSGEStateSpace
from geconpy_tpu.ops.pallas_dare import pallas_dare_settle


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def make_batch(B=12, n=8, k=3, seed=0, rho=0.9):
    """The reference test's random pencils (numpy, float64)."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n))
    rad = np.abs(np.linalg.eigvals(M)).max(axis=1)
    T = rho * M / rad[:, None, None]
    R = rng.normal(size=(B, n, k)) * 0.1
    RQR = np.einsum("bij,bkj->bik", R, R) + 1e-8 * np.eye(n)
    Z = rng.normal(size=(B, k, n))
    H = np.broadcast_to(0.01 * np.eye(k), (B, k, k)).copy()
    return T, RQR, Z, H


@pytest.fixture(scope="module")
def sw_dare_inputs():
    model = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn("sw2007"))
    est = ["crhoa", "sigma_ea", "crr", "crpi", "chabb"]
    ss = DSGEStateSpace(model, device="cpu").configure(
        observed_states=["y", "c", "pinf", "r"], filter_type="stationary",
        constant_params=[p for p in model.param_names if p not in est])
    data, draw = ss.data_from_prior(torch.Generator().manual_seed(1),
                                    periods=40)
    u0 = ss.unconstrain(draw).numpy()
    U = u0[None] + 0.05 * np.random.default_rng(1).standard_normal((5, len(u0)))
    record: dict = {}
    ss.build_batched_logpost(data, settle="pallas")(torch.as_tensor(U),
                                                    record=record)
    return tuple(x.numpy() for x in record["dare_settle"])


# the (n, k) of the GPU tests of K6 (tests/test_torch_cuda.py)
GPU_NK = [(n, k) for n in (1, 9, 17, 26, 32, 40) for k in (1, 7, 9)]


@pytest.mark.parametrize("case", ["random", "sw2007"]
                         + [f"n{n}-k{k}" for n, k in GPU_NK])
def test_plain_k6_matches_pallas_interpret(case, request):
    if case == "random":
        args = make_batch(B=13)
    elif case == "sw2007":
        args = request.getfixturevalue("sw_dare_inputs")
    else:
        n, k = (int(part[1:]) for part in case.split("-"))
        args = make_batch(B=2, n=n, k=k, seed=100 * n + k)
    P_ref = np.asarray(jax.jit(lambda *a: pallas_dare_settle(
        *a, tile=8, interpret=True))(*(jnp.asarray(a) for a in args)))
    P = dare_settle(*(torch.as_tensor(a) for a in args)).numpy()
    assert np.isfinite(P_ref).all()
    np.testing.assert_allclose(P, P_ref, rtol=1e-10,
                               atol=1e-10 * np.abs(P_ref).max())


def test_matches_scipy_dare():
    T, RQR, Z, H = make_batch()
    P = dare_settle(*(torch.as_tensor(a) for a in (T, RQR, Z, H))).numpy()
    for i in range(T.shape[0]):
        P_ref = scipy.linalg.solve_discrete_are(T[i].T, Z[i].T, RQR[i], H[i])
        np.testing.assert_allclose(P[i], P_ref, rtol=1e-8, atol=1e-10)


def test_fixed_point_property():
    T, RQR, Z, H = (torch.as_tensor(a) for a in make_batch(B=4, seed=3,
                                                           rho=0.95))
    P = dare_settle(T, RQR, Z, H)
    np.testing.assert_allclose(_dare_step(P, T, RQR, Z, H).numpy(), P.numpy(),
                               rtol=1e-9, atol=1e-11)


def test_float32_io_computes_in_float64():
    """float32 inputs give the float64 schedule's P rounded to float32."""
    args = [torch.as_tensor(a).float() for a in make_batch(B=4, seed=3)]
    P32 = dare_settle(*args)
    assert P32.dtype == torch.float32
    np.testing.assert_array_equal(P32.numpy(),
                                  dare_settle(*(a.double() for a in args))
                                  .float().numpy())


def test_residual_gate_flags_unsettled_draws():
    T, RQR, Z, H = (torch.as_tensor(a) for a in make_batch(B=4, seed=3,
                                                           rho=0.95))
    assert bool(dare_residual_settled(T, RQR, Z, H,
                                      dare_settle(T, RQR, Z, H)).all())
    # an ill-conditioned draw without measurement error (shock scales 1e-2
    # .. 5e-4, rho 0.97): one Hewer polish of the plain schedule leaves it
    # unsettled, twelve settle
    rng = np.random.default_rng(5)
    n, k = 8, 3
    q, r = np.linalg.qr(rng.standard_normal((n, n)))
    Ti = torch.as_tensor(0.97 * q * np.sign(np.diag(r)))[None]
    Ri = rng.standard_normal((n, k)) / np.sqrt(k)
    Qi = np.diag(np.array([1e-2, 2e-3, 5e-4]) ** 2)
    RQRi = torch.as_tensor(Ri @ Qi @ Ri.T)[None]
    Zi = torch.as_tensor(rng.standard_normal((k, n)) / np.sqrt(n))[None]
    Hi = torch.zeros((1, k, k))
    starved = _dare_plain(Ti, RQRi, Zi, Hi, hewer_iters=1)
    assert not bool(dare_residual_settled(Ti, RQRi, Zi, Hi, starved)[0])
    full = _dare_plain(Ti, RQRi, Zi, Hi, hewer_iters=12)
    assert bool(dare_residual_settled(Ti, RQRi, Zi, Hi, full)[0])


def test_wrapper_rejects_unknown_device():
    meta = [torch.as_tensor(a).to("meta") for a in make_batch(B=2)]
    with pytest.raises(ValueError, match="no kernel"):
        dare_settle(*meta)
