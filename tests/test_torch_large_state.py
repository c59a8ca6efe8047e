"""Port parity at the state sizes above the small-state CUDA kernels.

The plain versions of K2 (``settle_parts``), K5 (``settle_filter_loglik``),
K6 (``dare_settle``) and K3 (``filter_tail``) against the reference's
Pallas kernels in interpret mode, at rel 1e-10 (``|a - b| / (1 + |b|)``),
on synthetic stable systems from a numpy seed in float64: K2, K5 and K6 at
(n, k) = (66, 7) and (104, 7), where the small-state kernels of the settle
and the DARE run out of shared memory, and K3 there and at (40, 33), above
the small-state tail kernel's k <= 32.  On the card the wrappers send these
shapes to the large-state kernels (``tests/test_torch_cuda.py`` holds those
to the same plain versions).

End to end: SW-2007 with its published first-difference observables, the
nominal rate, hours and year-on-year inflation
(``pinf4 = pinf[] + pinf[-1] + pinf[-2] + pinf[-3]``), whose lags give a
filter state of 4 x 26 = 104.  The port's ``build_batched_loglik(policy=
"pallas", settle="pallas")`` on the CPU equals the reference's with
``interpret=True`` at rel 1e-8, on two draws over 32 periods.  The
reference is built once for the module.  Without measurement error the
fixed DARE schedule of K6 leaves that system unsettled: the port's K6
gives the reference kernel's P on the path's own inputs, and the gate
rejects every draw, on both packages alike.  CPU, float64, one thread.
"""

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
import geconpy_tpu
from geconpy_torch.interop import state_from_reference
from geconpy_torch.ops.batched_dare import dare_settle
from geconpy_torch.ops.batched_filter import filter_tail
from geconpy_torch.ops.batched_settle import settle_filter_loglik, settle_parts
from geconpy_torch.ops.kalman import dare_residual_settled
from geconpy_torch.stats.statespace import DSGEStateSpace as PortStateSpace
from geconpy_tpu.ops.pallas_dare import pallas_dare_settle
from geconpy_tpu.ops.pallas_filter import pallas_filter_tail
from geconpy_tpu.ops.pallas_settle import (pallas_settle_filter_loglik,
                                           pallas_settle_parts)
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace

SETTLE_NK = [(66, 7), (104, 7)]
TAIL_NK = SETTLE_NK + [(40, 33)]
BATCH, N_OBS, N_SETTLE = 2, 6, 4

# SW-2007 with year-on-year inflation: the filter state of 104
SW_EST = ["crhoa", "crhob", "crhog", "crhoqs", "crhoms", "crhopinf", "crhow",
          "cmap", "cmaw", "cgy", "sigma_ea", "sigma_eb", "sigma_eg",
          "sigma_eqs", "sigma_em", "sigma_epinf", "sigma_ew", "crpi", "crr",
          "cry", "chabb", "csigma"]
SW_YOY_OBS = ["dy", "dc", "dinve", "dw", "pinf4", "r", "lab"]
SW_YOY_EQS = {"dy": "y[] - y[-1]", "dc": "c[] - c[-1]",
              "dinve": "inve[] - inve[-1]", "dw": "w[] - w[-1]",
              "pinf4": "pinf[] + pinf[-1] + pinf[-2] + pinf[-3]"}
SW_PERIODS, SW_SETTLE, SW_BATCH = 32, 8, 2


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all() and np.isfinite(b).all()
    return float((np.abs(a - b) / (1.0 + np.abs(b))).max())


def _stable_system(n, k, seed):
    """numpy float64 (y, T, R Q R', Z, H, d): T of spectral radius 0.9,
    R Q R' and H positive definite (``tests/test_torch_cuda.py``'s
    systems)."""
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((BATCH, n, n))
    T *= 0.9 / np.abs(np.linalg.eigvals(T)).max(axis=-1)[:, None, None]
    G = rng.standard_normal((BATCH, n, n))
    RQR = G @ G.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    Z = rng.standard_normal((BATCH, k, n))
    E = rng.standard_normal((BATCH, k, k))
    H = E @ E.transpose(0, 2, 1) / k + 0.1 * np.eye(k)
    d = 0.1 * rng.standard_normal((BATCH, k))
    y = rng.standard_normal((N_OBS, k))
    return y, T, RQR, Z, H, d


def _tail_inputs(n, k, seed):
    """numpy float64 (y, M, TK, Z, d, F^{-1}, const, x0), M of spectral
    radius 0.9 and F^{-1} positive definite."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((BATCH, n, n))
    M *= 0.9 / np.abs(np.linalg.eigvals(M)).max(axis=-1)[:, None, None]
    TK = 0.3 * rng.standard_normal((BATCH, n, k))
    Z = rng.standard_normal((BATCH, k, n))
    d = 0.1 * rng.standard_normal((BATCH, k))
    E = rng.standard_normal((BATCH, k, k))
    Finv = E @ E.transpose(0, 2, 1) / k + np.eye(k)
    const = rng.standard_normal(BATCH)
    x0 = rng.standard_normal((BATCH, n))
    y = rng.standard_normal((2 * N_OBS, k))
    return y, M, TK, Z, d, Finv, const, x0


def _jnp(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _torch(arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


@pytest.mark.parametrize("n,k", SETTLE_NK)
def test_settle_parts_matches_pallas_interpret(n, k):
    y, *mats = _stable_system(n, k, seed=n + k)
    ref = jax.jit(lambda *a: pallas_settle_parts(
        *a, tile=BATCH, interpret=True))(*_jnp((y[:N_SETTLE], *mats)))
    got = settle_parts(*_torch((y[:N_SETTLE], *mats)))
    for name, r, g in zip(["ll_head", "x_pred0", "M", "TK", "Finv", "const"],
                          ref, got):
        assert _rel(g.numpy(), r) < 1e-10, name


@pytest.mark.parametrize("n,k", SETTLE_NK)
def test_settle_filter_loglik_matches_pallas_interpret(n, k):
    arrays = _stable_system(n, k, seed=2 * n + k)
    ref = jax.jit(lambda *a: pallas_settle_filter_loglik(
        *a, n_settle=N_SETTLE, tile=BATCH, interpret=True))(*_jnp(arrays))
    got = settle_filter_loglik(*_torch(arrays), n_settle=N_SETTLE)
    assert _rel(got.numpy(), ref) < 1e-10


@pytest.mark.parametrize("n,k", SETTLE_NK)
def test_dare_settle_matches_pallas_interpret(n, k):
    _y, T, RQR, Z, H, _d = _stable_system(n, k, seed=3 * n + k)
    ref = jax.jit(lambda *a: pallas_dare_settle(
        *a, tile=BATCH, interpret=True))(*_jnp((T, RQR, Z, H)))
    got = dare_settle(*_torch((T, RQR, Z, H)))
    assert _rel(got.numpy(), ref) < 1e-10


@pytest.mark.parametrize("n,k", TAIL_NK)
def test_filter_tail_matches_pallas_interpret(n, k):
    arrays = _tail_inputs(n, k, seed=4 * n + k)
    ref = jax.jit(lambda *a: pallas_filter_tail(*a, tile=128, interpret=True))(
        *_jnp(arrays))
    got = filter_tail(*_torch(arrays))
    assert _rel(got.numpy(), ref) < 1e-10


def _configure(names):
    return dict(observed_states=SW_YOY_OBS,
                observation_equations=SW_YOY_EQS,
                filter_type="steady_state", kalman_settle=SW_SETTLE,
                constant_params=[p for p in names if p not in SW_EST])


@pytest.fixture(scope="module")
def sw_yoy():
    """Both packages' SW-2007 with year-on-year inflation, the reference's
    data (periods, 7) and two draws near its generating point."""
    ref_model = geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn("sw2007"), verbose=False)
    ref_ss = RefStateSpace(ref_model).configure(
        **_configure(ref_model.param_names))
    data, draw = ref_ss.data_from_prior(jax.random.PRNGKey(0),
                                        periods=SW_PERIODS)
    data = np.asarray(data)
    u0 = np.asarray(ref_ss.unconstrain(draw))
    U = u0[None] + 0.05 * np.random.default_rng(1).standard_normal(
        (SW_BATCH, u0.shape[0]))
    port_model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("sw2007"))
    port_ss = PortStateSpace(port_model, device="cpu").configure(
        **_configure(port_model.param_names))
    plan = ref_model.static_reduction
    state = state_from_reference(
        {"param_labels": np.asarray(ref_ss.param_labels),
         "theta_default": np.asarray(ref_ss._theta_default),
         "est_idx": np.asarray(ref_ss._est_idx),
         "static_idx": np.asarray(plan.static_idx),
         "dynamic_idx": np.asarray(plan.dynamic_idx), "U": U}, port_ss)
    return ref_ss, port_ss, data, U, state["U"]


def test_sw2007_yoy_inflation_has_filter_state_104(sw_yoy):
    _ref_ss, port_ss, data, _U, U_port = sw_yoy
    assert len(port_ss._filter_core) == 26
    record: dict = {}
    port_ss.build_batched_loglik(data, n_settle=SW_SETTLE, policy="pallas",
                                 settle="pallas")(U_port, record=record)
    _y, T_aug, RQR, Z, _H, _d = record["settle_parts"]
    assert T_aug.shape == RQR.shape == (SW_BATCH, 104, 104)
    assert Z.shape == (SW_BATCH, len(SW_YOY_OBS), 104)


def test_sw2007_yoy_sweep_matches_reference(sw_yoy):
    ref_ss, port_ss, data, U, U_port = sw_yoy
    want = np.asarray(jax.jit(ref_ss.build_batched_loglik(
        data, n_settle=SW_SETTLE, policy="pallas", settle="pallas", cr_tile=8,
        interpret=True))(jnp.asarray(U)))
    got = port_ss.build_batched_loglik(
        data, n_settle=SW_SETTLE, policy="pallas", settle="pallas")(U_port)
    assert _rel(got.numpy(), want) < 1e-8



def test_sw2007_yoy_dare_schedule_leaves_draws_unsettled(sw_yoy):
    """Without measurement error the fixed DARE schedule (8 Hewer
    polishes) leaves this system's residual over the sqrt(eps) gate, so
    the stationary filter's ``settle="pallas"`` rejects these draws: the
    port's K6 (plain version) gives the reference's kernel's P on the
    path's own inputs, and the gate flags every draw."""
    _ref_ss, port_ss, data, _U, U_port = sw_yoy
    configure = dict(_configure(port_ss.model.param_names),
                     filter_type="stationary")
    port_st = PortStateSpace(port_ss.model, device="cpu").configure(
        **configure)
    record: dict = {}
    got = port_st.build_batched_logpost(data, settle="pallas")(
        U_port, record=record)
    dare_in = record["dare_settle"]
    assert dare_in[0].shape == (SW_BATCH, 104, 104)
    want = jax.jit(lambda *a: pallas_dare_settle(
        *a, tile=SW_BATCH, interpret=True))(*_jnp(x.numpy() for x in dare_in))
    P = dare_settle(*dare_in)
    assert _rel(P.numpy(), want) < 1e-10
    assert not dare_residual_settled(*dare_in, P).any()
    assert torch.isneginf(got).all()
