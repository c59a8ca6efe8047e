"""Port parity: the fused settle + tail (kernel K5's plain version) and the
batched Cholesky steady-state filter against the reference.

SW-2007 with 4 observables and 5 estimated parameters, 40 periods, batch 4,
16 settle steps (the configuration of ``tests/ops/test_pallas_settle.py``).
The per-draw solutions come from the reference's ``build_solution_fn`` and
cross over as numpy arrays.  ``settle_filter_loglik`` on CPU tensors agrees
with ``pallas_settle_filter_loglik(..., interpret=True)`` and with the
reference's vmapped ``steady_state_kalman_loglik`` at atol 1e-8 (the bar of
that file); the port's batched ``steady_state_filter_parts`` and
``steady_state_kalman_loglik`` agree with the reference's at atol 1e-10
(the same Cholesky algebra on both sides, so only the order of sums
differs).  ``settle_parts`` and ``settle_filter_loglik`` are also held to
the reference's ``steady_state_filter_parts`` and
``steady_state_kalman_loglik`` on synthetic stable systems whose sizes are
not multiples of the CUDA kernels' tiles (atol 1e-8: Gauss-Jordan against
Cholesky, and sums in another order).
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

import geconpy_tpu
from geconpy_torch.ops import kalman as port_kalman
from geconpy_torch.ops.batched_filter import filter_tail
from geconpy_torch.ops.batched_settle import settle_filter_loglik, settle_parts
from geconpy_tpu.ops import kalman as ref_kalman
from geconpy_tpu.ops.pallas_settle import pallas_settle_filter_loglik
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace

N_SETTLE = 16
PARTS = ["ll_head", "x_pred0", "M", "TK", "Finv", "const"]


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


@pytest.fixture(scope="module")
def solutions():
    """numpy: y (40, 4) and per-draw T, R, Q, Z, H, d, RQR at batch 4."""
    estimated = ["crhoa", "sigma_ea", "crr", "crpi", "chabb"]
    model = geconpy_tpu.model_from_gcn(geconpy_tpu.get_example_gcn("sw2007"),
                                       verbose=False)
    ss = RefStateSpace(model).configure(
        observed_states=["y", "c", "pinf", "r"], filter_type="steady_state",
        kalman_settle=N_SETTLE,
        constant_params=[p for p in model.param_names if p not in estimated])
    data, draw = ss.data_from_prior(jax.random.PRNGKey(0), periods=40)
    u0 = np.asarray(ss.unconstrain(draw))
    U = u0[None] + 0.05 * np.random.default_rng(1).standard_normal((4, len(u0)))
    sol = jax.jit(jax.vmap(ss.build_solution_fn()))(jnp.asarray(U))
    out = {k: np.array(sol[k]) for k in ("T_aug", "R_aug", "Q", "Z", "H", "d")}
    out["RQR"] = out["R_aug"] @ out["Q"] @ out["R_aug"].transpose(0, 2, 1)
    out["y"] = np.array(data)
    return out


def _fused_args(s):
    return tuple(s[k] for k in ("y", "T_aug", "RQR", "Z", "H", "d"))


def _filter_args(s):
    return tuple(s[k] for k in ("T_aug", "R_aug", "Q", "Z", "H", "d"))


def _as_torch(arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _ref_loglik(s, n_settle):
    y = jnp.asarray(s["y"])
    return np.asarray(jax.vmap(
        lambda t, r, q, z, h, dd: ref_kalman.steady_state_kalman_loglik(
            y, t, r, q, z, h, d=dd, n_settle=n_settle))(
        *(jnp.asarray(a) for a in _filter_args(s))))


def test_fused_matches_pallas_interpret(solutions):
    ref = pallas_settle_filter_loglik(
        *(jnp.asarray(a) for a in _fused_args(solutions)), n_settle=N_SETTLE,
        tile=4, interpret=True)
    got = settle_filter_loglik(*_as_torch(_fused_args(solutions)),
                               n_settle=N_SETTLE)
    assert got.shape == (4,) and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-8)


def test_fused_matches_reference_steady_state_filter(solutions):
    got = settle_filter_loglik(*_as_torch(_fused_args(solutions)),
                               n_settle=N_SETTLE)
    np.testing.assert_allclose(got.numpy(), _ref_loglik(solutions, N_SETTLE),
                               atol=1e-8)


def test_fused_equals_settle_then_tail(solutions):
    """In float64 the one call is the settle followed by the tail."""
    y, *mats = _as_torch(_fused_args(solutions))
    ll_head, x_pred0, M, TK, Finv, const = settle_parts(y[:N_SETTLE], *mats)
    ll_tail = filter_tail(y[N_SETTLE:], M, TK, mats[2], mats[4], Finv, const,
                          x_pred0)
    got = settle_filter_loglik(y, *mats, n_settle=N_SETTLE)
    np.testing.assert_allclose(got.numpy(), (ll_head + ll_tail).numpy(),
                               rtol=1e-13)


@pytest.mark.parametrize("n_settle", [40, 64])
def test_fused_settle_over_the_whole_sample(solutions, n_settle):
    """``n_settle`` at or beyond the sample: every step is exact, the tail
    is empty, and nothing is read past the last observation."""
    got = settle_filter_loglik(*_as_torch(_fused_args(solutions)),
                               n_settle=n_settle)
    np.testing.assert_allclose(got.numpy(), _ref_loglik(solutions, n_settle),
                               atol=1e-8)
    y, *mats = _as_torch(_fused_args(solutions))
    np.testing.assert_allclose(got.numpy(),
                               settle_parts(y, *mats)[0].numpy(), rtol=1e-13)


def test_fused_nan_draw_poisons_only_itself(solutions):
    args = list(_as_torch(_fused_args(solutions)))
    clean = settle_filter_loglik(*args, n_settle=N_SETTLE)
    T_bad = args[1].clone()
    T_bad[1, 0, 0] = float("nan")
    got = settle_filter_loglik(args[0], T_bad, *args[2:], n_settle=N_SETTLE)
    assert not torch.isfinite(got[1])
    keep = [0, 2, 3]
    np.testing.assert_array_equal(got[keep].numpy(), clean[keep].numpy())


def test_fused_float32_io_computes_in_float64(solutions):
    """float32 inputs give the float64 recursion's total rounded to float32
    (the kernel's precision contract)."""
    inputs32 = [a.float() for a in _as_torch(_fused_args(solutions))]
    got32 = settle_filter_loglik(*inputs32, n_settle=N_SETTLE)
    ref = settle_filter_loglik(*(x.double() for x in inputs32),
                               n_settle=N_SETTLE)
    assert got32.dtype == torch.float32
    np.testing.assert_array_equal(got32.numpy(), ref.float().numpy())


def test_fused_rejects_unknown_device(solutions):
    meta = [a.to("meta") for a in _as_torch(_fused_args(solutions))]
    with pytest.raises(ValueError, match="no kernel"):
        settle_filter_loglik(*meta)


def test_filter_parts_match_reference(solutions):
    y_head = solutions["y"][:N_SETTLE]
    ref = jax.vmap(
        lambda t, r, q, z, h, dd: ref_kalman.steady_state_filter_parts(
            jnp.asarray(y_head), t, r, q, z, h, d=dd))(
        *(jnp.asarray(a) for a in _filter_args(solutions)))
    got = port_kalman.steady_state_filter_parts(
        torch.as_tensor(y_head), *_as_torch(_filter_args(solutions)))
    for name, r, g in zip(PARTS, ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-10,
                                   err_msg=name)


@pytest.mark.parametrize("n_settle", [16, 40])
def test_steady_state_loglik_matches_reference(solutions, n_settle):
    got = port_kalman.steady_state_kalman_loglik(
        torch.as_tensor(solutions["y"]), *_as_torch(_filter_args(solutions)),
        n_settle=n_settle)
    np.testing.assert_allclose(got.numpy(), _ref_loglik(solutions, n_settle),
                               atol=1e-10)


def test_steady_state_filter_failures_are_flags(solutions):
    """A draw whose F is not positive definite gets -inf and leaves its
    neighbours' values unchanged; missing data in the settle's head run
    the masked step, whose log-likelihood is the sequential filter's over
    the same periods."""
    y = torch.as_tensor(solutions["y"])
    args = list(_as_torch(_filter_args(solutions)))
    clean = port_kalman.steady_state_kalman_loglik(y, *args, n_settle=N_SETTLE)
    H_bad = args[4].clone()
    H_bad[2] = -1e3 * torch.eye(H_bad.shape[-1])
    got = port_kalman.steady_state_kalman_loglik(
        y, *args[:4], H_bad, args[5], n_settle=N_SETTLE)
    assert got[2].item() == -np.inf
    np.testing.assert_array_equal(got[[0, 1, 3]].numpy(),
                                  clean[[0, 1, 3]].numpy())
    y_missing = y.clone()
    y_missing[3, 0] = float("nan")
    ll_head = port_kalman.steady_state_filter_parts(y_missing[:N_SETTLE],
                                                    *args)[0]
    seq = port_kalman.kalman_filter(y_missing[:N_SETTLE], *args[:5],
                                    d=args[5])
    assert torch.isfinite(ll_head).all()
    np.testing.assert_allclose(ll_head.numpy(), seq.loglik.numpy(),
                               rtol=1e-12)


# ---- ragged shapes: synthetic stable systems from a seed

RAGGED_NK = [(n, k) for n in (1, 2, 7, 8, 9, 26, 33) for k in (1, 3, 7, 8)
             if k <= n]
RAGGED_OBS, RAGGED_SETTLE = 12, 5


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


@pytest.mark.parametrize("n,k", RAGGED_NK)
def test_settle_and_fused_match_reference_filter_on_ragged_shapes(n, k):
    y, T, RQR, Z, H, d = _stable_system(n, k, 3, RAGGED_OBS, seed=100 * n + k)
    R, Q = np.linalg.cholesky(RQR), jnp.eye(n)
    y_j = jnp.asarray(y)

    def reference(t, r, z, h, dd):
        parts = ref_kalman.steady_state_filter_parts(
            y_j[:RAGGED_SETTLE], t, r, Q, z, h, d=dd)
        total = ref_kalman.steady_state_kalman_loglik(
            y_j, t, r, Q, z, h, d=dd, n_settle=RAGGED_SETTLE)
        return parts, total

    ref_parts, ref_total = jax.jit(jax.vmap(reference))(
        *(jnp.asarray(a) for a in (T, R, Z, H, d)))
    y_t, *mats = _as_torch((y, T, RQR, Z, H, d))
    got_parts = settle_parts(y_t[:RAGGED_SETTLE], *mats)
    for name, r, g in zip(PARTS, ref_parts, got_parts):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-8,
                                   err_msg=name)
    got = settle_filter_loglik(y_t, *mats, n_settle=RAGGED_SETTLE)
    assert got.shape == (3,) and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_total), atol=1e-8)
