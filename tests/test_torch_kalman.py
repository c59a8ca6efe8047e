"""Port parity: the stationary Kalman filter of the value+grad path.

- ``_hewer_settle`` (P, and the ``settled`` flags) equals the reference's
  at 1e-10 of max|P|, on SW-2007's own DARE inputs and on random stable
  systems that include a tiny-innovation one (no measurement error, shock
  scales 1e-2 .. 5e-4).
- ``stationary_kalman_loglik`` equals the reference in value (1e-10) and in
  its gradient with respect to T, R, Q, Z, H and d (1e-8), against
  ``jax.value_and_grad``.
- ``dare_residual_settled`` gives the reference's flags.
- The two float64 pins of ``tests/ops/test_stationary_kalman.py``, on the
  port: the settle is unbiased with tiny innovations (and a fixed 4-stage
  settle is not), and with H = 0 it reaches the limit of plain Riccati
  iteration started at the open-loop unconditional covariance.
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
from geconpy_torch.ops import kalman as port
from geconpy_torch.ops.lyapunov import _doubling
from geconpy_torch.stats.statespace import DSGEStateSpace
from geconpy_tpu.ops import kalman as ref

SW_EST = ["crhoa", "sigma_ea", "crr", "crpi", "chabb"]


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _orthogonal(rng, n):
    q, r = np.linalg.qr(rng.standard_normal((n, n)))
    return q * np.sign(np.diag(r))


def _random_systems(seed=0, n=8, k=3, m=3):
    """Stable systems: two with measurement error, one tiny-innovation
    system without it (``test_settle_unbiased_tiny_innovations``'s)."""
    rng = np.random.default_rng(seed)
    T, R, Q, Z, H = [], [], [], [], []
    for i in range(3):
        T.append((0.97 if i == 2 else 0.85) * _orthogonal(rng, n))
        R.append(rng.standard_normal((n, m)) / np.sqrt(m))
        Q.append(np.diag(np.array([1e-2, 2e-3, 5e-4]) ** 2) if i == 2
                 else np.diag(0.05 + rng.uniform(size=m)))
        Z.append(rng.standard_normal((k, n)) / np.sqrt(n))
        H.append(np.zeros((k, k)) if i == 2
                 else np.diag(0.01 + 0.05 * rng.uniform(size=k)))
    T, R, Q, Z, H = (np.stack(x) for x in (T, R, Q, Z, H))
    d = 0.1 * rng.standard_normal((3, k))
    return T, R, Q, Z, H, d


def _simulate(rng, T, R, Q, Z, periods=80):
    """One shared observation path from the first system."""
    L = np.linalg.cholesky(Q[0])
    x = np.zeros(T.shape[-1])
    ys = []
    for _ in range(periods):
        x = T[0] @ x + R[0] @ (L @ rng.standard_normal(L.shape[0]))
        ys.append(Z[0] @ x)
    return np.stack(ys) + 0.05 * rng.standard_normal((periods, Z.shape[1]))


@pytest.fixture(scope="module")
def sw_dare_inputs():
    model = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn("sw2007"))
    ss = DSGEStateSpace(model, device="cpu").configure(
        observed_states=["y", "pinf", "r"], filter_type="stationary",
        constant_params=[p for p in model.param_names if p not in SW_EST])
    data, draw = ss.data_from_prior(torch.Generator().manual_seed(0),
                                    periods=40)
    u0 = ss.unconstrain(draw).numpy()
    U = u0[None] + 0.05 * np.random.default_rng(0).standard_normal((4, len(u0)))
    record: dict = {}
    ss.build_batched_logpost(data, settle="pallas")(torch.as_tensor(U),
                                                    record=record)
    return tuple(x.numpy() for x in record["dare_settle"])


def _ref_hewer(T, RQR, Z, H, n_settle):
    return jax.vmap(lambda *a: ref._hewer_settle(*a, n_settle))(
        *(jnp.asarray(x) for x in (T, RQR, Z, H)))


@pytest.mark.parametrize("case", ["sw2007", "random"])
def test_hewer_settle_matches_reference(case, request):
    if case == "sw2007":
        T, RQR, Z, H = request.getfixturevalue("sw_dare_inputs")
    else:
        T, R, Q, Z, H, _d = _random_systems()
        RQR = R @ Q @ np.swapaxes(R, -1, -2)
    P_r, set_r = _ref_hewer(T, RQR, Z, H, 32)
    P_p, set_p = port._hewer_settle(*(torch.as_tensor(x) for x in (T, RQR, Z, H)),
                                    32)
    np.testing.assert_array_equal(set_p.numpy(), np.asarray(set_r))
    assert set_p.all()
    scale = float(np.abs(np.asarray(P_r)).max())
    np.testing.assert_allclose(P_p.numpy(), np.asarray(P_r), atol=1e-10 * scale)
    # a starved cap (4 floor stages + 1) leaves the tiny-innovation system
    # unsettled on both sides
    if case == "random":
        _P, set_r5 = _ref_hewer(T, RQR, Z, H, 5)
        _P, set_p5 = port._hewer_settle(
            *(torch.as_tensor(x) for x in (T, RQR, Z, H)), 5)
        np.testing.assert_array_equal(set_p5.numpy(), np.asarray(set_r5))
        assert not bool(set_p5[2])


def test_dare_residual_settled_matches_reference(sw_dare_inputs):
    T, RQR, Z, H = sw_dare_inputs
    P_good = port._hewer_settle(*(torch.as_tensor(x) for x in sw_dare_inputs),
                                32)[0].numpy()
    P_bad = P_good.copy()
    P_bad[1] *= 1.0 + 1e-3                # one draw moved off its fixed point
    for P in (P_good, P_bad):
        got = port.dare_residual_settled(
            *(torch.as_tensor(x) for x in (T, RQR, Z, H, P))).numpy()
        want = np.asarray(jax.vmap(ref.dare_residual_settled)(
            *(jnp.asarray(x) for x in (T, RQR, Z, H, P))))
        np.testing.assert_array_equal(got, want)
    assert got.tolist() == [True, False, True, True]


def test_stationary_loglik_value_and_gradient_match_reference():
    T, R, Q, Z, H, d = _random_systems(seed=1)
    y = _simulate(np.random.default_rng(2), T, R, Q, Z)

    def one(T_, R_, Q_, Z_, H_, d_):
        return ref.stationary_kalman_loglik(jnp.asarray(y), T_, R_, Q_, Z_,
                                            H_, d=d_, n_settle=32)

    vals_r, grads_r = jax.vmap(jax.value_and_grad(one, argnums=tuple(range(6))))(
        *(jnp.asarray(x) for x in (T, R, Q, Z, H, d)))
    leaves = [torch.as_tensor(x).requires_grad_(True)
              for x in (T, R, Q, Z, H, d)]
    vals = port.stationary_kalman_loglik(torch.as_tensor(y), *leaves[:5],
                                         d=leaves[5], n_settle=32)
    grads = torch.autograd.grad(vals.sum(), leaves)
    assert np.isfinite(np.asarray(vals_r)).all()
    np.testing.assert_allclose(vals.detach().numpy(), np.asarray(vals_r),
                               rtol=1e-10)
    for g, r, name in zip(grads, grads_r, ["T", "R", "Q", "Z", "H", "d"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-8,
                                   atol=1e-8 * float(np.abs(np.asarray(r)).max()),
                                   err_msg=f"grad wrt {name}")


def test_sda_and_auto_settles_are_not_ported():
    """Both settles are ported (the name is the one this test had while
    they raised): ``stationary_kalman_loglik`` with ``"sda"`` and
    ``"auto"`` equals the reference's in value (1e-8) on the three random
    systems, the tiny-innovation one included, and an unknown method
    raises the reference's ``ValueError``."""
    T, R, Q, Z, H, d = _random_systems(seed=1)
    y = _simulate(np.random.default_rng(2), T, R, Q, Z)
    for method in ("sda", "auto"):
        got = port.stationary_kalman_loglik(
            *(torch.as_tensor(x) for x in (y, T, R, Q, Z, H)),
            d=torch.as_tensor(d), settle_method=method).numpy()
        want = np.asarray(jax.vmap(
            lambda *a: ref.stationary_kalman_loglik(
                jnp.asarray(y), *a[:5], d=a[5], settle_method=method))(
            *(jnp.asarray(x) for x in (T, R, Q, Z, H, d))))
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        assert np.isfinite(want[:2]).all()
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-8)
    with pytest.raises(ValueError, match="settle_method"):
        port.stationary_kalman_loglik(
            *(torch.as_tensor(x) for x in (y, T, R, Q, Z, H)),
            settle_method="newton")


def _riccati_limit(T, RQR, Z, H, P, max_steps=20000):
    """Plain Riccati iteration from P, each system frozen once its step is
    below 1e-14 of max|P| (the oracle of the reference's pin)."""
    done = torch.zeros(T.shape[0], dtype=torch.bool)
    for _ in range(max_steps):
        P2 = port._dare_step(P, T, RQR, Z, H)
        small = (P2 - P).abs().amax(dim=(-2, -1)) < \
            1e-14 * P2.abs().amax(dim=(-2, -1))
        P = torch.where(done[:, None, None], P, P2)
        done = done | small
        if bool(done.all()):
            break
    return P


def test_settle_reaches_the_limit_from_the_open_loop_covariance():
    """``test_sda_settle_matches_brute_force_from_unconditional_covariance``
    (its Hewer half) on the port: with and without measurement error, at
    spectral radii up to 0.995, the settle equals plain Riccati iteration
    from the unconditional covariance (with H = 0 the DARE has several
    fixed points; this limit is the one the time-varying filter reaches)."""
    rng = np.random.default_rng(0)
    T, RQR, Z, H = [], [], [], []
    for rho in (0.5, 0.9, 0.97, 0.995):
        for h_scale in (0.0, 0.3):
            A = rng.standard_normal((8, 8))
            T.append(rho / np.abs(np.linalg.eigvals(A)).max() * A)
            R = rng.standard_normal((8, 3))
            RQR.append(R @ R.T)
            Z.append(rng.standard_normal((3, 8)))
            H.append(h_scale * np.eye(3))
    T, RQR, Z, H = (torch.as_tensor(np.stack(x)) for x in (T, RQR, Z, H))
    P_oracle = _riccati_limit(T, RQR, Z, H, _doubling(T, RQR, 1e-14, 60))
    P_h, settled = port._hewer_settle(T, RQR, Z, H, 48)
    assert bool(settled.all())
    scale = P_oracle.abs().amax(dim=(-2, -1))[:, None, None]
    assert bool(((P_h - P_oracle).abs() <= 1e-9 * scale).all())


def test_settle_unbiased_tiny_innovations():
    """``test_settle_unbiased_tiny_innovations`` on the port: no measurement
    error and shock scales 1e-2 .. 5e-4 shrink the Hewer iteration's
    quadratic basin; the adaptive settle's likelihood matches the one at a
    brute-force converged fixed point, while a fixed 4-stage settle is
    biased by more than 0.1."""
    T, R, Q, Z, H, d = _random_systems()
    T, R, Q, Z, H, d = (torch.as_tensor(x[2:3]) for x in (T, R, Q, Z, H, d))
    d = torch.zeros_like(d)
    rng = np.random.default_rng(8)
    L = np.linalg.cholesky(Q[0].numpy())
    x = np.zeros(8)
    ys = []
    for _ in range(150):
        x = T[0].numpy() @ x + R[0].numpy() @ (L @ rng.standard_normal(3))
        ys.append(Z[0].numpy() @ x)
    y = torch.as_tensor(np.stack(ys))
    RQR = R @ Q @ R.mT
    P_ref = RQR
    for _ in range(4000):
        P_ref = port._dare_step(P_ref, T, RQR, Z, H)
    resid = float((port._dare_step(P_ref, T, RQR, Z, H) - P_ref).abs().max())
    assert resid < 1e-8 * float(P_ref.abs().max())
    ll_ref = float(port.stationary_loglik_from_P(y, T, RQR, Z, H, d, None,
                                                   P_ref))
    ll_settle = float(port.stationary_kalman_loglik(y, T, R, Q, Z, H, d=d))
    assert np.isfinite(ll_ref)
    np.testing.assert_allclose(ll_settle, ll_ref,
                               atol=1e-4 * max(1.0, abs(ll_ref)) * 1e-2,
                               rtol=1e-6)
    P4 = _doubling(T, RQR, 1e-14, 60)
    for _ in range(4):
        PZt = P4 @ Z.mT
        Kp = T @ (PZt @ port._spd_inverse(Z @ PZt + H))
        P4 = _doubling(T - Kp @ Z, RQR, 1e-14, 60)
        P4 = 0.5 * (P4 + P4.mT)
    ll_4 = float(port.stationary_loglik_from_P(y, T, RQR, Z, H, d, None, P4))
    assert abs(ll_4 - ll_ref) > 0.1
