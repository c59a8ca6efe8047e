"""Port parity: the SDA and auto settles of the stationary Kalman filter.

- ``_gj_inverse`` (the pivoted Gauss-Jordan inverse) equals the
  reference's at 1e-12, zero pivots, ties and NaN included, and its pivot
  rule is ``jnp.argmax``'s (first of equal scores, first NaN).
- ``_sda_settle``: the ``certified`` flags equal, and P within rel 1e-10
  of max|P| on the certified draws, on random systems across spectral
  radii with and without measurement error, on the degenerate exactly
  observed ones and on SW-2007's own DARE inputs.
- ``_auto_settle`` equals the reference's, including the degenerate
  exactly observed systems (H = 0) and the fallback when the SDA shift
  breaks (a noiseless observable no shock reaches in one period).
- ``stationary_kalman_loglik`` with ``"sda"`` and ``"auto"``: value 1e-8
  and gradient 1e-6 against ``jax.value_and_grad``; the reference's
  tiny-innovation and non-finite pins on both sides.
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


def _t(*xs):
    return tuple(torch.as_tensor(np.asarray(x)) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(np.asarray(x)) for x in xs)


def _brute_force_systems():
    """The systems of the reference's
    ``test_sda_settle_matches_brute_force_from_unconditional_covariance``:
    spectral radii 0.5-0.995, H = 0 and H = 0.3 I, stacked."""
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
    return tuple(np.stack(x) for x in (T, RQR, Z, H))


def _degenerate_systems():
    """``test_sda_certificate_is_honest_on_degenerate_exact_observation``'s
    six exactly observed systems (H = 0, several PSD fixed points)."""
    rng = np.random.default_rng(0)
    T, RQR, Z = [], [], []
    for _ in range(6):
        A = rng.standard_normal((8, 8))
        T.append(0.97 / np.abs(np.linalg.eigvals(A)).max() * A)
        R = rng.standard_normal((8, 3))
        RQR.append(R @ R.T)
        Z.append(rng.standard_normal((3, 8)))
    return np.stack(T), np.stack(RQR), np.stack(Z), np.zeros((6, 3, 3))


def _unreached_observable():
    """``test_auto_settle_falls_back_when_sda_uncertified``'s system:
    H + Z RQR Zᵀ singular, so the SDA shift breaks."""
    T = 0.8 * np.asarray(jax.random.orthogonal(
        jax.random.split(jax.random.PRNGKey(30))[0], 5))
    R = np.zeros((5, 1))
    R[0, 0] = 1.0
    Z = np.zeros((2, 5))
    Z[0, 0] = Z[1, 2] = 1.0
    return T, R, np.eye(1), Z, np.zeros((2, 2)), np.zeros(2)


def _simulate(rng, T, R, Q, Z, periods, noise=0.05):
    L = np.linalg.cholesky(Q)
    x = np.zeros(T.shape[-1])
    ys = []
    for _ in range(periods):
        x = T @ x + R @ (L @ rng.standard_normal(L.shape[0]))
        ys.append(Z @ x)
    return np.stack(ys) + noise * rng.standard_normal((periods, Z.shape[0]))


@pytest.fixture(scope="module")
def sw_dare_inputs():
    model = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn("sw2007"),
                                         verbose=False)
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


@pytest.mark.parametrize("case", ["zero_pivots", "permutation_ties",
                                  "random_batch", "nan"])
def test_gj_inverse_matches_reference(case):
    """``test_gj_inverse_handles_zero_pivots`` on the port and against the
    reference: zero diagonals, tied pivot candidates, a shifted random
    batch, and a NaN entry (which the first-NaN pivot rule must place as
    the reference does)."""
    if case == "zero_pivots":
        W = np.array([[[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 2.0]]])
    elif case == "permutation_ties":
        W = np.array([[[1.0, 1.0, 0.0], [1.0, -1.0, 1.0], [0.0, 1.0, 1.0]],
                      [[2.0, 0.0, 2.0], [2.0, 1.0, 0.0], [0.0, 2.0, 2.0]]])
    elif case == "random_batch":
        W = np.random.default_rng(3).standard_normal((5, 12, 12)) \
            + 5.0 * np.eye(12)
    else:
        W = np.random.default_rng(4).standard_normal((2, 6, 6)) + 3 * np.eye(6)
        W[1, 2, 0] = np.nan
    got = port._gj_inverse(torch.as_tensor(W)).numpy()
    want = np.asarray(jax.vmap(ref._gj_inverse)(jnp.asarray(W)))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12, atol=1e-12)
    if case != "nan":
        err = np.abs(got @ W - np.eye(W.shape[-1])).max()
        assert err < 1e-12


def test_first_argmax_follows_jnp_argmax():
    scores = np.array([[1.0, 3.0, 3.0, -1.0], [2.0, np.nan, 5.0, np.nan],
                       [-1.0, -1.0, -1.0, -1.0], [0.0, 0.0, 7.0, 7.0]])
    got = port._first_argmax(torch.as_tensor(scores)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.argmax(
        jnp.asarray(scores), axis=-1)))


@pytest.mark.parametrize("case", ["brute_force", "sw2007", "degenerate"])
def test_sda_settle_matches_reference(case, request):
    if case == "sw2007":
        T, RQR, Z, H = request.getfixturevalue("sw_dare_inputs")
    elif case == "brute_force":
        T, RQR, Z, H = _brute_force_systems()
    else:
        T, RQR, Z, H = _degenerate_systems()
    P_r, cert_r = jax.jit(jax.vmap(ref._sda_settle))(*_j(T, RQR, Z, H))
    P_p, cert_p = port._sda_settle(*_t(T, RQR, Z, H))
    np.testing.assert_array_equal(cert_p.numpy(), np.asarray(cert_r))
    # an uncertified iterate is off the fixed point (the from-zero doubling
    # may head for another one), where rounding moves it arbitrarily far:
    # both sides reject it, so P is held on the certified draws
    P_r, cert = np.asarray(P_r), cert_p.numpy()
    scale = np.abs(P_r[cert]).max(axis=(-2, -1))[:, None, None]
    assert (np.abs(P_p.numpy()[cert] - P_r[cert]) <= 1e-10 * scale).all()
    if case == "brute_force":
        assert int(cert_p.sum()) >= 5
    if case == "sw2007":
        assert bool(cert_p.all())


@pytest.mark.parametrize("case", ["degenerate", "brute_force", "sw2007"])
def test_auto_settle_matches_reference(case, request):
    """The auto settle's P and flags equal the reference's; on the
    degenerate exactly observed systems it also equals the Hewer settle,
    certified draws through the start correction and the others through
    the fallback (the reference's :318 pin)."""
    if case == "sw2007":
        T, RQR, Z, H = request.getfixturevalue("sw_dare_inputs")
    elif case == "brute_force":
        T, RQR, Z, H = _brute_force_systems()
    else:
        T, RQR, Z, H = _degenerate_systems()
    P_r, set_r = jax.jit(jax.vmap(lambda *a: ref._auto_settle(*a, 48)))(
        *_j(T, RQR, Z, H))
    P_a, set_a = port._auto_settle(*_t(T, RQR, Z, H), 48)
    np.testing.assert_array_equal(set_a.numpy(), np.asarray(set_r))
    assert bool(set_a.all())
    scale = np.abs(np.asarray(P_r)).max(axis=(-2, -1))[:, None, None]
    assert (np.abs(P_a.numpy() - np.asarray(P_r)) <= 1e-10 * scale).all()
    P_h, set_h = port._hewer_settle(*_t(T, RQR, Z, H), 48)
    np.testing.assert_array_equal(set_h.numpy(), set_a.numpy())
    assert (np.abs(P_a.numpy() - P_h.numpy()) <= 1e-8 * scale).all()


def test_auto_settle_falls_back_when_sda_uncertified():
    """The reference's :366 pin on both sides: the SDA certificate fails,
    ``"sda"`` rejects the draw as -inf, ``"auto"`` gives the Hewer
    likelihood (here -inf too, on both sides: the second observable is
    exact and unreached, so its innovation variance vanishes) and the
    Hewer fixed point through its fallback."""
    T, R, Q, Z, H, d = _unreached_observable()
    RQR = R @ Q @ R.T
    assert np.linalg.matrix_rank(Z @ RQR @ Z.T) < 2
    _P, cert = port._sda_settle(*_t(T, RQR, Z, H))
    _P, cert_r = ref._sda_settle(*_j(T, RQR, Z, H))
    assert not bool(cert) and not bool(cert_r)
    y = _simulate(np.random.default_rng(31), T, R, Q, Z, 60, noise=1e-9)
    lls = {}
    for method in ("hewer", "auto", "sda"):
        lls[method] = float(port.stationary_kalman_loglik(
            *_t(y, T, R, Q, Z, H), d=torch.as_tensor(d),
            settle_method=method))
        want = float(ref.stationary_kalman_loglik(
            *_j(y, T, R, Q, Z, H), d=jnp.asarray(d), settle_method=method))
        if np.isfinite(want):
            np.testing.assert_allclose(lls[method], want, rtol=1e-8)
        else:
            assert lls[method] == want
    assert lls["sda"] == -np.inf
    np.testing.assert_allclose(lls["auto"], lls["hewer"], rtol=1e-9)
    # the fallback's fixed point: the Hewer settle's, on both sides
    P_a, set_a = port._auto_settle(*_t(T, RQR, Z, H), 48)
    P_h, set_h = port._hewer_settle(*_t(T, RQR, Z, H), 48)
    P_r, set_r = ref._auto_settle(*_j(T, RQR, Z, H), 48)
    assert bool(set_a) and bool(set_h) and bool(set_r)
    scale = float(np.abs(np.asarray(P_r)).max())
    np.testing.assert_allclose(P_a.numpy(), np.asarray(P_r), rtol=0,
                               atol=1e-10 * scale)
    np.testing.assert_allclose(P_a.numpy(), P_h.numpy(), rtol=0,
                               atol=1e-10 * scale)


def _random_systems(seed=1, n=8, k=3, m=3):
    """Two stable systems with measurement error and one tiny-innovation
    system without it (``tests/test_torch_kalman.py``'s)."""
    rng = np.random.default_rng(seed)
    T, R, Q, Z, H = [], [], [], [], []
    for i in range(3):
        q, r = np.linalg.qr(rng.standard_normal((n, n)))
        T.append((0.97 if i == 2 else 0.85) * q * np.sign(np.diag(r)))
        R.append(rng.standard_normal((n, m)) / np.sqrt(m))
        Q.append(np.diag(np.array([1e-2, 2e-3, 5e-4]) ** 2) if i == 2
                 else np.diag(0.05 + rng.uniform(size=m)))
        Z.append(rng.standard_normal((k, n)) / np.sqrt(n))
        H.append(np.zeros((k, k)) if i == 2
                 else np.diag(0.01 + 0.05 * rng.uniform(size=k)))
    T, R, Q, Z, H = (np.stack(x) for x in (T, R, Q, Z, H))
    return T, R, Q, Z, H, 0.1 * rng.standard_normal((3, k))


@pytest.mark.parametrize("method", ["sda", "auto"])
def test_stationary_loglik_value_and_gradient_match_reference(method):
    T, R, Q, Z, H, d = _random_systems()
    y = _simulate(np.random.default_rng(2), T[0], R[0], Q[0], Z[0], 80)

    def one(T_, R_, Q_, Z_, H_, d_):
        return ref.stationary_kalman_loglik(jnp.asarray(y), T_, R_, Q_, Z_,
                                            H_, d=d_, n_settle=32,
                                            settle_method=method)

    vals_r, grads_r = jax.jit(jax.vmap(jax.value_and_grad(
        one, argnums=tuple(range(6)))))(*_j(T, R, Q, Z, H, d))
    leaves = [x.requires_grad_(True) for x in _t(T, R, Q, Z, H, d)]
    vals = port.stationary_kalman_loglik(torch.as_tensor(y), *leaves[:5],
                                         d=leaves[5], n_settle=32,
                                         settle_method=method)
    vals_r = np.asarray(vals_r)
    fin = np.isfinite(vals_r)
    np.testing.assert_array_equal(np.isfinite(vals.detach().numpy()), fin)
    assert fin[:2].all()
    np.testing.assert_allclose(vals.detach().numpy()[fin], vals_r[fin],
                               rtol=1e-8)
    grads = torch.autograd.grad(vals[torch.as_tensor(fin)].sum(), leaves)
    for g, r, name in zip(grads, grads_r, ["T", "R", "Q", "Z", "H", "d"]):
        r = np.asarray(r)[fin]
        np.testing.assert_allclose(g.numpy()[fin], r, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(r).max()),
                                   err_msg=f"grad wrt {name}")


def test_sda_and_auto_unbiased_tiny_innovations():
    """The reference's :404 pin on the port: on the ill-conditioned
    fixture (no measurement error, shock scales 1e-2 .. 5e-4) the SDA path
    matches the brute-force DARE likelihood or rejects the draw, the auto
    path matches it, and both equal the reference's."""
    T, R, Q, Z, H, d = _random_systems(seed=0)
    T, R, Q, Z, H = (x[2] for x in (T, R, Q, Z, H))
    d = np.zeros(3)
    y = _simulate(np.random.default_rng(8), T, R, Q, Z, 150, noise=1e-9)
    RQR = R @ Q @ R.T
    P_ref = torch.as_tensor(RQR)
    Tt, RQRt, Zt, Ht = _t(T, RQR, Z, H)
    for _ in range(4000):
        P_ref = port._dare_step(P_ref, Tt, RQRt, Zt, Ht)
    ll_ref = float(port.stationary_loglik_from_P(
        *_t(y, T, RQR, Z, H, d), None, P_ref))
    for method in ("sda", "auto"):
        ll = float(port.stationary_kalman_loglik(
            *_t(y, T, R, Q, Z, H), d=torch.as_tensor(d), settle_method=method))
        want = float(ref.stationary_kalman_loglik(
            *_j(y, T, R, Q, Z, H), d=jnp.asarray(d), settle_method=method))
        assert ll == -np.inf or abs(ll - ll_ref) < 1e-6 * abs(ll_ref), method
        # with H = 0 and noise of 1e-9 a rounding-level change of P moves
        # this likelihood by ~1e-7 relative: the pin's own bar, 1e-6
        if np.isfinite(want):
            np.testing.assert_allclose(ll, want, rtol=1e-6)
        else:
            assert ll == want
    ll_auto = float(port.stationary_kalman_loglik(
        *_t(y, T, R, Q, Z, H), d=torch.as_tensor(d), settle_method="auto"))
    np.testing.assert_allclose(ll_auto, ll_ref, rtol=1e-6)


@pytest.mark.parametrize("method", ["sda", "auto"])
def test_nonfinite_settle_rejected_as_neg_inf(method):
    """The reference's :441 pin with both settles: a NaN in T gives -inf,
    never NaN, and leaves the batch's other draws as they are."""
    T, R, Q, Z, H, d = _random_systems()
    y = _simulate(np.random.default_rng(12), T[0], R[0], Q[0], Z[0], 40)
    T_bad = T.copy()
    T_bad[1, 0, 0] = np.nan
    got = port.stationary_kalman_loglik(*_t(y, T_bad, R, Q, Z, H),
                                        d=torch.as_tensor(d),
                                        settle_method=method).numpy()
    alone = port.stationary_kalman_loglik(*_t(y, T, R, Q, Z, H),
                                          d=torch.as_tensor(d),
                                          settle_method=method).numpy()
    assert got[1] == -np.inf
    np.testing.assert_array_equal(got[[0, 2]], alone[[0, 2]])
    want = float(ref.stationary_kalman_loglik(
        *_j(y, T_bad[1], R[1], Q[1], Z[1], H[1]), d=jnp.asarray(d[1]),
        settle_method=method))
    assert want == -np.inf
