"""Port parity: the cyclostationary Kalman filter of mixed-frequency data.

- ``detect_mask_period`` gives the reference's periods on the reference's
  cases (``tests/ops/test_cyclo_kalman.py:23, :310``).
- ``cyclostationary_kalman_loglik``: value (1e-8) and gradient with
  respect to T, R, Q, Z, H and d (1e-6) against ``jax.value_and_grad``,
  for mask periods 1, 2 and 3 on 31 periods (no multiple of p).
- p = 1 with every series observed equals the port's stationary filter.
- The non-convergent and unstable cases of the reference's tests give
  -inf, or the reference's finite value, on both sides, never NaN.
- A batch of draws equals its per-draw runs.
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

from geconpy_torch.ops import cyclo_kalman as port
from geconpy_torch.ops.kalman import stationary_kalman_loglik
from geconpy_tpu.ops import cyclo_kalman as ref

PATTERNS = {1: np.array([[True, True]]),
            2: np.array([[True, False], [True, True]]),
            3: np.array([[True, False], [True, False], [True, True]])}


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


def make_system(seed=0, n=4, k=2, n_shocks=2):
    """The reference test's ``make_system``."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    T = 0.85 * M / np.max(np.abs(np.linalg.eigvals(M)))
    R = rng.normal(size=(n, n_shocks))
    Q = np.diag(rng.uniform(0.5, 1.5, n_shocks) * 0.01)
    Z = rng.normal(size=(k, n))
    H = np.diag(rng.uniform(0.5, 1.5, k) * 0.001)
    d = rng.normal(size=(k,)) * 0.1
    return T, R, Q, Z, H, d


def simulate(T, R, Q, Z, H, d, periods, seed=1):
    rng = np.random.default_rng(seed)
    x = np.zeros(T.shape[0])
    ys = []
    cq, ch = np.linalg.cholesky(Q), np.linalg.cholesky(H)
    for _ in range(periods):
        x = T @ x + R @ (cq @ rng.normal(size=R.shape[1]))
        ys.append(Z @ x + d + ch @ rng.normal(size=Z.shape[0]))
    return np.asarray(ys)


def _masked(y, pattern):
    periods, p = y.shape[0], pattern.shape[0]
    mask = np.tile(pattern, (periods // p + 1, 1))[:periods]
    return np.where(mask, y, np.nan)


def test_detect_mask_period_matches_reference():
    rng = np.random.default_rng(0)
    aperiodic = rng.random((20, 2)) > 0.5
    aperiodic[0, 0], aperiodic[1, 0] = True, False
    p5 = np.ones((5, 2), bool)
    p5[1, 0] = p5[4, 1] = False
    p3 = np.ones((3, 1), bool)
    p3[2, 0] = False
    hole = np.ones((30, 1), bool)
    hole[13, 0] = False
    p30 = np.ones((30, 1), bool)
    p30[29, 0] = False
    cases = [(np.tile(PATTERNS[3], (7, 1))[:20], {}),
             (np.ones((10, 2), bool), {}), (aperiodic, {"max_period": 8}),
             (np.ones((30, 2), bool), {}), (np.tile(p5, (5, 1))[:23], {}),
             (np.tile(p3, (8, 1)), {}), (hole, {}),
             (np.tile(p30, (3, 1)), {"max_period": 24}),
             (np.tile(p30, (3, 1)), {"max_period": 30})]
    got = [port.detect_mask_period(m, **kw) for m, kw in cases]
    assert got == [ref.detect_mask_period(m, **kw) for m, kw in cases]
    assert got == [3, 1, None, 1, 5, 3, None, None, 30]


@pytest.mark.parametrize("p", [1, 2, 3])
def test_value_and_gradient_match_reference(p):
    T, R, Q, Z, H, d = make_system(seed=3 + p)
    y = _masked(simulate(T, R, Q, Z, H, d, 31), PATTERNS[p])

    def one(*a):
        return ref.cyclostationary_kalman_loglik(
            jnp.asarray(y), *a[:5], d=a[5], mask_pattern=PATTERNS[p])

    val_r, grads_r = jax.jit(jax.value_and_grad(one, argnums=tuple(range(6))))(
        *_j(T, R, Q, Z, H, d))
    leaves = [x.requires_grad_(True) for x in _t(T, R, Q, Z, H, d)]
    val = port.cyclostationary_kalman_loglik(
        torch.as_tensor(y), *leaves[:5], d=leaves[5],
        mask_pattern=PATTERNS[p])
    grads = torch.autograd.grad(val, leaves)
    assert np.isfinite(float(val_r))
    np.testing.assert_allclose(float(val.detach()), float(val_r), rtol=1e-8)
    for g, r, name in zip(grads, grads_r, ["T", "R", "Q", "Z", "H", "d"]):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(r).max()),
                                   err_msg=f"grad wrt {name}")


def test_p1_equals_the_stationary_filter():
    """``test_p1_reduces_to_stationary_filter`` on the port."""
    T, R, Q, Z, H, d = _t(*make_system(seed=7))
    y = torch.as_tensor(simulate(*make_system(seed=7), periods=40))
    ll_stat = stationary_kalman_loglik(y, T, R, Q, Z, H, d=d)
    ll_cyclo = port.cyclostationary_kalman_loglik(
        y, T, R, Q, Z, H, d=d, mask_pattern=np.ones((1, 2), dtype=bool))
    np.testing.assert_allclose(float(ll_cyclo), float(ll_stat), rtol=1e-9)


def _tiny_innovation_system(seed, q_diag):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    n, k = 8, 3
    T = 0.97 * np.asarray(jax.random.orthogonal(k1, n))
    R = np.asarray(jax.random.normal(k2, (n, k))) / np.sqrt(k)
    Q = np.diag(np.asarray(q_diag) ** 2)
    Z = np.asarray(jax.random.normal(k3, (k, n))) / np.sqrt(n)
    return T, R, Q, Z, np.zeros((k, k)), np.zeros(k)


@pytest.mark.parametrize("case", ["unstable_blind", "unstable_detectable",
                                  "tiny_innovations", "nonconvergent"])
def test_hard_cases_match_reference_and_never_nan(case):
    """The reference's pins (``tests/ops/test_cyclo_kalman.py:181-207,
    :232-307``) on both sides: an unstable system with Z = 0 (no settle:
    finite-or--inf, never NaN), an unstable but detectable one (finite),
    the no-measurement-error tiny-innovation fixture with the warmup
    starved to one cycle, and shock scales that need more stages than the
    cap (converged or -inf)."""
    kw = {}
    if case.startswith("unstable"):
        T, R, Q, Z, H, d = make_system(seed=17)
        y = simulate(T, R, Q, Z, H, d, periods=12)
        if case == "unstable_blind":
            T, Z = 3.0 * T, np.zeros_like(Z)
        else:
            T = 1.2 * T
        pattern = np.array([[True, True]])
    else:
        q = [1e-2, 2e-3, 5e-4] if case == "tiny_innovations" \
            else [1e-2, 1e-8, 1e-10]
        T, R, Q, Z, H, d = _tiny_innovation_system(
            21 if case == "tiny_innovations" else 33, q)
        pattern = np.array([[True, True, True], [True, False, True]])
        y = _masked(simulate(T, R, Q * 1e-12, Z, np.eye(3) * 1e-18, d, 60,
                             seed=22), pattern)
        kw = {"n_settle": 1} if case == "tiny_innovations" else {}
    got = float(port.cyclostationary_kalman_loglik(
        *_t(y, T, R, Q, Z, H), d=torch.as_tensor(d), mask_pattern=pattern,
        **kw))
    want = float(ref.cyclostationary_kalman_loglik(
        *_j(y, T, R, Q, Z, H), d=jnp.asarray(d), mask_pattern=pattern, **kw))
    assert not np.isnan(got) and not np.isnan(want)
    if np.isfinite(want):
        np.testing.assert_allclose(got, want, rtol=1e-8)
    else:
        assert got == want
    if case == "unstable_blind":
        assert got < 0
    if case in ("unstable_detectable", "tiny_innovations"):
        assert np.isfinite(got)


def test_batch_equals_per_draw_runs():
    """``test_vmap_and_jit_over_draws`` on the port: T scaled by 0.9, 0.95
    and 1.0, plus a draw whose T holds a NaN (-inf, and no effect on the
    others); the batch equals each draw run alone."""
    T, R, Q, Z, H, d = make_system(seed=13)
    y = _masked(simulate(T, R, Q, Z, H, d, 30), PATTERNS[2])
    Ts = np.stack([T * s for s in (0.9, 0.95, 1.0, 1.0)])
    Ts[3, 1, 2] = np.nan
    yt = torch.as_tensor(y)
    rest = _t(R, Q, Z, H)
    batch = port.cyclostationary_kalman_loglik(
        yt, torch.as_tensor(Ts), *rest, d=torch.as_tensor(d),
        mask_pattern=PATTERNS[2]).numpy()
    alone = [float(port.cyclostationary_kalman_loglik(
        yt, torch.as_tensor(t[None]), *rest, d=torch.as_tensor(d),
        mask_pattern=PATTERNS[2])[0]) for t in Ts]
    assert np.isfinite(batch[:3]).all() and batch[3] == -np.inf
    np.testing.assert_allclose(batch, alone, rtol=1e-12)
    want = [float(ref.cyclostationary_kalman_loglik(
        jnp.asarray(y), *_j(t, R, Q, Z, H), d=jnp.asarray(d),
        mask_pattern=PATTERNS[2])) for t in Ts[:3]]
    np.testing.assert_allclose(batch[:3], want, rtol=1e-8)
