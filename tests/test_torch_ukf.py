"""Port parity: the unscented filters (``geconpy_torch/ops/ukf.py``).

Against the JAX package on the CPU, float64, one thread, on random
systems made with numpy from a seed (the reference's own test cases,
``tests/ops/test_ukf.py``):

- ``ukf_loglik`` (with missing data, and with other sigma-point weights),
  ``ukf_smoother`` and ``cl_ukf_loglik`` on nonlinear (quadratic) systems:
  log-likelihood, filtered means and covariances within rel 1e-8 of the
  reference; the gradient in a scale of the transition within rel 1e-6 of
  ``jax.grad``.
- On a linear system the filter equals the port's own Kalman filter
  (rel 1e-8, the unscented transform being exact there) and the smoother
  the port's RTS smoother (rel 1e-6).
- The checkpointed filter (``remat=True``) equals the stored one within
  1e-12 on values and gradients; a batch of systems equals each system
  alone, bitwise; an explosive transition flips ``success`` and raises
  nothing.
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

from geconpy_torch.ops import kalman as port_kalman
from geconpy_torch.ops import ukf as port
from geconpy_torch.ops.lyapunov import solve_discrete_lyapunov
from geconpy_tpu.ops import ukf as ref

VALUE_TOL, GRAD_TOL = 1e-8, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _system(seed=0, n=4, q=2, k=3, periods=40):
    """A stable linear system, a quadratic term G, data simulated from the
    linear part, and the stationary start."""
    rng = np.random.default_rng(seed)
    A = 0.3 * rng.standard_normal((n, n))
    T = 0.8 * A / max(1.0, np.abs(np.linalg.eigvals(A)).max())
    R = 0.5 * rng.standard_normal((n, q))
    Z = rng.standard_normal((k, n))
    Q = np.diag([0.04, 0.09][:q])
    H = 0.01 * np.eye(k)
    G = 0.3 * rng.standard_normal((n, n, n))
    x, ys = np.zeros(n), []
    for _ in range(periods):
        x = T @ x + R @ (np.sqrt(np.diag(Q)) * rng.standard_normal(q))
        ys.append(Z @ x + 0.1 * rng.standard_normal(k))
    P0 = np.asarray(solve_discrete_lyapunov(torch.as_tensor(T),
                                            torch.as_tensor(R @ Q @ R.T)))
    return dict(T=T, R=R, Z=Z, Q=Q, H=H, G=G, y=np.asarray(ys), P0=P0)


@pytest.fixture(scope="module")
def system():
    return _system()


def _fns(s, lib, scale=1.0, quad=0.0):
    """(transition, observe) of x' = scale T x + R e + quad 1/2 G(x, x),
    y = Z x: per draw for the reference, batched for the port."""
    if lib == "ref":
        T, R, Z, G = (jnp.asarray(s[k]) for k in "TRZG")
        return (lambda x, e: scale * (T @ x) + R @ e
                + quad * 0.5 * jnp.einsum("ijk,j,k->i", G, x, x),
                lambda x: Z @ x)
    T, R, Z, G = (torch.as_tensor(s[k]) for k in "TRZG")
    return (lambda x, e: scale * (x @ T.mT) + e @ R.mT
            + quad * 0.5 * ((x[..., :, None] * x[..., None, :]).flatten(-2)
                            @ G.flatten(-2).mT),
            lambda x: x @ Z.mT)


def _args(s, lib):
    conv = jnp.asarray if lib == "ref" else torch.as_tensor
    n = s["T"].shape[0]
    return conv(s["Q"]), conv(s["H"]), conv(np.zeros(n)), conv(s["P0"])


def _close(got, want, tol=VALUE_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("case", ["quadratic", "missing", "weights"])
def test_ukf_matches_reference(system, case):
    y = system["y"].copy()
    kw = {}
    if case == "missing":
        y[5:15, 0] = np.nan
        y[30, :] = np.nan
    if case == "weights":
        kw = dict(alpha=0.9, beta=2.0, kappa=1.0)
    want = ref.ukf_loglik(jnp.asarray(y), *_fns(system, "ref", quad=0.5),
                          *_args(system, "ref"), **kw)
    got = port.ukf_loglik(torch.as_tensor(y), *_fns(system, "port", quad=0.5),
                          *_args(system, "port"), **kw)
    assert bool(got.success) and bool(want.success)
    for g, w in zip(got[:4], want[:4]):
        _close(g, w)


def test_ukf_equals_kalman_on_linear_system(system):
    y = system["y"].copy()
    y[5:15, 0] = np.nan
    yt = torch.as_tensor(y)
    got = port.ukf_loglik(yt, *_fns(system, "port"), *_args(system, "port"))
    T, R, Z, Q, H, P0 = (torch.as_tensor(system[k])
                         for k in ("T", "R", "Z", "Q", "H", "P0"))
    kf = port_kalman.kalman_filter(yt, T, R, Q, Z, H, P0=P0)
    _close(got.loglik, kf.loglik.numpy())
    _close(got.filtered_mean, kf.filtered_mean.numpy(), 1e-6)


def test_smoother_matches_reference_and_rts(system):
    y = torch.as_tensor(system["y"])
    want = ref.ukf_smoother(jnp.asarray(system["y"]),
                            *_fns(system, "ref", quad=0.5),
                            *_args(system, "ref"))
    got = port.ukf_smoother(y, *_fns(system, "port", quad=0.5),
                            *_args(system, "port"))
    assert bool(got.success)
    for g, w in zip(got[:5], want[:5]):
        _close(g, w)
    lin = port.ukf_smoother(y, *_fns(system, "port"), *_args(system, "port"))
    T, R, Z, Q, H, P0 = (torch.as_tensor(system[k])
                         for k in ("T", "R", "Z", "Q", "H", "P0"))
    ks = port_kalman.kalman_smoother(y, T, R, Q, Z, H, P0=P0)
    _close(lin.smoothed_mean, ks.smoothed_mean.numpy(), 1e-6)


def _cl_case(system, lib):
    """A conditionally linear system: z = (y1, y2), y1' = T y1 + R e,
    y2' = T y2 + 1/2 G(y1, y1), observed through Z (y1 + y2)."""
    n = system["T"].shape[0]
    T, R, Z, G = (system[k] for k in "TRZG")
    A = np.block([[T, np.zeros((n, n))], [np.zeros((n, n)), T]])
    Zc = np.concatenate([Z, Z], axis=1)
    P0 = np.block([[system["P0"], np.zeros((n, n))],
                   [np.zeros((n, n)), 0.1 * system["P0"]]])
    if lib == "ref":
        Gj, Rj = jnp.asarray(G), jnp.asarray(R)

        def nonlinear(y1, e):
            return jnp.concatenate([Rj @ e,
                                    0.5 * jnp.einsum("ijk,j,k->i", Gj, y1,
                                                     y1)])
        conv = jnp.asarray
    else:
        Gt, Rt = torch.as_tensor(G), torch.as_tensor(R)

        def nonlinear(y1, e):
            quad = (y1[..., :, None] * y1[..., None, :]).flatten(-2) \
                @ Gt.flatten(-2).mT
            return torch.cat([e @ Rt.mT, 0.5 * quad], dim=-1)
        conv = torch.as_tensor
    return (conv(A), nonlinear, conv(Zc), conv(system["H"]), None,
            conv(system["Q"]), conv(np.zeros(2 * n)), conv(P0), n)


def test_marginalized_filter_matches_reference(system):
    y = system["y"].copy()
    y[7, 1] = np.nan
    want = ref.cl_ukf_loglik(jnp.asarray(y), *_cl_case(system, "ref"))
    got = port.cl_ukf_loglik(torch.as_tensor(y), *_cl_case(system, "port"))
    assert bool(got.success)
    for g, w in zip(got[:4], want[:4]):
        _close(g, w)


def test_gradient_matches_jax(system):
    y = system["y"]

    def ref_loss(scale):
        return ref.ukf_loglik(jnp.asarray(y),
                              *_fns(system, "ref", scale, 0.5),
                              *_args(system, "ref")).loglik

    want = float(jax.grad(ref_loss)(1.0))
    scale = torch.tensor(1.0, requires_grad=True)
    got = port.ukf_loglik(torch.as_tensor(y),
                          *_fns(system, "port", scale, 0.5),
                          *_args(system, "port")).loglik
    (g,) = torch.autograd.grad(got, scale)
    np.testing.assert_allclose(float(g), want, rtol=GRAD_TOL)


@pytest.mark.parametrize("marginalized", [False, True])
def test_checkpointed_filter_equals_stored(system, marginalized):
    y = torch.as_tensor(system["y"])
    out = []
    for remat in (False, True):
        scale = torch.tensor(1.0, requires_grad=True)
        if marginalized:
            case = list(_cl_case(system, "port"))
            case[0] = case[0] * scale
            ll = port.cl_ukf_loglik(y, *case, remat=remat).loglik
        else:
            ll = port.ukf_loglik(y, *_fns(system, "port", scale, 0.5),
                                 *_args(system, "port"), remat=remat).loglik
        out.append((float(ll.detach()),
                    float(torch.autograd.grad(ll, scale)[0])))
    np.testing.assert_allclose(out[1], out[0], rtol=1e-12)


def test_batch_equals_systems_one_at_a_time():
    systems = [_system(seed) for seed in range(3)]
    stack = {k: torch.as_tensor(np.stack([s[k] for s in systems]))
             for k in ("T", "R", "Z", "Q", "H", "P0", "G")}

    def fns(s):
        return (lambda x, e: x @ s["T"].mT + e @ s["R"].mT
                + 0.25 * ((x[..., :, None] * x[..., None, :]).flatten(-2)
                          @ s["G"].flatten(-2).mT),
                lambda x: x @ s["Z"].mT)

    y = torch.as_tensor(systems[0]["y"])
    batch = port.ukf_loglik(y, *fns(stack), stack["Q"], stack["H"],
                            torch.zeros(3, 4), stack["P0"])
    for i in range(3):
        one = {k: v[i:i + 1] for k, v in stack.items()}
        alone = port.ukf_loglik(y, *fns(one), one["Q"], one["H"],
                                torch.zeros(1, 4), one["P0"])
        for b, a in zip(batch, alone):
            assert torch.equal(b[i:i + 1], a)


def test_quadratic_mean_shift_and_failure_flag():
    """The predicted mean of x' = t x + 1/2 g (x² + e²) + e against its
    closed form (rel 1e-10, the reference's bar), and an explosive
    transition that flips ``success`` without raising."""
    t, g = 0.5, 0.4
    res = port.ukf_loglik(torch.tensor([[np.nan]]),
                          lambda x, e: t * x + 0.5 * g * (x * x + e * e) + e,
                          lambda x: x, torch.tensor([[0.25]]),
                          torch.tensor([[1e-4]]), torch.tensor([0.3]),
                          torch.tensor([[0.09]]))
    want = t * 0.3 + 0.5 * g * (0.3 ** 2 + 0.09 + 0.25)
    np.testing.assert_allclose(float(res.filtered_mean[0, 0]), want,
                               rtol=1e-10)
    bad = port.ukf_loglik(torch.ones(20, 1),
                          lambda x, e: torch.exp(x * 500.0) + e,
                          lambda x: x, 0.01 * torch.eye(1),
                          0.01 * torch.eye(1), torch.tensor([5.0]),
                          torch.eye(1))
    assert not bool(bad.success)
