"""Port parity: the Chandrasekhar and parallel filters, and every filter of
the log posterior.

- ``chandrasekhar_loglik`` and ``parallel_kalman_loglik`` equal the
  reference's in value (1e-8) and gradient with respect to T, R, Q, Z, H
  and d (1e-6), batched over three systems against the reference's
  per-draw calls; the parallel filter on 1, 2, 7 and 21 periods (every
  branch of the scan's odd/even recursion), with scattered NaN, and from
  a diffuse P0 (``tests/ops/test_parallel_kalman.py:38-174``).  Its
  filtered and predicted moments equal the reference's (1e-10 of scale).
- ``build_logpost`` on ``rbc_estimation`` (Y observed, measurement error on
  it) configured with ``filter_type="steady_state"`` (the differentiable
  branch) and ``"chandrasekhar"`` equals the reference's
  under ``jax.jit``: value 1e-8, gradient 1e-6
  (``tests/test_torch_filter_types.py`` holds the other filter types).
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

from geconpy_torch.ops import chandrasekhar as port_ch
from geconpy_torch.ops import parallel_kalman as port_par
from geconpy_tpu.ops import chandrasekhar as ref_ch
from geconpy_tpu.ops import parallel_kalman as ref_par

from _torch_filter_cases import assert_logpost_matches, rbc_case


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _systems(seed=0, n=5, k=2, m=2, batch=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(batch):
        M = rng.normal(size=(n, n))
        T = (0.9 - 0.2 * i) * M / np.max(np.abs(np.linalg.eigvals(M)))
        R = rng.normal(size=(n, m))
        Q = np.diag(rng.uniform(0.5, 1.5, m) * 0.01)
        Z = rng.normal(size=(k, n))
        H = np.diag(rng.uniform(0.5, 1.5, k) * 0.001)
        d = rng.normal(size=(k,)) * 0.1
        out.append((T, R, Q, Z, H, d))
    return tuple(np.stack(x) for x in zip(*out))


def _value_grad_both(ref_fn, port_fn, y, sys_, **kw):
    def one(*a):
        return ref_fn(jnp.asarray(y), *a[:5], d=a[5], **kw)

    vals_r, grads_r = jax.jit(jax.vmap(jax.value_and_grad(
        one, argnums=tuple(range(6)))))(*(jnp.asarray(x) for x in sys_))
    leaves = [torch.as_tensor(x).requires_grad_(True) for x in sys_]
    vals = port_fn(torch.as_tensor(y), *leaves[:5], d=leaves[5], **kw)
    grads = torch.autograd.grad(vals.sum(), leaves)
    assert np.isfinite(np.asarray(vals_r)).all()
    np.testing.assert_allclose(vals.detach().numpy(), np.asarray(vals_r),
                               rtol=1e-8)
    for g, r, name in zip(grads, grads_r, ["T", "R", "Q", "Z", "H", "d"]):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(r).max()),
                                   err_msg=f"grad wrt {name}")


@pytest.mark.parametrize("periods", [7, 37])
def test_chandrasekhar_matches_reference(periods):
    sys_ = _systems()
    y = 0.1 * np.random.default_rng(periods).normal(size=(periods, 2))
    _value_grad_both(ref_ch.chandrasekhar_loglik, port_ch.chandrasekhar_loglik,
                     y, sys_)


@pytest.mark.parametrize("periods,missing", [(1, False), (2, False),
                                             (7, False), (21, True)])
def test_parallel_loglik_matches_reference(periods, missing):
    sys_ = _systems(seed=1)
    y = 0.1 * np.random.default_rng(periods).normal(size=(periods, 2))
    if missing:
        y[[3, 11, 20], 0] = np.nan
        y[14, :] = np.nan
    _value_grad_both(ref_par.parallel_kalman_loglik,
                     port_par.parallel_kalman_loglik, y, sys_)


def test_parallel_filter_moments_and_diffuse_start_match_reference():
    """The filtered and predicted moments of the parallel filter, from the
    unconditional covariance and from a diffuse P0 = 1e4 I, equal the
    reference's; the parallel log-likelihood equals the sequential one's
    up to the parallel filter's 1e-12 jitter of the process noise."""
    sys_ = _systems(seed=2)
    y = 0.1 * np.random.default_rng(9).normal(size=(24, 2))
    y[5, 1] = np.nan
    n = sys_[0].shape[-1]
    for P0 in (None, 1e4 * np.eye(n)):
        def one(*a):
            return ref_par.parallel_kalman_filter(
                jnp.asarray(y), *a[:5], d=a[5],
                P0=None if P0 is None else jnp.asarray(P0))

        want = jax.jit(jax.vmap(one))(*(jnp.asarray(x) for x in sys_))
        got = port_par.parallel_kalman_filter(
            torch.as_tensor(y), *(torch.as_tensor(x) for x in sys_[:5]),
            d=torch.as_tensor(sys_[5]),
            P0=None if P0 is None else torch.as_tensor(P0))
        for name in got._fields:
            w = np.asarray(getattr(want, name))
            np.testing.assert_allclose(getattr(got, name).numpy(), w,
                                       rtol=1e-10,
                                       atol=1e-10 * float(np.abs(w).max()),
                                       err_msg=f"{name}, P0 {P0 is None}")
    from geconpy_torch.ops.kalman import kalman_loglik

    seq = kalman_loglik(torch.as_tensor(y), *(torch.as_tensor(x)
                                              for x in sys_[:5]),
                        d=torch.as_tensor(sys_[5]))
    par = port_par.parallel_kalman_loglik(
        torch.as_tensor(y), *(torch.as_tensor(x) for x in sys_[:5]),
        d=torch.as_tensor(sys_[5]))
    np.testing.assert_allclose(par.numpy(), seq.numpy(), rtol=1e-7)


CONFIGS = {
    "steady_state": dict(filter_type="steady_state", kalman_settle=16),
    "chandrasekhar": dict(filter_type="chandrasekhar"),
}


@pytest.fixture(scope="module")
def rbc():
    return rbc_case()


@pytest.mark.parametrize("config", list(CONFIGS))
def test_build_logpost_matches_reference_for_each_filter(config, rbc):
    assert_logpost_matches(rbc, CONFIGS[config])
