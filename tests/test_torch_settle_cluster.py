"""Port parity at the shapes the cluster tier of K2 and K5 adds on the card.

On the card the settle wrappers send a draw too large for one block's
shared memory to the cluster kernel (``csrc/settle_cluster.cu``: the draw's
buffers in row panels over a thread-block cluster), which runs the
schedule of the plain versions ``_settle_plain`` and ``_settle_filter_plain``
(``tests/test_torch_cuda.py`` holds it to them).  Here the plain versions
meet the reference's Pallas kernels in interpret mode at the cluster
shapes that ``tests/test_torch_large_state.py`` does not cover: n = 130
with k = 7 (a cluster of three CTAs or more) and n = 104 with k = 14 (the
filter state of SW-2007 with year-on-year inflation and twice its
observables, so the elimination runs in shared memory), on two draws of
synthetic stable systems from a numpy seed over 32 periods: K2 settles all
32, K5 settles 8 and runs the constant-gain tail over the rest.  Rel 1e-10
(``|a - b| / (1 + |b|)``), float64, one thread.
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

from geconpy_torch.ops.batched_settle import settle_filter_loglik, settle_parts
from geconpy_tpu.ops.pallas_settle import (pallas_settle_filter_loglik,
                                           pallas_settle_parts)

CLUSTER_NK = [(130, 7), (104, 14)]
BATCH, N_OBS, N_SETTLE = 2, 32, 8


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


@pytest.mark.parametrize("n,k", CLUSTER_NK)
def test_settle_parts_matches_pallas_interpret_at_cluster_shapes(n, k):
    arrays = _stable_system(n, k, seed=5 * n + k)
    ref = jax.jit(lambda *a: pallas_settle_parts(
        *a, tile=BATCH, interpret=True))(*(jnp.asarray(a) for a in arrays))
    got = settle_parts(*(torch.as_tensor(a) for a in arrays))
    for name, r, g in zip(["ll_head", "x_pred0", "M", "TK", "Finv", "const"],
                          ref, got):
        assert _rel(g.numpy(), r) < 1e-10, name


@pytest.mark.parametrize("n,k", CLUSTER_NK)
def test_settle_filter_loglik_matches_pallas_interpret_at_cluster_shapes(n, k):
    arrays = _stable_system(n, k, seed=6 * n + k)
    ref = jax.jit(lambda *a: pallas_settle_filter_loglik(
        *a, n_settle=N_SETTLE, tile=BATCH, interpret=True))(
        *(jnp.asarray(a) for a in arrays))
    got = settle_filter_loglik(*(torch.as_tensor(a) for a in arrays),
                               n_settle=N_SETTLE)
    assert _rel(got.numpy(), ref) < 1e-10
