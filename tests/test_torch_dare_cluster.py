"""Port parity at the shapes the cluster tier of K6 adds on the card.

On the card the DARE wrapper sends a draw too large for one block's shared
memory to the cluster kernel (``csrc/dare.cu``: the draw's buffers in row
panels over a thread-block cluster), which runs the schedule of the plain
version ``_dare_plain`` (``tests/test_torch_cuda.py`` holds it to that).
Here the plain version meets the reference's Pallas kernel in interpret
mode at the cluster shapes that ``tests/test_torch_large_state.py`` does
not cover: n = 130 with k = 7 (a cluster of five CTAs on an H100) and n =
104 with k = 14 (the filter state of SW-2007 with year-on-year inflation
and twice its observables, so that S is eliminated in shared memory), on
two draws of synthetic stable systems from a numpy seed, at rel 1e-10
(``|a - b| / (1 + |b|)``); and a pair at n = 104 without measurement error
(H = 0), where the residual gate (``dare_residual_settled``) must settle
the same draws on both sides.  Float64, one thread.
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

from geconpy_torch.ops.batched_dare import dare_settle
from geconpy_torch.ops.kalman import dare_residual_settled
from geconpy_tpu.ops.kalman import \
    dare_residual_settled as ref_dare_residual_settled
from geconpy_tpu.ops.pallas_dare import pallas_dare_settle

CLUSTER_NK = [(130, 7), (104, 14)]
BATCH = 2


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


def _dare_system(n, k, seed, h_scale=1.0):
    """numpy float64 (T, R Q R', Z, H): T of spectral radius 0.9, R Q R'
    positive definite, H = h_scale times a positive definite matrix
    (``tests/test_torch_cuda.py``'s systems)."""
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((BATCH, n, n))
    T *= 0.9 / np.abs(np.linalg.eigvals(T)).max(axis=-1)[:, None, None]
    G = rng.standard_normal((BATCH, n, n))
    RQR = G @ G.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    Z = rng.standard_normal((BATCH, k, n))
    E = rng.standard_normal((BATCH, k, k))
    H = h_scale * (E @ E.transpose(0, 2, 1) / k + 0.1 * np.eye(k))
    return T, RQR, Z, H


def _both(arrays):
    """The reference's P (interpret mode) and the port's, as numpy."""
    ref = jax.jit(lambda *a: pallas_dare_settle(
        *a, tile=BATCH, interpret=True))(*(jnp.asarray(a) for a in arrays))
    got = dare_settle(*(torch.as_tensor(a) for a in arrays))
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("n,k", CLUSTER_NK)
def test_dare_settle_matches_pallas_interpret_at_cluster_shapes(n, k):
    ref, got = _both(_dare_system(n, k, seed=7 * n + k))
    assert _rel(got, ref) < 1e-10
    assert np.array_equal(got, got.transpose(0, 2, 1))


def test_dare_settle_without_measurement_error_settles_as_the_reference():
    arrays = _dare_system(104, 7, seed=104, h_scale=0.0)
    ref, got = _both(arrays)
    assert _rel(got, ref) < 1e-10
    want = np.array([bool(ref_dare_residual_settled(
        *(jnp.asarray(a[i]) for a in arrays), jnp.asarray(ref[i])))
        for i in range(BATCH)])
    flags = dare_residual_settled(*(torch.as_tensor(a) for a in arrays),
                                  torch.as_tensor(got)).numpy()
    assert np.array_equal(flags, want)
