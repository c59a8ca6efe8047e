"""Port parity: the constant-gain filter tail (kernel K3's plain version).

``geconpy_torch.ops.batched_filter.filter_tail`` on CPU tensors runs the
plain PyTorch version of the CUDA kernel; it must equal the reference's
``reference_filter_tail`` and the Pallas kernel in interpret mode at rtol
1e-10, the tolerance of ``tests/ops/test_pallas_filter.py``.  The
interpret-mode comparison runs at every (n, k) at which
``tests/test_torch_cuda.py`` holds the kernel to the plain version on a
GPU, so that kernel, plain version and JAX kernel are chained at each.
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

from geconpy_torch.ops.batched_filter import filter_tail
from geconpy_tpu.ops.pallas_filter import pallas_filter_tail, reference_filter_tail


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def make_batch(B, n=6, k=3, T=40, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n)) * 0.2
    TK = rng.normal(size=(B, n, k)) * 0.3
    Z = rng.normal(size=(B, k, n))
    d = rng.normal(size=(B, k)) * 0.1
    F0 = rng.normal(size=(B, k, k))
    Finv = np.einsum("bij,bkj->bik", F0, F0) + 3 * np.eye(k)
    const = rng.normal(size=B)
    x0 = rng.normal(size=(B, n))
    y = rng.normal(size=(T, k))
    return y, M, TK, Z, d, Finv, const, x0


@pytest.mark.parametrize("B,n,k,T", [(20, 6, 3, 40), (7, 26, 7, 168),
                                     (1, 4, 2, 12)])
def test_filter_tail_matches_reference(B, n, k, T):
    arrays = make_batch(B, n, k, T, seed=B)
    ref = np.asarray(reference_filter_tail(*(jnp.asarray(a) for a in arrays)))
    got = filter_tail(*(torch.as_tensor(a) for a in arrays)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-10)


def stable_batch(B, n, k, T, seed):
    """make_batch with M scaled to spectral radius 0.9 per draw, so that
    the state stays bounded at any n."""
    y, M, *rest = make_batch(B, n, k, T, seed=seed)
    M = M * (0.9 / np.abs(np.linalg.eigvals(M)).max(axis=-1))[:, None, None]
    return (y, M, *rest)


# the (n, k) of the GPU tests of K3 (tests/test_torch_cuda.py)
GPU_NK = [(n, k) for n in (1, 7, 26, 32, 33, 64) for k in (1, 7, 9)]


@pytest.mark.parametrize("n,k", [(6, 3)] + GPU_NK)
def test_filter_tail_matches_pallas_interpret(n, k):
    arrays = make_batch(9, seed=3) if (n, k) == (6, 3) else \
        stable_batch(5, n, k, 40, seed=100 * n + k)
    pal = np.asarray(pallas_filter_tail(*(jnp.asarray(a) for a in arrays),
                                        tile=128, interpret=True))
    got = filter_tail(*(torch.as_tensor(a) for a in arrays)).numpy()
    np.testing.assert_allclose(got, pal, rtol=1e-10)


def test_filter_tail_nonfinite_draw_stays_isolated():
    """A NaN in one draw's matrices poisons only that draw's likelihood."""
    arrays = [a.copy() for a in make_batch(5, seed=4)]
    arrays[1][2, 0, 0] = np.nan          # M of draw 2
    got = filter_tail(*(torch.as_tensor(a) for a in arrays)).numpy()
    assert np.isnan(got[2])
    assert np.isfinite(np.delete(got, 2)).all()


def test_filter_tail_rejects_unknown_device():
    arrays = [torch.as_tensor(a).to("meta") for a in make_batch(2)]
    with pytest.raises(ValueError, match="no kernel"):
        filter_tail(*arrays)
