"""Port parity: the batched Riccati settle (kernel K2's plain version)
against the reference's Pallas settle kernel in interpret mode.

The settle inputs (T_aug, R Q R', Z, H, d and the head of the data) come
from the port's SW-2007 and ``rbc_estimation`` sweeps at a few perturbed
draws; the same numpy arrays go to ``pallas_settle_parts(...,
interpret=True)`` and to ``geconpy_torch.ops.batched_settle.settle_parts``
on CPU tensors.  Every output agrees at atol 1e-8, the bar of
``tests/ops/test_pallas_settle.py``.
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
from geconpy_torch.ops.batched_settle import settle_parts
from geconpy_torch.stats.statespace import DSGEStateSpace
from geconpy_tpu.ops.pallas_settle import pallas_settle_parts

NAMES = ["ll_head", "x_pred0", "M", "TK", "Finv", "const"]


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _settle_inputs(name, configure, batch, seed, n_settle=16):
    model = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn(name))
    ss = DSGEStateSpace(model, device="cpu").configure(**configure(model),
                                         kalman_settle=n_settle)
    data, draw = ss.data_from_prior(torch.Generator().manual_seed(seed),
                                    periods=40)
    u0 = ss.unconstrain(draw).numpy()
    rng = np.random.default_rng(seed)
    U = u0[None] + 0.05 * rng.standard_normal((batch, u0.shape[0]))
    record: dict = {}
    ss.build_batched_loglik(data, n_settle=n_settle, policy="pallas",
                            settle="pallas")(torch.as_tensor(U), record=record)
    return tuple(x.numpy() for x in record["settle_parts"])


@pytest.fixture(scope="module", params=["sw2007", "rbc_estimation"])
def settle_inputs(request):
    if request.param == "sw2007":
        def configure(model):
            est = ["crhoa", "sigma_ea", "crr", "crpi", "chabb"]
            return dict(observed_states=["y", "c", "pinf", "r"],
                        constant_params=[p for p in model.param_names
                                         if p not in est])
    else:
        def configure(model):
            return dict(observed_states=["Y", "C"],
                        measurement_error=["Y", "C"])
    return _settle_inputs(request.param, configure, batch=4, seed=0)


def test_settle_parts_matches_pallas_interpret(settle_inputs):
    ref = jax.jit(lambda *a: pallas_settle_parts(*a, tile=4, interpret=True))(
        *(jnp.asarray(a) for a in settle_inputs))
    got = settle_parts(*(torch.as_tensor(a) for a in settle_inputs))
    for name, r, g in zip(NAMES, ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-8,
                                   err_msg=name)


def test_settle_parts_float32_io_computes_in_float64(settle_inputs):
    """float32 inputs give the float64 recursion's outputs rounded to
    float32 (the kernel's precision contract)."""
    got64 = settle_parts(*(torch.as_tensor(a) for a in settle_inputs))
    inputs32 = [torch.as_tensor(a).float() for a in settle_inputs]
    got32 = settle_parts(*inputs32)
    ref = settle_parts(*(x.double() for x in inputs32))
    for name, a, b in zip(NAMES, got32, ref):
        assert a.dtype == torch.float32, name
        np.testing.assert_array_equal(a.numpy(), b.float().numpy(),
                                      err_msg=name)
    assert np.isfinite(got64[0].numpy()).all()


def test_settle_parts_rejects_unknown_device(settle_inputs):
    meta = [torch.as_tensor(a).to("meta") for a in settle_inputs]
    with pytest.raises(ValueError, match="no kernel"):
        settle_parts(*meta)
