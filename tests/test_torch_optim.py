"""Port parity: the minimum-distance optimizer and the exact Jacobian
(``geconpy_torch/stats/_optim.py`` against ``geconpy_tpu/stats/_optim.py``
and ``jax.jacrev``).

- ``jacobian`` (the batched-primal reverse-mode Jacobian) equals
  ``jax.jacrev`` at 1e-12 on a row-separable closed form, and at 1e-10
  through ``rbc_estimation``'s solution pipeline (steady state, cycle
  reduction and Lyapunov adjoints) on the GMM moment vector.
- ``adam_gauss_newton`` equals the reference on a numpy-seeded nonlinear
  least-squares problem: Adam alone (400 steps, ``newton_steps=0``) at
  1e-10, and with its 6 Gauss-Newton steps at 1e-10; with a success flag
  that fails on part of the space, both packages zero Adam's gradients
  there and reject Gauss-Newton steps into it alike.
CPU, float64, one thread.
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
import geconpy_tpu
from geconpy_torch.stats import _optim as port
from geconpy_torch.stats import moment_matching as port_mm
from geconpy_torch.stats.statespace import DSGEStateSpace as PortStateSpace
from geconpy_tpu.stats import _optim as ref
from geconpy_tpu.stats import moment_matching as ref_mm
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace

RNG = np.random.default_rng(0)
T_GRID = np.linspace(0.0, 3.0, 25)
Z_TRUE = np.array([1.3, -0.7, 0.4])
Y_OBS = (Z_TRUE[0] * np.exp(Z_TRUE[1] * T_GRID) + Z_TRUE[2] * T_GRID
         + 0.01 * RNG.normal(size=T_GRID.shape))
Z0 = np.array([1.0, -0.5, 0.2])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _curve(xp, z, gate: float | None):
    """Residuals of y = a exp(b t) + c t; ``ok`` False where b >= gate."""
    t = T_GRID if xp is jnp else torch.tensor(T_GRID)
    y = Y_OBS if xp is jnp else torch.tensor(Y_OBS)
    a, b, c = z[..., 0:1], z[..., 1:2], z[..., 2:3]
    r = a * xp.exp(b * t) + c * t - y
    ok = (b[..., 0] < gate) if gate is not None else (b[..., 0] < np.inf)
    return r, ok


def test_jacobian_matches_jacrev_closed_form():
    z = np.array([0.9, -0.4, 0.2])
    want = np.asarray(jax.jacrev(lambda zz: _curve(jnp, zz, None)[0])(
        jnp.asarray(z)))
    got = port.jacobian(lambda Z: _curve(torch, Z, None)[0], torch.tensor(z),
                        len(T_GRID)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_jacobian_through_the_solution_pipeline():
    kw = dict(observed_states=["Y", "C"], constant_params=["alpha", "sigma_C"],
              measurement_error={"Y": 1e-4, "C": 1e-4},
              filter_type="sequential")
    src = "rbc_estimation"
    ref_ss = RefStateSpace(geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn(src), verbose=False)).configure(**kw)
    port_ss = PortStateSpace(geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn(src), verbose=False),
        device="cpu").configure(**kw)
    u = port_ss.initial_position() + 0.1
    ref_solve = ref_ss.build_solution_fn(full_state=True)
    want = np.asarray(jax.jit(jax.jacrev(
        lambda uu: ref_mm.model_moments(ref_solve(uu), (1, 2))))(
        jnp.asarray(u.numpy())))
    port_solve = port_ss.build_solution_fn(full_state=True)
    got = port.jacobian(lambda U: port_mm.model_moments(port_solve(U), (1, 2)),
                        u, want.shape[0]).numpy()
    assert want.shape == (13, 2)
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("newton_steps", [0, 6])
@pytest.mark.parametrize("gate", [None, -0.6])
def test_adam_gauss_newton_matches_reference(newton_steps, gate):
    """Adam's 400 iterates and the Gauss-Newton end point, with and
    without a failure region (b >= -0.6 fails; the start lies in it)."""
    want = np.asarray(ref.adam_gauss_newton(
        lambda z: _curve(jnp, z, gate), jnp.asarray(Z0), adam_steps=400,
        newton_steps=newton_steps))
    got = port.adam_gauss_newton(lambda z: _curve(torch, z, gate),
                                 torch.tensor(Z0), adam_steps=400,
                                 newton_steps=newton_steps).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    if gate is not None and not newton_steps:
        # the start fails, so every gradient is zeroed and Adam stays put
        np.testing.assert_array_equal(got, Z0)
    elif gate is None and newton_steps:
        np.testing.assert_allclose(got, Z_TRUE, atol=0.05)
