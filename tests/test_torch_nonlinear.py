"""Port parity: the second-order log posterior (``geconpy_torch/stats/
nonlinear.py`` and the ``DSGEStateSpace`` methods on it).

Against the JAX package on the CPU, float64, one thread, on the
reference's fixtures (``tests/stats/test_second_order_estimation.py``,
shared with ``tests/test_torch_nonlinear_filters.py`` through
``tests/_torch_second_order_cases.py``): ``rbc_estimation`` with Y and C
observed under measurement error (40 periods from the port's
``data_from_prior`` under a seeded generator), and ``brock_mirman`` with the growth
observable dY = Y[] - Y[-1] (a lag chain in the filter state).

- The solution dict (G blocks, x0, P0, mu2, Sigma1, A_cl, Z_cl) and
  ``quadratic_drive_covariance`` at rel 1e-10 (the blocks of the
  solution's scale: Brock-Mirman's vanish in logs).
- ``build_logpost_second_order`` (the marginalized filter; the full one
  in ``tests/test_torch_nonlinear_filters.py``) at two draws: values
  within rel 1e-8 and gradients within rel 1e-6 of the reference's; on the log-linear Brock-Mirman with Y (every quadratic
  block zero, no estimated parameter) equal to the port's first-order log
  posterior at rel 1e-6 (the reference's bar).
- The checkpointed filter equals the stored one at 1e-12, a batch of
  draws the draws one at a time bitwise, and an absurd draw gives -inf
  with a zero gradient row.
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
from _torch_second_order_cases import (BM_LAG, GRAD_TOL, RBC, VALUE_TOL,
                                       close, pair, ref_value_and_grad)
from geconpy_torch.stats import nonlinear as port
from geconpy_torch.stats.statespace import DSGEStateSpace as PortStateSpace
from geconpy_tpu.stats import nonlinear as ref


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


@pytest.fixture(scope="module")
def rbc():
    return pair("rbc_estimation", RBC, 11, 40)


@pytest.fixture(scope="module")
def bm_lag():
    return pair("brock_mirman", BM_LAG, 5, 30)


@pytest.mark.parametrize("case", ["rbc", "bm_lag"])
def test_solution_dict_matches_reference(case, request):
    ref_ss, port_ss, _data, u0 = request.getfixturevalue(case)
    fn = ref.build_second_order_solution_fn(ref_ss)
    want = jax.jit(lambda u: {k: v for k, v in fn(u).items()
                              if not callable(v)})(jnp.asarray(u0))
    got = port_ss.build_second_order_solution_fn()(torch.as_tensor(u0))
    assert bool(got["so_success"]) and bool(want["so_success"])
    # the blocks at rel 1e-10 of the solution's scale (Brock-Mirman's
    # vanish in logs: there they are rounding)
    scale = max(float(np.abs(np.asarray(want[k])).max())
                for k in ("G_xx", "T"))
    for k in ("G_xx", "G_xu", "G_uu", "g_ss"):
        close(got[k], want[k], 1e-10, scale)
    for k in ("P0", "Sigma1", "A_cl", "Z_cl"):
        close(got[k], want[k], 1e-10)
    # the second-order mean, O(Sigma1), at rel 1e-10 of Sigma1's scale
    s1 = float(np.abs(np.asarray(want["Sigma1"])).max())
    for k in ("x0", "mu2"):
        close(got[k], want[k], 1e-10,
              max(float(np.abs(np.asarray(want[k])).max()), s1))


def test_quadratic_drive_covariance_matches_reference():
    rng = np.random.default_rng(0)
    n, k = 5, 2
    args = [rng.standard_normal(s) for s in ((n, n, n), (n, n, k), (n, k, k))]
    S = rng.standard_normal((n, n))
    Q = rng.standard_normal((k, k))
    args += [S @ S.T, Q @ Q.T]
    want = ref.quadratic_drive_covariance(*(jnp.asarray(a) for a in args))
    got = port.quadratic_drive_covariance(*(torch.as_tensor(a)
                                            for a in args))
    close(got, want, 1e-10)


def test_logpost_and_grad_match_reference(rbc, method="marginalized"):
    ref_ss, port_ss, data, u0 = rbc
    U = u0[None] + 0.05 * np.random.default_rng(0).standard_normal(
        (2, len(u0)))
    v_ref, g_ref = ref_value_and_grad(ref_ss, data, U, method=method)
    vag = port_ss.build_logpost_and_grad_second_order(data, method=method)
    v, g = vag(torch.as_tensor(U))
    assert np.isfinite(v_ref).all()
    close(v, v_ref, VALUE_TOL)
    for i in range(len(U)):
        close(g[i], g_ref[i], GRAD_TOL)


def test_loglinear_model_equals_first_order():
    ss = PortStateSpace(geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("brock_mirman"), verbose=False),
        device="cpu").configure(observed_states=["Y"], shock_std=0.01)
    data, _ = ss.data_from_prior(torch.Generator().manual_seed(3),
                                 periods=40)
    u = torch.zeros(len(ss.estimated))
    lp1 = float(ss.build_logpost(data)(u))
    lp2 = float(ss.build_logpost_second_order(data)(u))
    assert np.isfinite(lp1)
    np.testing.assert_allclose(lp2, lp1, rtol=1e-6)


def test_remat_batch_and_gate(rbc):
    _ref_ss, port_ss, data, u0 = rbc
    U = torch.as_tensor(u0)[None] + 0.05 * torch.randn(
        (3, len(u0)), generator=torch.Generator().manual_seed(1))
    U[2] = 40.0
    stored = port_ss.build_logpost_and_grad_second_order(data, remat=False)
    remat = port_ss.build_logpost_and_grad_second_order(data)
    v_s, g_s = stored(U)
    v_r, g_r = remat(U)
    np.testing.assert_allclose(v_r[:2].numpy(), v_s[:2].numpy(), rtol=1e-12)
    np.testing.assert_allclose(g_r.numpy(), g_s.numpy(), rtol=1e-12,
                               atol=1e-12 * float(g_s.abs().max()))
    assert float(v_r[2]) == -np.inf and bool((g_r[2] == 0).all())
    for i in range(3):
        v_i, g_i = remat(U[i:i + 1])
        assert torch.equal(v_i, v_r[i:i + 1]) and torch.equal(g_i,
                                                              g_r[i:i + 1])
