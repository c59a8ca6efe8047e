"""Port parity: filtering the pruned second-order system
(``geconpy_torch/stats/nonlinear.py``: the lag chain of an observation
equation, ``filter_data_second_order`` and the particle filter's
likelihood ``build_pf_loglik_second_order``).

Against the JAX package on the CPU, float64, one thread, on the cases of
``tests/_torch_second_order_cases.py`` (the reference's fixtures of
``tests/stats/test_second_order_estimation.py``):

- ``build_logpost_second_order(method="full")`` on ``rbc_estimation`` at
  two draws: values within rel 1e-8 and gradients within rel 1e-6.
- ``brock_mirman`` with dY = Y[] - Y[-1]: the value and gradient within
  rel 1e-8 / 1e-6 of the reference's, and equal to the port's first-order
  log posterior at rel 1e-5 (the reference's bar).
- ``filter_data_second_order`` (smoothed) on ``rbc_estimation``: paths,
  y1, y2 and the log-likelihood at rel 1e-8 of the reference's solution
  and ``ukf_smoother`` composed as its ``filter_data_second_order`` does;
  the log-likelihood is the full UKF log posterior less the prior (rel
  1e-8).
- The particle filter: on injected draws (the reference's start normals,
  offsets and shock normals rebuilt from its key as it splits it) at rel
  1e-10; by distribution, the mean of 3 runs of 8,192 particles within
  3.0 of the UKF log-likelihood (the reference's bar) and bitwise
  reproducible under one generator.
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

from _torch_second_order_cases import (BM_LAG, GRAD_TOL, RBC, VALUE_TOL,
                                       close, pair, ref_value_and_grad)
from geconpy_torch.stats import nonlinear as port
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


def test_full_ukf_logpost_and_grad_match_reference(rbc):
    """``method="full"`` (the generic augmented-state UKF) at two draws."""
    ref_ss, port_ss, data, u0 = rbc
    U = u0[None] + 0.05 * np.random.default_rng(0).standard_normal(
        (2, len(u0)))
    v_ref, g_ref = ref_value_and_grad(ref_ss, data, U, method="full")
    v, g = port_ss.build_logpost_and_grad_second_order(data, method="full")(
        torch.as_tensor(U))
    assert np.isfinite(v_ref).all()
    close(v, v_ref, VALUE_TOL)
    for i in range(len(U)):
        close(g[i], g_ref[i], GRAD_TOL)


def test_observation_lag_matches_reference_and_first_order(bm_lag):
    """Brock-Mirman in logs is exactly linear: with the dY lag chain the
    second-order log posterior equals the reference's and the port's
    first-order one."""
    ref_ss, port_ss, data, u0 = bm_lag
    U = u0[None]
    v_ref, g_ref = ref_value_and_grad(ref_ss, data, U)
    v, g = port_ss.build_logpost_and_grad_second_order(data)(
        torch.as_tensor(U))
    close(v, v_ref, VALUE_TOL)
    close(g[0], g_ref[0], GRAD_TOL)
    lp1 = float(port_ss.build_logpost(data)(torch.as_tensor(u0)))
    np.testing.assert_allclose(float(v[0]), lp1, rtol=1e-5)


def test_filter_data_matches_reference(rbc):
    """The reference's ``filter_data_second_order`` (``nonlinear.py:244``)
    is its solution and ``ukf_smoother`` at the point; both run here
    compiled, as it composes them (its eager form takes ~25 s a call)."""
    ref_ss, port_ss, data, u0 = rbc
    from geconpy_tpu.ops.ukf import ukf_smoother

    fn = ref.build_second_order_solution_fn(ref_ss)

    @jax.jit
    def ref_filter(u):
        sol = fn(u)
        res = ukf_smoother(jnp.asarray(data), sol["transition"],
                           sol["observe"], sol["Q"], sol["H"], sol["x0"],
                           sol["P0"])
        return res.smoothed_mean, res.loglik

    means, want_ll = (np.asarray(x) for x in ref_filter(jnp.asarray(u0)))
    n = port_ss.model.functions.n_variables
    y1, y2 = means[:, :n], means[:, n:2 * n]
    draw = dict(zip(port_ss.param_labels,
                    port_ss.constrain(torch.as_tensor(u0)).tolist()))
    got = port.filter_data_second_order(port_ss, data, params=draw,
                                        smoother=True)
    assert got.variable_names == list(ref_ss.model.functions.variable_names)
    close(got.paths, y1 + y2, VALUE_TOL)
    close(got.y1, y1, VALUE_TOL)
    close(got.y2, y2, VALUE_TOL, np.abs(y1 + y2).max())
    np.testing.assert_allclose(float(got.loglik), float(want_ll),
                               rtol=VALUE_TOL)
    u = port_ss.unconstrain(draw)
    # the smoother's forward pass is the generic (full) UKF
    lp = float(port_ss.build_logpost_second_order(data, method="full")(u))
    logprior = float(port_ss.build_second_order_solution_fn()(u)["logprior"])
    np.testing.assert_allclose(float(got.loglik), lp - logprior, rtol=1e-8)


def _ref_pf_draws(key, periods, n_particles, nz, q):
    """The reference's start normals, then per period its resampling
    offset and shock normals (``nonlinear.py:293-299``,
    ``particle_filter.py:121-147``)."""
    k_init, k_run = jax.random.split(key)
    init = np.asarray(jax.random.normal(k_init, (n_particles, nz),
                                        jnp.float64))
    us, eps = [], []
    for k_t in jax.random.split(k_run, periods):
        k_eps, k_res = jax.random.split(k_t)
        us.append(float(jax.random.uniform(k_res, ())))
        eps.append(np.asarray(jax.random.normal(k_eps, (n_particles, q),
                                                jnp.float64)))
    return init, np.asarray(us), np.stack(eps)


def test_particle_filter_on_injected_draws(rbc):
    ref_ss, port_ss, data, u0 = rbc
    n_particles, key = 256, jax.random.PRNGKey(2)
    want_ll, want_ok = jax.jit(ref_ss.build_pf_loglik_second_order(
        data, n_particles=n_particles))(jnp.asarray(u0), key)
    n = port_ss.model.functions.n_variables
    init, us, eps = _ref_pf_draws(key, len(data), n_particles, 2 * n,
                                  port_ss.model.n_shocks)
    pf = port_ss.build_pf_loglik_second_order(data, n_particles=n_particles)
    ll, ok = pf.from_draws(
        torch.as_tensor(u0)[None], torch.as_tensor(init)[None],
        lambda t: (torch.tensor([us[t]]), torch.as_tensor(eps[t])[None]))
    assert bool(ok[0]) and bool(want_ok)
    np.testing.assert_allclose(float(ll[0]), float(want_ll), rtol=1e-10)


def test_particle_filter_agrees_with_ukf(rbc):
    _ref_ss, port_ss, data, u0 = rbc
    u = torch.as_tensor(u0)
    pf = port_ss.build_pf_loglik_second_order(data, n_particles=8192)
    U = u[None].expand(3, -1)
    ll, ok = pf(U, torch.Generator().manual_seed(0))
    again, _ = pf(U, torch.Generator().manual_seed(0))
    assert torch.equal(ll, again) and bool(ok.all())
    sol = port_ss.build_second_order_solution_fn()(u)
    ll_ukf = float(port_ss.build_logpost_second_order(data)(u)) \
        - float(sol["logprior"])
    assert abs(float(ll.mean()) - ll_ukf) < 3.0, (ll, ll_ukf)
