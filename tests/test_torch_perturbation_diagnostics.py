"""Port parity: ``geconpy_torch/stats/perturbation_diagnostics.py`` and the
differentiable eigenvalues of ``geconpy_torch/ops/eig.py``.

- ``solvability_check`` on ``rbc`` (16 draws of alpha and beta, the last
  with beta = 1.05, which has no steady state; the reference's
  ``tests/stats/test_diagnostics_sweeps.py`` case): every stage's flags,
  ``success`` and the failure stages equal the reference's; the spectral
  radius at rel 1e-10 and the residual norms at rel 1e-10 or within 1e-12
  (they are rounding, ~1e-15, on the draws that solve).
- ``prior_solvability_check`` on ``rbc_estimation``: with ``how="qmc"``
  the same Sobol draws as the reference and the same flags; with
  ``how="mc"`` (a ``torch.Generator``) reproducible, and > 90% solvable.
- ``bk_condition_sweep`` on ``nk_3eq`` across the Taylor-principle
  boundary (24 draws of phi_pi): counts, flags and ``bk_satisfied`` equal
  the reference's (which its own test holds to scipy's ``ordqz``), and at
  the calibration they equal ``Model.check_bk_condition``.
- ``summarize_perturbation_solution`` and ``PolicySolution.summary``: the
  reference's P/Q/R/S blocks at rel 1e-10 with the same state and jump
  names; ``spectral_radius_sensitivity`` at rel 1e-10.
- ``eigenvalue_sensitivity``: the eigenvalues, sorted by (modulus,
  imaginary part), at rel 1e-10; the derivatives of the finite roots
  within 1e-4 of each row's largest, because both packages differentiate the BK companion
  matrix, whose eigenvector matrix is near singular (seven zero roots)
  and which holds a 1/ε = 1e7 root, so rounding moves them by ~1e-5
  relative; and the reference's own checks: d|λ|/d rho_A = 1 at the
  technology root (1e-5) and the derivative of the finite moduli' sum
  against central differences (rtol 1e-4).
- ``eig_vals``: the reference's values and vector-Jacobian product at
  1e-10 on a random matrix with simple eigenvalues.
- ``mesh=`` raises.
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
from geconpy_torch.ops.eig import eig_vals as port_eig_vals
from geconpy_torch.stats import perturbation_diagnostics as port
from geconpy_tpu.ops.eig import eig_vals as ref_eig_vals
from geconpy_tpu.stats import perturbation_diagnostics as ref

STAGES = ["steady_state", "linearization", "policy_solve", "stability",
          "residual_norms", "success"]


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _models(name):
    return (geconpy_tpu.model_from_gcn(geconpy_tpu.get_example_gcn(name),
                                       verbose=False),
            geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn(name),
                                         verbose=False))


@pytest.fixture(scope="module")
def rbc():
    return _models("rbc")


def _assert_table(got, want):
    assert got.param_names == [c for c in want.columns
                               if c not in STAGES + ["failure_stage",
                                                     "spectral_radius",
                                                     "deterministic_norm",
                                                     "stochastic_norm"]]
    for i, name in enumerate(got.param_names):
        np.testing.assert_array_equal(got.draws[:, i].numpy(),
                                      want[name].to_numpy())
    for stage in STAGES:
        np.testing.assert_array_equal(getattr(got, stage).numpy(),
                                      want[stage].to_numpy(), err_msg=stage)
    assert got.failure_stage == list(want["failure_stage"])
    for col in ("spectral_radius", "deterministic_norm", "stochastic_norm"):
        np.testing.assert_allclose(getattr(got, col).numpy(),
                                   want[col].to_numpy(), rtol=1e-10,
                                   atol=1e-12, err_msg=col)


def test_solvability_check_matches_reference(rbc):
    ref_model, port_model = rbc
    rng = np.random.default_rng(0)
    draws = {"alpha": np.clip(0.35 + 0.05 * rng.normal(size=16), 0.1, 0.9),
             "beta": np.concatenate([np.full(15, 0.99), [1.05]])}
    want = ref.solvability_check(ref_model, draws)
    got = port.solvability_check(port_model, draws, device="cpu")
    _assert_table(got, want)
    assert got.success[:15].all() and not got.success[15]
    assert got.failure_stage[15] == "steady_state"
    with pytest.raises(ValueError, match="unknown parameters"):
        port.solvability_check(port_model, {"nope": [1.0]}, device="cpu")


def test_prior_solvability_check():
    ref_model, port_model = _models("rbc_estimation")
    want = ref.prior_solvability_check(ref_model, n_samples=32, how="qmc",
                                       seed=0)
    got = port.prior_solvability_check(port_model, n_samples=32, how="qmc",
                                       seed=0, device="cpu")
    _assert_table(got, want)
    assert float(got.success.double().mean()) > 0.9
    assert {"alpha", "rho_A", "sigma_C"} <= set(got.param_names)
    mc = [port.prior_solvability_check(
        port_model, n_samples=64, seed=3, device="cpu") for _ in range(2)]
    assert torch.equal(mc[0].draws, mc[1].draws)
    assert float(mc[0].success.double().mean()) > 0.9
    lhs = port.prior_solvability_check(port_model, n_samples=16, how="lhs",
                                       seed=2, device="cpu")
    assert len(lhs.failure_stage) == 16


def test_bk_sweep_matches_reference_and_model_table():
    ref_model, port_model = _models("nk_3eq")
    phi_pi = np.random.default_rng(1).uniform(0.3, 2.5, size=24)
    want = ref.bk_condition_sweep(ref_model, {"phi_pi": phi_pi})
    got = port.bk_condition_sweep(port_model, {"phi_pi": phi_pi},
                                  device="cpu")
    for col in ("n_unstable", "n_forward", "bk_satisfied", "ok"):
        np.testing.assert_array_equal(getattr(got, col).numpy(),
                                      want[col].to_numpy(), err_msg=col)
    assert got.ok.all()
    assert 3 < int(got.bk_satisfied.sum()) < 21      # both sides of phi_pi = 1
    table = port.check_bk_condition(port_model, verbose=False, device="cpu")
    at_cal = port.bk_condition_sweep(port_model, {"phi_pi": [1.5]},
                                     device="cpu")
    assert bool(at_cal.ok[0])
    assert int(at_cal.n_unstable[0]) == table["n_unstable"]
    assert int(at_cal.n_forward[0]) == table["n_forward"]
    assert bool(at_cal.bk_satisfied[0]) == table["bk_satisfied"]


def test_policy_tables_match_reference(rbc):
    ref_model, port_model = rbc
    want = ref.summarize_perturbation_solution(
        ref_model.solve_model(verbose=False))
    sol = port_model.solve_model(verbose=False, device="cpu")
    for got in (port.summarize_perturbation_solution(sol), sol.summary()):
        assert got.states == want.attrs["states"] == ["A", "K"]
        assert got.jumps == want.attrs["jumps"]
        for block, rows, cols in (("P", got.states, got.states),
                                  ("Q", got.states, got.shocks),
                                  ("R", got.jumps, got.states),
                                  ("S", got.jumps, got.shocks)):
            w = want.loc[block].loc[rows, cols].to_numpy()
            np.testing.assert_allclose(getattr(got, block).numpy(), w,
                                       rtol=1e-10, atol=1e-14, err_msg=block)
        np.testing.assert_allclose(float(got.P[0, 0]), 0.95, atol=1e-8)


def test_spectral_radius_sensitivity_matches_reference(rbc):
    ref_model, port_model = rbc
    want = ref.spectral_radius_sensitivity(ref_model)
    got = port.spectral_radius_sensitivity(port_model, device="cpu")
    assert got.param_names == list(want.index)
    np.testing.assert_allclose(got.d_rho_d_param.numpy(),
                               want["d_rho_d_param"].to_numpy(), rtol=1e-10,
                               atol=1e-14)
    assert float(got.d_rho_d_param[got.param_names.index("rho_A")]) > 0


def _order(lam):
    return np.lexsort((np.imag(lam), np.abs(lam)))


def test_eigenvalue_sensitivity_matches_reference(rbc):
    ref_model, port_model = rbc
    want = ref.eigenvalue_sensitivity(ref_model)
    got = port.eigenvalue_sensitivity(port_model, device="cpu")
    assert got.param_names == list(want.columns)
    lam_r = np.asarray(want.attrs["eigenvalues"])
    lam_p = got.eigenvalues.numpy()
    i_r, i_p = _order(lam_r), _order(lam_p)
    np.testing.assert_allclose(lam_p[i_p], lam_r[i_r], rtol=1e-10,
                               atol=1e-12)
    table = want.to_numpy().reshape(len(lam_r), 3, -1)
    # the regularized infinite root's derivatives are rounding (~1e-8)
    keep = np.abs(lam_r[i_r]) < 1e6
    for k, part in enumerate(("real", "imag", "modulus")):
        w = table[i_r, k][keep]
        g = getattr(got, part).numpy()[i_p][keep]
        scale = np.abs(w).max(axis=1, keepdims=True)
        np.testing.assert_array_less(np.abs(g - w), np.broadcast_to(
            1e-4 * scale + 1e-12, w.shape), err_msg=part)
    # the reference's checks on the port: the technology root, and FD
    mods = got.moduli.numpy()
    tech = int(np.argmin(np.abs(mods - 0.95)))
    np.testing.assert_allclose(
        float(got.modulus[tech, got.param_names.index("rho_A")]), 1.0,
        atol=1e-5)
    finite = (mods < 1e6) & (mods > 1e-4)
    eps = 1e-4
    hi, lo = (port.eigenvalue_sensitivity(port_model, device="cpu",
                                          beta=0.99 + s)
              for s in (eps, -eps))
    fd = (hi.moduli.numpy()[finite].sum()
          - lo.moduli.numpy()[finite].sum()) / (2 * eps)
    beta = got.param_names.index("beta")
    np.testing.assert_allclose(got.modulus[:, beta].numpy()[finite].sum(),
                               fd, rtol=1e-4)


def test_eig_vals_and_their_gradient_match_reference():
    rng = np.random.default_rng(5)
    M = rng.normal(size=(6, 6))
    c = rng.normal(size=(2, 6))
    re_r, im_r = ref_eig_vals(jnp.asarray(M))
    _, vjp = jax.vjp(ref_eig_vals, jnp.asarray(M))
    (M_bar_r,) = vjp((jnp.asarray(c[0]), jnp.asarray(c[1])))
    Mt = torch.tensor(M, requires_grad=True)
    re, im = port_eig_vals(Mt)
    np.testing.assert_allclose(re.detach().numpy(), np.asarray(re_r),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(im.detach().numpy(), np.asarray(im_r),
                               rtol=1e-10, atol=1e-12)
    (M_bar,) = torch.autograd.grad((re * torch.as_tensor(c[0])).sum()
                                   + (im * torch.as_tensor(c[1])).sum(), Mt)
    np.testing.assert_allclose(M_bar.numpy(), np.asarray(M_bar_r),
                               rtol=1e-10, atol=1e-12)


def test_mesh_is_accepted(rbc):
    """The sweeps under a mesh of 3 CPU devices (5 draws, padded to 6)
    give the flags and counts of the unsplit sweep (tests/test_torch_mesh.py
    holds them on 8 devices)."""
    from geconpy_torch.parallel import make_mesh

    _, port_model = rbc
    mesh = make_mesh(devices=("cpu",) * 3)
    draws = {"alpha": [0.25, 0.3, 0.35, 0.4, 0.45]}
    a = port.solvability_check(port_model, draws, device="cpu")
    b = port.solvability_check(port_model, draws, mesh=mesh)
    assert torch.equal(a.success, b.success) and b.success.all()
    a = port.bk_condition_sweep(port_model, draws, device="cpu")
    b = port.bk_condition_sweep(port_model, draws, mesh=mesh)
    assert torch.equal(a.n_unstable, b.n_unstable)
    assert torch.equal(a.bk_satisfied, b.bk_satisfied)
    est_model = _models("rbc_estimation")[1]
    a = port.prior_solvability_check(est_model, n_samples=20, device="cpu")
    b = port.prior_solvability_check(est_model, n_samples=20, mesh=mesh)
    assert torch.equal(a.draws, b.draws) and torch.equal(a.success, b.success)
