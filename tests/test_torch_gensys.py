"""Port parity: the inverse-free disk split and the device gensys.

``geconpy_torch.ops.qz_disk`` and ``geconpy_torch.ops.gensys_jax`` against
``geconpy_tpu``'s on the same float64 inputs, on the CPU.  The bases V, Q
and Z are unique only up to signs and rotations, so what is held is what
does not depend on them: the projector's singular values (1e-10), the
counts and flags (equal), the stable subspace V Vᵀ (1e-8), and T and R
(rel 1e-8).  Cases: seeded random pencils, one with a singular B (an
infinite root), one with a root on the unit circle; the pencils of three
bundled models at their calibration and of ``nk_3eq`` in its indeterminate
region (``phi_pi=0.5, phi_x=0``, the reference's own case); a batch holding
determinate, indeterminate, singular and non-finite draws is bitwise equal
to its draws run one at a time, and a singular or non-finite pencil gives
flags, never an exception.
"""

import importlib
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
from geconpy_torch.ops import qz_disk as port_qz
from geconpy_tpu.ops import qz_disk as ref_qz

# both packages re-export the function gensys_jax under the module's name
ref_gs = importlib.import_module("geconpy_tpu.ops.gensys_jax")
port_gs = importlib.import_module("geconpy_torch.ops.gensys_jax")


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pencils():
    rng = np.random.default_rng(0)
    out = {}
    for i in range(3):
        n = 6
        A = rng.normal(size=(n, n)) * 2.0
        B = rng.normal(size=(n, n)) + 2 * np.eye(n)
        out[f"random{i}"] = (A, B)
    A = rng.normal(size=(5, 5))
    B = rng.normal(size=(5, 5))
    B[:, 2] = 0.0                                   # an infinite root
    out["singular_B"] = (A, B)
    Qm = np.linalg.qr(rng.normal(size=(4, 4)))[0]
    out["root_on_circle"] = (Qm @ np.diag([0.3, 1.0, 2.0, -0.5]) @ Qm.T,
                             np.eye(4))
    return out


PENCILS = _pencils()


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("name", list(PENCILS))
def test_count_eigs_inside_matches_reference(name):
    A, B = PENCILS[name]
    n_ref, ok_ref = ref_qz.count_eigs_inside(jnp.asarray(A), jnp.asarray(B))
    n, ok = port_qz.count_eigs_inside(torch.as_tensor(A), torch.as_tensor(B))
    assert int(n) == int(n_ref) and bool(ok) == bool(ok_ref)
    lam = np.abs(np.linalg.eigvals(np.linalg.solve(B, A))) \
        if name != "singular_B" else None
    if name.startswith("random"):
        assert bool(ok) and int(n) == int(np.sum(lam < 1.0))
    if name == "root_on_circle":
        assert not bool(ok)


@pytest.mark.parametrize("name", list(PENCILS))
def test_disk_split_matches_reference(name):
    A, B = PENCILS[name]
    k = int(ref_qz.count_eigs_inside(jnp.asarray(A), jnp.asarray(B))[0])
    ref = ref_qz.disk_function_split(jnp.asarray(A), jnp.asarray(B), k)
    got = port_qz.disk_function_split(torch.as_tensor(A), torch.as_tensor(B),
                                      k)
    # a root on the circle leaves a singular value near 0.5 that 30
    # squarings make as sensitive to rounding as the root itself
    atol = 1e-6 if name == "root_on_circle" else 1e-10
    np.testing.assert_allclose(got.sv.numpy(), np.asarray(ref.sv),
                               rtol=0, atol=atol)
    assert int(got.n_inside) == int(ref.n_inside)
    assert bool(got.converged) == bool(ref.converged)
    if bool(ref.converged):
        V, V_ref = got.V_stable.numpy(), np.asarray(ref.V_stable)
        np.testing.assert_allclose(V @ V.T, V_ref @ V_ref.T, atol=1e-8)


def _model_pencil(name, **updates):
    model = geconpy_tpu.model_from_gcn(geconpy_tpu.get_example_gcn(name),
                                       verbose=False)
    mats = model.linearize_model(**updates)
    return model, tuple(mats[k].to_numpy() for k in "ABCD")


@pytest.fixture(scope="module", params=["rbc", "nk_3eq", "sw2007"])
def model_pencil(request):
    return _model_pencil(request.param)


def _solve_both(model, pencil):
    A, B, C, D = pencil
    ref_solve = ref_gs.make_gensys_solver(model.n_variables,
                                          model.lead_var_idx, D.shape[1])
    port_solve = port_gs.make_gensys_solver(model.n_variables,
                                            model.lead_var_idx, D.shape[1])
    ref = jax.jit(ref_solve)(*(jnp.asarray(X) for X in pencil))
    got = port_solve(*(torch.as_tensor(X) for X in pencil))
    return ref, got, port_solve


def test_gensys_matches_reference_on_model_pencils(model_pencil):
    model, pencil = model_pencil
    ref, got, _ = _solve_both(model, pencil)
    assert bool(ref.success) and bool(got.success)
    for key in ("existence", "uniqueness", "success", "split_dim"):
        assert int(getattr(got, key)) == int(getattr(ref, key)), key
    assert _rel(got.T.numpy(), ref.T) < 1e-8
    assert _rel(got.R.numpy(), ref.R) < 1e-8


def test_gensys_flags_indeterminacy_as_the_reference():
    model, pencil = _model_pencil("nk_3eq", phi_pi=0.5, phi_x=0.0)
    ref, got, _ = _solve_both(model, pencil)
    assert not bool(ref.success) and not bool(got.success)
    for key in ("existence", "uniqueness", "success", "split_dim"):
        assert int(getattr(got, key)) == int(getattr(ref, key)), key
    # too many stable roots: the split finds more than the n determinate
    # ones, and the solution is not unique
    assert int(got.split_dim) > model.n_variables
    assert bool(got.existence) and not bool(got.uniqueness)


def test_gensys_batch_is_bitwise_its_draws_and_never_raises():
    """Determinate, indeterminate, all-zero (singular) and NaN draws in one
    batch: each equals its solo run bitwise, the last three fail by flags."""
    model, good = _model_pencil("nk_3eq")
    _, indet = _model_pencil("nk_3eq", phi_pi=0.5, phi_x=0.0)
    zero = tuple(np.zeros_like(X) for X in good)
    nan = tuple(X.copy() for X in good)
    nan[1][0, 0] = np.nan
    draws = [good, indet, zero, nan]
    solve = port_gs.make_gensys_solver(model.n_variables, model.lead_var_idx,
                                       model.n_shocks)
    batch = solve(*(torch.as_tensor(np.stack([d[i] for d in draws]))
                    for i in range(4)))
    assert batch.success.tolist() == [True, False, False, False]
    assert torch.isnan(batch.T[2:]).all() and torch.isnan(batch.R[2:]).all()
    for b, d in enumerate(draws):
        solo = solve(*(torch.as_tensor(X) for X in d))
        for key, val in solo._asdict().items():
            torch.testing.assert_close(getattr(batch, key)[b], val, rtol=0,
                                       atol=0, equal_nan=True)
    # the reference flags the same draws
    ref_solve = ref_gs.make_gensys_solver(model.n_variables,
                                          model.lead_var_idx, model.n_shocks)
    ref = jax.jit(jax.vmap(ref_solve))(
        *(jnp.asarray(np.stack([d[i] for d in draws])) for i in range(4)))
    assert np.asarray(ref.success).tolist() == batch.success.tolist()
    assert np.asarray(ref.existence)[:2].tolist() == \
        batch.existence[:2].tolist()
    assert np.asarray(ref.uniqueness)[:2].tolist() == \
        batch.uniqueness[:2].tolist()


def test_singular_pencils_give_flags_not_exceptions():
    zero = torch.zeros(4, 4, dtype=torch.float64)
    n, ok = port_qz.count_eigs_inside(zero, zero)
    assert not bool(ok)
    split = port_qz.disk_function_split(zero[None].expand(3, 4, 4),
                                        zero[None].expand(3, 4, 4), 2)
    assert not split.converged.any()
    nan = torch.full((2, 4, 4), torch.nan, dtype=torch.float64)
    n, ok = port_qz.count_eigs_inside(nan, nan)
    assert not ok.any() and (n == 0).all()
    n_ref, ok_ref = ref_qz.count_eigs_inside(jnp.zeros((4, 4)),
                                             jnp.zeros((4, 4)))
    assert not bool(ok_ref) and int(n_ref) == int(
        port_qz.count_eigs_inside(zero, zero)[0])


def test_backward_solver_singular_b_gives_nan_and_false():
    from geconpy_torch.models.perturbation import solve_policy_backward
    from geconpy_tpu.models.perturbation import \
        solve_policy_backward as ref_backward

    rng = np.random.default_rng(1)
    A, B, D = rng.normal(size=(3, 3)), rng.normal(size=(3, 3)), \
        rng.normal(size=(3, 2))
    T, R, ok = solve_policy_backward(*(torch.as_tensor(X) for X in (A, B, D)))
    T_ref, R_ref, ok_ref = ref_backward(*(jnp.asarray(X) for X in (A, B, D)))
    assert bool(ok) and bool(ok_ref)
    np.testing.assert_allclose(T.numpy(), T_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(R.numpy(), R_ref, rtol=1e-12, atol=1e-12)
    B_sing = np.stack([B, np.zeros((3, 3))])
    T, R, ok = solve_policy_backward(torch.as_tensor(np.stack([A, A])),
                                     torch.as_tensor(B_sing),
                                     torch.as_tensor(np.stack([D, D])))
    assert ok.tolist() == [True, False]
    assert torch.isnan(T[1]).all() and torch.isfinite(T[0]).all()
    _, _, ok_ref = ref_backward(jnp.asarray(A), jnp.zeros((3, 3)),
                                jnp.asarray(D))
    assert not bool(ok_ref)


def test_gecon_matrices_match_reference():
    from geconpy_torch.models.perturbation import gecon_matrices
    from geconpy_tpu.models.perturbation import gecon_matrices as ref_gecon

    model = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn("rbc"),
                                         verbose=False)
    sol = model.solve_model(verbose=False, device="cpu")
    got = gecon_matrices(sol.T, sol.R, sol.variables)
    ref = ref_gecon(sol.T.numpy(), sol.R.numpy(), sol.variables)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert len(got[4]) > 0 and len(got[5]) > 0
