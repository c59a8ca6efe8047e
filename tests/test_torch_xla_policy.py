"""Port parity: the XLA policy solve, the adaptive cycle reduction
(``geconpy_torch/ops/cycle_reduction.py::cycle_reduction``) and the policy
with the statics eliminated
(``geconpy_torch/ops/static_reduction.py::solve_policy_reduced``).

Against ``geconpy_tpu/ops/cycle_reduction.py`` and
``geconpy_tpu/ops/static_reduction.py`` under ``jax.jit`` (vmapped over
the draws), on SW-2007's and ``nk_calvo``'s own pencils (the port's
linearization at the calibration and three copies with each nonzero
entry moved by 0.1% from a numpy seed, the same numpy arrays to both
sides) and on random
quadratic pencils with a stable solvent: T (and R) at 1e-10 of their
largest entry, ``success`` and ``n_iter`` equal, and the VJP at 1e-8
against ``jax.vjp``.  A pencil with no stable solvent fails in both, a
singular ``B`` gives a False flag and no exception, and a batch that mixes
draws with different iteration counts and a NaN draw gives every draw its
solo result.  CPU, float64, one thread.
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
from geconpy_torch.ops.cycle_reduction import cycle_reduction
from geconpy_torch.ops.static_reduction import solve_policy_reduced
# the package re-exports functions under the modules' names
ref_cr = importlib.import_module("geconpy_tpu.ops.cycle_reduction")
ref_sr = importlib.import_module("geconpy_tpu.ops.static_reduction")

TOL, MAXITER = 1e-10, 100      # configure's cycle_reduction_tol / maxiter


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


@pytest.fixture(scope="module", params=["sw2007", "nk_calvo"])
def model_pencils(request):
    """(A, B, C, D) numpy (4, n, .) at jittered calibrations, the plan,
    and the reduced dynamic pencils."""
    from geconpy_torch.ops.static_reduction import reduce_pencil

    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn(request.param))
    ss = model.ss_solver(model.default_theta()[None])
    assert bool(ss.success.all())
    lin = model.linearizer("auto")(ss.x_ss, ss.theta_full)
    # four draws: the calibration, then its pencil with each nonzero
    # entry moved by 0.1% (the sparsity, and so the statics, stay)
    rng = np.random.default_rng(0)
    pencil = []
    for X in (lin.A, lin.B, lin.C, lin.D):
        jitter = 1.0 + 1e-3 * rng.standard_normal((4,) + tuple(X.shape[1:]))
        jitter[0] = 1.0
        pencil.append(X * torch.as_tensor(jitter))
    lin = type(lin)(*pencil, *lin[4:])
    plan = model.static_reduction
    red = reduce_pencil(lin.A, lin.B, lin.C, lin.D, plan)
    full = tuple(x.numpy() for x in (lin.A, lin.B, lin.C, lin.D))
    reduced = tuple(x.numpy() for x in (red.A2, red.B2, red.C2))
    ref_plan = ref_sr.StaticReduction(np.asarray(plan.static_idx),
                                      np.asarray(plan.dynamic_idx))
    return request.param, full, reduced, plan, ref_plan


def _random_pencil(n, rho, rng):
    """A + B T + C T² = 0 with the stable solvent T of spectral radius
    ``rho`` and an unstable block: B = -(C (T + U) ), A = C U T for a U
    with eigenvalues outside the unit circle."""
    def scaled(r):
        M = rng.standard_normal((n, n))
        return r * M / np.max(np.abs(np.linalg.eigvals(M)))

    T = scaled(rho)
    U_inv = scaled(0.5)             # U = U_inv⁻¹: eigenvalues >= 2
    U = np.linalg.inv(U_inv)
    C = rng.standard_normal((n, n)) + n * np.eye(n)
    return C @ U @ T, -C @ (U + T), C


def _ref_cr(A, B, C):
    return jax.jit(jax.vmap(lambda a, b, c: ref_cr.cycle_reduction(
        a, b, c, tol=TOL, maxiter=MAXITER)))(A, B, C)


def _port_cr(A, B, C):
    return cycle_reduction(*(torch.tensor(x) for x in (A, B, C)), tol=TOL,
                           maxiter=MAXITER)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.max(np.abs(want)), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _assert_cr_equal(got, want):
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(want.n_iter))
    _close(got.T.numpy(), want.T, 1e-10)
    _close(got.resid_norm.numpy(), want.resid_norm, 1e-6)


def test_cycle_reduction_on_model_pencils(model_pencils):
    _name, _full, (A2, B2, C2), _plan, _ref_plan = model_pencils
    got, want = _port_cr(A2, B2, C2), _ref_cr(A2, B2, C2)
    _assert_cr_equal(got, want)
    assert got.success.all()


def test_cycle_reduction_on_random_pencils():
    rng = np.random.default_rng(1)
    A, B, C = (np.stack(x) for x in zip(*(
        _random_pencil(6, rho, rng) for rho in (0.2, 0.7, 0.95, 0.995))))
    got, want = _port_cr(A, B, C), _ref_cr(A, B, C)
    _assert_cr_equal(got, want)
    assert got.success.all()
    assert len(set(got.n_iter.tolist())) > 1


def test_solve_policy_reduced_on_model_pencils(model_pencils):
    _name, (A, B, C, D), _red, plan, ref_plan = model_pencils
    want = jax.jit(jax.vmap(lambda a, b, c, d: ref_sr.solve_policy_reduced(
        a, b, c, d, ref_plan, tol=TOL, maxiter=MAXITER)))(A, B, C, D)
    got = solve_policy_reduced(*(torch.tensor(x) for x in (A, B, C, D)),
                               plan, tol=TOL, maxiter=MAXITER)
    for name, g, w in zip(("T", "R"), got[:2], want[:2]):
        _close(g.numpy(), w, 1e-10)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert got[2].all()


def test_solve_policy_reduced_vjp(model_pencils):
    _name, (A, B, C, D), _red, plan, ref_plan = model_pencils
    rng = np.random.default_rng(2)
    n, m = D.shape[-2:]
    T_bar = rng.standard_normal((4, n, n))
    R_bar = rng.standard_normal((4, n, m))

    def ref_TR(a, b, c, d):
        T, R, *_ = ref_sr.solve_policy_reduced(a, b, c, d, ref_plan,
                                               tol=TOL, maxiter=MAXITER)
        return T, R

    _, vjp = jax.vjp(jax.vmap(ref_TR), *(jnp.asarray(x) for x in (A, B, C, D)))
    want = vjp((jnp.asarray(T_bar), jnp.asarray(R_bar)))
    leaves = [torch.tensor(x, requires_grad=True) for x in (A, B, C, D)]
    T, R, *_ = solve_policy_reduced(*leaves, plan, tol=TOL, maxiter=MAXITER)
    got = torch.autograd.grad((T, R), leaves,
                              (torch.tensor(T_bar), torch.tensor(R_bar)))
    for name, g, w in zip("ABCD", got, want):
        scale = max(np.max(np.abs(np.asarray(w))), 1.0)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-8 * scale, err_msg=name)


def test_cycle_reduction_vjp():
    rng = np.random.default_rng(3)
    A, B, C = (np.stack(x) for x in zip(*(
        _random_pencil(5, rho, rng) for rho in (0.5, 0.9, 0.98))))
    T_bar = rng.standard_normal(A.shape)
    _, vjp = jax.vjp(lambda a, b, c: _ref_cr(a, b, c).T,
                     *(jnp.asarray(x) for x in (A, B, C)))
    want = vjp(jnp.asarray(T_bar))
    leaves = [torch.tensor(x, requires_grad=True) for x in (A, B, C)]
    T = cycle_reduction(*leaves, tol=TOL, maxiter=MAXITER).T
    got = torch.autograd.grad(T, leaves, torch.tensor(T_bar))
    for name, g, w in zip("ABC", got, want):
        scale = max(np.max(np.abs(np.asarray(w))), 1.0)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-8 * scale, err_msg=name)


def test_no_stable_solvent_and_singular_B_are_flags():
    """Diagonal pencils: one whose roots are both inside the unit circle
    for one variable (no stable solvent with a dichotomy), one whose roots
    are both outside (no stable solvent), and one with B = 0 (singular)."""
    n = 3
    eye = np.eye(n)
    # c t² + b t + a = 0 with roots r1, r2: a = r1 r2, b = -(r1 + r2), c = 1
    def pencil(r1, r2):
        a, b = np.full(n, 0.3 * 0.1), np.full(n, -(0.3 + 1 / 0.1))
        a[0], b[0] = r1 * r2, -(r1 + r2)
        return np.diag(a), np.diag(b), eye.copy()

    inside, outside = pencil(0.5, 0.8), pencil(2.0, 3.0)
    singular = (np.diag(np.full(n, 0.2)), np.zeros((n, n)), eye.copy())
    A, B, C = (np.stack(x) for x in zip(inside, outside, singular))
    got, want = _port_cr(A, B, C), _ref_cr(A, B, C)
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    assert not got.success.any()
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(want.n_iter))


def test_mixed_batch_gives_each_draw_its_solo_result():
    rng = np.random.default_rng(4)
    A, B, C = (np.stack(x) for x in zip(*(
        _random_pencil(6, rho, rng) for rho in (0.1, 0.9, 0.999, 0.6))))
    A[3, 0, 0] = np.nan
    got = _port_cr(A, B, C)
    assert not bool(got.success[3]) and bool(got.success[:3].all())
    for b in range(4):
        solo = _port_cr(A[b:b + 1], B[b:b + 1], C[b:b + 1])
        assert int(solo.n_iter[0]) == int(got.n_iter[b])
        assert torch.equal(solo.T[0], got.T[b]) or b == 3
        assert bool(solo.success[0]) == bool(got.success[b])
    assert len(set(got.n_iter[:3].tolist())) == 3
    want = _ref_cr(A, B, C)
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(want.n_iter))
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    _close(got.T[:3].numpy(), np.asarray(want.T)[:3], 1e-10)
