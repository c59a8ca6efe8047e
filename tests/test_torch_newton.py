"""Port parity for the batched root finders (``geconpy_torch/ops/newton.py``
against ``geconpy_tpu/ops/newton.py``).

Every ported method runs on the fixtures of ``tests/ops/test_newton.py``
(the quadratic, the Rosenbrock gradient, the two stiff exponential systems
of the dogleg and extended-family tests, the chord test's nearly linear
system) and on a start where the Jacobian is exactly singular, through
both packages' ``root``: x at rel 1e-10 (atol 1e-12), equal ``success``,
``n_iter`` and ``n_feval``, and a converged residual norm within 1e-12
(it is rounding noise).  A mixed batch (a draw that converges at once,
a NaN draw, a slow draw, an ordinary one) equals its solo runs bit for bit,
for every method.  ``"newton_krylov"`` (the batched GMRES of
``geconpy_torch/ops/gmres.py`` inside) is one of the methods, and
``newton_krylov_solve`` also matches the reference on the banded systems
of the reference's Krylov tests at tol 1e-10.  CPU, float64, one thread.
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

from geconpy_torch.ops import newton as port
from geconpy_tpu.ops import newton as ref

METHODS = ["newton", "newton_nm", "chord", "lm", "dogleg", "gauss_newton",
           "newton_krylov", "hybrid"]


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stack(xp, *cols):
    return (jnp.stack(cols, axis=-1) if xp is jnp
            else torch.stack(cols, dim=-1))


# each fixture takes x (..., m) and the array module
def quad(x, xp):
    return _stack(xp, x[..., 0] ** 2 - 1.0, x[..., 1] ** 2 - 4.0)


def rosenbrock_grad(x, xp):
    a, b = 1.0, 100.0
    return _stack(xp,
                  -2 * (a - x[..., 0]) - 4 * b * x[..., 0]
                  * (x[..., 1] - x[..., 0] ** 2),
                  2 * b * (x[..., 1] - x[..., 0] ** 2))


def stiff_dogleg(x, xp):
    return _stack(xp, xp.exp(x[..., 0]) - 2.0,
                  x[..., 0] * x[..., 1] - float(np.log(2.0)))


def stiff_family(x, xp):
    return _stack(xp, xp.exp(x[..., 0]) - 2.0,
                  10.0 * x[..., 1] + x[..., 0] ** 3 - 1.3)


def nearly_linear(x, xp):
    return _stack(xp, x[..., 0] - 0.01 * xp.tanh(x[..., 0]) - 0.3,
                  x[..., 1] - 0.01 * xp.tanh(x[..., 1]) + 0.7)


def singular_start(x, xp):
    # J = [[2 x0, 1], [1, 2 x1]] is exactly singular at (0.5, 0.5)
    return _stack(xp, x[..., 0] ** 2 + x[..., 1] - 2.0,
                  x[..., 0] + x[..., 1] ** 2 - 2.0)


CASES = {
    "quadratic": (quad, [3.0, 3.0], 100),
    "rosenbrock": (rosenbrock_grad, [-1.2, 1.0], 200),
    "stiff_dogleg": (stiff_dogleg, [5.0, -4.0], 300),
    "stiff_family": (stiff_family, [5.0, -4.0], 500),
    "nearly_linear": (nearly_linear, [0.0, 0.0], 100),
    "singular_start": (singular_start, [0.5, 0.5], 100),
}


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", list(CASES))
def test_root_matches_reference(case, method):
    fn, x0, maxiter = CASES[case]
    want = ref.root(lambda x: fn(x, jnp), jnp.asarray(x0), method=method,
                    maxiter=maxiter)
    got = port.root(lambda x: fn(x, torch),
                    torch.tensor([x0], dtype=torch.float64),
                    method=method, maxiter=maxiter)
    assert bool(got.success[0]) == bool(want.success)
    assert int(got.n_iter[0]) == int(want.n_iter)
    assert int(got.n_feval[0]) == int(want.n_feval)
    np.testing.assert_allclose(got.x[0].numpy(), np.asarray(want.x),
                               rtol=1e-10, atol=1e-12)
    # a converged residual is rounding noise around the root
    if bool(want.success):
        assert abs(float(got.norm[0]) - float(want.norm)) < 1e-12


def test_singular_jacobian_is_a_flag_not_an_exception():
    """The Newton direction at an exactly singular J is NaN (``solve_ex``),
    so the steepest-descent fallback runs, as in the reference."""
    x0 = torch.tensor([[0.5, 0.5]], dtype=torch.float64)
    J = port.batched_jacobian(lambda x: singular_start(x, torch), x0)
    with pytest.raises(RuntimeError):
        torch.linalg.solve(J, -singular_start(x0, torch))
    res = port.newton_solve(lambda x: singular_start(x, torch), x0)
    assert bool(res.success[0])
    np.testing.assert_allclose(res.x[0].numpy(), [1.0, 1.0], rtol=1e-10)


def _scalar_root(x, c):
    return (x[..., 0] ** 2 - c[..., 0])[..., None]


@pytest.mark.parametrize("method", METHODS)
def test_mixed_batch_equals_solo_runs_bitwise(method):
    """One draw converged at its start, a NaN draw, a slow draw (a far
    root from a near start) and an ordinary one: the batch gives each draw
    exactly its solo result, flags and counts."""
    c = torch.tensor([[1.0], [float("nan")], [1e6], [4.0]],
                     dtype=torch.float64)
    x0 = torch.tensor([[1.0], [1.0], [1.0], [3.0]], dtype=torch.float64)
    batch = port.root(_scalar_root, x0, (c,), method=method, maxiter=60)
    assert batch.x.shape == (4, 1)
    assert bool(batch.success[0]) and not bool(batch.success[1])
    assert int(batch.n_iter[0]) == 0
    for i in range(4):
        solo = port.root(_scalar_root, x0[i:i + 1], (c[i:i + 1],),
                         method=method, maxiter=60)
        for field in port.RootResult._fields:
            torch.testing.assert_close(getattr(batch, field)[i:i + 1],
                                       getattr(solo, field), rtol=0, atol=0,
                                       equal_nan=True, msg=f"{field} {i}")


def test_mixed_batch_matches_reference_vmap():
    """The same batch against the reference's ``vmap`` of each solver."""
    c = np.array([[1.0], [np.nan], [1e6], [4.0]])
    x0 = np.array([[1.0], [1.0], [1.0], [3.0]])
    for method in METHODS:
        want = jax.vmap(lambda x, cc: ref.root(
            lambda xx, ccc: _scalar_root(xx, ccc), x, (cc,), method=method,
            maxiter=60))(jnp.asarray(x0), jnp.asarray(c))
        got = port.root(_scalar_root, torch.tensor(x0), (torch.tensor(c),),
                        method=method, maxiter=60)
        np.testing.assert_array_equal(got.success.numpy(),
                                      np.asarray(want.success), err_msg=method)
        np.testing.assert_array_equal(got.n_iter.numpy(),
                                      np.asarray(want.n_iter), err_msg=method)
        np.testing.assert_array_equal(got.n_feval.numpy(),
                                      np.asarray(want.n_feval), err_msg=method)
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                                   rtol=1e-10, err_msg=method)


def _banded(kind, x, xp):
    """The banded systems of the reference's Krylov tests
    (``tests/ops/test_newton.py:157-166``), over a leading batch."""
    cat = jnp.concatenate if xp is jnp else torch.cat
    zero = xp.zeros_like(x[..., :1])
    xm = cat([zero, x[..., :-1]], -1)
    if kind == "broyden_tridiag":
        xn = cat([x[..., 1:], zero], -1)
        return (3.0 - 2.0 * x) * x - xm - 2.0 * xn + 1.0
    return x - 0.4 * xp.tanh(xm) + 0.2 * xp.exp(-x) - 0.5


def test_newton_krylov_is_not_ported():
    """Once the pin of the missing method, now its parity check:
    ``newton_krylov_solve`` on the reference's two banded systems (30 and
    24 unknowns, tol 1e-10) takes the reference's iterations and function
    evaluations and lands on its root; an unknown method still raises."""
    for kind, x0 in (("broyden_tridiag", -np.ones(30)),
                     ("exp_coupled", np.zeros(24))):
        want = jax.jit(lambda x, kind=kind: ref.newton_krylov_solve(
            lambda y: _banded(kind, y, jnp), x, tol=1e-10))(jnp.asarray(x0))
        got = port.newton_krylov_solve(lambda y: _banded(kind, y, torch),
                                       torch.tensor(x0)[None], tol=1e-10)
        assert bool(got.success[0]) and bool(want.success), kind
        assert int(got.n_iter[0]) == int(want.n_iter), kind
        assert int(got.n_feval[0]) == int(want.n_feval), kind
        np.testing.assert_allclose(got.x[0].numpy(), np.asarray(want.x),
                                   rtol=1e-10, atol=1e-12, err_msg=kind)
    with pytest.raises(ValueError):
        port.root(lambda x: quad(x, torch),
                  torch.tensor([[3.0, 3.0]], dtype=torch.float64),
                  method="broyden")
