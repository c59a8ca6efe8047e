"""Port parity for the implicit-function gradient of a root solve
(``geconpy_torch/ops/implicit.py::implicit_root`` against
``geconpy_tpu/ops/implicit.py::implicit_root``).

The cases of ``tests/ops/test_implicit.py``, each against the reference's
``jax.grad`` at rel 1e-10: x* = sqrt(θ), the coupled two-variable system
(a loss of sin(x*)), θ as a tuple of tensors (the reference's pytree),
a zero gradient for x0, and a batch of θ (the reference's ``vmap``).  The
solver is the same fixed 30-step Newton iteration on both sides.  CPU,
float64, one thread.
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

from geconpy_torch.ops.implicit import implicit_root as port_implicit
from geconpy_torch.ops.newton import batched_jacobian
from geconpy_tpu.ops.implicit import implicit_root as ref_implicit


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ref_solver(f, n_iter=30):
    def solver(x0, theta):
        def body(x, _):
            J = jax.jacfwd(f, argnums=0)(x, theta)
            return x - jnp.linalg.solve(J, f(x, theta)), None
        x_star, _ = jax.lax.scan(body, x0, None, length=n_iter)
        return x_star, {"resid": jnp.linalg.norm(f(x_star, theta))}
    return solver


def _port_solver(f, n_iter=30):
    def solver(x0, theta):
        x = x0
        for _ in range(n_iter):
            J = batched_jacobian(f, x, (theta,))
            x = x - torch.linalg.solve(J, f(x, theta))
        return x, {"resid": torch.linalg.vector_norm(f(x, theta), dim=-1)}
    return solver


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def test_sqrt_gradient():
    def f_ref(x, theta):
        return x ** 2 - theta

    f_port = f_ref
    ref = ref_implicit(f_ref, _ref_solver(f_ref))
    port = port_implicit(f_port, _port_solver(f_port))
    theta = _t([[4.0]]).requires_grad_(True)
    x_star, aux = port(_t([[1.0]]), theta)
    np.testing.assert_allclose(float(x_star.detach()[0, 0]), 2.0, rtol=1e-12)
    assert float(aux["resid"][0]) < 1e-10
    (g,) = torch.autograd.grad(x_star.sum(), theta)
    g_ref = jax.grad(lambda th: ref(jnp.array([1.0]), th)[0].sum())(
        jnp.array([4.0]))
    np.testing.assert_allclose(g[0].numpy(), np.asarray(g_ref), rtol=1e-10)
    np.testing.assert_allclose(float(g[0, 0]), 0.25, rtol=1e-10)


def test_multivariate_system_gradient():
    def f_ref(x, theta):
        return jnp.array([x[0] ** 2 + x[1] - theta[0],
                          x[0] - x[1] ** 3 - theta[1]])

    def f_port(x, theta):
        return torch.stack([x[..., 0] ** 2 + x[..., 1] - theta[..., 0],
                            x[..., 0] - x[..., 1] ** 3 - theta[..., 1]], -1)

    ref = ref_implicit(f_ref, _ref_solver(f_ref))
    port = port_implicit(f_port, _port_solver(f_port))
    x0 = [1.0, 0.5]
    g_ref = jax.grad(lambda th: jnp.sum(jnp.sin(ref(jnp.array(x0), th)[0])))(
        jnp.array([2.0, 0.5]))
    theta = _t([[2.0, 0.5]]).requires_grad_(True)
    (g,) = torch.autograd.grad(torch.sin(port(_t([x0]), theta)[0]).sum(),
                               theta)
    np.testing.assert_allclose(g[0].numpy(), np.asarray(g_ref), rtol=1e-10)


def test_tuple_theta():
    def f_ref(x, theta):
        return theta["a"] * x + theta["b"]

    def f_port(x, theta):
        a, b = theta
        return a * x + b

    ref = ref_implicit(f_ref, _ref_solver(f_ref))
    port = port_implicit(f_port, _port_solver(f_port))
    g_ref = jax.grad(lambda th: ref(jnp.array([0.0]), th)[0].sum())(
        {"a": jnp.array([2.0]), "b": jnp.array([-6.0])})
    a = _t([[2.0]]).requires_grad_(True)
    b = _t([[-6.0]]).requires_grad_(True)
    x_star, _ = port(_t([[0.0]]), (a, b))
    np.testing.assert_allclose(float(x_star.detach()[0, 0]), 3.0, rtol=1e-10)
    ga, gb = torch.autograd.grad(x_star.sum(), (a, b))
    np.testing.assert_allclose(ga[0].numpy(), np.asarray(g_ref["a"]),
                               rtol=1e-10)
    np.testing.assert_allclose(gb[0].numpy(), np.asarray(g_ref["b"]),
                               rtol=1e-10)
    np.testing.assert_allclose([float(ga[0, 0]), float(gb[0, 0])],
                               [-1.5, -0.5], rtol=1e-8)


def test_x0_gradient_is_zero():
    def f(x, theta):
        return x - theta

    port = port_implicit(f, _port_solver(f))
    x0 = _t([[1.0]]).requires_grad_(True)
    (g,) = torch.autograd.grad(port(x0, _t([[5.0]]))[0].sum(), x0)
    ref = ref_implicit(f, _ref_solver(f))
    g_ref = jax.grad(lambda x: ref(x, jnp.array([5.0]))[0].sum())(
        jnp.array([1.0]))
    np.testing.assert_array_equal(g[0].numpy(), np.asarray(g_ref))
    np.testing.assert_array_equal(g.numpy(), [[0.0]])


def test_batch_over_theta():
    """Three draws at once; each draw's value and gradient are the
    reference's ``vmap`` of the single-draw solve."""
    def f(x, theta):
        return x ** 2 - theta

    ref = ref_implicit(f, _ref_solver(f))
    port = port_implicit(f, _port_solver(f))
    thetas = np.array([[1.0], [4.0], [9.0]])
    xs_ref = jax.vmap(lambda th: ref(jnp.array([1.0]), th)[0])(thetas)
    g_ref = jax.vmap(jax.grad(lambda th: ref(jnp.array([1.0]), th)[0].sum()))(
        thetas)
    theta = _t(thetas).requires_grad_(True)
    xs, _ = port(_t([[1.0]] * 3), theta)
    (g,) = torch.autograd.grad(xs.sum(), theta)
    np.testing.assert_allclose(xs.detach().numpy(), np.asarray(xs_ref),
                               rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-10)
    np.testing.assert_allclose(g.numpy().ravel(), [0.5, 0.25, 1 / 6],
                               rtol=1e-10)
