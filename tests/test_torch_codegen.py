"""Port parity: sympy -> torch code generation.

Every function of ``geconpy_torch.codegen.build_model_functions`` equals
the JAX one of ``geconpy_tpu.codegen`` at float64 (atol 1e-12) on
``rbc_estimation`` and ``sw2007``, at random points near the steady state,
unbatched and batched (a leading batch dimension where JAX uses ``vmap``);
the static metadata (orderings, sparse-Jacobian indices, bijector codes) is
identical.  A few expressions exercise the printer's special-function and
piecewise routes.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import sympy as sp
import torch

import geconpy_torch
import geconpy_tpu
from geconpy_torch.codegen.lower import lower_to_torch
from geconpy_tpu.codegen.lower import lower_to_jax

BATCH = 5


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


@pytest.fixture(scope="module", params=["rbc_estimation", "sw2007"])
def bundles(request):
    ref = geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn(request.param), verbose=False)
    port = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn(request.param))
    return ref, port


def _points(ref_model, seed):
    """Random valid points: parameters near calibration, states near the
    analytic steady state; (batched arrays, one unbatched row)."""
    mf = ref_model.functions
    rng = np.random.default_rng(seed)
    free0 = np.asarray(ref_model.default_theta())
    free = free0[None] * (1 + 0.01 * rng.standard_normal((BATCH, len(free0))))
    theta = np.asarray(jax.vmap(mf.f_params)(jnp.asarray(free)))
    x_ss = np.asarray(jax.vmap(jax.jit(ref_model.ss_solver))(
        jnp.asarray(free)).x_ss)
    n, k = mf.n_variables, mf.n_shocks

    def near(x):
        return x * (1 + 0.01 * rng.standard_normal(x.shape))

    return {"free": free, "theta": theta, "x_ss": x_ss,
            "y_m1": near(x_ss), "y": near(x_ss), "y_p1": near(x_ss),
            "eps": 0.01 * rng.standard_normal((BATCH, k)),
            "n": n}


def _check(ref_fn, port_fn, args):
    batched_ref = np.asarray(jax.vmap(ref_fn.fn)(*(jnp.asarray(a) for a in args)))
    batched_port = port_fn(*(torch.tensor(a) for a in args)).numpy()
    assert batched_port.shape == batched_ref.shape
    np.testing.assert_allclose(batched_port, batched_ref, rtol=0, atol=1e-12)
    one_ref = np.asarray(ref_fn.fn(*(jnp.asarray(a[0]) for a in args)))
    one_port = port_fn(*(torch.tensor(a[0]) for a in args)).numpy()
    assert one_port.shape == one_ref.shape
    np.testing.assert_allclose(one_port, one_ref, rtol=0, atol=1e-12)


def test_metadata_matches(bundles):
    ref, port = bundles
    r, p = ref.functions, port.functions
    assert p.variable_names == r.variable_names
    assert p.shock_names == r.shock_names
    assert p.param_names == r.param_names
    for name in ("known_idx", "unknown_idx", "eq_unknown_idx", "lin_rows",
                 "lin_cols"):
        np.testing.assert_array_equal(getattr(p, name), getattr(r, name),
                                      err_msg=name)
    assert list(p.bijector.kinds) == np.asarray(r.bijector.kinds).tolist()
    assert (p.f_calib_resid is None) == (r.f_calib_resid is None)
    for name in ("f_params", "f_resid", "f_ss_resid", "f_lin_nz", "f_ss_known"):
        assert getattr(p, name).group_names == getattr(r, name).group_names
        assert getattr(p, name).output_shape == getattr(r, name).output_shape


def test_generated_functions_match(bundles):
    ref, port = bundles
    r, p = ref.functions, port.functions
    pts = _points(ref, seed=0)
    dyn = (pts["y_m1"], pts["y"], pts["y_p1"], pts["eps"], pts["x_ss"],
           pts["theta"])
    _check(r.f_params, p.f_params, (pts["free"],))
    _check(r.f_resid, p.f_resid, dyn)
    _check(r.f_lin_nz, p.f_lin_nz, dyn)
    _check(r.f_ss_resid, p.f_ss_resid, (pts["x_ss"], pts["theta"]))
    _check(r.f_ss_known, p.f_ss_known, (pts["theta"],))


def test_steady_state_and_linearization_match(bundles):
    ref, port = bundles
    pts = _points(ref, seed=1)
    ss_ref = jax.vmap(jax.jit(ref.ss_solver))(jnp.asarray(pts["free"]))
    ss_port = port.ss_solver(torch.as_tensor(pts["free"]))
    np.testing.assert_allclose(ss_port.x_ss.numpy(), np.asarray(ss_ref.x_ss),
                               atol=1e-12)
    np.testing.assert_array_equal(ss_port.success.numpy(),
                                  np.asarray(ss_ref.success))
    lin_ref = jax.vmap(ref.linearizer())(ss_ref.x_ss, ss_ref.theta_full)
    lin_port = port.linearizer()(ss_port.x_ss, ss_port.theta_full)
    for name in ("A", "B", "C", "D", "loglin_scale"):
        np.testing.assert_allclose(getattr(lin_port, name).numpy(),
                                   np.asarray(getattr(lin_ref, name)),
                                   atol=1e-12, err_msg=name)


def test_printer_routes_special_functions_and_piecewise():
    x, y = sp.symbols("x y", positive=True)
    exprs = [sp.erf(x), sp.erfc(y), sp.loggamma(x + 1), sp.gamma(y + 0.5),
             sp.Max(x, y, 1), sp.Min(x, 2), sp.Piecewise((x, x > y), (y, True)),
             sp.sqrt(2) * sp.log(x) + sp.pi * y + sp.exp(1), sp.Integer(3)]
    ref = lower_to_jax(exprs, [("v", [x, y])], name="special")
    port = lower_to_torch(exprs, [("v", [x, y])], name="special")
    v = np.array([[0.3, 1.7], [2.5, 0.4], [1.0, 1.0]])
    _check(ref, port, (v,))
