"""Port parity: the differentiable policy solve of the value+grad path.

- The plain version of kernel K4 (``batched_cycle_reduction.cycle_reduction``
  on CPU tensors) equals ``pallas_cycle_reduction(..., interpret=True)``:
  T at atol 1e-10 and the success flags equal, on SW-2007's reduced pencils
  at 8 perturbed draws plus a divergent (BK-violating) one, and on
  ``rbc_estimation``'s (n = 4, where the reference embeds the pencil in an
  8 x 8 identity-padded system).
- ``ops.linalg.gj_solve`` and its VJP equal the reference's
  ``custom_linear_solve`` at 1e-12.
- ``solve_adjoint_sylvester`` and the VJP of the implicit policy adjoint
  (``_ImplicitPolicyT``) equal the reference's at 1e-10 on SW-2007 systems;
  ``policy_from_reduced`` and ``finalize_reduced_policy`` (T, R, success)
  equal the reference's at 1e-10.
"""

import functools
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
from geconpy_torch.ops import linalg as port_linalg
from geconpy_torch.ops import static_reduction as port_sr
from geconpy_torch.ops.batched_cycle_reduction import cycle_reduction
from geconpy_torch.stats.statespace import DSGEStateSpace
from geconpy_tpu.ops import linalg as ref_linalg
from geconpy_tpu.ops import static_reduction as ref_sr
from geconpy_tpu.ops.pallas_cycle_reduction import pallas_cycle_reduction

# the modules, not the functions of the same names that both ops packages export
ref_cr = importlib.import_module("geconpy_tpu.ops.cycle_reduction")
port_cr = importlib.import_module("geconpy_torch.ops.cycle_reduction")

N_ITER = 14
SW_EST = ["crhoa", "sigma_ea", "crr", "crpi", "chabb"]


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _system(name, configure, batch, scale, seed):
    """Full and reduced pencils of ``batch`` perturbed draws."""
    model = geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn(name))
    ss = DSGEStateSpace(model, device="cpu").configure(**configure(model))
    pre_policy, _, _ = ss._solution_pieces()
    u0 = ss.initial_position().numpy()
    rng = np.random.default_rng(seed)
    U = u0[None] + scale * rng.standard_normal((batch, u0.shape[0]))
    pre = pre_policy(torch.as_tensor(U))
    plan = model.static_reduction
    red = port_sr.reduce_pencil(pre["A"], pre["B"], pre["C"], pre["D"], plan)
    return dict(pre=pre, red=red, plan=plan, order=ss._static_pivot_order(),
                n=model.functions.n_variables)


@pytest.fixture(scope="module")
def sw():
    return _system("sw2007", lambda m: dict(
        observed_states=["y", "pinf", "r"], filter_type="stationary",
        constant_params=[p for p in m.param_names if p not in SW_EST]),
        batch=8, scale=0.05, seed=0)


@pytest.fixture(scope="module")
def rbc():
    return _system("rbc_estimation", lambda m: dict(
        observed_states=["Y"], constant_params=["alpha", "sigma_C"],
        filter_type="stationary"), batch=8, scale=0.1, seed=1)


def _with_divergent_draw(red):
    A, B, C = (X.numpy() for X in (red.A2, red.B2, red.C2))
    n = A.shape[-1]
    rng = np.random.default_rng(99)
    bad = [M[0] + 0.05 * rng.standard_normal((n, n)) * np.abs(M[0]).max()
           for M in (A, B, C)]
    return tuple(np.concatenate([M, b[None]]) for M, b in zip((A, B, C), bad))


@pytest.mark.parametrize("case", ["sw", "rbc"])
def test_k4_plain_matches_pallas_interpret(case, request):
    sys_ = request.getfixturevalue(case)
    pencils = _with_divergent_draw(sys_["red"])
    fn = jax.jit(functools.partial(
        pallas_cycle_reduction, order=sys_["order"], n_iter=N_ITER,
        tile=pencils[0].shape[0], interpret=True))
    T_r, ok_r = (np.asarray(x) for x in fn(*(jnp.asarray(p) for p in pencils)))
    T_p, ok_p = cycle_reduction(*(torch.as_tensor(p) for p in pencils),
                                order=sys_["order"], n_iter=N_ITER)
    np.testing.assert_array_equal(ok_p.numpy(), ok_r)
    assert ok_r[:-1].all() and not ok_r[-1]
    np.testing.assert_allclose(T_p.numpy()[ok_r], T_r[ok_r], atol=1e-10)


def test_gj_solve_value_and_vjp_match_reference():
    rng = np.random.default_rng(3)
    M = rng.standard_normal((4, 6, 6)) + 2.0 * np.eye(6)
    M[:, 0, 0] = 0.0                      # needs a row swap
    B = rng.standard_normal((4, 6, 3))
    W = rng.standard_normal((4, 6, 3))

    def ref_loss(m, b):
        return jnp.sum(jax.vmap(ref_linalg.gj_solve)(m, b) * W)

    val_r, (gM_r, gB_r) = jax.value_and_grad(ref_loss, argnums=(0, 1))(
        jnp.asarray(M), jnp.asarray(B))
    Mt, Bt = (torch.as_tensor(x).requires_grad_(True) for x in (M, B))
    X = port_linalg.gj_solve(Mt, Bt)
    loss = (X * torch.as_tensor(W)).sum()
    gM, gB = torch.autograd.grad(loss, (Mt, Bt))
    np.testing.assert_allclose(float(loss.detach()), float(val_r), rtol=1e-12)
    np.testing.assert_allclose(gM.numpy(), np.asarray(gM_r), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(gB.numpy(), np.asarray(gB_r), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(port_linalg.gj_inverse(torch.as_tensor(M)).numpy(),
                               np.asarray(jax.vmap(ref_linalg.gj_inverse)(
                                   jnp.asarray(M))), rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def sw_policy(sw):
    """SW-2007 full-system pencils and their policy T from the port's K4."""
    red, plan, n = sw["red"], sw["plan"], sw["n"]
    T_d, ok = cycle_reduction(red.A2, red.B2, red.C2, order=sw["order"],
                              n_iter=N_ITER)
    assert bool(ok.all())
    T = port_sr.policy_from_reduced(T_d, red, plan, n)
    pre = sw["pre"]
    return dict(A=pre["A"], B=pre["B"], C=pre["C"], D=pre["D"], T=T, T_d=T_d,
                ok=ok, red=red, plan=plan, n=n)


def test_policy_from_reduced_and_finalize_match_reference(sw_policy):
    p = sw_policy
    red_np = {f: jnp.asarray(getattr(p["red"], f).numpy())
              for f in ("A2", "B2", "C2", "A1", "B1", "C1", "R_s")}
    T_ref = jax.vmap(lambda t, a1, b1, c1, rs: ref_sr.policy_from_reduced(
        t, ref_sr.ReducedPencil(None, None, None, a1, b1, c1, rs), p["plan"],
        p["n"]))(jnp.asarray(p["T_d"].numpy()), red_np["A1"], red_np["B1"],
                 red_np["C1"], red_np["R_s"])
    np.testing.assert_allclose(p["T"].numpy(), np.asarray(T_ref), atol=1e-10)
    args = [jnp.asarray(p[k].numpy()) for k in ("A", "B", "C", "D", "T", "T_d")]
    T_r, R_r, ok_r, resid_r = jax.vmap(ref_sr.finalize_reduced_policy)(
        *args, jnp.asarray(p["ok"].numpy()))
    T_p, R_p, ok_p, resid_p = port_sr.finalize_reduced_policy(
        p["A"], p["B"], p["C"], p["D"], p["T"], p["T_d"], p["ok"])
    np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_r))
    np.testing.assert_allclose(T_p.numpy(), np.asarray(T_r), atol=1e-10)
    np.testing.assert_allclose(R_p.numpy(), np.asarray(R_r), atol=1e-10)
    np.testing.assert_allclose(resid_p.numpy(), np.asarray(resid_r), atol=1e-10)


def test_solve_adjoint_sylvester_matches_reference(sw_policy):
    p = sw_policy
    B, C, T = p["B"], p["C"], p["T"]
    G = torch.as_tensor(np.random.default_rng(5).standard_normal(T.shape))
    W = port_cr.solve_adjoint_sylvester(B + C @ T, C, T, G)
    W_ref = jax.vmap(ref_cr.solve_adjoint_sylvester)(
        *(jnp.asarray(X.numpy()) for X in (B + C @ T, C, T, G)))
    scale = float(np.abs(np.asarray(W_ref)).max())
    np.testing.assert_allclose(W.numpy(), np.asarray(W_ref),
                               atol=1e-10 * max(1.0, scale))
    # W solves the adjoint equation  M' W + C' W T' = G
    M = B + C @ T
    resid = M.transpose(-1, -2) @ W + C.transpose(-1, -2) @ W @ T.transpose(-1, -2) - G
    assert float(resid.abs().max()) < 1e-9 * max(1.0, scale)


def test_implicit_policy_vjp_matches_reference(sw_policy):
    p = sw_policy
    T_bar = np.random.default_rng(6).standard_normal(p["T"].shape)
    A, B, C = (p[k].clone().requires_grad_(True) for k in ("A", "B", "C"))
    T = port_sr._ImplicitPolicyT.apply(A, B, C, p["T"])
    assert torch.equal(T.detach(), p["T"])
    grads = torch.autograd.grad(T, (A, B, C), torch.as_tensor(T_bar))

    def one(a, b, c, t, tb):
        _, vjp = jax.vjp(lambda a_, b_, c_: ref_sr._implicit_policy_T(
            a_, b_, c_, t), a, b, c)
        return vjp(tb)

    refs = jax.vmap(one)(*(jnp.asarray(p[k].numpy()) for k in ("A", "B", "C")),
                         jnp.asarray(p["T"].numpy()), jnp.asarray(T_bar))
    for g, r, name in zip(grads, refs, "ABC"):
        scale = float(np.abs(np.asarray(r)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=1e-10 * max(1.0, scale),
                                   err_msg=f"grad wrt {name}")
