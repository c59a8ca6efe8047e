"""Port parity: the NUTS sampler (``geconpy_torch/stats/nuts.py``).

One ``nuts_kernel`` transition equals the reference's from the same random
numbers: the test regenerates the reference's draws from its
``jax.random`` key splits (momenta, one direction bit and one acceptance
uniform per level, one uniform per leaf) and hands them to the port;
``q'``, ``logp'``, ``grad'`` and ``accept_prob`` agree at 1e-10, and
``n_leapfrog`` and ``diverging`` exactly.  Cases: a 5-dimensional
correlated Gaussian with a diagonal and with a dense metric, a target with
-inf regions, ``rbc_estimation``'s batched value+grad (the reference
through its Pallas kernel in interpret mode, its adaptation state and
chains carried across by ``interop.adaptation_from_reference``), and
``rbc_estimation``'s single-draw log posterior on the sequential filter
(``fit(policy="xla")``'s target).

The adaptation pieces equal the reference's at 1e-12 (the curvature seed
at 1e-8), and ``_window_schedule`` exactly (and by AST).  The statistical
tests mirror ``tests/stats/test_nuts.py`` with its bars at about half its
numbers of draws: the port's random numbers come from ``torch.Generator``,
so only moments are compared.  CPU, float64, one thread.
"""

import ast
import inspect
import os
import textwrap

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
from geconpy_torch.interop import adaptation_from_reference
from geconpy_torch.stats import nuts as port
from geconpy_torch.stats.diagnostics import split_rhat
from geconpy_torch.stats.statespace import DSGEStateSpace as PortStateSpace
from geconpy_tpu.stats import estimation as ref_estimation
from geconpy_tpu.stats import nuts as ref
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


# ------------------------------------------------------------- one transition

def reference_draws(keys, dim, max_depth):
    """The random numbers the reference's ``nuts_kernel`` draws from each
    chain's key (``nuts.py:142-143, :221-222, :280-290``), in the port's
    layout."""
    z, direction, u_accept, u_leaf = [], [], [], []
    for key in keys:
        key_mom, key = jax.random.split(key)
        z.append(np.asarray(jax.random.normal(key_mom, (dim,), jnp.float64)))
        dirs, accs, leaves = [], [], []
        for depth in range(max_depth):
            key, k_dir, k_accept, k_sub = jax.random.split(key, 4)
            dirs.append(bool(jax.random.bernoulli(k_dir)))
            accs.append(float(jax.random.uniform(k_accept, dtype=jnp.float64)))
            for _ in range(2**depth):
                k_sub, sub = jax.random.split(k_sub)
                leaves.append(float(jax.random.uniform(sub, dtype=jnp.float64)))
        direction.append(dirs)
        u_accept.append(accs)
        u_leaf.append(leaves)
    return {"z": torch.tensor(np.stack(z)), "direction": torch.tensor(direction),
            "u_accept": torch.tensor(u_accept), "u_leaf": torch.tensor(u_leaf)}


def _gaussian(dim=5, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((dim, dim))
    cov = A @ A.T / dim + 0.5 * np.eye(dim)
    return cov, np.linalg.inv(cov)


def _gaussian_targets(prec, support=None):
    """(reference logp, port batched value+grad) of N(0, prec^-1), set to
    -inf where ``q[0] < support`` when given."""
    P, Pt = jnp.asarray(prec), torch.tensor(prec)

    def ref_logp(q):
        val = -0.5 * q @ P @ q
        return val if support is None else jnp.where(q[0] > support, val,
                                                     -jnp.inf)

    def port_vag(Q):
        val = -0.5 * ((Q @ Pt) * Q).sum(-1)
        if support is not None:
            val = torch.where(Q[:, 0] > support, val,
                              torch.full_like(val, -np.inf))
        return val, -(Q @ Pt)

    return ref_logp, port_vag


def _compare_transition(ref_out, port_out):
    q_r, l_r, g_r, info_r = (jax.tree.map(np.asarray, x) for x in ref_out)
    q_p, l_p, g_p, info_p = port_out
    np.testing.assert_allclose(q_p.numpy(), q_r, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(l_p.numpy(), l_r, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(g_p.numpy(), g_r, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(info_p["accept_prob"].numpy(),
                               info_r["accept_prob"], rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(info_p["n_leapfrog"].numpy(),
                                  info_r["n_leapfrog"])
    np.testing.assert_array_equal(info_p["diverging"].numpy(),
                                  info_r["diverging"])
    return info_p


@pytest.mark.parametrize("case", ["diag", "dense", "neg_inf"])
def test_gaussian_transition_matches_reference(case):
    dim, chains, max_depth, eps = 5, 8, 6, 0.3
    cov, prec = _gaussian(dim)
    support = -0.3 if case == "neg_inf" else None
    ref_logp, port_vag = _gaussian_targets(prec, support)
    rng = np.random.default_rng(1)
    q = 0.8 * rng.standard_normal((chains, dim))
    if support is not None:
        q[:, 0] = np.abs(q[:, 0])
        eps = 0.9          # long steps that leave the support
    inv_mass = cov if case == "dense" else np.diag(cov).copy()
    lp, g = (np.asarray(x) for x in jax.vmap(jax.value_and_grad(ref_logp))(
        jnp.asarray(q)))
    keys = jax.random.split(jax.random.PRNGKey(4), chains)
    ref_out = jax.vmap(lambda qq, ll, gg, k: ref.nuts_kernel(
        ref_logp, qq, ll, gg, k, eps, jnp.asarray(inv_mass), max_depth))(
        jnp.asarray(q), jnp.asarray(lp), jnp.asarray(g), keys)
    im = torch.tensor(inv_mass)
    port_out = port.nuts_kernel(
        port_vag, torch.tensor(q), torch.tensor(lp), torch.tensor(g), eps,
        im.expand((chains,) + im.shape), max_depth,
        draws=reference_draws(keys, dim, max_depth))
    info = _compare_transition(ref_out, port_out)
    if case == "neg_inf":
        assert info["diverging"].any() and not info["diverging"].all()
    # the port calls the value+grad once per leaf of the levels it runs
    depth_run = int(np.log2(info["n_calls"] + 1))
    assert info["n_calls"] == 2**depth_run - 1
    assert int(info["n_leapfrog"].max()) <= info["n_calls"]


RBC = dict(observed_states=["Y"], constant_params=["alpha", "sigma_C"],
           filter_type="stationary", kalman_settle=12)


def _ref_fd_logp_grad(ref_vag):
    """The reference's value+grad with non-finite gradients zeroed (as its
    sampler wraps it), refusing forward mode with ``TypeError`` so that its
    curvature seed takes its central-difference branch
    (``nuts.py:379-385``), the branch the port implements."""
    @jax.custom_jvp
    def logp_grad(q):
        val, g = ref_vag(q)
        return val, jnp.where(jnp.isfinite(g), g, jnp.zeros_like(g))

    @logp_grad.defjvp
    def _no_forward_mode(primals, tangents):
        raise TypeError("forward mode is refused")

    return logp_grad


@pytest.fixture(scope="module")
def rbc():
    ref_model = geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn("rbc_estimation"), verbose=False)
    ref_ss = RefStateSpace(ref_model).configure(**RBC)
    data, _ = ref_ss.data_from_prior(jax.random.PRNGKey(0), periods=48,
                                     params={"rho_A": 0.9, "sigma_A": 0.012})
    data = np.asarray(data)
    port_ss = PortStateSpace(geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation")), device="cpu"
    ).configure(**RBC)
    ref_vag = ref_estimation.make_batched_logp_grad(ref_ss, data,
                                                    interpret=True, cr_tile=8)
    u0 = np.asarray(ref_ss.initial_position())
    q = u0[None] + 0.05 * np.random.default_rng(2).standard_normal((6, 2))
    hess = np.asarray(jax.jit(jax.vmap(lambda x: ref._hessian_diag_inv_mass(
        _ref_fd_logp_grad(ref_vag), x)))(jnp.asarray(q)))
    return ref_ss, port_ss, data, ref_vag, q, hess


def test_rbc_transition_matches_reference(rbc):
    """The DSGE target: both value+grads batched over the chains, the
    reference's curvature-seeded pooled adaptation state carried across."""
    ref_ss, port_ss, data, ref_vag, q, hess = rbc
    chains, dim, max_depth = q.shape[0], q.shape[1], 4
    adapt = ref._adapt_init(0.5, dim, jnp.float64, inv_mass0=hess.mean(0))
    carried = adaptation_from_reference(
        {"param_labels": ref_ss.param_labels, "q": q,
         **{k: np.asarray(v) for k, v in adapt._asdict().items()}}, port_ss)
    eps = float(np.exp(np.asarray(adapt.log_eps)))
    lp, g = (np.asarray(x) for x in jax.jit(jax.vmap(ref_vag))(jnp.asarray(q)))
    keys = jax.random.split(jax.random.PRNGKey(5), chains)
    ref_out = jax.jit(jax.vmap(lambda qq, ll, gg, k: ref.nuts_kernel(
        None, qq, ll, gg, k, eps, adapt.inv_mass, max_depth,
        logp_grad_fn=ref_vag)))(jnp.asarray(q), jnp.asarray(lp),
                                jnp.asarray(g), keys)
    vag = port_ss.build_batched_logpost_and_grad(data)
    lp_p, g_p = vag(carried["q"])
    np.testing.assert_allclose(lp_p.numpy(), lp, rtol=1e-10)
    port_out = port.nuts_kernel(
        vag, carried["q"], lp_p, g_p, torch.exp(carried["adapt"].log_eps),
        carried["adapt"].inv_mass, max_depth,
        draws=reference_draws(keys, dim, max_depth))
    _compare_transition(ref_out, port_out)


def test_rbc_transition_xla_policy_matches_reference():
    """``fit(policy="xla")``'s target: the single-draw log posterior on the
    reference's default configuration (sequential filter, XLA policy),
    the reference's chains differentiating it per chain under ``vmap``,
    the port's one batched value+grad for all chains
    (``build_logpost_and_grad``)."""
    kw = dict(observed_states=["Y"], constant_params=["alpha", "sigma_C"])
    ref_ss = RefStateSpace(geconpy_tpu.model_from_gcn(
        geconpy_tpu.get_example_gcn("rbc_estimation"), verbose=False)
    ).configure(**kw)
    data, _ = ref_ss.data_from_prior(jax.random.PRNGKey(0), periods=32,
                                     params={"rho_A": 0.9, "sigma_A": 0.012})
    data = np.asarray(data)
    port_ss = PortStateSpace(geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation")), device="cpu"
    ).configure(**kw)
    chains, dim, max_depth, eps = 4, 2, 4, 0.05
    q = np.asarray(ref_ss.initial_position())[None] \
        + 0.05 * np.random.default_rng(3).standard_normal((chains, dim))
    inv_mass = np.array([0.05, 1.0])
    ref_logp = ref_ss.build_logpost(data)
    lp, g = (np.asarray(x) for x in jax.jit(jax.vmap(
        jax.value_and_grad(ref_logp)))(jnp.asarray(q)))
    keys = jax.random.split(jax.random.PRNGKey(6), chains)
    ref_out = jax.jit(jax.vmap(lambda qq, ll, gg, k: ref.nuts_kernel(
        ref_logp, qq, ll, gg, k, eps, jnp.asarray(inv_mass), max_depth)))(
        jnp.asarray(q), jnp.asarray(lp), jnp.asarray(g), keys)
    vag = port_ss.build_logpost_and_grad(data)
    lp_p, g_p = vag(torch.tensor(q))
    np.testing.assert_allclose(lp_p.numpy(), lp, rtol=1e-10)
    np.testing.assert_allclose(g_p.numpy(), g, rtol=1e-8, atol=1e-8)
    im = torch.tensor(inv_mass)
    port_out = port.nuts_kernel(
        vag, torch.tensor(q), lp_p, g_p, eps, im.expand(chains, dim),
        max_depth, draws=reference_draws(keys, dim, max_depth))
    info = _compare_transition(ref_out, port_out)
    assert info["n_leapfrog"].min() > 1


def test_adaptation_from_reference_refuses_mismatches(rbc):
    ref_ss, port_ss, _data, _vag, q, _hess = rbc
    adapt = {k: np.asarray(v) for k, v in
             ref._adapt_init(0.1, 2, jnp.float64)._asdict().items()}
    ok = adaptation_from_reference(
        {"param_labels": ref_ss.param_labels, "q": q, **adapt}, port_ss)
    assert ok["adapt"].count.dtype == torch.int32
    assert ok["adapt"].inv_mass.shape == (2,)
    with pytest.raises(ValueError, match="order differs"):
        adaptation_from_reference({"param_labels": ref_ss.param_labels[::-1],
                                   "q": q, **adapt}, port_ss)
    with pytest.raises(ValueError, match="inv_mass must be"):
        adaptation_from_reference({"param_labels": ref_ss.param_labels,
                                   "q": q, **dict(adapt, inv_mass=np.ones(3))},
                                  port_ss)
    with pytest.raises(ValueError, match="missing arrays"):
        adaptation_from_reference({"param_labels": ref_ss.param_labels,
                                   "q": q}, port_ss)


def test_hessian_seed_matches_reference(rbc):
    """``_hessian_diag_inv_mass``: central differences, all chains' shifted
    draws in one batched call, equal to the reference's central-difference
    branch at 1e-8."""
    _ref_ss, port_ss, data, _ref_vag, q, want = rbc
    calls = []
    vag = port_ss.build_batched_logpost_and_grad(data)

    def counted(U):
        calls.append(U.shape[0])
        return vag(U)

    got = port._hessian_diag_inv_mass(counted, torch.tensor(q))
    assert calls == [q.shape[0] * 2 * q.shape[1]]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-8)


# -------------------------------------------------------------- adaptation

def _port_adapt(a):
    return port.WindowedAdaptation(*(torch.tensor(np.asarray(x)) for x in a))


def _assert_adapt_equal(got, want, rtol=1e-12):
    for name, g, w in zip(want._fields, got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=rtol,
                                   err_msg=name)


def test_dual_averaging_matches_reference():
    a = ref._adapt_init(0.1, 3, jnp.float64)
    p = _port_adapt(a)
    for acc in (0.2, 0.95, 0.0, 1.0, 0.7):
        a = ref._dual_averaging_update(a, jnp.float64(acc), target=0.9)
        p = port._dual_averaging_update(p, torch.tensor(acc), target=0.9)
    _assert_adapt_equal(p, a)
    # per chain (the unpooled run)
    acc = np.array([0.1, 0.5, 0.99])
    a_c = jax.vmap(lambda x: ref._dual_averaging_update(a, x))(jnp.asarray(acc))
    p_c = port._dual_averaging_update(port._per_chain(p, 3), torch.tensor(acc))
    _assert_adapt_equal(p_c, a_c)


def _window(case, chains, dim):
    rng = np.random.default_rng(3)
    qs = rng.standard_normal((5, chains, dim)) * np.array([2.0, 0.1, 1.0, 5.0])
    if case == "frozen":
        qs[:] = qs[0, 0]                 # no chain moved
    return qs


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
@pytest.mark.parametrize("prev_anchor", [False, True], ids=["stan", "anchor"])
@pytest.mark.parametrize("case", ["moving", "frozen", "nonfinite"])
def test_welford_and_finalize_match_reference(dense, prev_anchor, case):
    chains, dim = 6, 4
    qs = _window(case, chains, dim)
    seed = jnp.asarray(np.linspace(0.5, 2.0, dim))
    im0 = jnp.diag(seed) if dense else seed
    # pooled: one batch update per step
    a = ref._adapt_init(0.1, dim, jnp.float64, inv_mass0=im0, dense=dense)
    p = _port_adapt(a)
    for step in qs:
        a = ref._welford_update_batch(a, jnp.asarray(step))
        p = port._welford_update_batch(p, torch.tensor(step))
    _assert_adapt_equal(p, a)
    if case == "nonfinite":
        bad = np.asarray(a.welford_m2).copy()
        bad[(0, 0) if dense else 0] = np.nan
        a = a._replace(welford_m2=jnp.asarray(bad))
        p = p._replace(welford_m2=torch.tensor(bad))
    _assert_adapt_equal(port._welford_finalize(p, prev_anchor),
                        ref._welford_finalize(a, prev_anchor))
    # unpooled: one draw per chain per step, every field per chain
    a1 = ref._adapt_init(0.1, dim, jnp.float64, inv_mass0=im0, dense=dense)
    a_c = jax.vmap(lambda _: a1)(jnp.arange(chains))
    p_c = port._per_chain(_port_adapt(a1), chains)
    for step in qs:
        a_c = jax.vmap(ref._welford_update)(a_c, jnp.asarray(step))
        p_c = port._welford_update(p_c, torch.tensor(step))
    _assert_adapt_equal(p_c, a_c)
    if case == "nonfinite":
        bad = np.asarray(a_c.welford_m2).copy()
        bad[(1, 0, 0) if dense else (1, 0)] = np.nan
        a_c = a_c._replace(welford_m2=jnp.asarray(bad))
        p_c = p_c._replace(welford_m2=torch.tensor(bad))
    fin_r = jax.vmap(lambda x: ref._welford_finalize(x, prev_anchor))(a_c)
    _assert_adapt_equal(port._welford_finalize(p_c, prev_anchor), fin_r)


@pytest.mark.parametrize("num_warmup", [0, 19, 20, 100, 384, 1000])
def test_window_schedule_matches_reference(num_warmup):
    for got, want in zip(port._window_schedule(num_warmup),
                         ref._window_schedule(num_warmup)):
        np.testing.assert_array_equal(got, want)


def test_window_schedule_is_the_reference_code():
    dump = lambda f: ast.dump(ast.parse(textwrap.dedent(  # noqa: E731
        inspect.getsource(f))))
    assert dump(port._window_schedule) == dump(ref._window_schedule)


def test_logaddexp_and_log_edges_match_jnp():
    a = np.array([-np.inf, -np.inf, np.inf, 3.0, -np.inf, 1e308, np.nan])
    b = np.array([-np.inf, 2.0, np.inf, -np.inf, 5.0, 1e308, 1.0])
    got = port._logaddexp(torch.tensor(a), torch.tensor(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.logaddexp(a, b)))
    # exp of a large energy error and the log of a uniform that is 0
    delta = np.array([-1e4, -5.0, 0.0, 800.0, np.inf])
    np.testing.assert_array_equal(
        torch.clamp(torch.exp(-torch.tensor(delta)), max=1.0).numpy(),
        np.asarray(jnp.minimum(1.0, jnp.exp(-delta))))
    assert torch.log(torch.tensor(0.0)).item() == float(jnp.log(0.0))


# ------------------------------------------------------------- statistical

def _std_normal_vag(Q):
    return -0.5 * (Q * Q).sum(-1), -Q


def test_nuts_standard_normal():
    dim = 4
    gen = torch.Generator().manual_seed(0)
    init = torch.randn((4, dim), generator=gen)
    res = port.sample_nuts(_std_normal_vag, init, gen, num_warmup=200,
                           num_samples=400)
    samples = res.samples.numpy()
    assert samples.shape == (4, 400, dim)
    flat = samples.reshape(-1, dim)
    np.testing.assert_allclose(flat.mean(axis=0), 0.0, atol=0.1)
    np.testing.assert_allclose(flat.std(axis=0), 1.0, atol=0.12)
    assert res.diverging.double().mean() < 0.02
    for i in range(dim):
        assert split_rhat(samples[:, :, i]) < 1.05
    assert len(res.n_calls) == 600 and (res.n_calls >= 1).all()


def test_nuts_hard_neg_inf_regions_safe():
    def vag(Q):
        val = -0.5 * ((Q - 1.0) ** 2).sum(-1)
        return (torch.where((Q > 0).all(-1), val, torch.full_like(val, -np.inf)),
                -(Q - 1.0))

    gen = torch.Generator().manual_seed(3)
    res = port.sample_nuts(vag, torch.full((2, 2), 1.0), gen, num_warmup=100,
                           num_samples=150)
    samples = res.samples.numpy()
    assert np.isfinite(samples).all()
    assert (samples > 0).all()
    assert torch.isfinite(res.logp).all()


def _band_cov(dim, rho, scales):
    C = rho ** np.abs(np.subtract.outer(np.arange(dim), np.arange(dim)))
    return np.asarray(scales)[:, None] * C * np.asarray(scales)[None, :]


def test_pooled_adaptation_gaussian():
    cov = np.array([[4.0, 0.9], [0.9, 0.25]])
    prec = torch.tensor(np.linalg.inv(cov))
    gen = torch.Generator().manual_seed(1)
    q0 = torch.randn((16, 2), generator=gen)
    res = port.sample_nuts(lambda Q: (-0.5 * ((Q @ prec) * Q).sum(-1), -(Q @ prec)),
                           q0, gen, num_warmup=200, num_samples=300,
                           pooled=True)
    s = res.samples.numpy().reshape(-1, 2)
    np.testing.assert_allclose(s.mean(0), [0.0, 0.0], atol=0.3)
    np.testing.assert_allclose(s.var(0), [4.0, 0.25], rtol=0.25)
    assert np.unique(res.step_size.numpy()).size == 1
    assert np.unique(res.inv_mass[:, 0].numpy()).size == 1
    np.testing.assert_allclose(res.inv_mass[0].numpy(), [4.0, 0.25], rtol=0.5)


def test_dense_mass_recovers_full_covariance():
    dim = 5
    C = _band_cov(dim, 0.9, [2.0, 1.0, 0.5, 1.0, 2.0])
    Cinv = torch.tensor(np.linalg.inv(C))
    gen = torch.Generator().manual_seed(1)
    init = 0.1 * torch.randn((16, dim), generator=gen)
    res = port.sample_nuts(lambda Q: (-0.5 * ((Q @ Cinv) * Q).sum(-1), -(Q @ Cinv)),
                           init, gen, num_warmup=300, num_samples=300,
                           pooled=True, mass_matrix="dense")
    inv_mass = res.inv_mass.numpy()
    assert inv_mass.shape == (16, dim, dim)
    M = inv_mass[0]
    np.testing.assert_allclose(inv_mass[7], M, atol=1e-12)
    corr_M = M / np.sqrt(np.outer(np.diag(M), np.diag(M)))
    corr_C = C / np.sqrt(np.outer(np.diag(C), np.diag(C)))
    np.testing.assert_allclose(corr_M, corr_C, atol=0.15)
    flat = res.samples.numpy().reshape(-1, dim)
    np.testing.assert_allclose(np.cov(flat.T), C, atol=0.35 * C.max())
    assert res.diverging.double().mean() < 0.02


def test_dense_kernel_survives_singular_metric():
    """A singular dense metric: the factor fails (NaN, never finite
    garbage), the transition falls back to the diagonal, and the chains
    move on finite."""
    dim, chains = 4, 3
    q = torch.zeros((chains, dim))
    lp, g = _std_normal_vag(q)
    v = torch.arange(1.0, dim + 1.0)
    inv_mass = torch.outer(v, v).expand(chains, dim, dim)
    _, info = torch.linalg.cholesky_ex(inv_mass)
    assert (info != 0).all()
    q2, lp2, g2, out = port.nuts_kernel(_std_normal_vag, q, lp, g, 0.25,
                                        inv_mass, max_depth=5,
                                        generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(q2).all() and torch.isfinite(lp2).all()
    assert torch.isfinite(out["accept_prob"]).all()
    assert (out["accept_prob"] > 0).all()
    assert (q2 != 0).any(-1).all()


def test_sample_nuts_validation():
    gen = torch.Generator().manual_seed(0)
    init = torch.zeros((2, 2))
    with pytest.raises(ValueError, match="mass_matrix"):
        port.sample_nuts(_std_normal_vag, init, gen, mass_matrix="full")
    with pytest.raises(ValueError, match="mass_init"):
        port.sample_nuts(_std_normal_vag, init, gen, mass_init="auto")
    # the reference's divisibility error: 2 chains over a 3-device mesh
    from geconpy_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="divisible by the mesh size"):
        port.sample_nuts(_std_normal_vag, init, gen,
                         mesh=make_mesh(devices=("cpu",) * 3))


def test_segment_size_changes_nothing():
    gen_a = torch.Generator().manual_seed(5)
    gen_b = torch.Generator().manual_seed(5)
    init = torch.ones((3, 2))
    kw = dict(num_warmup=25, num_samples=10, pooled=True, mass_matrix="dense")
    a = port.sample_nuts(_std_normal_vag, init, gen_a, **kw)
    b = port.sample_nuts(_std_normal_vag, init, gen_b, segment_size=4, **kw)
    for name in port.NUTSResult._fields:
        if name != "seconds":       # the host clock
            np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                          np.asarray(getattr(b, name)))
