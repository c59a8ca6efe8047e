"""No-U-Turn Sampler over a batched value+gradient.

Mirrors ``geconpy_tpu/stats/nuts.py``: the pieces ``_apply_inv_mass``
(:60), ``_leapfrog`` (:68), ``_kinetic`` (:76), ``_is_uturn`` (:80) and
``_select`` (:99), the transition ``nuts_kernel`` (:109), the adaptation
``WindowedAdaptation`` (:323), ``_adapt_init`` (:337),
``_hessian_diag_inv_mass`` (:355), ``_dual_averaging_update`` (:395),
``_welford_update`` (:408), ``_welford_update_batch`` (:419),
``_welford_finalize`` (:444) and ``_window_schedule`` (:491), and
``sample_nuts`` (:562) with its unpooled (:690-845) and pooled (:847-999)
run loops.

The algorithm is the reference's: multinomial NUTS (Hoffman & Gelman 2014;
Betancourt 2017) with iterative doubling to ``max_depth``, checkpoint
buffers for the U-turn checks of every aligned subtree, a divergence at an
energy error over 1000, dual-averaging step sizes and Stan's windowed
(diagonal or dense) metric.

Where the reference vmaps one chain's kernel, the port batches the chains
along a leading dimension: every leapfrog step is ONE call of a batched
``value_and_grad(U (C, dim)) -> (logp (C,), grad (C, dim))`` for all chains
(``DSGEStateSpace.build_batched_logpost_and_grad``), and a chain that has
turned or diverged is frozen by ``torch.where`` masks, as ``_select``
freezes it under ``vmap``.  The reference's static ``fori_loop``s evaluate
all 2^max_depth - 1 leaves of every transition; the port reads the chains'
termination back to the host once per tree level and skips the levels that
no chain needs.  The loops over transitions run on the host; the chain
state stays on the value+grad's device.

Random numbers come from an explicit ``torch.Generator`` on that device
(the reference splits a JAX key), or are handed in (``draws``): momentum
normals, one direction bit and one acceptance uniform per level, and one
uniform per leaf.  ``mesh`` (a :class:`~geconpy_torch.parallel.Mesh`)
splits the chain axis of every value+grad call over its devices
(:func:`~geconpy_torch.parallel.pvmap`); the host loop, the adaptation and
the random numbers stay on the chains' device, so a run under a mesh gives
the result of the same run without one.
"""

from __future__ import annotations

import math
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.precision import highest_precision

__all__ = ["NUTSResult", "sample_nuts", "nuts_kernel", "WindowedAdaptation",
           "draw_transition"]

_MAX_DELTA_ENERGY = 1000.0

ValueAndGrad = Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


# ----------------------------------------------------------------- pieces
# Every piece takes a leading chain dimension C.  ``inv_mass`` is per chain,
# (C, dim) for a diagonal metric or (C, dim, dim) for a dense one; a metric
# shared by all chains is passed as an ``expand``ed view.

def _apply_inv_mass(inv_mass, p):
    """M^-1 p for a diagonal (C, dim) or dense (C, dim, dim) metric."""
    if inv_mass.ndim == 3:
        return (inv_mass @ p.unsqueeze(-1)).squeeze(-1)
    return inv_mass * p


def _leapfrog(value_and_grad, q, p, grad, eps, inv_mass):
    """One leapfrog step for all chains; ``eps`` is (C,)."""
    half = (0.5 * eps)[:, None]
    p_half = p + half * grad
    q_new = q + eps[:, None] * _apply_inv_mass(inv_mass, p_half)
    logp_new, grad_new = value_and_grad(q_new)
    p_new = p_half + half * grad_new
    return q_new, p_new, logp_new, grad_new


def _kinetic(p, inv_mass):
    return 0.5 * (p * _apply_inv_mass(inv_mass, p)).sum(-1)


def _is_uturn(q_minus, q_plus, p_minus, p_plus):
    """The reference's metric-free generalized U-turn criterion
    ``dot(dq, p-) < 0 | dot(dq, p+) < 0`` per chain (see its docstring for
    why ``M^-1`` is not applied)."""
    dq = q_plus - q_minus
    return ((dq * p_minus).sum(-1) < 0) | ((dq * p_plus).sum(-1) < 0)


def _select(pred, a, b):
    """Per-chain select over tuples of tensors: ``pred (C,) ? a : b``."""
    vals = [torch.where(pred.reshape(pred.shape + (1,) * (x.ndim - 1)), x, y)
            for x, y in zip(a, b)]
    return type(a)._make(vals) if hasattr(a, "_make") else tuple(vals)


def _logaddexp(a, b):
    """``jnp.logaddexp``: the same formula on every device, -inf for two
    -inf arguments."""
    amax = torch.maximum(a, b)
    delta = a - b
    return torch.where(torch.isnan(delta), a + b,
                       amax + torch.log1p(torch.exp(-torch.abs(delta))))


def _finite_grad(value_and_grad):
    def logp_and_grad(q):
        val, g = value_and_grad(q)
        # a non-finite gradient at a -inf point must not poison arithmetic
        return val, torch.where(torch.isfinite(g), g, torch.zeros_like(g))
    return logp_and_grad


class _Tree(NamedTuple):
    q_prop: torch.Tensor
    logp_prop: torch.Tensor
    grad_prop: torch.Tensor
    q_left: torch.Tensor
    p_left: torch.Tensor
    grad_left: torch.Tensor
    logp_left: torch.Tensor
    q_right: torch.Tensor
    p_right: torch.Tensor
    grad_right: torch.Tensor
    logp_right: torch.Tensor
    log_weight: torch.Tensor
    sum_accept_prob: torch.Tensor
    n_leapfrog: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor


def draw_transition(generator: torch.Generator, n_chains: int, dim: int,
                    max_depth: int, dtype: torch.dtype,
                    device: torch.device) -> dict[str, torch.Tensor]:
    """The random numbers of one transition for ``n_chains`` chains:
    ``z`` (C, dim) momentum normals, ``direction`` (C, max_depth) bits
    (True = forward), ``u_accept`` (C, max_depth) one subtree acceptance
    uniform per level, and ``u_leaf`` (C, 2^max_depth - 1) one uniform per
    leaf (level d owns columns 2^d - 1 .. 2^(d+1) - 2)."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    return {"z": torch.randn((n_chains, dim), **kw),
            "direction": torch.rand((n_chains, max_depth), **kw) < 0.5,
            "u_accept": torch.rand((n_chains, max_depth), **kw),
            "u_leaf": torch.rand((n_chains, 2**max_depth - 1), **kw)}


@highest_precision()
def nuts_kernel(value_and_grad: ValueAndGrad, q, logp, grad, step_size,
                inv_mass, max_depth: int = 8,
                generator: torch.Generator | None = None,
                draws: dict[str, torch.Tensor] | None = None):
    """One NUTS transition for all chains.  Returns (q', logp', grad',
    info) with ``info`` holding per-chain ``accept_prob``, ``n_leapfrog``,
    ``diverging`` and ``energy``, and ``n_calls``, the value+grad calls
    the transition made (a host int).

    ``q`` (C, dim), ``logp`` (C,), ``grad`` (C, dim); ``step_size`` a
    scalar or (C,); ``inv_mass`` per chain, (C, dim) diagonal or (C, dim,
    dim) dense (a metric shared by the chains is an ``expand``ed view).
    The random numbers are ``draws`` (see :func:`draw_transition`) or are
    drawn from ``generator``.
    """
    n_chains, dim = q.shape
    dtype, device = q.dtype, q.device
    step_size = torch.as_tensor(step_size, dtype=dtype, device=device)
    step_size = step_size.expand(n_chains)
    if draws is None:
        if generator is None:
            raise ValueError("nuts_kernel needs a generator or draws")
        draws = draw_transition(generator, n_chains, dim, max_depth, dtype,
                                device)
    logp_and_grad = _finite_grad(value_and_grad)

    z0 = draws["z"]
    if inv_mass.ndim == 3:
        # dense metric: inv_mass is the covariance Sigma = L L', momenta are
        # N(0, Sigma^-1), so p = L^-T z.  A failed factor is NaN (never
        # finite garbage), so the chain falls back to the metric's diagonal
        # for the whole transition, as the reference does.
        L, info = torch.linalg.cholesky_ex(0.5 * (inv_mass + inv_mass.mT))
        L = torch.where((info != 0)[:, None, None],
                        torch.full_like(L, math.nan), L)
        p_dense = torch.linalg.solve_triangular(
            L.mT, z0.unsqueeze(-1), upper=True).squeeze(-1)
        d = torch.clamp(torch.diagonal(inv_mass, dim1=-2, dim2=-1), min=1e-30)
        p_diag = z0 / torch.sqrt(d)
        ok = torch.isfinite(p_dense).all(-1)
        inv_mass = torch.where(ok[:, None, None], inv_mass, torch.diag_embed(d))
        p0 = torch.where(ok[:, None], p_dense, p_diag)
    else:
        p0 = z0 / torch.sqrt(inv_mass)
    energy0 = -logp + _kinetic(p0, inv_mass)

    zero = q.new_zeros(n_chains)
    false = torch.zeros(n_chains, dtype=torch.bool, device=device)
    state = _Tree(q, logp, grad, q, p0, grad, logp, q, p0, grad, logp,
                  zero, zero, torch.zeros(n_chains, dtype=torch.int32,
                                          device=device), false, false)

    def extend_subtree(state, depth, direction, u_leaf):
        """2^depth leapfrog steps in ``direction`` (C,) for every chain
        still running; progressive multinomial sampling and the U-turn
        checks of every aligned subtree, as the reference's
        ``extend_subtree``."""
        eps = direction * step_size
        forward = direction > 0
        ckpt_q = q.new_zeros((max_depth + 1, n_chains, dim))
        ckpt_p = q.new_zeros((max_depth + 1, n_chains, dim))
        sub_logw = torch.full_like(zero, -math.inf)
        for i in range(2**depth):
            # the reference's cond_body: a chain that turned or diverged
            # (in this subtree or before it) takes no more leaves
            running = ~(state.turning | state.diverging)
            q0, p0_, g0 = _select(forward, (state.q_right, state.p_right,
                                            state.grad_right),
                                  (state.q_left, state.p_left,
                                   state.grad_left))
            # frozen chains are evaluated at their (finite) proposal; their
            # rows are discarded
            q_frozen = state.q_prop
            q1, p1, logp1, g1 = _leapfrog(
                lambda qq: logp_and_grad(torch.where(running[:, None], qq,
                                                     q_frozen)),
                q0, p0_, g0, eps, inv_mass)
            energy1 = -logp1 + _kinetic(p1, inv_mass)
            delta = energy1 - energy0
            delta = torch.where(torch.isnan(delta),
                                torch.full_like(delta, math.inf), delta)
            diverging = delta > _MAX_DELTA_ENERGY
            log_w_leaf = torch.where(diverging,
                                     torch.full_like(delta, -math.inf), -delta)
            accept_prob = torch.clamp(torch.exp(-delta), max=1.0)

            leaf = (q1, p1, g1, logp1)
            right = _select(forward, leaf, (state.q_right, state.p_right,
                                            state.grad_right, state.logp_right))
            left = _select(forward, (state.q_left, state.p_left,
                                     state.grad_left, state.logp_left), leaf)
            new = state._replace(q_left=left[0], p_left=left[1],
                                 grad_left=left[2], logp_left=left[3],
                                 q_right=right[0], p_right=right[1],
                                 grad_right=right[2], logp_right=right[3])

            sub_logw_new = _logaddexp(sub_logw, log_w_leaf)
            accept_leaf = torch.log(u_leaf[:, i]) < (log_w_leaf - sub_logw_new)
            prop = _select(accept_leaf & ~diverging, (q1, logp1, g1),
                           (new.q_prop, new.logp_prop, new.grad_prop))
            new = new._replace(q_prop=prop[0], logp_prop=prop[1],
                               grad_prop=prop[2])

            # leaf i opens every aligned subtree of size 2^m with
            # i % 2^m == 0, and closes those with (i + 1) % 2^m == 0
            for m in range(1, depth + 1):
                if i % 2**m == 0:
                    ckpt_q[m], ckpt_p[m] = q1, p1
            turning_sub = false
            for m in range(1, depth + 1):
                if (i + 1) % 2**m == 0:
                    # orientation matters (see the reference's check_m):
                    # the forward-time order of a backward subtree is
                    # (current leaf) -> (subtree opener)
                    fwd = _is_uturn(ckpt_q[m], q1, ckpt_p[m], p1)
                    bwd = _is_uturn(q1, ckpt_q[m], p1, ckpt_p[m])
                    turning_sub = turning_sub | torch.where(forward, fwd, bwd)

            new = new._replace(
                sum_accept_prob=new.sum_accept_prob + accept_prob,
                n_leapfrog=new.n_leapfrog + 1,
                turning=new.turning | turning_sub,
                diverging=new.diverging | diverging)
            state = _select(running, new, state)
            sub_logw = torch.where(running, sub_logw_new, sub_logw)
        return state, sub_logw

    done = false
    n_calls = 0
    for depth in range(max_depth):
        # one read-back per level: when every chain has turned or diverged
        # the remaining levels are skipped.  The reference evaluates them
        # and discards the results, so skipping changes no result, only
        # the number of value+grad calls.
        if depth and bool(done.all()):
            break
        direction = torch.where(draws["direction"][:, depth],
                                torch.ones_like(zero), -torch.ones_like(zero))
        lo = 2**depth - 1
        old_prop = (state.q_prop, state.logp_prop, state.grad_prop)
        old_logw = state.log_weight
        new, sub_logw = extend_subtree(state, depth, direction,
                                       draws["u_leaf"][:, lo:lo + 2**depth])
        n_calls += 2**depth

        # multinomial acceptance of the new subtree's proposal against the
        # old trajectory's (biased progressive sampling, Betancourt 2017)
        log_ratio = sub_logw - old_logw
        accept_new = ((torch.log(draws["u_accept"][:, depth]) < log_ratio)
                      & ~new.diverging & ~new.turning)
        prop = _select(accept_new, (new.q_prop, new.logp_prop, new.grad_prop),
                       old_prop)
        new = new._replace(q_prop=prop[0], logp_prop=prop[1],
                           grad_prop=prop[2],
                           log_weight=_logaddexp(old_logw, sub_logw))
        # whole-trajectory U-turn check
        turning_full = _is_uturn(new.q_left, new.q_right, new.p_left,
                                 new.p_right)
        new = new._replace(turning=new.turning | turning_full)
        state = _select(done, state, new)
        done = state.turning | state.diverging

    n = torch.clamp(state.n_leapfrog, min=1).to(dtype)
    info = {"accept_prob": state.sum_accept_prob / n,
            "n_leapfrog": state.n_leapfrog,
            "diverging": state.diverging,
            "energy": energy0,
            "n_calls": n_calls}
    return state.q_prop, state.logp_prop, state.grad_prop, info


# ------------------------------------------------------------- adaptation

class WindowedAdaptation(NamedTuple):
    """Dual-averaging step size + Welford (diagonal or dense) metric.  Each
    field is a scalar (pooled) or has a leading chain dimension
    (unpooled)."""

    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor
    welford_mean: torch.Tensor
    welford_m2: torch.Tensor
    welford_n: torch.Tensor
    inv_mass: torch.Tensor


def _adapt_init(eps0, dim, dtype, inv_mass0=None, dense: bool = False,
                device: torch.device | str = "cpu"):
    """One adaptation state (no chain dimension)."""
    kw = dict(dtype=dtype, device=device)
    if inv_mass0 is None:
        inv_mass0 = torch.eye(dim, **kw) if dense else torch.ones((dim,), **kw)
    m2_shape = (dim, dim) if dense else (dim,)
    eps = torch.as_tensor(eps0, **kw)
    return WindowedAdaptation(
        log_eps=torch.log(eps),
        log_eps_bar=torch.zeros((), **kw),
        h_bar=torch.zeros((), **kw),
        mu=torch.log(10.0 * eps),
        count=torch.zeros((), dtype=torch.int32, device=device),
        welford_mean=torch.zeros((dim,), **kw),
        welford_m2=torch.zeros(m2_shape, **kw),
        welford_n=torch.zeros((), dtype=torch.int32, device=device),
        inv_mass=torch.as_tensor(inv_mass0, **kw),
    )


def _per_chain(adapt: WindowedAdaptation, n_chains: int, inv_mass0=None):
    """The unpooled state: every field with a leading chain dimension
    (``vmap`` of ``_adapt_init``), ``inv_mass0`` (C, ...) per chain."""
    fields = [x.expand((n_chains,) + x.shape).clone() for x in adapt]
    out = WindowedAdaptation(*fields)
    if inv_mass0 is not None:
        out = out._replace(inv_mass=inv_mass0.to(out.inv_mass).clone())
    return out


def _hessian_diag_inv_mass(value_and_grad: ValueAndGrad, q):
    """Diagonal-curvature metric for every chain: inv_mass_i =
    1 / |d2(-logp)/dq_i2| from central differences of the gradient (the
    reference's fallback branch, which it takes on the stationary filter),
    all chains' 2 x dim shifted draws in ONE batched call.  Coordinates
    with non-positive or non-finite curvature fall back to unit; the result
    is clipped to [1e-6, 10].  ``q`` is (C, dim); returns (C, dim)."""
    n_chains, dim = q.shape
    h = float(torch.finfo(q.dtype).eps) ** (1.0 / 3.0)
    shift = h * torch.eye(dim, dtype=q.dtype, device=q.device)
    U = torch.cat([q[:, None, :] + shift, q[:, None, :] - shift], dim=1)
    _, g = _finite_grad(value_and_grad)(U.reshape(-1, dim))
    g = g.reshape(n_chains, 2, dim, dim)
    diag = torch.diagonal(g[:, 0] - g[:, 1], dim1=-2, dim2=-1)
    neg_curv = -(diag / (2.0 * h))
    good = torch.isfinite(neg_curv) & (neg_curv > 1e-12)
    inv_mass = torch.where(good, 1.0 / torch.where(good, neg_curv,
                                                   torch.ones_like(neg_curv)),
                           torch.ones_like(neg_curv))
    return torch.clamp(inv_mass, 1e-6, 10.0)


def _dual_averaging_update(adapt, accept_prob, target=0.8, gamma=0.05,
                           t0=10.0, kappa=0.75):
    count = adapt.count + 1
    t = count.to(adapt.log_eps.dtype)
    eta_h = 1.0 / (t + t0)
    h_bar = (1 - eta_h) * adapt.h_bar + eta_h * (target - accept_prob)
    log_eps = adapt.mu - torch.sqrt(t) / gamma * h_bar
    eta = t ** (-kappa)
    log_eps_bar = eta * log_eps + (1 - eta) * adapt.log_eps_bar
    return adapt._replace(log_eps=log_eps, log_eps_bar=log_eps_bar,
                          h_bar=h_bar, count=count)


def _dense(adapt) -> bool:
    return adapt.welford_m2.ndim == adapt.welford_mean.ndim + 1


def _outer(a, b):
    return a.unsqueeze(-1) * b.unsqueeze(-2)


def _welford_update(adapt, q):
    """One draw per chain into each chain's running estimate (unpooled)."""
    n = adapt.welford_n + 1
    delta = q - adapt.welford_mean
    mean = adapt.welford_mean + delta / n.unsqueeze(-1)
    if _dense(adapt):
        m2 = adapt.welford_m2 + _outer(delta, q - mean)
    else:
        m2 = adapt.welford_m2 + delta * (q - mean)
    return adapt._replace(welford_mean=mean, welford_m2=m2, welford_n=n)


def _welford_update_batch(adapt, qs):
    """Chan et al.'s merge of one step's cross-chain batch ``qs`` (C, dim)
    into the pooled running estimate."""
    dtype = adapt.welford_m2.dtype
    dense = _dense(adapt)
    c = torch.as_tensor(qs.shape[0], dtype=dtype, device=qs.device)
    s1 = torch.sum(qs, dim=0)
    s2 = qs.T @ qs if dense else torch.sum(qs * qs, dim=0)
    b_mean = s1 / c
    b_m2 = s2 - (_outer(s1, s1) if dense else s1 * s1) / c
    n_old = adapt.welford_n.to(dtype)
    n_new = n_old + c
    delta = b_mean - adapt.welford_mean
    mean = adapt.welford_mean + delta * (c / n_new)
    dd = _outer(delta, delta) if dense else delta * delta
    m2 = adapt.welford_m2 + b_m2 + dd * (n_old * c / n_new)
    return adapt._replace(welford_mean=mean, welford_m2=m2,
                          welford_n=adapt.welford_n + qs.shape[0])


def _welford_finalize(adapt, prev_anchor: bool = False):
    """End of a slow window: the regularised variance becomes the metric.
    Keeps the reference's guards: the previous metric as the anchor for
    curvature-seeded runs (``prev_anchor``); for a dense metric,
    symmetrisation, the anchor in place of a non-finite estimate and a
    relative ridge (1e-6 in float32, 1e-12 in float64) so that the metric
    stays positive definite.  Works per chain (unpooled) or pooled."""
    dense = _dense(adapt)
    extra = (None, None) if dense else (None,)
    n = torch.clamp(adapt.welford_n, min=2).to(adapt.welford_m2.dtype)
    n = n[(...,) + extra]
    var = adapt.welford_m2 / (n - 1)
    dim = var.shape[-1]
    eye = torch.eye(dim, dtype=var.dtype, device=var.device)
    if prev_anchor:
        anchor = adapt.inv_mass
    elif dense:
        anchor = 1e-3 * eye
    else:
        anchor = 1e-3
    var = (n / (n + 5.0)) * var + (5.0 / (n + 5.0)) * anchor
    if dense:
        var = 0.5 * (var + var.mT)
        anchor_mat = anchor if prev_anchor else 1e-3 * eye
        finite = torch.isfinite(var).flatten(-2).all(-1)
        var = torch.where(finite[..., None, None], var,
                          anchor_mat.expand_as(var))
        eps_rel = 1e-6 if var.dtype == torch.float32 else 1e-12
        trace = torch.diagonal(var, dim1=-2, dim2=-1).sum(-1)
        ridge = eps_rel * (trace / dim + 1e-30)
        var = var + ridge[..., None, None] * eye
    return adapt._replace(
        inv_mass=var,
        welford_mean=torch.zeros_like(adapt.welford_mean),
        welford_m2=torch.zeros_like(adapt.welford_m2),
        welford_n=torch.zeros_like(adapt.welford_n),
    )


def _restart_dual_averaging(adapt):
    """After a window: dual averaging restarts around the current step."""
    return adapt._replace(mu=math.log(10.0) + adapt.log_eps,
                          h_bar=torch.zeros_like(adapt.h_bar),
                          count=torch.zeros_like(adapt.count))


def _window_schedule(num_warmup: int):
    """Stan's three-phase schedule: fast, doubling slow windows, fast."""
    if num_warmup < 20:
        return np.zeros(num_warmup, dtype=bool), np.zeros(num_warmup, dtype=bool)
    init_fast = int(0.15 * num_warmup)
    term_fast = int(0.1 * num_warmup)
    slow_len = num_warmup - init_fast - term_fast
    in_slow = np.zeros(num_warmup, dtype=bool)
    in_slow[init_fast:init_fast + slow_len] = True
    window_end = np.zeros(num_warmup, dtype=bool)
    # doubling windows inside the slow phase: 25, 50, 100, ... (last absorbs)
    start = init_fast
    w = max(25, slow_len // 15)
    while start < init_fast + slow_len:
        end = min(start + w, init_fast + slow_len)
        if init_fast + slow_len - end < w * 2:
            end = init_fast + slow_len
        window_end[end - 1] = True
        start = end
        w *= 2
    return in_slow, window_end


# --------------------------------------------------------------- sampling

class NUTSResult(NamedTuple):
    samples: torch.Tensor          # (chains, draws, dim) unconstrained
    logp: torch.Tensor             # (chains, draws)
    accept_prob: torch.Tensor      # (chains, draws)
    diverging: torch.Tensor        # (chains, draws)
    n_leapfrog: torch.Tensor       # (chains, draws)
    step_size: torch.Tensor        # (chains,)
    inv_mass: torch.Tensor         # (chains, dim) or (chains, dim, dim) dense
    n_calls: np.ndarray | None = None  # value+grad calls per transition,
                                       # warmup then sampling
    seconds: dict | None = None        # host clock: "hessian", "warmup",
                                       # "sampling"


def sample_nuts(
    value_and_grad: ValueAndGrad,
    initial_position: torch.Tensor,     # (chains, dim)
    generator: torch.Generator,
    num_warmup: int = 500,
    num_samples: int = 500,
    max_depth: int = 8,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
    pooled: bool = False,
    mass_init: str = "unit",
    mass_matrix: str = "diag",
    segment_size: int | None = None,
    mesh=None,
) -> NUTSResult:
    """Run NUTS chains batched along the first dimension of
    ``initial_position``, on its device and in its dtype.

    ``value_and_grad(U (C, dim)) -> (logp (C,), grad (C, dim))`` is called
    once per leapfrog step for all chains.  ``generator`` (on the chains'
    device) draws every random number.  Warmup adapts the step size (dual
    averaging toward ``target_accept``) and the metric (Stan's windows)
    per chain, or, with ``pooled=True``, one step size from the chains'
    mean acceptance and one metric from the cross-chain Welford estimate.
    ``mass_init="hessian"`` seeds the diagonal metric from the curvature at
    each chain's start (averaged over the chains when pooled);
    ``mass_matrix="dense"`` adapts a full covariance metric.

    ``segment_size`` is accepted and changes nothing: every transition
    already returns to the host (the reference uses it to bound the length
    of one device program).  ``mesh`` splits the chains of every
    value+grad call over its devices (``value_and_grad`` may then be a
    mapping from each distinct device to its function,
    :func:`~geconpy_torch.parallel.functions_per_device`); the number of
    chains must divide by the mesh size.
    """
    if mesh is not None:
        from ..parallel.mesh import pvmap

        if initial_position.shape[0] % mesh.size:
            raise ValueError(
                f"num_chains={initial_position.shape[0]} must be divisible "
                f"by the mesh size {mesh.size}")
        value_and_grad = pvmap(value_and_grad, mesh, mesh.axis_name)
    if mass_init not in ("unit", "hessian"):
        raise ValueError(f"mass_init must be 'unit' or 'hessian', "
                         f"got {mass_init!r}")
    if mass_matrix not in ("diag", "dense"):
        raise ValueError(f"mass_matrix must be 'diag' or 'dense', "
                         f"got {mass_matrix!r}")
    del segment_size
    dense = mass_matrix == "dense"
    q = initial_position
    n_chains, dim = q.shape
    dtype, device = q.dtype, q.device
    vag = _finite_grad(value_and_grad)
    in_slow, window_end = _window_schedule(num_warmup)
    prev_anchor = mass_init == "hessian"

    clock = {"start": time.perf_counter()}
    inv_mass0 = (_hessian_diag_inv_mass(vag, q) if mass_init == "hessian"
                 else None)
    clock["hessian"] = time.perf_counter()
    adapt = _adapt_init(initial_step_size, dim, dtype, dense=dense,
                        device=device)
    if pooled:
        if inv_mass0 is not None:
            inv_mass0 = torch.mean(inv_mass0, dim=0)   # per-chain diag seeds
            adapt = adapt._replace(inv_mass=torch.diag(inv_mass0) if dense
                                   else inv_mass0)
    else:
        if inv_mass0 is not None and dense:
            inv_mass0 = torch.diag_embed(inv_mass0)
        adapt = _per_chain(adapt, n_chains, inv_mass0)

    logp, grad = vag(q)
    n_calls = []

    def transition(q, logp, grad, eps, inv_mass):
        if pooled:
            inv_mass = inv_mass.expand((n_chains,) + inv_mass.shape)
        q, logp, grad, info = nuts_kernel(vag, q, logp, grad, eps, inv_mass,
                                          max_depth, generator=generator)
        n_calls.append(info["n_calls"])
        return q, logp, grad, info

    for step in range(num_warmup):
        q, logp, grad, info = transition(q, logp, grad,
                                         torch.exp(adapt.log_eps),
                                         adapt.inv_mass)
        if pooled:
            adapt = _dual_averaging_update(adapt, torch.mean(info["accept_prob"]),
                                           target=target_accept)
            if in_slow[step]:
                adapt = _welford_update_batch(adapt, q)
        else:
            adapt = _dual_averaging_update(adapt, info["accept_prob"],
                                           target=target_accept)
            if in_slow[step]:
                adapt = _welford_update(adapt, q)
        if window_end[step]:
            adapt = _restart_dual_averaging(
                _welford_finalize(adapt, prev_anchor=prev_anchor))

    eps_final = torch.exp(adapt.log_eps_bar)
    inv_mass = adapt.inv_mass
    clock["warmup"] = time.perf_counter()
    qs = q.new_empty((num_samples, n_chains, dim))
    logps = q.new_empty((num_samples, n_chains))
    accepts = q.new_empty((num_samples, n_chains))
    divs = torch.empty((num_samples, n_chains), dtype=torch.bool, device=device)
    n_leaps = torch.empty((num_samples, n_chains), dtype=torch.int32,
                          device=device)
    for s in range(num_samples):
        q, logp, grad, info = transition(q, logp, grad, eps_final, inv_mass)
        qs[s], logps[s], accepts[s] = q, logp, info["accept_prob"]
        divs[s], n_leaps[s] = info["diverging"], info["n_leapfrog"]

    if pooled:
        eps_final = eps_final.expand(n_chains)
        inv_mass = inv_mass.expand((n_chains,) + inv_mass.shape)
    # every transition has read its chains back, so the host clock has
    # waited for the device
    divs.any().item()
    clock["sampling"] = time.perf_counter()
    seconds = {k: clock[k] - clock[prev] for prev, k in
               (("start", "hessian"), ("hessian", "warmup"),
                ("warmup", "sampling"))}
    return NUTSResult(qs.transpose(0, 1), logps.T, accepts.T, divs.T,
                      n_leaps.T, eps_final, inv_mass,
                      np.asarray(n_calls, dtype=np.int64), seconds)
