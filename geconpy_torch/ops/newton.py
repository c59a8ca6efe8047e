"""Batched root finders for the numeric steady state.

Mirrors ``geconpy_tpu/ops/newton.py``: ``RootResult`` (:26), ``_inf_norm``
(:34), ``newton_solve`` (:39-119, with the nonmonotone ``memory > 1``
variant), ``chord_solve`` (:122-197), ``gauss_newton_cg_solve``
(:200-303), ``levenberg_marquardt_solve`` (:306-360), ``dogleg_solve``
(:363-459), ``newton_krylov_solve`` (:462-544, on the batched GMRES of
:mod:`.gmres`) and ``root`` (:547-582).

Every solver works over a leading batch dimension: ``f(x (B, m), *args)
-> (B, m)``, each tensor of ``args`` with the same leading ``B`` (nested
tuples allowed), and ``f`` must also accept one draw's shapes, since the
Jacobian is ``torch.func.vmap(torch.func.jacfwd(f))``.  The reference maps
its ``lax.while_loop`` over draws with ``vmap``; here each draw keeps a
``done`` mask and is frozen with ``torch.where`` once it converges, gets
stuck or reaches ``maxiter``, so every draw takes exactly the iterations
it takes alone.  The outer loop reads ``done.all()`` back to the host once
an iteration; the fixed-length inner loops (Newton's Armijo backtracks,
chord's halvings, Steihaug's CG steps) read nothing.  Newton's and chord's
trial points are evaluated in one call of ``f`` on ``(B * k, m)``: the
same selection and ``n_feval`` as the reference's ``lax.scan``, in far
fewer launches.  Singular systems are solved with ``solve_ex`` /
``lu_factor_ex`` and give NaN in their own draw, never an exception, so the
reference's fallbacks (Newton's steepest descent, dogleg's ``-g``) fire as
they do in JAX.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .gmres import gmres
from .precision import highest_precision

__all__ = ["RootResult", "newton_solve", "levenberg_marquardt_solve",
           "dogleg_solve", "chord_solve", "gauss_newton_cg_solve",
           "newton_krylov_solve", "root", "batched_jacobian"]


class RootResult(NamedTuple):
    x: torch.Tensor           # (B, m)
    success: torch.Tensor     # (B,) bool
    norm: torch.Tensor        # (B,) final residual inf-norm
    n_iter: torch.Tensor      # (B,) int64 iterations used
    n_feval: torch.Tensor     # (B,) int64


def _inf_norm(r: torch.Tensor) -> torch.Tensor:
    return torch.amax(r.abs(), dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1)


def _tol(tol: float, x0: torch.Tensor) -> float:
    return max(tol, 100 * float(torch.finfo(x0.dtype).eps))


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree)


def _in_dims(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_in_dims(t) for t in tree)
    return 0 if isinstance(tree, torch.Tensor) else None


def batched_jacobian(f: Callable, x: torch.Tensor, args: tuple = ()
                     ) -> torch.Tensor:
    """∂f/∂x per draw, (B, m_out, m): ``vmap(jacfwd(f))`` over the batch."""
    return torch.func.vmap(torch.func.jacfwd(f),
                           in_dims=(0, *_in_dims(args)))(x, *args)


def _repeat(args, k: int):
    """Each draw's arguments ``k`` times in a row: (B, ...) -> (B * k, ...)."""
    return _tree_map(lambda a: a.repeat_interleave(k, dim=0)
                     if isinstance(a, torch.Tensor) else a, args)


def _solve_nan(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A⁻¹ b per draw by pivoted LU; NaN in a draw whose A is singular
    (where ``jnp.linalg.solve`` returns non-finite values)."""
    X, info = torch.linalg.solve_ex(A, b[..., None])
    return torch.where((info == 0)[..., None], X[..., 0],
                       torch.full_like(b, torch.nan))


def _trials(f, x, dx, args, alphas):
    """f at x + alpha·dx for every alpha, in one call: (B, k, m) points and
    residuals."""
    B, m = x.shape
    k = alphas.shape[0]
    x_try = x[:, None, :] + alphas[None, :, None] * dx[:, None, :]
    r_try = f(x_try.reshape(B * k, m), *_repeat(args, k)).reshape(B, k, -1)
    return x_try, r_try


def _first(ok: torch.Tensor):
    """(index of the first True along the last dim, any True)."""
    k = ok.shape[-1]
    idx = torch.arange(k, device=ok.device).expand(ok.shape)
    first = torch.where(ok, idx, torch.full_like(idx, k)).amin(dim=-1)
    return first.clamp(max=k - 1), first < k


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """a[b, i[b]] for a (B, k, ...)."""
    index = i.reshape(-1, *([1] * (a.dim() - 1))).expand(
        a.shape[0], 1, *a.shape[2:])
    return torch.take_along_dim(a, index, dim=1)[:, 0]


def _where(mask, new, old):
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)),
                       new, old)


def _finish(x, r, it, nfev, tol) -> RootResult:
    norm = _inf_norm(r)
    success = torch.isfinite(norm) & (norm < tol)
    return RootResult(x, success, norm, it, nfev)


@highest_precision()
def newton_solve(f: Callable, x0: torch.Tensor, args: tuple = (),
                 tol: float = 1e-8, maxiter: int = 100,
                 max_backtracks: int = 12, armijo_c: float = 1e-4,
                 memory: int = 1) -> RootResult:
    """Damped Newton with (non)monotone Armijo backtracking, batched.

    ``memory > 1`` accepts a step against the max of the last ``memory``
    merit values (Grippo-Lampariello-Lucidi), as the reference's
    ``newton_nm``.  With ``memory == 1`` the reference never updates its
    history, so every step is tested against the start's merit, not the
    current one; the port keeps that rule.  A step whose 12 halvings all
    fail marks the draw stuck.
    """
    tol = _tol(tol, x0)
    memory = max(1, int(memory))
    B = x0.shape[0]
    dev = x0.device
    alphas = 0.5 ** torch.arange(max_backtracks, dtype=x0.dtype, device=dev)
    x = x0
    r = f(x0, *args)
    hist = (0.5 * _dot(r, r))[:, None].expand(B, memory).clone()
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    nfev = torch.ones(B, dtype=torch.int64, device=dev)
    done = _inf_norm(r) < tol
    for _ in range(maxiter):
        if bool(done.all()):
            break
        J = batched_jacobian(f, x, args)
        dx = _solve_nan(J, -r)
        # steepest descent where the Newton direction is not finite
        bad_dir = ~torch.isfinite(dx).all(dim=-1)
        grad = _mv(J.mT, r)
        dx = _where(bad_dir, -grad, dx)
        m0 = 0.5 * _dot(r, r)
        m_ref = hist.amax(dim=-1)
        slope = _dot(grad, dx)
        x_try, r_try = _trials(f, x, dx, args, alphas)
        m_try = 0.5 * _dot(r_try, r_try)
        ok = torch.isfinite(r_try).all(dim=-1) & (
            m_try <= m_ref[:, None] + armijo_c * alphas * slope[:, None])
        first, accepted = _first(ok)
        x_new = _where(accepted, _take(x_try, first), x)
        r_new = _where(accepted, _take(r_try, first), r)
        m_new = torch.where(accepted, _take(m_try[..., None], first)[:, 0], m0)
        nf = torch.where(accepted, first + 1,
                         torch.full_like(first, max_backtracks))
        live = ~done
        if memory > 1:
            hist = _where(live, torch.cat([hist[:, 1:], m_new[:, None]], -1),
                          hist)
        x = _where(live, x_new, x)
        r = _where(live, r_new, r)
        it = it + live.to(it.dtype)
        nfev = nfev + torch.where(live, nf + 1, torch.zeros_like(nf))
        done = done | (live & (~accepted | (_inf_norm(r_new) < tol)))
    return _finish(x, r, it, nfev, tol)


@highest_precision()
def chord_solve(f: Callable, x0: torch.Tensor, args: tuple = (),
                tol: float = 1e-8, maxiter: int = 200,
                refactor_ratio: float = 0.5) -> RootResult:
    """Chord (frozen-Jacobian) iteration with the reference's refactor
    trigger: the LU factors are reused until a step's merit contraction is
    worse than ``refactor_ratio``.  The refactor's Jacobian is taken only in
    an iteration where some draw refactors (one more host read then)."""
    tol = _tol(tol, x0)
    B = x0.shape[0]
    dev = x0.device
    halvings = 16
    alphas = 0.5 ** torch.arange(halvings, dtype=x0.dtype, device=dev)

    def factor(x):
        LU, piv, info = torch.linalg.lu_factor_ex(batched_jacobian(f, x, args))
        return LU, piv, info != 0

    x = x0
    r = f(x0, *args)
    LU, piv, sing = factor(x0)
    fresh = torch.ones(B, dtype=torch.bool, device=dev)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    njac = torch.ones(B, dtype=torch.int64, device=dev)
    done = _inf_norm(r) < tol
    for _ in range(maxiter):
        if bool(done.all()):
            break
        dx = torch.linalg.lu_solve(LU, piv, -r[..., None])[..., 0]
        dx = _where(sing, torch.full_like(dx, torch.nan), dx)
        m0 = _dot(r, r)
        x_t, r_t = _trials(f, x, dx, args, alphas)
        m_t = _dot(r_t, r_t)
        ok = torch.isfinite(r_t).all(dim=-1) & (m_t < m0[:, None])
        first, improved = _first(ok)
        x_try = _where(improved, _take(x_t, first), x)
        r_try = _where(improved, _take(r_t, first), r)
        m_try = torch.where(improved, _take(m_t[..., None], first)[:, 0], m0)
        live = ~done
        refactor = live & (~improved | (m_try > refactor_ratio * m0))
        if bool(refactor.any()):
            LU_n, piv_n, sing_n = factor(x_try)
            LU = _where(refactor, LU_n, LU)
            piv = _where(refactor, piv_n, piv)
            sing = _where(refactor, sing_n, sing)
        stuck = ~improved & fresh
        x = _where(live, x_try, x)
        r = _where(live, r_try, r)
        fresh = _where(live, refactor, fresh)
        it = it + live.to(it.dtype)
        njac = njac + refactor.to(njac.dtype)
        done = done | (live & ((_inf_norm(r_try) < tol) | stuck))
    return _finish(x, r, it, it + njac, tol)


def _steihaug(J, g, radius, cg_iters: int):
    """CG on JᵀJ p = -g per draw, truncated at the trust-region boundary;
    ``cg_iters`` steps, a finished draw frozen."""

    def to_boundary(p, d):
        a = _dot(d, d)
        b = 2.0 * _dot(p, d)
        c = _dot(p, p) - radius ** 2
        disc = torch.clamp(b * b - 4 * a * c, min=0.0)
        tau = (-b + torch.sqrt(disc)) / torch.clamp(2 * a, min=1e-300)
        return p + tau[:, None] * d

    p = torch.zeros_like(g)
    rr, d = -g, -g
    done = torch.zeros(g.shape[0], dtype=torch.bool, device=g.device)
    for _ in range(cg_iters):
        Hd = _mv(J.mT, _mv(J, d))
        dHd = _dot(d, Hd)
        alpha = _dot(rr, rr) / torch.clamp(dHd, min=1e-300)
        p_next = p + alpha[:, None] * d
        hit = _norm(p_next) >= radius
        neg_curv = dHd <= 0.0
        stop = done | neg_curv | hit
        p = _where(done, p, _where(neg_curv | hit, to_boundary(p, d), p_next))
        rr_new = _where(stop, rr, rr - alpha[:, None] * Hd)
        beta = _dot(rr_new, rr_new) / torch.clamp(_dot(rr, rr), min=1e-300)
        d = _where(stop, d, rr_new + beta[:, None] * d)
        rr = rr_new
        done = stop | (_norm(rr_new) < 1e-10)
    return p


def _trust_update(f, x, r, J, step, radius, args, max_radius):
    """The trust-region acceptance and radius rule shared by Gauss-Newton
    and dogleg: (x_new, r_new, radius_new)."""
    r_try = f(x + step, *args)
    finite = torch.isfinite(r_try).all(dim=-1)
    rr = _dot(r, r)
    actual = 0.5 * (rr - _dot(r_try, r_try))
    pred_vec = r + _mv(J, step)
    predicted = 0.5 * (rr - _dot(pred_vec, pred_vec))
    rho = actual / torch.clamp(predicted, min=1e-300)
    accept = finite & (rho > 0.05)
    x_new = _where(accept, x + step, x)
    r_new = _where(accept, r_try, r)
    step_norm = _norm(step)
    grow = (rho > 0.75) & (step_norm >= 0.8 * radius) & finite
    shrink = ~finite | (rho < 0.25)
    radius_new = torch.where(
        grow, torch.clamp(2.0 * radius, max=max_radius),
        torch.where(shrink, 0.25 * step_norm + 1e-14, radius))
    return x_new, r_new, torch.clamp(radius_new, min=1e-12)


def _trust_region(f, x0, args, tol, maxiter, trust_radius0, max_radius,
                  step_fn) -> RootResult:
    tol = _tol(tol, x0)
    B = x0.shape[0]
    x = x0
    r = f(x0, *args)
    radius = torch.full((B,), trust_radius0, dtype=x0.dtype, device=x0.device)
    it = torch.zeros(B, dtype=torch.int64, device=x0.device)
    done = _inf_norm(r) < tol
    for _ in range(maxiter):
        if bool(done.all()):
            break
        J = batched_jacobian(f, x, args)
        step = step_fn(J, r, radius)
        x_new, r_new, radius_new = _trust_update(f, x, r, J, step, radius,
                                                 args, max_radius)
        live = ~done
        x = _where(live, x_new, x)
        r = _where(live, r_new, r)
        radius = torch.where(live, radius_new, radius)
        it = it + live.to(it.dtype)
        done = done | (live & ((_inf_norm(r_new) < tol)
                               | (radius_new <= 1e-11)))
    return _finish(x, r, it, it, tol)


@highest_precision()
def gauss_newton_cg_solve(f: Callable, x0: torch.Tensor, args: tuple = (),
                          tol: float = 1e-8, maxiter: int = 200,
                          cg_iters: int | None = None,
                          trust_radius0: float = 1.0,
                          max_radius: float = 100.0) -> RootResult:
    """Trust-region Gauss-Newton with a fixed-length Steihaug-CG inner
    solve on JᵀJ (``cg_iters`` steps, default m)."""
    cg = x0.shape[-1] if cg_iters is None else cg_iters

    def step_fn(J, r, radius):
        return _steihaug(J, _mv(J.mT, r), radius, cg)

    return _trust_region(f, x0, args, tol, maxiter, trust_radius0,
                         max_radius, step_fn)


@highest_precision()
def levenberg_marquardt_solve(f: Callable, x0: torch.Tensor,
                              args: tuple = (), tol: float = 1e-8,
                              maxiter: int = 200, mu0: float = 1e-3,
                              mu_inc: float = 10.0, mu_dec: float = 0.2,
                              mu_max: float = 1e12) -> RootResult:
    """Levenberg-Marquardt: ``(JᵀJ + mu·diag(JᵀJ)) dx = -Jᵀr`` with
    multiplicative damping, batched."""
    tol = _tol(tol, x0)
    B = x0.shape[0]
    x = x0
    r = f(x0, *args)
    mu = torch.full((B,), mu0, dtype=x0.dtype, device=x0.device)
    it = torch.zeros(B, dtype=torch.int64, device=x0.device)
    done = _inf_norm(r) < tol
    for _ in range(maxiter):
        if bool(done.all()):
            break
        J = batched_jacobian(f, x, args)
        JtJ = J.mT @ J
        g = _mv(J.mT, r)
        d = torch.diag_embed(torch.clamp(torch.diagonal(JtJ, dim1=-2, dim2=-1),
                                         min=1e-12))
        dx = _solve_nan(JtJ + mu[:, None, None] * d, -g)
        x_try = x + dx
        r_try = f(x_try, *args)
        improved = torch.isfinite(r_try).all(dim=-1) & (
            _dot(r_try, r_try) < _dot(r, r))
        live = ~done
        stuck = ~improved & (mu >= mu_max)
        mu_new = torch.where(improved, torch.clamp(mu * mu_dec, min=1e-16),
                             torch.clamp(mu * mu_inc, max=mu_max))
        x = _where(live & improved, x_try, x)
        r = _where(live & improved, r_try, r)
        mu = torch.where(live, mu_new, mu)
        it = it + live.to(it.dtype)
        done = done | (live & ((_inf_norm(r) < tol) | stuck))
    return _finish(x, r, it, it, tol)


@highest_precision()
def dogleg_solve(f: Callable, x0: torch.Tensor, args: tuple = (),
                 tol: float = 1e-8, maxiter: int = 200,
                 trust_radius0: float = 1.0,
                 max_radius: float = 100.0) -> RootResult:
    """Powell dogleg trust region on the Gauss-Newton model; the reference's
    ``lax.cond`` path selection becomes ``torch.where`` over the three
    candidate steps."""

    def step_fn(J, r, radius):
        g = _mv(J.mT, r)
        gn = _solve_nan(J, -r)
        gn = _where(~torch.isfinite(gn).all(dim=-1), -g, gn)
        gn_norm = _norm(gn)
        Jg = _mv(J, g)
        t_c = _dot(g, g) / torch.clamp(_dot(Jg, Jg), min=1e-300)
        cauchy = -t_c[:, None] * g
        c_norm = _norm(cauchy)
        clip = cauchy * (radius / torch.clamp(c_norm, min=1e-300))[:, None]
        d = gn - cauchy
        a = _dot(d, d)
        b = 2.0 * _dot(cauchy, d)
        c = _dot(cauchy, cauchy) - radius ** 2
        disc = torch.clamp(b * b - 4 * a * c, min=0.0)
        tau = (-b + torch.sqrt(disc)) / torch.clamp(2 * a, min=1e-300)
        seg = cauchy + tau[:, None] * d
        return _where(gn_norm <= radius, gn,
                      _where(c_norm >= radius, clip, seg))

    return _trust_region(f, x0, args, tol, maxiter, trust_radius0,
                         max_radius, step_fn)


@highest_precision()
def newton_krylov_solve(f: Callable, x0: torch.Tensor, args: tuple = (),
                        tol: float = 1e-8, maxiter: int = 100,
                        max_backtracks: int = 12, armijo_c: float = 1e-4,
                        gmres_tol: float = 1e-4, gmres_restart: int = 30,
                        gmres_maxiter: int = 4) -> RootResult:
    """Matrix-free inexact Newton-Krylov with Armijo backtracking, batched.

    The Newton direction solves ``J dx = -r`` by GMRES (:func:`.gmres.
    gmres`, JAX's batched method, each draw its own Krylov basis) whose
    matvec is one ``torch.func.jvp`` of the residual: the Jacobian is never
    materialized.  ``gmres_tol`` is the inexact-Newton forcing term.  A
    non-finite direction falls back to steepest descent (Jᵀr by one
    ``torch.func.vjp``).  The 12 trial steps are evaluated in one call and
    the first that meets Armijo is taken; as in the reference's scan, every
    iteration counts all of them in ``n_feval`` (1 + 13 an iteration), and
    a draw whose trials all fail stops.
    """
    tol = _tol(tol, x0)
    B = x0.shape[0]
    dev = x0.device
    alphas = 0.5 ** torch.arange(max_backtracks, dtype=x0.dtype, device=dev)
    x = x0
    r = f(x0, *args)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    nfev = torch.ones(B, dtype=torch.int64, device=dev)
    done = _inf_norm(r) < tol
    for _ in range(maxiter):
        if bool(done.all()):
            break

        def fx(xx):
            return f(xx, *args)

        def matvec(v):
            return torch.func.jvp(fx, (x,), (v,))[1]

        dx = gmres(matvec, -r, tol=gmres_tol, atol=0.0,
                   restart=min(gmres_restart, x.shape[-1]),
                   maxiter=gmres_maxiter)
        _, vjp_fn = torch.func.vjp(fx, x)
        (grad,) = vjp_fn(r)
        bad_dir = ~torch.isfinite(dx).all(dim=-1)
        dx = _where(bad_dir, -grad, dx)
        m0 = 0.5 * _dot(r, r)
        slope = _dot(grad, dx)
        x_try, r_try = _trials(f, x, dx, args, alphas)
        m_try = 0.5 * _dot(r_try, r_try)
        ok = torch.isfinite(r_try).all(dim=-1) & (
            m_try <= m0[:, None] + armijo_c * alphas * slope[:, None])
        first, accepted = _first(ok)
        x_new = _where(accepted, _take(x_try, first), x)
        r_new = _where(accepted, _take(r_try, first), r)
        live = ~done
        x = _where(live, x_new, x)
        r = _where(live, r_new, r)
        it = it + live.to(it.dtype)
        nfev = nfev + live.to(nfev.dtype) * (max_backtracks + 1)
        done = done | (live & (~accepted | (_inf_norm(r_new) < tol)))
    return _finish(x, r, it, nfev, tol)


def _pick_hybrid(res_n: RootResult, res_lm: RootResult) -> RootResult:
    """Newton's answer where it succeeded, LM's elsewhere (the reference's
    ``"hybrid"`` combination)."""
    pick = res_n.success
    return RootResult(_where(pick, res_n.x, res_lm.x),
                      pick | res_lm.success,
                      torch.where(pick, res_n.norm, res_lm.norm),
                      torch.where(pick, res_n.n_iter, res_lm.n_iter),
                      res_n.n_feval + res_lm.n_feval)


def root(f: Callable, x0: torch.Tensor, args: tuple = (),
         method: str = "newton", tol: float = 1e-8,
         maxiter: int = 100) -> RootResult:
    """Dispatching root finder; ``method`` in ``"newton"``, ``"newton_nm"``,
    ``"chord"``, ``"lm"``, ``"dogleg"``, ``"gauss_newton"``,
    ``"newton_krylov"``, ``"hybrid"``.

    ``"hybrid"`` runs Newton and Levenberg-Marquardt (``2 * maxiter``) from
    the same start on every draw and keeps LM's answer where Newton failed,
    as the reference does (its ``n_feval`` is the sum of both).  The steady
    state's ``"hybrid"`` runs LM on the failed draws only.
    """
    if method == "newton":
        return newton_solve(f, x0, args, tol=tol, maxiter=maxiter)
    if method == "newton_nm":
        return newton_solve(f, x0, args, tol=tol, maxiter=maxiter, memory=5)
    if method == "chord":
        return chord_solve(f, x0, args, tol=tol, maxiter=maxiter)
    if method == "lm":
        return levenberg_marquardt_solve(f, x0, args, tol=tol,
                                         maxiter=maxiter)
    if method == "dogleg":
        return dogleg_solve(f, x0, args, tol=tol, maxiter=maxiter)
    if method == "gauss_newton":
        return gauss_newton_cg_solve(f, x0, args, tol=tol, maxiter=maxiter)
    if method == "hybrid":
        return _pick_hybrid(
            newton_solve(f, x0, args, tol=tol, maxiter=maxiter),
            levenberg_marquardt_solve(f, x0, args, tol=tol,
                                      maxiter=2 * maxiter))
    if method == "newton_krylov":
        return newton_krylov_solve(f, x0, args, tol=tol, maxiter=maxiter)
    raise ValueError(f"unknown method {method!r}")
