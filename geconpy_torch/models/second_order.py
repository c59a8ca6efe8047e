"""Second-order perturbation, batched over draws, and the pruned system.

Mirrors ``geconpy_tpu/models/second_order.py``: ``SecondOrderResult``
(:52), the doubling ``_sqs_raw`` (:61), ``solve_quadratic_sylvester``
(:92) with its implicit adjoint (``_sqs_fwd``/``_sqs_bwd``, :111-133),
``make_second_order_solver`` (:136), ``_second_order_correction`` (:231),
``simulate_pruned`` (:240), ``second_order_mean`` (:264),
``irf_second_order`` (:290) and ``generalized_irf`` (:304).

The method is the reference's:

- the Hessian of the stacked residual F(y_{t-1}, y_t, y_{t+1}, eps) in the
  hat coordinates (log deviations for log-linearized variables) is
  ``torch.func.jacfwd`` twice of the lowered ``f_resid``, vmapped over the
  draws; gradients flow through it in (x_ss, theta) by reverse mode over
  the forward-mode derivatives, which the NUTS gradient of the
  second-order likelihood needs;
- G_xx solves the generalized Sylvester equation
  ``A_l G + C G (T (x) T) = -K_xx`` by Smith doubling.  The reference's
  ``while_loop`` under ``vmap`` stops each draw on its own criterion; here
  a finished draw is frozen by a per-draw mask and the loop runs while
  any draw is unfinished (one host read a doubling), so a draw takes the
  doublings it takes alone.  The adjoint is the transposed equation,
  solved by the same doubling (:class:`_QuadraticSylvester`);
- G_xu, G_uu and g_ss are direct solves once G_xx is known.

Every contraction ``X[i, a, b] T[a, j] T[b, k]`` runs as two batched
products of O(n^4) work.  A failed solve gives NaN (``solve_ex``) and
``success=False`` in its draw, never an exception.

Simulation and impulse responses use the pruned state space of
Kim-Kim-Schaumburg (2008); paths are batched along a path axis (see
:func:`simulate_pruned`), and the generalized IRF draws its shock paths
from a ``torch.Generator`` where the reference takes a JAX key.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..codegen.model_functions import ModelFunctions
from ..ops.cycle_reduction import _solve_nan
from ..ops.kalman import _chol_nan
from ..ops.lyapunov import solve_discrete_lyapunov
from ..ops.precision import highest_precision
from .perturbation import _ZERO_TOL, make_loglin_mask

__all__ = ["SecondOrderResult", "make_second_order_solver",
           "solve_quadratic_sylvester", "simulate_pruned",
           "second_order_mean", "irf_second_order", "generalized_irf"]


class SecondOrderResult(NamedTuple):
    G_xx: torch.Tensor    # (..., n, n, n)  symmetric in the trailing axes
    G_xu: torch.Tensor    # (..., n, n, k)
    G_uu: torch.Tensor    # (..., n, k, k)  symmetric
    g_ss: torch.Tensor    # (..., n)        uncertainty correction
    success: torch.Tensor  # (...,) bool


def _contract_tt(X: torch.Tensor, Ta: torch.Tensor, Tb: torch.Tensor
                 ) -> torch.Tensor:
    """out[..., i, j, k] = X[..., i, a, b] Ta[..., a, j] Tb[..., b, k], as
    two batched products."""
    Y = X @ Tb.unsqueeze(-3)                 # (..., i, a, k)
    return Ta.mT.unsqueeze(-3) @ Y           # (..., i, j, k)


def _left(M: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """out[..., i, j, k] = M[..., i, a] X[..., a, j, k]."""
    return (M @ X.flatten(-2)).reshape(X.shape[:-3] + (M.shape[-2],)
                                       + X.shape[-2:])


def _sqs_raw(A_l, C, T, K, n_iter: int = 30):
    """Smith doubling of X = Σ_j M^j X0 (T^j (x) T^j), M = -A_l⁻¹C,
    X0 = -A_l⁻¹K, per draw: a draw stops once max|ΔX| <= 10 eps max|X| or
    ΔX goes non-finite, or after ``n_iter`` doublings.  Returns
    (X, converged)."""
    X = -_solve_nan(A_l, K.flatten(-2)).reshape(K.shape)
    M = -_solve_nan(A_l, C)
    Tk = T
    eps = float(torch.finfo(X.dtype).eps)
    done = torch.zeros(X.shape[:-3], dtype=torch.bool, device=X.device)
    for _ in range(n_iter):
        if bool(done.all()):
            break
        delta = _contract_tt(_left(M, X), Tk, Tk)
        X_new = X + delta
        scale = torch.clamp(torch.amax(X_new.abs(), dim=(-3, -2, -1)),
                            min=1e-30)
        d_max = torch.amax(delta.abs(), dim=(-3, -2, -1))
        small = d_max <= 10 * eps * scale
        live = ~done
        X = torch.where(live[..., None, None, None], X_new, X)
        M = torch.where(live[..., None, None], M @ M, M)
        Tk = torch.where(live[..., None, None], Tk @ Tk, Tk)
        done = done | small | ~torch.isfinite(d_max)
    converged = done & torch.isfinite(X).all(dim=(-3, -2, -1))
    return X, converged


class _QuadraticSylvester(torch.autograd.Function):
    """X solving A_l X + C X (T (x) T) = -K; the backward solves the
    transposed equation A_lᵀ W + Cᵀ W (Tᵀ (x) Tᵀ) = X̄ by the same doubling
    (``second_order.py:117-130``)."""

    @staticmethod
    def forward(ctx, A_l, C, T, K, n_iter):
        with highest_precision():
            X, converged = _sqs_raw(A_l, C, T, K, n_iter)
        ctx.save_for_backward(A_l, C, T, X)
        ctx.n_iter = n_iter
        ctx.mark_non_differentiable(converged)
        return X, converged

    @staticmethod
    def backward(ctx, X_bar, _converged_bar):
        A_l, C, T, X = ctx.saved_tensors
        if X_bar is None:
            X_bar = torch.zeros_like(X)
        with highest_precision():
            W, _ = _sqs_raw(A_l.mT, C.mT, T.mT, -X_bar, ctx.n_iter)
            XT = _contract_tt(X, T, T)
            Wf = W.flatten(-2)
            A_bar = -(Wf @ X.flatten(-2).mT)
            C_bar = -(Wf @ XT.flatten(-2).mT)
            CX = _left(C, X)
            # -(einsum("ijk,ipq,qk->pj") + einsum("ijk,ipq,pj->qk"))
            T_bar = -((CX @ T.unsqueeze(-3)) @ W.mT).sum(dim=-3) \
                - ((T.mT.unsqueeze(-3) @ CX).mT @ W).sum(dim=-3)
        return A_bar, C_bar, T_bar, -W, None


def solve_quadratic_sylvester(A_l, C, T, K, n_iter: int = 30):
    """Solve  A_l X + C X (T (x) T) = -K  for X (..., n_eq, n, n), batched
    over leading dimensions; returns (X, converged).  Differentiable in
    A_l, C, T and K through the implicit adjoint (one transposed doubling
    per backward pass)."""
    return _QuadraticSylvester.apply(A_l, C, T, K, n_iter)


def make_second_order_solver(mf: ModelFunctions,
                             loglin_variables: list[str] | bool = True
                             ) -> Callable[..., SecondOrderResult]:
    """Build ``solve2(x_ss, theta_full, T, R, Q) -> SecondOrderResult``
    over a leading batch dimension (x_ss (B, n), theta_full (B, P), T (B,
    n, n), R (B, n, k), Q (B, k, k)).

    ``loglin_variables`` must match the first-order linearization that
    produced T and R (``models/perturbation.py::make_linearizer``): a
    variable is in log deviations where it is log-linearized and its
    steady state exceeds ``_ZERO_TOL``, per draw.
    """
    n, k = mf.n_variables, mf.n_shocks
    loglin_mask = torch.as_tensor(make_loglin_mask(mf, loglin_variables))
    f = mf.f_resid
    m = 3 * n + k

    def derivatives(x_ss, theta_full):
        """(H (n, m, m), J (n, m)) of one draw's residual at w = 0."""
        is_log = loglin_mask.to(x_ss.device) & (x_ss > _ZERO_TOL)

        def tx(yhat):
            return torch.where(is_log, x_ss * torch.exp(yhat), x_ss + yhat)

        def resid_hat(w):
            return f(tx(w[:n]), tx(w[n:2 * n]), tx(w[2 * n:3 * n]),
                     w[3 * n:], x_ss, theta_full)

        def jac_and_aux(w):
            J = torch.func.jacfwd(resid_hat)(w)
            return J, J

        H, J = torch.func.jacfwd(jac_and_aux, has_aux=True)(
            x_ss.new_zeros(m))
        return H, J

    batched = torch.func.vmap(derivatives)

    @highest_precision()
    def solve2(x_ss, theta_full, T, R, Q) -> SecondOrderResult:
        H, J = batched(x_ss, theta_full)                   # (B, n, m, m)
        B_ = J[..., n:2 * n]
        C_ = J[..., 2 * n:3 * n]
        batch = T.shape[:-2]
        eye_n = torch.eye(n, dtype=T.dtype, device=T.device).expand(
            batch + (n, n))
        eye_k = torch.eye(k, dtype=T.dtype, device=T.device).expand(
            batch + (k, k))
        # first derivatives of each residual slot in (x, u):
        # y_{t-1} -> [I, 0]; y_t -> [T, R]; y_{t+1} -> [TT, TR]; eps -> [0, I]
        P = torch.cat([
            torch.cat([eye_n, T.new_zeros(batch + (n, k))], dim=-1),
            torch.cat([T, R], dim=-1),
            torch.cat([T @ T, T @ R], dim=-1),
            torch.cat([T.new_zeros(batch + (k, n)), eye_k], dim=-1),
        ], dim=-2)                                         # (B, m, n + k)
        K_mm = _contract_tt(H, P, P)                       # (B, n, n+k, n+k)
        K_xx = K_mm[..., :n, :n]
        K_xu = K_mm[..., :n, n:]
        K_uu = K_mm[..., n:, n:]

        A_l = B_ + C_ @ T
        G_xx, sylv_ok = solve_quadratic_sylvester(A_l, C_, T, K_xx)
        G_xx = 0.5 * (G_xx + G_xx.mT)

        rhs_xu = K_xu + _left(C_, _contract_tt(G_xx, T, R))
        G_xu = -_solve_nan(A_l, rhs_xu.flatten(-2)).reshape(rhs_xu.shape)
        rhs_uu = K_uu + _left(C_, _contract_tt(G_xx, R, R))
        G_uu = -_solve_nan(A_l, rhs_uu.flatten(-2)).reshape(rhs_uu.shape)
        G_uu = 0.5 * (G_uu + G_uu.mT)

        # uncertainty correction: (B + C + C T) g_ss =
        #   -( C (G_uu : Q) + f_{y+ y+} : (R Q Rᵀ) )
        Q_ = Q.to(T.dtype)
        guuQ = (G_uu * Q_.unsqueeze(-3)).sum(dim=(-2, -1))
        H_pp = H[..., 2 * n:3 * n, 2 * n:3 * n]
        fvvRQR = (H_pp * (R @ Q_ @ R.mT).unsqueeze(-3)).sum(dim=(-2, -1))
        rhs = (C_ @ guuQ[..., None])[..., 0] + fvvRQR
        g_ss = -_solve_nan(B_ + C_ + C_ @ T, rhs[..., None])[..., 0]

        success = sylv_ok & torch.isfinite(G_xu).all(dim=(-3, -2, -1)) \
            & torch.isfinite(G_uu).all(dim=(-3, -2, -1)) \
            & torch.isfinite(g_ss).all(dim=-1)
        return SecondOrderResult(G_xx, G_xu, G_uu, g_ss, success)

    return solve2


def _quadratic(G: torch.Tensor, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
    """out[..., s, i] = G[..., i, j, l] a[..., s, j] b[..., s, l]."""
    ab = (a.unsqueeze(-1) * b.unsqueeze(-2)).flatten(-2)
    return ab @ G.flatten(-2).mT


def _second_order_correction(res: SecondOrderResult, y1, eps,
                             with_gss: bool = True) -> torch.Tensor:
    """1/2 G_xx (y1 (x) y1) + G_xu (y1 (x) eps) + 1/2 G_uu (eps (x) eps)
    (+ 1/2 g_ss) for y1 (..., S, n) and eps (..., S, k), the path axis S
    beside the result's batch dimensions."""
    quad = 0.5 * _quadratic(res.G_xx, y1, y1) \
        + _quadratic(res.G_xu, y1, eps) \
        + 0.5 * _quadratic(res.G_uu, eps, eps)
    if with_gss:
        quad = quad + 0.5 * res.g_ss.unsqueeze(-2)
    return quad


@highest_precision()
def simulate_pruned(T, R, res: SecondOrderResult, shocks,
                    y1_0=None, y2_0=None, with_gss: bool = True
                    ) -> torch.Tensor:
    """Pruned second-order simulation (Kim-Kim-Schaumburg).

    ``shocks`` is one path (periods, k), as in the reference, or paths
    (..., S, periods, k) whose leading dimensions are those of T (S paths
    per solution).  Returns the hat-coordinate paths y1 + y2, (periods, n)
    or (..., S, periods, n).  ``y1_0`` and ``y2_0`` ((..., n), zero by
    default) start every path.
    """
    T = torch.as_tensor(T)
    R = torch.as_tensor(R, dtype=T.dtype, device=T.device)
    shocks = torch.as_tensor(shocks, dtype=T.dtype, device=T.device)
    single = shocks.ndim == 2
    if single:
        shocks = shocks[None]
    n = T.shape[-1]
    lead = shocks.shape[:-2]

    def start(y0):
        if y0 is None:
            return T.new_zeros(lead + (n,))
        y0 = torch.as_tensor(y0, dtype=T.dtype, device=T.device)
        return y0.unsqueeze(-2).expand(lead + (n,))

    y1, y2 = start(y1_0), start(y2_0)
    Tt, Rt = T.mT, R.mT
    out = []
    for t in range(shocks.shape[-2]):
        e = shocks[..., t, :]
        y1_next = y1 @ Tt + e @ Rt
        y2 = y2 @ Tt + _second_order_correction(res, y1, e, with_gss)
        y1 = y1_next
        out.append(y1 + y2)
    path = torch.stack(out, dim=-2)
    return path[0] if single else path


@highest_precision()
def second_order_mean(T, R, res: SecondOrderResult, Q) -> torch.Tensor:
    """Exact unconditional mean of the pruned second-order system,

        E[y2] = (I - T)⁻¹ (1/2 G_xx : Σ1 + 1/2 G_uu : Q + 1/2 g_ss),

    Σ1 the first-order stationary covariance; batched over leading
    dimensions (the G_xu term vanishes: y1_{t-1} is independent of
    eps_t)."""
    T = torch.as_tensor(T)
    R = torch.as_tensor(R, dtype=T.dtype, device=T.device)
    Q = torch.as_tensor(Q, dtype=T.dtype, device=T.device)
    Sigma1 = solve_discrete_lyapunov(T, R @ Q @ R.mT)
    drive = 0.5 * (res.G_xx * Sigma1.unsqueeze(-3)).sum(dim=(-2, -1)) \
        + 0.5 * (res.G_uu * Q.unsqueeze(-3)).sum(dim=(-2, -1)) \
        + 0.5 * res.g_ss
    eye = torch.eye(T.shape[-1], dtype=T.dtype, device=T.device)
    return _solve_nan(eye - T, drive[..., None])[..., 0]


def irf_second_order(T, R, res: SecondOrderResult, shock_vec,
                     periods: int = 40) -> torch.Tensor:
    """Deterministic second-order IRF: the pruned path with the impulse at
    t = 0 less the path without it (g_ss left out, so it cancels).
    ``shock_vec`` is (k,) for one response (periods, n), or (..., k) for
    several at once along a path axis, (..., periods, n)."""
    T = torch.as_tensor(T)
    shock_vec = torch.as_tensor(shock_vec, dtype=T.dtype, device=T.device)
    k = R.shape[-1]
    hit = T.new_zeros(shock_vec.shape[:-1] + (periods, k))
    hit[..., 0, :] = shock_vec
    base = torch.zeros_like(hit)
    return (simulate_pruned(T, R, res, hit, with_gss=False)
            - simulate_pruned(T, R, res, base, with_gss=False))


@highest_precision()
def _girf_from_normals(T, R, res: SecondOrderResult, shock_vec, Q,
                       normals: torch.Tensor, x0=None) -> torch.Tensor:
    """The generalized IRF on given standard normals ``normals`` (...,
    n_draws, periods, k): the shock paths are ``normals Lᵀ`` (L the
    Cholesky factor of Q), the impulse ``shock_vec`` (..., k) is added at
    t = 0, and the mean over the draws of the two paths' difference is
    (..., periods, n)."""
    chol = _chol_nan(Q)
    eps = normals @ chol.mT.unsqueeze(-3)
    eps_hit = eps.clone()
    eps_hit[..., 0, :] = eps_hit[..., 0, :] + shock_vec.unsqueeze(-2)
    n_draws = normals.shape[-3]
    paths = simulate_pruned(T, R, res, torch.cat([eps_hit, eps], dim=-3),
                            y1_0=x0, with_gss=False)
    return (paths[..., :n_draws, :, :]
            - paths[..., n_draws:, :, :]).mean(dim=-3)


def generalized_irf(T, R, res: SecondOrderResult, shock_vec, Q,
                    periods: int = 40, n_draws: int = 256,
                    generator: torch.Generator | None = None,
                    x0=None) -> torch.Tensor:
    """Generalized IRF (Koop-Pesaran-Potter 1996) of the pruned system:
    E[y | eps_0 = e + shock] - E[y | eps_0 = e] by Monte Carlo over
    ``n_draws`` future shock paths, the paths with and without the impulse
    sharing their draws.  The standard normals (..., n_draws, periods, k)
    come from ``generator`` (on T's device; without one, a generator there
    seeded with 0).  ``x0`` (..., n) sets the initial first-order state
    (the GIRF is state-dependent at second order).  Batched over the
    leading dimensions of T; returns (..., periods, n)."""
    T = torch.as_tensor(T)
    R = torch.as_tensor(R, dtype=T.dtype, device=T.device)
    Q = torch.as_tensor(Q, dtype=T.dtype, device=T.device)
    shock_vec = torch.as_tensor(shock_vec, dtype=T.dtype, device=T.device)
    if generator is None:
        generator = torch.Generator(device=T.device).manual_seed(0)
    normals = torch.randn(T.shape[:-2] + (n_draws, periods, R.shape[-1]),
                          generator=generator, dtype=T.dtype,
                          device=T.device)
    return _girf_from_normals(T, R, res, shock_vec, Q, normals, x0)
