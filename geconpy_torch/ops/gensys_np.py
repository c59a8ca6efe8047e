"""Host (numpy/scipy) gensys of Sims (2002): a copy of
``geconpy_tpu/ops/gensys_np.py``, the reference's code with only the
package name changed (``tests/test_torch_frontend.py`` holds it to the
original).

Implemented from the published algorithm (Sims 2002, "Solving Linear
Rational Expectations Models", Computational Economics 20) with scipy's
ordered QZ.  It is the accuracy oracle of the device gensys
(:mod:`~geconpy_torch.ops.gensys_jax`), the ``solver="gensys_host"`` of
``Model.solve_model``, and the setup of ``Model.check_bk_condition``.

System form:  Gamma0 y_t = Gamma1 y_{t-1} + c + Psi z_t + Pi eta_t, where
z_t are exogenous shocks and eta_t are endogenous expectational errors.
Returns the solution  y_t = G1 y_{t-1} + C + impact z_t  plus the (eu)
existence/uniqueness codes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.linalg import ordqz, svd

__all__ = ["gensys", "gensys_setup", "solve_policy_gensys", "interpret_eu",
           "GensysResult"]

_REALSMALL = 1e-9


class GensysResult(NamedTuple):
    G1: np.ndarray
    C: np.ndarray
    impact: np.ndarray
    fmat: np.ndarray
    fwt: np.ndarray
    ywt: np.ndarray
    gev: np.ndarray          # (n, 2) [alpha, beta] generalized eigen components
    eu: tuple[int, int]
    loose: np.ndarray


def _determine_div(alpha: np.ndarray, beta: np.ndarray) -> float:
    """Sims's adaptive stability cutoff: shrink toward 1 whenever an
    eigenvalue lies just outside the unit circle so borderline roots are
    grouped consistently."""
    div = 1.01
    for a, b in zip(alpha, beta):
        if abs(a) > 0:
            divhat = abs(b) / abs(a)
            if 1 + _REALSMALL < divhat <= div:
                div = 0.5 * (1 + divhat)
    return div


def _ranked_svd(M: np.ndarray):
    u, d, vh = svd(M, full_matrices=False)
    big = d > _REALSMALL
    return u[:, big], d[big], vh[big, :].conj().T  # (u, d, v) with v columns


def gensys(g0, g1, c=None, psi=None, pi=None, div: float | None = None
           ) -> GensysResult:
    """Sims (2002) gensys on the host via scipy ordqz — the oracle for the
    device-side disk-iteration solver (``gensys_jax``).  Returns G1/impact
    and the eu existence/uniqueness codes."""
    n = g0.shape[0]
    g0 = np.asarray(g0, dtype=complex)
    g1 = np.asarray(g1, dtype=complex)
    c = np.zeros((n, 1)) if c is None else np.asarray(c, dtype=complex).reshape(n, -1)
    psi = np.zeros((n, 0)) if psi is None else np.asarray(psi, dtype=complex)
    pi = np.zeros((n, 0)) if pi is None else np.asarray(pi, dtype=complex)
    n_shocks = psi.shape[1]
    n_eta = pi.shape[1]

    # complex QZ of the pencil (g0, g1):  g0 = Q a Z^H,  g1 = Q b Z^H
    # transition eigenvalues are |b_ii / a_ii|
    a0, b0, alpha0, beta0, _, _ = ordqz(g0, g1, sort=lambda a, b: np.ones_like(
        np.asarray(a), dtype=bool), output="complex")
    div_used = _determine_div(np.diag(a0), np.diag(b0)) if div is None else div

    zxz = any(
        abs(aa) < _REALSMALL and abs(bb) < _REALSMALL
        for aa, bb in zip(np.diag(a0), np.diag(b0))
    )
    if zxz:
        nan = np.full((n, n), np.nan)
        return GensysResult(nan, np.full((n, c.shape[1]), np.nan),
                            np.full((n, n_shocks), np.nan), nan, nan, nan,
                            np.stack([np.diag(a0), np.diag(b0)], axis=1),
                            (-2, -2), np.full((n, n_eta), np.nan))

    def stable_first(aa, bb):
        return np.abs(bb) <= div_used * np.abs(aa)

    a, b, alpha, beta, q, z = ordqz(g0, g1, sort=stable_first, output="complex")
    qh = q.conj().T
    nunstab = int(np.sum(np.abs(beta) > div_used * np.abs(alpha)))
    nstab = n - nunstab

    q1 = qh[:nstab, :]
    q2 = qh[nstab:, :]

    etawt = q2 @ pi                                   # (nunstab, n_eta)
    ueta, deta, veta = _ranked_svd(etawt)

    # ---- existence: unstable-block shock loadings must lie in span(etawt)
    eu0 = 0
    if nunstab == 0:
        eu0 = 1
    else:
        zwt = q2 @ psi
        if zwt.size == 0 or np.linalg.norm(zwt - ueta @ (ueta.conj().T @ zwt)) \
                < _REALSMALL * n:
            eu0 = 1

    # ---- uniqueness: no loose expectational errors in the stable block
    etawt1 = q1 @ pi
    ueta1, deta1, veta1 = _ranked_svd(etawt1)
    if veta.shape[1] == 0:
        loose = etawt1
    else:
        loose = etawt1 @ (np.eye(n_eta) - veta @ veta.conj().T)
    if loose.size:
        dloose = svd(loose, compute_uv=False)
        nloose = int(np.sum(np.abs(dloose) > _REALSMALL * n))
    else:
        nloose = 0
    eu1 = 1 if nloose == 0 else -1
    n_loose_vars = nloose

    # ---- assemble solution
    if deta1.size:
        inner = ueta @ np.diag(1.0 / deta) @ veta.conj().T \
            @ veta1 @ np.diag(deta1) @ ueta1.conj().T
        tmat = np.hstack([np.eye(nstab), -inner.conj().T])
    else:
        tmat = np.hstack([np.eye(nstab), np.zeros((nstab, nunstab))])

    G0 = np.vstack([
        tmat @ a,
        np.hstack([np.zeros((nunstab, nstab)), np.eye(nunstab)]),
    ])
    G1 = np.vstack([tmat @ b, np.zeros((nunstab, n))])
    G0i = np.linalg.inv(G0)
    G1 = G0i @ G1

    usix = slice(nstab, n)
    a22 = a[usix, usix]
    b22 = b[usix, usix]
    if nunstab:
        C_upper = tmat @ qh @ c
        C_lower = np.linalg.solve(a22 - b22, q2 @ c)
        C_out = G0i @ np.vstack([C_upper, C_lower])
        fmat = np.linalg.solve(b22, a22)
        fwt = -np.linalg.solve(b22, q2 @ psi)
    else:
        C_out = G0i @ (tmat @ qh @ c)
        fmat = np.zeros((0, 0), dtype=complex)
        fwt = np.zeros((0, n_shocks), dtype=complex)
    impact = G0i @ np.vstack([tmat @ qh @ psi, np.zeros((nunstab, n_shocks))])
    ywt = G0i[:, nstab:]

    loose_out = np.zeros((n, n_eta), dtype=complex)

    G1 = np.real(z @ G1 @ z.conj().T)
    C_out = np.real(z @ C_out)
    impact = np.real(z @ impact)
    ywt = z @ ywt

    gev = np.stack([np.diag(a), np.diag(b)], axis=1)
    if eu0 == 1 and eu1 == -1:
        eu = (1, -1)
    elif eu0 == 0:
        eu = (0, eu1 if eu1 == 1 else 0)
    else:
        eu = (eu0, eu1)
    return GensysResult(G1, C_out, impact, fmat, fwt, ywt, gev, eu, loose_out)


def gensys_setup(A, B, C, D, tol: float = 1e-8):
    """Augment  A y_{t-1} + B y_t + C y_{t+1} + D eps_t = 0  into gensys form.

    Lead variables (columns of C with any non-negligible entry — a
    *structural* fact fixed at build time) get auxiliary states
    w_t = E_t y_{t+1} and expectational-error rows  y_t = w_{t-1} + eta_t.
    Role parity with ``gEconpy/solvers/gensys.py:568``.

    Returns (g0, g1, c, psi, pi, lead_idx).
    """
    A = np.asarray(A, dtype=float)
    B = np.asarray(B, dtype=float)
    C = np.asarray(C, dtype=float)
    D = np.asarray(D, dtype=float)
    n = A.shape[0]
    n_shocks = D.shape[1]

    lead_idx = np.flatnonzero(np.abs(C).sum(axis=0) > tol)
    k = len(lead_idx)
    m = n + k

    # state s_t = [y_t ; w_t], w_t = E_t y_{t+1} restricted to lead columns
    g0 = np.zeros((m, m))
    g1 = np.zeros((m, m))
    psi = np.zeros((m, n_shocks))
    pi = np.zeros((m, k))

    # original equations:  B y_t + C_lead w_t + A y_{t-1} + D eps = 0
    #   => (-B) y_t + (-C_lead) w_t = A y_{t-1} + D eps
    g0[:n, :n] = -B
    g0[:n, n:] = -C[:, lead_idx]
    g1[:n, :n] = A
    psi[:n, :] = D
    # expectational rows:  y_{j,t} = w_{j,t-1} + eta_{j,t}
    for row, j in enumerate(lead_idx):
        g0[n + row, j] = 1.0
        g1[n + row, n + row] = 1.0
        pi[n + row, row] = 1.0

    c = np.zeros((m, 1))
    return g0, g1, c, psi, pi, lead_idx


def solve_policy_gensys(A, B, C, D, tol: float = 1e-8):
    """A/B/C/D -> (T, R, eu).  T, R restricted to the original n variables."""
    n = A.shape[0]
    g0, g1, c, psi, pi, _ = gensys_setup(A, B, C, D, tol)
    res = gensys(g0, g1, c, psi, pi)
    T = res.G1[:n, :n]
    R = res.impact[:n, :]
    return T, R, res.eu


def interpret_eu(eu) -> str:
    """Humanize gensys existence/uniqueness codes."""
    e, u = eu[0], eu[1]
    if e == -2 and u == -2:
        return ("Coincident zeros. Indeterminacy and/or nonexistence; "
                "check that the system is correctly specified.")
    if e == 1 and u == 1:
        return "Gensys found a unique, stable solution."
    if e == 1 and u == -1:
        return "Solution exists but is not unique — sunspots possible."
    if e == 1 and u == 0:
        return "Solution exists but is not unique."
    if e == 0:
        return "No stable solution exists (explosive dynamics)."
    return f"Unknown gensys return code {eu}."
