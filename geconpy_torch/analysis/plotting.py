"""Matplotlib plotting layer.

Mirrors ``geconpy_tpu/analysis/plotting.py`` (``prepare_gridspec_figure``
:44, ``_hdi_band`` :70, ``plot_timeseries`` :78, ``plot_simulation`` :106,
``plot_irf`` :132, ``plot_eigenvalues`` :197, ``plot_solvability`` :232,
``plot_solvability_summary`` :265, ``plot_heatmap`` :277,
``plot_covariance_matrix`` :299, ``plot_estimated_matrix`` :303,
``plot_acf`` :319, ``plot_corner`` :364, ``plot_kalman_filter`` :399,
``plot_priors`` :436, ``plot_posterior_with_prior`` :451,
``plot_eigenvalue_sensitivity`` :489, ``plot_perfect_foresight`` :520,
``plot_shock_decomposition`` :533, ``plot_forecast`` :575).  Where the
reference's plots read DataFrames, the port's read its own results:
tensors with name lists (``Simulations``, ``ImpulseResponses``,
``LabeledMoments``, ``LabeledMatrix``, ``ShareTable``), the posterior
``Bands``, ``SolvabilityTable``, the sensitivities, ``PerfectForesightResult``
and ``ShockDecomposition``; the figures are the reference's.  Pandas bar
plots become :func:`_bar_frame`, which places the bars as pandas does.
``plot_priors`` and ``plot_posterior_with_prior`` evaluate the densities
with :mod:`geconpy_torch.dists`.  Host-side presentation only; matplotlib
is imported lazily, so the compute stack never needs it.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

__all__ = [
    "prepare_gridspec_figure",
    "plot_timeseries",
    "plot_simulation",
    "plot_irf",
    "plot_eigenvalues",
    "plot_solvability",
    "plot_solvability_summary",
    "plot_covariance_matrix",
    "plot_heatmap",
    "plot_acf",
    "plot_corner",
    "plot_kalman_filter",
    "plot_priors",
    "plot_posterior_with_prior",
    "plot_estimated_matrix",
    "plot_eigenvalue_sensitivity",
    "plot_perfect_foresight",
    "plot_shock_decomposition",
    "plot_forecast",
]


def _plt():
    import matplotlib.pyplot as plt

    return plt


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _qcols(bands):
    """(column name, quantile array) of each level of ``bands``, ordered by
    name as the reference sorts its ``q*`` columns."""
    cols = {f"q{lvl}": _np(bands.quantiles[i])
            for i, lvl in enumerate(bands.levels)}
    return [(c, cols[c]) for c in sorted(cols)]


def _center(bands) -> np.ndarray:
    """The median where 0.5 is a level, else the mean."""
    cols = dict(_qcols(bands))
    return cols["q0.5"] if "q0.5" in cols else _np(bands.mean)


def _bar_frame(ax, values: np.ndarray, index, series=None, xlabel=None):
    """Vertical bars as ``DataFrame.plot.bar`` (a ``Series`` when
    ``series`` is None) draws them: width 0.5 per tick split among the
    series, colors C0, C1, ..., tick labels rotated 90 degrees, the index's
    name ``xlabel`` on the x axis."""
    values = np.atleast_2d(np.asarray(values, dtype=float).T).T
    n_rows, n_series = values.shape
    ticks = np.arange(n_rows)
    w = 0.5 / n_series
    for i in range(n_series):
        kwds = {} if series is None else {"label": str(series[i])}
        ax.bar(ticks - 0.25 + (i + 0.5) * w, np.nan_to_num(values[:, i]), w,
               color=f"C{i}", align="center", **kwds)
    ax.set_xticks(ticks, [str(i) for i in index], rotation=90)
    ax.set_xlim(-0.5, n_rows - 0.5)
    if xlabel:
        ax.set_xlabel(xlabel)
    if series is not None:
        ax.legend()
    return ax


def prepare_gridspec_figure(n_plots: int, n_cols: int = 3, figsize=None,
                            sharex: bool = False, sharey: bool = False,
                            suptitle: str | None = None, **fig_kwargs):
    """Figure + axes grid sized for ``n_plots`` panels.

    ``sharex``/``sharey`` share the axes across panels (role parity with the
    reference's gridspec helper, ``gEconpy/plotting.py:46``); surplus panels
    are hidden, and with ``sharex`` the x tick labels stay visible on the
    last occupied panel of each column."""
    plt = _plt()
    n_rows = -(-n_plots // n_cols)
    if figsize is None:
        figsize = (4 * n_cols, 2.6 * n_rows)
    fig, axes = plt.subplots(n_rows, n_cols, figsize=figsize, squeeze=False,
                             sharex=sharex, sharey=sharey, **fig_kwargs)
    flat = axes.ravel()
    for idx in range(n_plots, len(flat)):
        flat[idx].set_visible(False)
        if sharex and idx >= n_cols:
            # re-enable tick labels on the panel above the hidden one
            flat[idx - n_cols].tick_params(labelbottom=True)
    if suptitle:
        fig.suptitle(suptitle)
    return fig, flat[:n_plots]


def _hdi_band(draws_2d: np.ndarray, ci: float):
    """(lo, hi) equal-tailed interval across axis 0."""
    lo_q, hi_q = (1 - ci) / 2, 1 - (1 - ci) / 2
    return (np.quantile(draws_2d, lo_q, axis=0),
            np.quantile(draws_2d, hi_q, axis=0))


def plot_timeseries(data, variables=None, n_cols: int | None = None,
                    fig_kwargs: dict | None = None, sharex: bool = True, *,
                    names=None, index=None, **line_kwargs):
    """One panel per column of a time series (role parity with
    ``gEconpy/plotting.py:149``).

    ``data`` is (periods, k) with column ``names``, or a
    ``LabeledMatrix`` (values, index, columns).  ``index`` is the time
    axis (default 0, 1, ...); a ``numpy.datetime64`` index gets year-major
    date ticks like the reference.  Extra ``line_kwargs`` pass through to
    ``Axes.plot``."""
    if hasattr(data, "columns"):
        names, index, data = list(data.columns), data.index, data.values
    values = _np(data)
    if names is None:
        names = [f"x{i}" for i in range(values.shape[1])]
    names = list(names)
    index = np.arange(values.shape[0]) if index is None else np.asarray(index)
    variables = list(variables) if variables is not None else names
    if n_cols is None:
        n_cols = min(4, len(variables))
    fig, axes = prepare_gridspec_figure(len(variables), n_cols, sharex=sharex,
                                        **(fig_kwargs or {}))
    is_dates = np.issubdtype(index.dtype, np.datetime64)
    for ax, var in zip(axes, variables):
        ax.plot(index, values[:, names.index(var)], **line_kwargs)
        ax.set_title(var)
        if is_dates:
            from matplotlib.dates import DateFormatter, YearLocator

            days = (index[-1] - index[0]) // np.timedelta64(1, "D")
            span_years = max(1, int(days) // 365)
            ax.xaxis.set_major_locator(YearLocator(max(1, span_years // 6)))
            ax.xaxis.set_major_formatter(DateFormatter("%Y"))
    fig.tight_layout()
    return fig


def plot_simulation(simulations, variables=None, n_cols: int = 3,
                    alpha: float = 0.3, ci: float = 0.9,
                    n_paths: int = 0, sharex: bool = True):
    """Fan chart of simulated paths: per-variable quantile band + mean,
    optionally overlaying ``n_paths`` individual trajectories (spaghetti) —
    role parity with ``gEconpy/plotting.py:202``.  ``simulations`` is a
    ``Simulations`` (values (n_simulations, periods, n_variables))."""
    names = list(simulations.variables)
    values = _np(simulations.values)
    variables = variables or names
    fig, axes = prepare_gridspec_figure(len(variables), n_cols, sharex=sharex)
    lo_q, hi_q = (1 - ci) / 2, 1 - (1 - ci) / 2
    t = np.arange(values.shape[1])
    for ax, var in zip(axes, variables):
        paths = values[:, :, names.index(var)]
        mean = paths.mean(axis=0)
        lo = np.quantile(paths, lo_q, axis=0)
        hi = np.quantile(paths, hi_q, axis=0)
        ax.fill_between(t, lo, hi, alpha=alpha)
        for s in range(min(n_paths, paths.shape[0])):
            ax.plot(t, paths[s], lw=0.5, alpha=0.5, color="gray")
        ax.plot(t, mean, lw=1.5)
        ax.set_title(var)
        ax.axhline(0.0, color="k", lw=0.5, ls=":")
    fig.tight_layout()
    return fig


def plot_irf(irf, variables=None, shocks=None, n_cols: int = 3,
             legend: bool = True, ci: float | None = 0.9,
             group_by: str = "variable", cumulative: bool = False,
             sharex: bool = True):
    """IRF panels (role parity with ``gEconpy/plotting.py:393``).

    - point IRFs: an ``ImpulseResponses`` — one line per shock.
    - posterior IRFs: the ``Bands`` of ``posterior_irfs`` (dims shock,
      variable, time) — median line with the band of the outermost
      quantiles per shock.
    - ``group_by``: 'variable' (panel per variable, line per shock) or
      'shock' (panel per shock, line per variable).
    - ``cumulative``: plot cumulated responses (flow -> level).
    """
    posterior = hasattr(irf, "quantiles")
    if posterior:
        all_shocks, all_vars, times = (list(x) for x in irf.labels)
        center = _center(irf)
        qcols = _qcols(irf)
    else:
        all_shocks, all_vars = list(irf.shocks), list(irf.variables)
        values = _np(irf.values)
        times = list(range(values.shape[1]))
    variables = variables or all_vars
    shocks = shocks or all_shocks

    if group_by not in ("variable", "shock"):
        raise ValueError("group_by must be 'variable' or 'shock'")
    panels = variables if group_by == "variable" else shocks
    lines = shocks if group_by == "variable" else variables
    fig, axes = prepare_gridspec_figure(len(panels), n_cols, sharex=sharex)

    t = np.asarray(times)
    for ax, panel in zip(axes, panels):
        for li, line in enumerate(lines):
            var = panel if group_by == "variable" else line
            shock = line if group_by == "variable" else panel
            s, v = all_shocks.index(shock), all_vars.index(var)
            if posterior:
                vals = center[s, v]
                if cumulative:
                    vals = np.cumsum(vals)
                ax.plot(t, vals, label=str(line), color=f"C{li}")
                if ci and len(qcols) >= 2:
                    lo = qcols[0][1][s, v]
                    hi = qcols[-1][1][s, v]
                    if cumulative:
                        lo, hi = np.cumsum(lo), np.cumsum(hi)
                    ax.fill_between(t, lo, hi, alpha=0.25, color=f"C{li}")
            else:
                vals = values[s, :, v]
                if cumulative:
                    vals = np.cumsum(vals)
                ax.plot(t, vals, label=str(line), color=f"C{li}")
        ax.set_title(str(panel))
        ax.axhline(0.0, color="k", lw=0.5, ls=":")
    if legend and len(lines) > 1:
        axes[0].legend(fontsize=8)
    fig.tight_layout()
    return fig


def plot_eigenvalues(bk_table, ax=None, annotate_near: float = 0.15):
    """Unit-circle eigenvalue plot from Model.check_bk_condition output.

    Stable roots plot in blue, unstable in red; roots within
    ``annotate_near`` of the unit circle get their modulus annotated
    (they decide BK by a hair)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(5, 5))
    theta = np.linspace(0, 2 * np.pi, 200)
    ax.plot(np.cos(theta), np.sin(theta), "k--", lw=0.7)
    finite = np.isfinite(bk_table["modulus"])
    mod = np.asarray(bk_table["modulus"][finite], dtype=float)
    re = np.asarray(bk_table["real"][finite], dtype=float)
    im = np.asarray(bk_table["imag"][finite], dtype=float)
    stable = mod < 1.0
    ax.scatter(re[stable], im[stable], s=25, c="C0", label="stable")
    if (~stable).any():
        ax.scatter(re[~stable], im[~stable], s=25, c="C3", label="unstable")
    for r, i, m in zip(re, im, mod):
        if abs(m - 1.0) < annotate_near:
            ax.annotate(f"{m:.3f}", (r, i), fontsize=7,
                        xytext=(3, 3), textcoords="offset points")
    n_inf = int((~finite).sum())
    title = "Generalized eigenvalues"
    if n_inf:
        title += f" ({n_inf} infinite not shown)"
    ax.set_title(title)
    ax.set_xlabel("Re")
    ax.set_ylabel("Im")
    ax.set_aspect("equal")
    ax.legend(fontsize=7, loc="upper right")
    return ax


def plot_solvability(table, params=None, figsize=None):
    """Pairwise scatter of parameter draws colored by solvability, from a
    ``SolvabilityTable``."""
    plt = _plt()
    names = list(table.param_names)
    draws = _np(table.draws)
    params = params or names
    k = len(params)
    fig, axes = plt.subplots(k, k, figsize=figsize or (2.2 * k, 2.2 * k),
                             squeeze=False)
    ok = _np(table.success).astype(bool)
    for i, pi in enumerate(params):
        xi = draws[:, names.index(pi)]
        for j, pj in enumerate(params):
            xj = draws[:, names.index(pj)]
            ax = axes[i][j]
            if i == j:
                ax.hist([xi[ok], xi[~ok]], bins=15, stacked=True,
                        color=["C0", "C3"])
            else:
                ax.scatter(xj[ok], xi[ok], s=4, c="C0", label="ok")
                ax.scatter(xj[~ok], xi[~ok], s=6, c="C3", label="fail")
            if i == k - 1:
                ax.set_xlabel(pj, fontsize=8)
            if j == 0:
                ax.set_ylabel(pi, fontsize=8)
    fig.tight_layout()
    return fig


def plot_solvability_summary(table, ax=None):
    """Bar chart of failure-stage attribution (draws per first failed
    stage, most frequent first) of a ``SolvabilityTable``."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 3))
    counts = Counter(table.failure_stage).most_common()
    _bar_frame(ax, [c for _, c in counts], [s for s, _ in counts],
               xlabel="failure_stage")
    ax.set_ylabel("draws")
    ax.set_title("Solvability by failure stage")
    return ax


def _labelled_matrix(matrix):
    """(values (r, c), row names, column names) of a labelled matrix."""
    if hasattr(matrix, "columns"):             # LabeledMatrix
        return _np(matrix.values), list(matrix.index), list(matrix.columns)
    if hasattr(matrix, "shock_names"):         # ShareTable
        return (_np(matrix.values), list(matrix.variable_names),
                list(matrix.shock_names))
    return (_np(matrix.values), list(matrix.variables),   # LabeledMoments
            list(matrix.variables))


def plot_heatmap(matrix, ax=None, cmap="RdBu_r", annotate: bool = True,
                 fmt: str = "{:.2f}"):
    """Annotated heatmap of a labelled matrix (``LabeledMatrix``,
    ``ShareTable`` or a 2-D ``LabeledMoments``)."""
    plt = _plt()
    values, index, columns = _labelled_matrix(matrix)
    values = values.astype(float)
    if ax is None:
        _, ax = plt.subplots(figsize=(0.6 * len(columns) + 2,
                                      0.5 * len(index) + 1.5))
    vmax = np.nanmax(np.abs(values)) or 1.0
    im = ax.imshow(values, cmap=cmap, vmin=-vmax, vmax=vmax)
    ax.set_xticks(range(len(columns)), columns, rotation=90, fontsize=8)
    ax.set_yticks(range(len(index)),
                  [str(i) for i in index], fontsize=8)
    if annotate and values.size <= 400:
        for i in range(values.shape[0]):
            for j in range(values.shape[1]):
                ax.text(j, i, fmt.format(values[i, j]), ha="center",
                        va="center", fontsize=7)
    plt.colorbar(im, ax=ax, shrink=0.8)
    return ax


def plot_covariance_matrix(cov, ax=None, **kwargs):
    return plot_heatmap(cov, ax=ax, **kwargs)


def plot_estimated_matrix(posterior_matrices, index=None, columns=None,
                          n_cols: int = 4):
    """Posterior distribution per matrix entry (draws, n, m) as histograms."""
    arr = _np(posterior_matrices)
    _, n, m = arr.shape
    fig, axes = prepare_gridspec_figure(n * m, n_cols)
    for idx, ax in enumerate(axes):
        i, j = divmod(idx, m)
        ax.hist(arr[:, i, j], bins=30, density=True)
        ri = index[i] if index is not None else i
        cj = columns[j] if columns is not None else j
        ax.set_title(f"[{ri}, {cj}]", fontsize=8)
    fig.tight_layout()
    return fig


def plot_acf(acf, variables=None, n_cols: int = 3, ci: float | None = 0.9,
             n_obs: int | None = None):
    """Autocorrelation-function panels (role parity with
    ``gEconpy/plotting.py:1454``).

    - point ACF: a ``LabeledMoments`` of ``autocorrelation_matrix``
      (n_lags, n, n) — bar per lag.
    - posterior ACF: the ``Bands`` of ``posterior_autocorrelation`` (dims
      lag, variable) — posterior-median bars with whiskers to the outermost
      quantiles per lag.
    - ``n_obs``: draw the ±1.96/√T white-noise significance band.
    """
    posterior = hasattr(acf, "quantiles")
    if posterior:
        lag_labels, names = (list(x) for x in acf.labels)
        center = _center(acf)
        qcols = _qcols(acf)
    else:
        names = list(acf.variables)
        values = _np(acf.values)
        lag_labels = list(range(values.shape[0]))
    variables = variables or names
    fig, axes = prepare_gridspec_figure(len(variables), n_cols, sharey=True)
    lags = np.asarray(sorted(lag_labels))
    order = [lag_labels.index(lag) for lag in lags]
    for ax, var in zip(axes, variables):
        v = names.index(var)
        if posterior:
            med = center[order, v]
            ax.bar(lags, med, width=0.3)
            if ci and len(qcols) >= 2:
                lo = qcols[0][1][order, v]
                hi = qcols[-1][1][order, v]
                ax.errorbar(lags, med, yerr=[med - lo, hi - med], fmt="none",
                            ecolor="k", elinewidth=0.8, capsize=2)
        else:
            ax.bar(lags, values[order, v, v], width=0.3)
        if n_obs:
            band = 1.96 / np.sqrt(n_obs)
            ax.axhspan(-band, band, color="gray", alpha=0.15)
        ax.set_title(var)
        ax.set_ylim(-1.05, 1.05)
        ax.axhline(0.0, color="k", lw=0.5)
    fig.tight_layout()
    return fig


def plot_corner(samples, names=None, figsize=None, truths: dict | None = None):
    """Corner (pairs) plot of posterior draws (chains, draws, dim), with
    optional true-value crosshairs (role parity with
    ``gEconpy/plotting.py:1680``)."""
    plt = _plt()
    arr = _np(samples)
    if arr.ndim == 3:
        arr = arr.reshape(-1, arr.shape[-1])
    d = arr.shape[1]
    names = names or [f"x{i}" for i in range(d)]
    truth_vals = [truths.get(n) if truths else None for n in names]
    fig, axes = plt.subplots(d, d, figsize=figsize or (2 * d, 2 * d),
                             squeeze=False)
    for i in range(d):
        for j in range(d):
            ax = axes[i][j]
            if j > i:
                ax.set_visible(False)
            elif i == j:
                ax.hist(arr[:, i], bins=40, density=True)
                if truth_vals[i] is not None:
                    ax.axvline(truth_vals[i], color="C3", lw=1.2, ls="--")
            else:
                ax.hist2d(arr[:, j], arr[:, i], bins=40)
                if truth_vals[j] is not None:
                    ax.axvline(truth_vals[j], color="C3", lw=0.9, ls="--")
                if truth_vals[i] is not None:
                    ax.axhline(truth_vals[i], color="C3", lw=0.9, ls="--")
            if i == d - 1:
                ax.set_xlabel(names[j], fontsize=8)
            if j == 0:
                ax.set_ylabel(names[i], fontsize=8)
    fig.tight_layout()
    return fig


def plot_kalman_filter(filter_result, data=None, state_names=None,
                       kind: str | tuple = "filtered", n_cols: int = 3,
                       observed_idx=None, n_sd: float = 1.0):
    """State paths with ±``n_sd``·σ bands (role parity with
    ``gEconpy/plotting.py:1788``).

    ``kind`` may be one name or several ('filtered', 'predicted',
    'smoothed') overlaid per panel; ``data`` (periods, k_obs) with
    ``observed_idx`` (state column per observable) scatters the
    observations onto the matching state panels."""
    kinds = (kind,) if isinstance(kind, str) else tuple(kind)
    mean0 = _np(getattr(filter_result, f"{kinds[0]}_mean"))
    n = mean0.shape[1]
    state_names = list(state_names) if state_names is not None \
        else [f"state {i}" for i in range(n)]
    fig, axes = prepare_gridspec_figure(n, n_cols, sharex=True)
    t = np.arange(mean0.shape[0])
    for i, ax in enumerate(axes):
        for ki, kname in enumerate(kinds):
            mean = _np(getattr(filter_result, f"{kname}_mean"))
            cov = _np(getattr(filter_result, f"{kname}_cov"))
            sd = n_sd * np.sqrt(np.maximum(cov[:, i, i], 0))
            ax.fill_between(t, mean[:, i] - sd, mean[:, i] + sd, alpha=0.25,
                            color=f"C{ki}")
            ax.plot(t, mean[:, i], lw=1.2, color=f"C{ki}", label=kname)
        if data is not None and observed_idx is not None:
            for j, state_col in enumerate(observed_idx):
                if state_col == i:
                    ax.scatter(t, _np(data)[:, j], s=6, c="k",
                               zorder=3, label="observed")
        ax.set_title(state_names[i])
    if len(kinds) > 1 or (data is not None and observed_idx is not None):
        axes[0].legend(fontsize=7)
    fig.tight_layout()
    return fig


def _density(dist, xs: np.ndarray) -> np.ndarray:
    """exp(logpdf) of a :mod:`geconpy_torch.dists` distribution on a
    float64 grid."""
    import torch

    return np.exp(_np(dist.logpdf(torch.as_tensor(xs, dtype=torch.float64))))


def plot_priors(priors: dict, n_cols: int = 3, n_points: int = 300):
    """Prior density panels from a {name: Distribution} dict."""
    fig, axes = prepare_gridspec_figure(len(priors), n_cols)
    for ax, (name, dist) in zip(axes, priors.items()):
        lo, hi = dist.hdi(0.995)
        xs = np.linspace(lo, hi, n_points)
        ax.plot(xs, _density(dist, xs))
        ax.set_title(name)
    fig.tight_layout()
    return fig


def plot_posterior_with_prior(result, priors: dict, n_cols: int = 3,
                              n_points: int = 300, true_values: dict | None = None,
                              per_chain: bool = False):
    """Posterior histograms overlaid with prior densities (role parity with
    ``gEconpy/plotting.py:1932``).

    ``true_values`` marks known values (simulation studies) as vertical
    lines; ``per_chain`` overlays a translucent histogram per chain so
    between-chain disagreement (bad mixing) is visible."""
    names = result.param_names
    fig, axes = prepare_gridspec_figure(len(names), n_cols)
    samples = _np(result.samples)
    flat = samples.reshape(-1, len(names))
    for i, (ax, name) in enumerate(zip(axes, names)):
        if per_chain and samples.ndim == 3:
            for c in range(samples.shape[0]):
                ax.hist(samples[c, :, i], bins=30, density=True, alpha=0.35,
                        histtype="stepfilled")
        else:
            ax.hist(flat[:, i], bins=40, density=True, alpha=0.6,
                    label="posterior")
        if name in priors:
            lo, hi = priors[name].hdi(0.995)
            xs = np.linspace(lo, hi, n_points)
            ax.plot(xs, _density(priors[name], xs), "k-", lw=1.2,
                    label="prior")
        if true_values and name in true_values:
            ax.axvline(true_values[name], color="C3", lw=1.4, ls="--",
                       label="true")
        # posterior mean marker
        ax.axvline(flat[:, i].mean(), color="C0", lw=1.0, ls=":")
        ax.set_title(name)
    axes[0].legend(fontsize=8)
    fig.tight_layout()
    return fig


def plot_eigenvalue_sensitivity(sensitivity, ax=None, n_eigs: int = 6):
    """Bar panel of eigenvalue sensitivities.

    Accepts either ``eigenvalue_sensitivity``'s result (plots d|λ|/dθ for
    the ``n_eigs`` eigenvalues closest to the unit circle) or
    ``spectral_radius_sensitivity``'s."""
    plt = _plt()
    names = list(sensitivity.param_names)
    if hasattr(sensitivity, "d_rho_d_param"):
        if ax is None:
            _, ax = plt.subplots(figsize=(6, 3))
        _bar_frame(ax, _np(sensitivity.d_rho_d_param), names)
        ax.set_ylabel(r"$\partial \rho(T) / \partial \theta$")
        ax.axhline(0, color="k", lw=0.5)
        return ax
    order = np.argsort(np.abs(_np(sensitivity.moduli) - 1.0))[:n_eigs]
    if ax is None:
        _, ax = plt.subplots(figsize=(7, 3.2))
    _bar_frame(ax, _np(sensitivity.modulus)[order].T, names, list(order))
    ax.set_ylabel(r"$\partial |\lambda| / \partial \theta$")
    ax.axhline(0, color="k", lw=0.5)
    ax.legend(title="eigenvalue", fontsize=7)
    return ax


def plot_perfect_foresight(result, variables=None, n_cols: int = 3):
    """Trajectory panels with the terminal steady state marked."""
    names = list(result.variables)
    traj = _np(result.trajectory)
    t = np.asarray(result.time)
    variables = variables or names
    fig, axes = prepare_gridspec_figure(len(variables), n_cols)
    for ax, var in zip(axes, variables):
        path = traj[:, names.index(var)]
        ax.plot(t, path, lw=1.3)
        ax.axhline(path[-1], color="k", lw=0.6, ls=":")
        ax.set_title(var)
    fig.tight_layout()
    return fig


def plot_shock_decomposition(decomposition, variables=None,
                             n_cols: int = 2):
    """Stacked-bar historical shock decomposition (the classic Dynare
    ``shock_decomposition`` panel; no reference counterpart).

    ``decomposition`` comes from
    :func:`geconpy_torch.stats.posterior.historical_shock_decomposition`:
    each shock's contribution, the initial condition's and the smoothed
    states.  Per variable, positive and negative contributions stack
    above/below zero and the smoothed total overlays as a line.
    """
    plt = _plt()
    all_vars = list(decomposition.variable_names)
    variables = list(variables) if variables is not None else all_vars
    parts = _np(decomposition.contributions)
    columns = list(decomposition.shock_names) + ["initial"]
    parts = np.concatenate([parts, _np(decomposition.initial)[None]])
    smoothed = _np(decomposition.smoothed)

    fig, axes = prepare_gridspec_figure(len(variables), n_cols, sharex=True)
    cmap = plt.get_cmap("tab10")
    t = np.arange(smoothed.shape[0])
    for ax, var in zip(axes, variables):
        v = all_vars.index(var)
        pos_base = np.zeros(len(t))
        neg_base = np.zeros(len(t))
        for j, col in enumerate(columns):
            vals = parts[j, :, v]
            pos = np.where(vals > 0, vals, 0.0)
            neg = np.where(vals < 0, vals, 0.0)
            color = cmap(j % 10)
            ax.bar(t, pos, bottom=pos_base, width=1.0, color=color,
                   label=col, linewidth=0)
            ax.bar(t, neg, bottom=neg_base, width=1.0, color=color,
                   linewidth=0)
            pos_base = pos_base + pos
            neg_base = neg_base + neg
        ax.plot(t, smoothed[:, v], color="black", lw=1.2,
                label="smoothed")
        ax.axhline(0.0, color="black", lw=0.5)
        ax.set_title(var)
    axes[0].legend(fontsize=7, ncol=2)
    fig.tight_layout()
    return fig


def plot_forecast(forecast, data=None, observed_names=None,
                  history: int = 40, n_cols: int = 2):
    """Fan chart: history + forecast quantile bands per observable.

    ``forecast`` is the ``Bands`` of :func:`geconpy_torch.stats.forecast.
    posterior_forecast` or ``conditional_forecast`` (dims variable, time
    1..H).  Pass the estimation ``data`` (and its column order in
    ``observed_names``) to draw the last ``history`` observations before
    the forecast origin.  Nested quantile pairs shade progressively
    (outermost lightest).
    """
    variables, times = (list(x) for x in forecast.labels)
    qcols = sorted(_qcols(forecast), key=lambda c: float(c[0][1:]))
    pairs = [(qcols[i][1], qcols[-1 - i][1]) for i in range(len(qcols) // 2)]
    mean = _np(forecast.mean)

    fig, axes = prepare_gridspec_figure(len(variables), n_cols, sharex=True)
    t_fc = np.asarray(times, dtype=float)
    for v, (ax, var) in enumerate(zip(axes, variables)):
        if data is not None:
            names = list(observed_names) if observed_names is not None \
                else variables
            if var in names:
                col = _np(data)[:, names.index(var)]
                h = col[-history:] if history else col
                t_hist = np.arange(-len(h) + 1, 1, dtype=float)
                ax.plot(t_hist, h, color="black", lw=1.0)
                ax.axvline(0.0, color="grey", lw=0.7, ls=":")
        for k, (lo, hi) in enumerate(pairs):
            ax.fill_between(t_fc, lo[v], hi[v],
                            alpha=0.25 + 0.15 * k, color="C0", lw=0)
        ax.plot(t_fc, mean[v], color="C0", lw=1.4)
        ax.set_title(var)
    fig.tight_layout()
    return fig
