"""The port's plots draw the reference's figures.

Each public function of ``analysis/plotting.py`` is called on the port's
result types and the reference's on the DataFrames that hold the same
numbers; every axes of the two figures must carry the same artists: title,
axis labels, visibility, tick labels, legend entries, texts, line data,
bar rectangles, scatter offsets, filled-band vertices and images, the
numbers within rel 1e-10.  Modelled on ``tests/analysis/test_plot_content.py``.
``plot_priors`` and ``plot_posterior_with_prior`` evaluate the densities
with ``geconpy_torch.dists`` where the reference calls ``jnp``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import pandas as pd  # noqa: E402

from geconpy_torch.analysis import plotting as port  # noqa: E402
from geconpy_torch.analysis.perfect_foresight import PerfectForesightResult  # noqa: E402
from geconpy_torch.analysis.simulate import ImpulseResponses, Simulations  # noqa: E402
from geconpy_torch.dists import core as port_dists  # noqa: E402
from geconpy_torch.ops.kalman import KalmanFilterResult  # noqa: E402
from geconpy_torch.stats.covariance import LabeledMoments  # noqa: E402
from geconpy_torch.stats.perturbation_diagnostics import (  # noqa: E402
    EigenvalueSensitivity, RadiusSensitivity, SolvabilityTable)
from geconpy_torch.stats.posterior import Bands, ShockDecomposition  # noqa: E402
from geconpy_torch.utils.formatting import LabeledMatrix  # noqa: E402
from geconpy_tpu.analysis import plotting as ref  # noqa: E402
from geconpy_tpu.dists import core as ref_dists  # noqa: E402

RTOL = 1e-10
LEVELS = (0.05, 0.5, 0.95)
RNG = np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _close_figs():
    yield
    plt.close("all")


def _axes(obj):
    return obj.axes if hasattr(obj, "axes") and isinstance(obj.axes, list) \
        else obj.figure.axes


def _close(a, b, what):
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-300, err_msg=what)


def _texts(items):
    return [t.get_text() for t in items]


def _assert_same_figure(got, want):
    """The same artists on every axes of the two figures."""
    gax, wax = _axes(got), _axes(want)
    assert len(gax) == len(wax)
    for i, (g, w) in enumerate(zip(gax, wax)):
        tag = f"axes {i}"
        assert g.get_visible() == w.get_visible(), tag
        assert g.get_title() == w.get_title(), tag
        assert g.get_xlabel() == w.get_xlabel(), tag
        assert g.get_ylabel() == w.get_ylabel(), tag
        if w.get_xticklabels() and any(_texts(w.get_xticklabels())):
            assert _texts(g.get_xticklabels()) == _texts(w.get_xticklabels())
        gl, wl = g.get_legend(), w.get_legend()
        assert (gl is None) == (wl is None), tag
        if wl is not None:
            assert _texts(gl.get_texts()) == _texts(wl.get_texts()), tag
        assert _texts(g.texts) == _texts(w.texts), tag
        assert len(g.lines) == len(w.lines), tag
        for lg, lw in zip(g.lines, w.lines):
            _close(lg.get_xdata(), lw.get_xdata(), f"{tag} line x")
            _close(lg.get_ydata(), lw.get_ydata(), f"{tag} line y")
            assert lg.get_label() == lw.get_label()
        assert len(g.patches) == len(w.patches), tag
        for pg, pw in zip(g.patches, w.patches):
            if hasattr(pw, "get_width"):
                _close([pg.get_x(), pg.get_y(), pg.get_width(),
                        pg.get_height()],
                       [pw.get_x(), pw.get_y(), pw.get_width(),
                        pw.get_height()], f"{tag} bar")
            else:
                _close(pg.get_path().vertices, pw.get_path().vertices,
                       f"{tag} patch")
        assert len(g.collections) == len(w.collections), tag
        for cg, cw in zip(g.collections, w.collections):
            assert type(cg) is type(cw), tag
            _close(cg.get_offsets(), cw.get_offsets(), f"{tag} offsets")
            pg, pw = cg.get_paths(), cw.get_paths()
            assert len(pg) == len(pw)
            for a, b in zip(pg, pw):
                _close(a.vertices, b.vertices, f"{tag} paths")
        assert len(g.images) == len(w.images), tag
        for ig, iw in zip(g.images, w.images):
            _close(ig.get_array(), iw.get_array(), f"{tag} image")


def _bands_frame(mean, quantiles, dims, labels):
    """The reference's frame of a ``Bands``: index ``dims``, columns mean
    and q<level>."""
    idx = pd.MultiIndex.from_product([list(x) for x in labels], names=dims) \
        if len(dims) > 1 else pd.Index(list(labels[0]), name=dims[0])
    cols = {"mean": mean.reshape(-1)}
    for lvl, q in zip(LEVELS, quantiles):
        cols[f"q{lvl}"] = q.reshape(-1)
    return pd.DataFrame(cols, index=idx)


def _bands(shape, dims, labels):
    draws = RNG.standard_normal((40,) + shape)
    mean = draws.mean(axis=0)
    q = np.quantile(draws, LEVELS, axis=0)
    return (Bands(torch.as_tensor(mean), torch.as_tensor(q), LEVELS, dims,
                  labels),
            _bands_frame(mean, q, dims, labels))


def test_gridspec_and_hdi_band():
    _assert_same_figure(port.prepare_gridspec_figure(5, 3, sharex=True,
                                                     suptitle="s")[0],
                        ref.prepare_gridspec_figure(5, 3, sharex=True,
                                                    suptitle="s")[0])
    draws = RNG.standard_normal((100, 4))
    for a, b in zip(port._hdi_band(draws, 0.8), ref._hdi_band(draws, 0.8)):
        _close(a, b, "hdi")


def test_timeseries():
    values = RNG.standard_normal((30, 3))
    names = ["Y", "C", "I"]
    df = pd.DataFrame(values, columns=names)
    _assert_same_figure(port.plot_timeseries(torch.as_tensor(values),
                                             names=names, lw=0.7),
                        ref.plot_timeseries(df, lw=0.7))
    _assert_same_figure(
        port.plot_timeseries(LabeledMatrix(torch.as_tensor(values),
                                           list(range(30)), names),
                             variables=["C"]),
        ref.plot_timeseries(df, variables=["C"]))


def test_simulation():
    values = RNG.standard_normal((5, 12, 2))
    idx = pd.MultiIndex.from_product([range(5), range(12)],
                                     names=["simulation", "time"])
    df = pd.DataFrame(values.reshape(60, 2), index=idx, columns=["Y", "C"])
    sims = Simulations(torch.as_tensor(values), ["Y", "C"])
    for kw in (dict(ci=0.8), dict(variables=["Y"], n_paths=3)):
        _assert_same_figure(port.plot_simulation(sims, **kw),
                            ref.plot_simulation(df, **kw))


@pytest.mark.parametrize("kw", [dict(), dict(group_by="shock"),
                                dict(variables=["Y"], shocks=["eps_a"],
                                     cumulative=True, legend=False)])
def test_irf(kw):
    values = RNG.standard_normal((2, 8, 2))       # shocks, time, variables
    idx = pd.MultiIndex.from_product([["eps_a", "eps_b"], range(8)],
                                     names=["shock", "time"])
    df = pd.DataFrame(values.reshape(16, 2), index=idx, columns=["Y", "C"])
    irf = ImpulseResponses(torch.as_tensor(values), ["eps_a", "eps_b"],
                           ["Y", "C"])
    _assert_same_figure(port.plot_irf(irf, **kw), ref.plot_irf(df, **kw))
    bands, frame = _bands((2, 2, 8), ("shock", "variable", "time"),
                          (["eps_a", "eps_b"], ["Y", "C"], range(8)))
    _assert_same_figure(port.plot_irf(bands, **kw), ref.plot_irf(frame, **kw))


def test_eigenvalues():
    table = {"real": np.array([0.5, -0.3, 1.2, 0.99, np.inf]),
             "imag": np.array([0.1, 0.0, 0.0, 0.0, 0.0])}
    table["modulus"] = np.hypot(table["real"], table["imag"])
    _assert_same_figure(port.plot_eigenvalues(table, annotate_near=0.05),
                        ref.plot_eigenvalues(pd.DataFrame(table),
                                             annotate_near=0.05))


def _solvability():
    names = ["alpha", "beta", "rho"]
    draws = RNG.uniform(size=(40, 3))
    stages = ["steady_state", "linearization", "policy_solve", "stability",
              "residual_norms"]
    flags = RNG.uniform(size=(40, 5)) > 0.15
    success = flags.all(axis=1)
    first = [stages[int(np.argmin(f))] if not s else "none"
             for f, s in zip(flags, success)]
    norms = RNG.uniform(size=(40, 3))
    table = SolvabilityTable(
        names, torch.as_tensor(draws),
        *(torch.as_tensor(flags[:, i]) for i in range(5)),
        torch.as_tensor(success), first,
        *(torch.as_tensor(norms[:, i]) for i in range(3)))
    df = pd.DataFrame(draws, columns=names)
    for i, s in enumerate(stages):
        df[s] = flags[:, i]
    df["success"] = success
    df["failure_stage"] = first
    for i, c in enumerate(["spectral_radius", "deterministic_norm",
                           "stochastic_norm"]):
        df[c] = norms[:, i]
    return table, df


def test_solvability():
    table, df = _solvability()
    _assert_same_figure(port.plot_solvability(table),
                        ref.plot_solvability(df))
    _assert_same_figure(port.plot_solvability(table, params=["rho", "alpha"]),
                        ref.plot_solvability(df, params=["rho", "alpha"]))
    _assert_same_figure(port.plot_solvability_summary(table),
                        ref.plot_solvability_summary(df))


def test_heatmap_and_covariance():
    values = RNG.standard_normal((3, 4))
    rows, cols = ["K", "A", "C"], ["a", "b", "c", "d"]
    df = pd.DataFrame(values, index=rows, columns=cols)
    _assert_same_figure(
        port.plot_heatmap(LabeledMatrix(torch.as_tensor(values), rows, cols)),
        ref.plot_heatmap(df))
    cov = RNG.standard_normal((3, 3))
    cov = cov @ cov.T
    _assert_same_figure(
        port.plot_covariance_matrix(LabeledMoments(torch.as_tensor(cov),
                                                   rows), annotate=False),
        ref.plot_covariance_matrix(pd.DataFrame(cov, index=rows,
                                                columns=rows),
                                   annotate=False))


def test_estimated_matrix_and_corner():
    arr = RNG.standard_normal((200, 2, 2))
    kw = dict(index=["x", "y"], columns=["u", "v"])
    _assert_same_figure(port.plot_estimated_matrix(torch.as_tensor(arr), **kw),
                        ref.plot_estimated_matrix(arr, **kw))
    samples = RNG.standard_normal((2, 100, 3))
    kw = dict(names=["a", "b", "c"], truths={"a": 0.1, "c": -0.2})
    _assert_same_figure(port.plot_corner(torch.as_tensor(samples), **kw),
                        ref.plot_corner(samples, **kw))


def test_acf():
    n_lags, names = 5, ["Y", "C"]
    acf = RNG.uniform(-1, 1, size=(n_lags, 2, 2))
    idx = pd.MultiIndex.from_product([range(n_lags), names],
                                     names=["lag", "variable"])
    df = pd.DataFrame(acf.reshape(n_lags * 2, 2), index=idx, columns=names)
    _assert_same_figure(
        port.plot_acf(LabeledMoments(torch.as_tensor(acf), names), n_obs=100),
        ref.plot_acf(df, n_obs=100))
    bands, frame = _bands((n_lags, 2), ("lag", "variable"),
                          (range(n_lags), names))
    _assert_same_figure(port.plot_acf(bands), ref.plot_acf(frame))


def test_kalman_filter():
    periods, n = 20, 3
    fields = {
        "filtered_mean": RNG.standard_normal((periods, n)),
        "filtered_cov": np.abs(RNG.standard_normal((periods, n, n))),
        "predicted_mean": RNG.standard_normal((periods, n)),
        "predicted_cov": np.abs(RNG.standard_normal((periods, n, n)))}
    res = KalmanFilterResult(torch.zeros(()), torch.zeros(periods),
                             **{k: torch.as_tensor(v) for k, v in fields.items()})
    ref_res = KalmanFilterResult(None, None, **fields)
    data = RNG.standard_normal((periods, 2))
    kw = dict(state_names=["K", "A", "C"], kind=("filtered", "predicted"),
              observed_idx=[0, 2], n_sd=2.0)
    _assert_same_figure(port.plot_kalman_filter(res, torch.as_tensor(data),
                                                **kw),
                        ref.plot_kalman_filter(ref_res, data, **kw))


PRIORS = [("Normal", dict(mu=0.2, sigma=0.5)), ("Gamma", dict(alpha=3.0,
                                                               beta=2.0)),
          ("Beta", dict(alpha=2.0, beta=5.0)),
          ("InverseGamma", dict(alpha=4.0, beta=0.3))]


def _priors(module):
    return {name.lower(): getattr(module, name)(**kw) for name, kw in PRIORS}


def test_priors_and_posterior():
    _assert_same_figure(port.plot_priors(_priors(port_dists)),
                        ref.plot_priors(_priors(ref_dists)))

    class Result:
        param_names = ["normal", "gamma", "other"]
        samples = np.abs(RNG.standard_normal((3, 50, 3))) + 0.1

    for kw in (dict(true_values={"gamma": 1.0}), dict(per_chain=True)):
        _assert_same_figure(
            port.plot_posterior_with_prior(Result(), _priors(port_dists), **kw),
            ref.plot_posterior_with_prior(Result(), _priors(ref_dists), **kw))


def test_eigenvalue_sensitivity():
    names = ["alpha", "beta", "rho"]
    d_rho = RNG.standard_normal(3)
    _assert_same_figure(
        port.plot_eigenvalue_sensitivity(RadiusSensitivity(
            torch.as_tensor(d_rho), names)),
        ref.plot_eigenvalue_sensitivity(pd.DataFrame({"d_rho_d_param": d_rho},
                                                     index=names)))
    m = 8
    parts = {p: RNG.standard_normal((m, 3)) for p in ("real", "imag",
                                                       "modulus")}
    moduli = RNG.uniform(0.2, 1.5, size=m)
    lam = moduli * np.exp(1j * RNG.uniform(0, np.pi, size=m))
    port_sens = EigenvalueSensitivity(
        *(torch.as_tensor(parts[p]) for p in ("real", "imag", "modulus")),
        torch.as_tensor(lam), torch.as_tensor(moduli), names)
    table = np.stack([parts["real"], parts["imag"], parts["modulus"]], axis=1)
    idx = pd.MultiIndex.from_product([range(m), ["real", "imag", "modulus"]],
                                     names=["eigenvalue", "part"])
    df = pd.DataFrame(table.reshape(m * 3, 3), index=idx, columns=names)
    df.attrs["eigenvalues"] = lam
    df.attrs["modulus"] = moduli
    _assert_same_figure(port.plot_eigenvalue_sensitivity(port_sens, n_eigs=4),
                        ref.plot_eigenvalue_sensitivity(df, n_eigs=4))


def test_perfect_foresight():
    traj = RNG.standard_normal((12, 3))
    time = list(range(-1, 11))
    res = PerfectForesightResult(torch.as_tensor(traj), True, 3, 1e-12,
                                 ["Y", "C", "K"], time)

    class RefResult:
        trajectory = pd.DataFrame(traj, index=time, columns=["Y", "C", "K"])

    _assert_same_figure(port.plot_perfect_foresight(res, variables=["C", "K"]),
                        ref.plot_perfect_foresight(RefResult(),
                                                   variables=["C", "K"]))


def test_shock_decomposition():
    shocks, names, periods = ["e_a", "e_b"], ["Y", "C", "K"], 10
    contrib = RNG.standard_normal((2, periods, 3))
    initial = RNG.standard_normal((periods, 3))
    smoothed = contrib.sum(axis=0) + initial
    dec = ShockDecomposition(torch.as_tensor(contrib), torch.as_tensor(initial),
                             torch.as_tensor(smoothed), shocks, names)
    idx = pd.MultiIndex.from_product([range(periods), names],
                                     names=["time", "variable"])
    df = pd.DataFrame({s: contrib[i].reshape(-1) for i, s in enumerate(shocks)},
                      index=idx)
    df["initial"] = initial.reshape(-1)
    df["smoothed"] = smoothed.reshape(-1)
    _assert_same_figure(port.plot_shock_decomposition(dec, variables=["Y", "K"]),
                        ref.plot_shock_decomposition(df, variables=["Y", "K"]))


def test_forecast():
    names, horizon = ["y", "pinf"], 6
    bands, frame = _bands((2, horizon), ("variable", "time"),
                          (names, range(1, horizon + 1)))
    data = RNG.standard_normal((50, 2))
    kw = dict(observed_names=names, history=20)
    _assert_same_figure(port.plot_forecast(bands, torch.as_tensor(data), **kw),
                        ref.plot_forecast(frame, data, **kw))
    _assert_same_figure(port.plot_forecast(bands), ref.plot_forecast(frame))


def test_every_public_function_is_covered():
    covered = {"prepare_gridspec_figure", "plot_timeseries", "plot_simulation",
               "plot_irf", "plot_eigenvalues", "plot_solvability",
               "plot_solvability_summary", "plot_covariance_matrix",
               "plot_heatmap", "plot_acf", "plot_corner", "plot_kalman_filter",
               "plot_priors", "plot_posterior_with_prior",
               "plot_estimated_matrix", "plot_eigenvalue_sensitivity",
               "plot_perfect_foresight", "plot_shock_decomposition",
               "plot_forecast"}
    assert set(port.__all__) == set(ref.__all__) == covered
