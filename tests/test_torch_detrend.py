"""Port parity: the detrending filters (``geconpy_torch/stats/detrend.py``).

The port's module is the reference's numpy code with the package name
changed (``tests/test_torch_frontend.py`` checks the AST).  Here the same
numpy-seeded series and panels go through both packages' ``hp_filter``,
``one_sided_hp_filter`` and ``hamilton_filter`` (trend and cycle within
1e-10, NaN layout equal), then the reference test's contracts
(``tests/stats/test_detrend.py``) run on the port: exact identities, the
linear-trend pass-through, the large-lambda limit, panel == per-series and
the input checks.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

from geconpy_torch.stats import detrend as port
from geconpy_tpu.stats import detrend as ref

FILTERS = {"hp_filter": {"lam": 1600.0}, "one_sided_hp_filter": {"lam": 1600.0},
           "hamilton_filter": {"h": 8, "p": 4}}


def _series(seed: int, shape):
    rng = np.random.default_rng(seed)
    T = shape[0]
    drift = (0.5 * np.arange(T, dtype=float) + 3.0).reshape(
        (T,) + (1,) * (len(shape) - 1))
    return drift + rng.normal(size=shape).cumsum(axis=0)


@pytest.mark.parametrize("name", list(FILTERS))
@pytest.mark.parametrize("shape", [(120,), (60, 3)])
def test_matches_reference(name, shape):
    y = _series(sum(shape), shape)
    for kw in (FILTERS[name], {}):
        t_p, c_p = getattr(port, name)(y, **kw)
        t_r, c_r = getattr(ref, name)(y, **kw)
        assert t_p.shape == t_r.shape == y.shape
        np.testing.assert_array_equal(np.isnan(t_p), np.isnan(t_r))
        np.testing.assert_allclose(t_p, t_r, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(c_p, c_r, rtol=1e-10, atol=1e-10)


def test_hp_identities():
    t = np.arange(120, dtype=float)
    line = 0.5 * t + 3.0
    trend, cycle = port.hp_filter(line)
    np.testing.assert_allclose(trend, line, atol=1e-8)
    np.testing.assert_allclose(cycle, 0.0, atol=1e-8)
    y = line + np.random.default_rng(0).normal(size=120)
    trend, cycle = port.hp_filter(y)
    np.testing.assert_allclose(trend + cycle, y, atol=1e-10)
    # a huge lambda leaves the OLS line
    y = line[:80] + np.random.default_rng(1).normal(size=80)
    trend, _ = port.hp_filter(y, lam=1e12)
    X = np.column_stack([np.ones(80), np.arange(80)])
    np.testing.assert_allclose(trend, X @ np.linalg.lstsq(X, y, rcond=None)[0],
                               atol=1e-3)


@pytest.mark.parametrize("name", list(FILTERS))
def test_panel_matches_per_series(name):
    Y = np.random.default_rng(2).normal(size=(60, 3)).cumsum(axis=0)
    trend, cycle = getattr(port, name)(Y)
    for j in range(3):
        tj, cj = getattr(port, name)(Y[:, j])
        np.testing.assert_allclose(trend[:, j], tj)
        np.testing.assert_allclose(cycle[:, j], cj)


def test_one_sided_tracks_linear_trend():
    y = 0.5 * np.arange(200, dtype=float) + 3.0
    trend, _ = port.one_sided_hp_filter(y)
    np.testing.assert_allclose(trend[50:], y[50:], atol=1e-2)


def test_one_sided_uses_no_future_data():
    """Changing y after t leaves the one-sided trend up to t unchanged."""
    y = _series(3, (80,))
    y2 = y.copy()
    y2[50:] += 10.0
    t1, _ = port.one_sided_hp_filter(y)
    t2, _ = port.one_sided_hp_filter(y2)
    np.testing.assert_array_equal(t1[:50], t2[:50])


def test_hamilton_nan_layout_and_linear_recovery():
    y = 0.5 * np.arange(100, dtype=float) + 3.0
    trend, cycle = port.hamilton_filter(y, h=8, p=4)
    assert np.isnan(trend[:11]).all() and np.isnan(cycle[:11]).all()
    np.testing.assert_allclose(cycle[11:], 0.0, atol=1e-8)


def test_input_checks():
    with pytest.raises(ValueError):
        port.hp_filter(np.array([1.0, np.nan, 3.0, 4.0]))
    with pytest.raises(ValueError):
        port.hp_filter(np.array([1.0, 2.0]))
    with pytest.raises(ValueError, match="h \\+ p"):
        port.hamilton_filter(np.arange(10.0), h=8, p=4)
    with pytest.raises(ValueError, match="fully observed"):
        port.one_sided_hp_filter(np.array([1.0, np.nan, 3.0]))
