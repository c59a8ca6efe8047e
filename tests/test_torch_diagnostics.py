"""Port parity: MCMC diagnostics (``geconpy_torch/stats/diagnostics.py``).

``_split_chains``, ``split_rhat``, ``_autocovariance_fft`` and
``effective_sample_size`` are the reference's numpy code, held to it by
AST; ``summarize_chains`` returns a plain dict whose numbers equal the
reference's ``pandas.DataFrame`` column by column.  The sanity checks of
``tests/stats/test_nuts.py`` (iid draws, a stuck chain, an AR(1) chain)
run on the port's copies.
"""

import ast
import inspect
import textwrap

import numpy as np
import pytest

from geconpy_torch.stats import diagnostics as port
from geconpy_tpu.stats import diagnostics as ref

COPIED = ["_split_chains", "split_rhat", "_autocovariance_fft",
          "effective_sample_size"]


def _dump(fn):
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    return ast.dump(tree)


@pytest.mark.parametrize("name", COPIED)
def test_copied_function_is_the_reference_code(name):
    assert _dump(getattr(port, name)) == _dump(getattr(ref, name))


def _draws(seed=0, shape=(4, 301, 3)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    x[..., 1] = np.cumsum(x[..., 1], axis=1) * 0.1      # autocorrelated
    x[1, :, 2] += 0.5                                   # one shifted chain
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_summary_numbers_match_the_reference_frame(seed):
    samples = _draws(seed)
    names = ["a", "b", "c"]
    got = port.summarize_chains(samples, names)
    want = ref.summarize_chains(samples, names)
    assert isinstance(got, dict)
    assert got["names"] == list(want.index)
    assert tuple(k for k in got if k != "names") == tuple(want.columns)
    for col in want.columns:
        np.testing.assert_array_equal(got[col], want[col].to_numpy())


def test_summary_default_names():
    samples = np.random.default_rng(2).standard_normal((2, 40, 2))
    got = port.summarize_chains(samples)
    assert got["names"] == ["x0", "x1"]
    assert got["ess"].shape == (2,)


def test_diagnostics_sane():
    rng = np.random.default_rng(0)
    good = rng.normal(size=(4, 1000))
    assert port.split_rhat(good) < 1.01
    assert port.effective_sample_size(good) > 2000
    bad = good.copy()
    bad[0] += 10.0
    assert port.split_rhat(bad) > 1.5
    ar = np.zeros((2, 2000))
    eps = rng.normal(size=(2, 2000))
    for t in range(1, 2000):
        ar[:, t] = 0.95 * ar[:, t - 1] + eps[:, t]
    assert port.effective_sample_size(ar) < 600
    assert port.split_rhat(np.ones((2, 10))) == np.inf
