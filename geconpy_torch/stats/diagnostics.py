"""MCMC convergence diagnostics: split R-hat and effective sample size.

Mirrors ``geconpy_tpu/stats/diagnostics.py``: ``_split_chains`` (:16),
``split_rhat`` (:23), ``_autocovariance_fft`` (:40) and
``effective_sample_size`` (:49) are the reference's numpy code unchanged
(``tests/test_torch_diagnostics.py`` holds them to it by AST).
``summarize_chains`` (:77) returns a plain dict where the reference
returns a ``pandas.DataFrame``: the port imports no pandas.
"""

from __future__ import annotations

import numpy as np

__all__ = ["split_rhat", "effective_sample_size", "summarize_chains"]


def _split_chains(x: np.ndarray) -> np.ndarray:
    """(chains, draws) -> (2*chains, draws//2)"""
    c, n = x.shape
    half = n // 2
    return np.concatenate([x[:, :half], x[:, half:2 * half]], axis=0)


def split_rhat(x: np.ndarray) -> float:
    """Gelman-Rubin potential scale reduction on split chains.

    x: (chains, draws) for one scalar quantity.
    """
    x = _split_chains(np.asarray(x, dtype=float))
    m, n = x.shape
    chain_means = x.mean(axis=1)
    chain_vars = x.var(axis=1, ddof=1)
    W = chain_vars.mean()
    B = n * chain_means.var(ddof=1)
    var_hat = (n - 1) / n * W + B / n
    if W <= 0:
        return np.inf
    return float(np.sqrt(var_hat / W))


def _autocovariance_fft(x: np.ndarray) -> np.ndarray:
    n = x.shape[-1]
    xc = x - x.mean(axis=-1, keepdims=True)
    size = 2 ** int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, size, axis=-1)
    acov = np.fft.irfft(f * np.conj(f), size, axis=-1)[..., :n]
    return acov / n


def effective_sample_size(x: np.ndarray) -> float:
    """ESS via the Geyer initial monotone sequence over pooled split chains."""
    x = _split_chains(np.asarray(x, dtype=float))
    m, n = x.shape
    acov = _autocovariance_fft(x)
    chain_var = acov[:, 0] * n / (n - 1)
    mean_var = chain_var.mean()
    var_plus = mean_var * (n - 1) / n + x.mean(axis=1).var(ddof=1)
    if var_plus <= 0:
        return float(m * n)

    rho = 1.0 - (mean_var - acov.mean(axis=0)) / var_plus
    # Geyer: sum consecutive pairs while positive and monotone
    tau = 1.0
    prev_pair = np.inf
    t = 1
    while t + 1 < n:
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        pair = min(pair, prev_pair)
        prev_pair = pair
        tau += 2.0 * pair
        t += 2
    ess = m * n / tau
    return float(min(ess, m * n))


SUMMARY_COLUMNS = ("mean", "sd", "hdi_3%", "hdi_97%", "ess", "r_hat")


def summarize_chains(samples: np.ndarray, names: list[str] | None = None
                     ) -> dict[str, np.ndarray | list[str]]:
    """samples: (chains, draws, dim) -> the reference's per-parameter table
    as a plain dict: ``"names"`` (the row labels) and one float64 array of
    length dim per column of :data:`SUMMARY_COLUMNS`, with the reference's
    numbers."""
    samples = np.asarray(samples)
    c, n, d = samples.shape
    names = names or [f"x{i}" for i in range(d)]
    cols = {k: np.empty(d) for k in SUMMARY_COLUMNS}
    for i in range(d):
        x = samples[:, :, i]
        flat = x.reshape(-1)
        cols["mean"][i] = flat.mean()
        cols["sd"][i] = flat.std(ddof=1)
        cols["hdi_3%"][i] = np.percentile(flat, 3)
        cols["hdi_97%"][i] = np.percentile(flat, 97)
        cols["ess"][i] = effective_sample_size(x)
        cols["r_hat"][i] = split_rhat(x)
    return {"names": list(names), **cols}
