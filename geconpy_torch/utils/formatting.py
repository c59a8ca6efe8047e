"""Labeling helpers for model matrices.

Mirrors ``geconpy_tpu/utils/formatting.py`` (``matrix_to_dataframe`` :17):
attach variable / shock / equation names to a raw matrix.  The reference
returns a ``pandas.DataFrame``; the port imports no pandas and returns a
:class:`LabeledMatrix`, the tensor with its row and column names.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["LabeledMatrix", "matrix_to_dataframe"]


class LabeledMatrix(NamedTuple):
    """A 2-D tensor with its row (``index``) and column names."""

    values: torch.Tensor
    index: list[str]
    columns: list[str]


def matrix_to_dataframe(matrix, model, dim1: str | None = None,
                        dim2: str | None = None,
                        round: int | None = None) -> LabeledMatrix:
    """Label a 2-D model matrix with variable / shock / equation names.

    Dimension names are one of ``'variable'``, ``'shock'``, ``'equation'``;
    when omitted they are inferred from the matrix shape (``variable`` wins
    over ``equation`` on ties, matching the reference).  ``round`` rounds
    the values to that many decimals (``torch.round``, half to even, as
    pandas rounds).
    """
    matrix = torch.as_tensor(matrix)
    if matrix.ndim != 2:
        raise ValueError("matrix must be 2-dimensional")

    coords = {
        "variable": list(model.variables),
        "shock": list(model.shocks),
        "equation": [f"Equation {i}"
                     for i in range(len(model.primitives.equations))],
    }
    n_variables = len(coords["variable"])
    n_shocks = len(coords["shock"])

    def infer(size: int, which: str) -> str:
        if size == n_variables:
            return "variable"
        if size == n_shocks:
            return "shock"
        raise ValueError(
            f"{which} dimension ({size}) matches neither the number of "
            f"variables ({n_variables}) nor shocks ({n_shocks})")

    dim1 = dim1 or infer(matrix.shape[0], "first")
    dim2 = dim2 or infer(matrix.shape[1], "second")
    for d, size in ((dim1, matrix.shape[0]), (dim2, matrix.shape[1])):
        if d not in coords:
            raise ValueError(f"unknown dimension name {d!r}")
        if len(coords[d]) != size:
            raise ValueError(f"dimension {d!r} has {len(coords[d])} labels "
                             f"but the matrix axis has {size}")

    values = matrix if round is None else torch.round(matrix, decimals=round)
    return LabeledMatrix(values, coords[dim1], coords[dim2])
