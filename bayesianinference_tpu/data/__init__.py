"""Small datasets shipped with the package (no download, no extra
dependency): Fisher's Iris, 150 rows x 4 features, 3 classes."""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

__all__ = ["Iris", "load_iris"]


class Iris(NamedTuple):
    data: np.ndarray  # [150, 4] float64
    target: np.ndarray  # [150] int64


def load_iris() -> Iris:
    """``Iris(data [150, 4] float64, target [150] int64)`` — sepal length/width
    and petal length/width in cm; target 0 = setosa, 1 = versicolor,
    2 = virginica (the same rows and order as scikit-learn's copy)."""
    path = os.path.join(os.path.dirname(__file__), "iris.csv")
    raw = np.loadtxt(path, delimiter=",", skiprows=1)
    return Iris(raw[:, :4], raw[:, 4].astype(np.int64))
