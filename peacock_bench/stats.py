"""Percentiles as the benchmark states them."""
from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float:
    """The q-th percentile (0–100) of ``values`` by linear interpolation
    between the closest ranks (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))
