"""Relational-table search (paper Example 2.1, section V-C, Adult experiment).

Continuous attributes are discretized into equal-width bins (the paper uses
1024); categorical attributes are integer codes.  A query is a per-attribute
range [lo, hi] (the paper's Adult queries use value +- 50 bins); the match
count is the number of attributes whose value falls in the query range --
computed by the RANGE engine without materialising the (attribute, value)
inverted index.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Discretizer:
    mins: np.ndarray      # [d]
    maxs: np.ndarray      # [d]
    n_bins: int

    def transform(self, values: np.ndarray) -> np.ndarray:
        span = np.maximum(self.maxs - self.mins, 1e-12)
        bins = np.floor((values - self.mins) / span * self.n_bins).astype(np.int32)
        return np.clip(bins, 0, self.n_bins - 1)


def fit_discretizer(values: np.ndarray, n_bins: int = 1024) -> Discretizer:
    return Discretizer(mins=values.min(axis=0), maxs=values.max(axis=0), n_bins=n_bins)


def point_range_queries(
    discrete_tuples: np.ndarray, radius: int = 50, n_bins: int = 1024
) -> tuple[np.ndarray, np.ndarray]:
    """Paper's Adult query model: [value - radius, value + radius] per attribute."""
    lo = np.clip(discrete_tuples - radius, 0, n_bins - 1).astype(np.int32)
    hi = np.clip(discrete_tuples + radius, 0, n_bins - 1).astype(np.int32)
    return lo, hi


def exact_range_count(data: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Oracle: counts [Q, N] = #attributes of each tuple inside each range."""
    hit = (data[None, :, :] >= lo[:, None, :]) & (data[None, :, :] <= hi[:, None, :])
    return hit.sum(axis=-1).astype(np.int32)
