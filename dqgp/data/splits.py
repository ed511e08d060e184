"""Seeded splits and scaling, index-for-index twins of the scikit-learn calls
the reference makes: ``KFold(shuffle=True)`` for CV folds,
``train_test_split`` for the train/test split and
``StandardScaler().fit_transform`` for real-world dataset normalisation.

The reference's CV folds and train/test split are part of its trajectory, so
these reproduce sklearn's RNG use exactly: one ``RandomState(seed)`` shuffle
(folds) or permutation (split) per call.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple

import numpy as np


def _rng(seed: Optional[int]) -> np.random.RandomState:
    # sklearn's check_random_state: None means numpy's global RandomState
    return np.random.mtrand._rand if seed is None else np.random.RandomState(seed)


def kfold_indices(n: int, k: int, seed: Optional[int]
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(train, test) index pairs of ``KFold(k, shuffle=True, random_state=seed)
    .split(range(n))``: the first ``n % k`` folds hold one extra sample, and
    both index sets come back sorted."""
    if k < 2:
        raise ValueError(f"k-fold cross-validation needs k >= 2, got {k}")
    if k > n:
        raise ValueError(
            f"Cannot have number of splits n_splits={k} greater than the "
            f"number of samples: n_samples={n}.")
    order = np.arange(n)
    _rng(seed).shuffle(order)
    sizes = np.full(k, n // k, dtype=int)
    sizes[: n % k] += 1
    start = 0
    for size in sizes:
        test = np.zeros(n, bool)
        test[order[start:start + size]] = True
        start += size
        yield np.flatnonzero(~test), np.flatnonzero(test)


def train_test_split(*arrays, test_size: float, random_state: Optional[int]):
    """``sklearn.model_selection.train_test_split(*arrays, test_size=...,
    random_state=..., shuffle=True)``: the first ``ceil(test_size * n)``
    entries of one seeded permutation are the test rows. Returns
    ``[a0_train, a0_test, a1_train, a1_test, ...]``."""
    n = len(arrays[0])
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size must be in (0, 1), got {test_size}")
    n_test = math.ceil(test_size * n)
    if n_test >= n:
        raise ValueError(
            f"test_size={test_size} with n_samples={n} leaves an empty "
            f"train set")
    perm = _rng(random_state).permutation(n)
    test, train = perm[:n_test], perm[n_test:]
    out = []
    for a in arrays:
        if len(a) != n:
            raise ValueError("all arrays must have the same length")
        out += [a[train], a[test]]
    return out


def standardize(a: np.ndarray) -> np.ndarray:
    """``StandardScaler().fit_transform``: per-column zero mean and unit
    (ddof 0) variance; a constant column is centred and left unscaled."""
    a = np.asarray(a, np.float64)
    scale = a.std(axis=0)
    scale = np.where(scale == 0.0, 1.0, scale)
    return (a - a.mean(axis=0)) / scale
