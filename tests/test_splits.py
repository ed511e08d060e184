"""The in-repo split/scaler twins reproduce scikit-learn index-for-index
(sklearn is a test oracle only)."""

import numpy as np
import pytest

from dqgp.data.splits import kfold_indices, standardize, train_test_split


@pytest.mark.parametrize("n,k,seed", [
    (10, 2, 0), (10, 3, 0), (250, 5, 42), (1000, 5, 43), (7, 7, 3),
    (101, 4, 2**31 - 1),
])
def test_kfold_matches_sklearn(n, k, seed):
    from sklearn.model_selection import KFold

    got = list(kfold_indices(n, k, seed))
    want = list(KFold(n_splits=k, shuffle=True, random_state=seed)
                .split(np.arange(n)))
    assert len(got) == len(want) == k
    for (tr, va), (tr_w, va_w) in zip(got, want):
        np.testing.assert_array_equal(tr, tr_w)
        np.testing.assert_array_equal(va, va_w)


@pytest.mark.parametrize("n,k", [(3, 4), (5, 1)])
def test_kfold_rejects_infeasible_folds(n, k):
    with pytest.raises(ValueError):
        list(kfold_indices(n, k, 0))


@pytest.mark.parametrize("n,test_size,seed", [
    (1000, 0.1, 42), (37, 0.25, 3), (11, 0.5, 0), (1111, 0.1, 7),
    (20, 0.05, 1),
])
def test_train_test_split_matches_sklearn(n, test_size, seed):
    from sklearn.model_selection import train_test_split as sk_split

    rng = np.random.RandomState(seed)
    X, Y, idx = rng.rand(n, 2), rng.rand(n), np.arange(n)
    got = train_test_split(X, Y, idx, test_size=test_size, random_state=seed)
    want = sk_split(X, Y, idx, test_size=test_size, random_state=seed,
                    shuffle=True)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(50, 3), (64,)])
def test_standardize_matches_standard_scaler(shape):
    from sklearn.preprocessing import StandardScaler

    a = np.random.RandomState(0).rand(*shape) * 7.0 - 2.0
    if a.ndim == 2:
        a[:, 1] = 2.5  # constant column: centred, left unscaled
    want = StandardScaler().fit_transform(a.reshape(len(a), -1))
    np.testing.assert_allclose(standardize(a).reshape(len(a), -1), want,
                               rtol=1e-12, atol=1e-12)
