"""GP core tests: posterior vs direct numpy math, NLL + gradient vs a numpy
oracle implementing the reference formulas, masking equivalence, CV plumbing."""

import numpy as np
import jax.numpy as jnp
import pytest

from dqgp.models.circuits import build_circuit
from dqgp.models.gp import (
    evaluate_predictions,
    k_fold_cross_validation_consensus,
    predict_quantum_gp,
)
from dqgp.models.gp.posterior import gp_posterior_from_grams, masked_nll_and_grad
from dqgp.models.kernels import QuantumKernelSpec, gram, gram_and_shift_grads


def _spec(kernel_type="projected", **kw):
    return QuantumKernelSpec(
        circuit=build_circuit("hubregtsen", 3, 2, 1),
        kernel_type=kernel_type, outer_kernel=kw.pop("outer_kernel", "gaussian"), **kw
    )


def _toy(N=12, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.uniform(-0.9, 0.9, (N, 2))
    Y = np.sin(2 * X[:, 0]) + 0.1 * rng.randn(N)
    theta = rng.uniform(0, np.pi, 6)
    return X, Y, theta


def ref_nll_and_grad(K, dK, y, noise_std):
    """Numpy oracle of agent_riemannian.py:409-460."""
    C = K + noise_std**2 * np.eye(len(y))
    L = np.linalg.cholesky(C)
    C_inv_y = np.linalg.solve(L.T, np.linalg.solve(L, y))
    C_inv = np.linalg.solve(L.T, np.linalg.solve(L, np.eye(len(y))))
    bracket = C_inv - np.outer(C_inv_y, C_inv_y)
    grad = 0.5 * np.array([np.sum(bracket * dK[i].T) for i in range(dK.shape[0])])
    sign, log_det = np.linalg.slogdet(C)
    nll = 0.5 * log_det + 0.5 * y @ C_inv_y + 0.5 * len(y) * np.log(2 * np.pi)
    return nll, grad, 0.5 * log_det, 0.5 * y @ C_inv_y


@pytest.mark.slow
def test_nll_and_grad_vs_oracle():
    spec = _spec()
    X, Y, theta = _toy()
    K, dK = gram_and_shift_grads(spec, jnp.asarray(X), jnp.asarray(theta))
    Kn, dKn = np.asarray(K, np.float64), np.asarray(dK, np.float64)
    res = masked_nll_and_grad(
        jnp.asarray(Kn), jnp.asarray(dKn), jnp.asarray(Y),
        jnp.ones(len(Y)), noise_std=0.1,
    )
    nll, grad, ld, quad = ref_nll_and_grad(Kn, dKn, Y, 0.1)
    assert np.isclose(float(res.nll), nll, rtol=1e-8)
    np.testing.assert_allclose(np.asarray(res.grad), grad, rtol=1e-6, atol=1e-9)
    assert np.isclose(float(res.log_det_term), ld, rtol=1e-8)
    assert np.isclose(float(res.quadratic_term), quad, rtol=1e-8)
    # condition number vs numpy (computed in f32 — reporting-only quantity)
    assert np.isclose(float(res.condition_number), np.linalg.cond(Kn), rtol=1e-3)


@pytest.mark.slow
def test_nll_masking_equivalence():
    """Padded+masked NLL/grad must equal the unpadded computation."""
    spec = _spec()
    X, Y, theta = _toy(N=10)
    K, dK = gram_and_shift_grads(spec, jnp.asarray(X), jnp.asarray(theta))
    K, dK = np.asarray(K, np.float64), np.asarray(dK, np.float64)

    res_full = masked_nll_and_grad(jnp.asarray(K), jnp.asarray(dK),
                                   jnp.asarray(Y), jnp.ones(10), 0.1)
    # pad to 16 with garbage
    P = 16
    Kp = np.full((P, P), 7.7); Kp[:10, :10] = K
    dKp = np.full((dK.shape[0], P, P), -3.3); dKp[:, :10, :10] = dK
    Yp = np.full(P, 9.9); Yp[:10] = Y
    mask = np.zeros(P); mask[:10] = 1
    res_pad = masked_nll_and_grad(jnp.asarray(Kp), jnp.asarray(dKp),
                                  jnp.asarray(Yp), jnp.asarray(mask), 0.1)
    assert np.isclose(float(res_pad.nll), float(res_full.nll), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(res_pad.grad), np.asarray(res_full.grad), rtol=1e-8)


@pytest.mark.slow
def test_posterior_vs_numpy():
    spec = _spec()
    X, Y, theta = _toy(N=20)
    Xte = X[15:]; Xtr = X[:15]; Ytr = Y[:15]
    mean, var = predict_quantum_gp(spec, jnp.asarray(Xtr), jnp.asarray(Ytr),
                                   jnp.asarray(Xte), jnp.asarray(theta), noise_std=0.1)
    # numpy oracle (main.py:1433-1466)
    Ktt = np.asarray(gram(spec, jnp.asarray(Xtr), jnp.asarray(theta)), np.float64)
    Kst = np.asarray(gram(spec, jnp.asarray(Xte), jnp.asarray(theta), jnp.asarray(Xtr)), np.float64)
    Kss = np.asarray(gram(spec, jnp.asarray(Xte), jnp.asarray(theta)), np.float64)
    C = Ktt + (0.01 + 1e-6) * np.eye(15)
    L = np.linalg.cholesky(C)
    alpha = np.linalg.solve(L.T, np.linalg.solve(L, Ytr))
    want_mean = Kst @ alpha
    v = np.linalg.solve(L, Kst.T)
    want_var = np.maximum(np.diag(Kss) - np.sum(v**2, axis=0), 1e-10)
    # oracle Grams are f32 while the predict path upcasts features to f64,
    # so agreement is at f32-Gram resolution
    np.testing.assert_allclose(np.asarray(mean), want_mean, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(var), want_var, rtol=1e-2, atol=1e-5)


def test_posterior_fallback_on_indefinite_matrix():
    # Force a non-PSD "Gram": the chol path NaNs, the fallback must recover.
    K = np.array([[1.0, 2.0], [2.0, 1.0]])  # indefinite
    Kst = np.array([[0.5, 0.5]])
    mean, var, ok = gp_posterior_from_grams(
        jnp.asarray(K), jnp.asarray(Kst), jnp.asarray([1.0]),
        jnp.asarray([1.0, -1.0]), noise_std=0.0, jitter=0.0,
    )
    assert not bool(ok)
    C_inv = np.linalg.pinv(K)
    np.testing.assert_allclose(float(mean[0]), (Kst @ C_inv @ np.array([1.0, -1.0]))[0], atol=1e-6)


def test_cv_consensus_runs_and_scores():
    spec = _spec()
    X, Y, theta = _toy(N=30, seed=3)
    out = k_fold_cross_validation_consensus(spec, X, Y, theta, noise_std=0.1,
                                            k_folds=5, random_seed=42)
    assert out["valid_folds"] == 5
    assert np.isfinite(out["mean_nlpd"])
    assert out["mean_rmse"] > 0
    # same seed reproduces, different seed changes folds
    out2 = k_fold_cross_validation_consensus(spec, X, Y, theta, noise_std=0.1,
                                             k_folds=5, random_seed=42)
    assert out["mean_nlpd"] == out2["mean_nlpd"]


@pytest.mark.slow
def test_cv_matches_unbatched_predict():
    """Fold NLPD from the vmapped CV path == naive per-fold predict path."""
    from sklearn.model_selection import KFold
    from dqgp.models.gp.metrics import nlpd

    spec = _spec()
    X, Y, theta = _toy(N=25, seed=4)
    out = k_fold_cross_validation_consensus(spec, X, Y, theta, noise_std=0.1,
                                            k_folds=5, random_seed=7)
    folds = list(KFold(5, shuffle=True, random_state=7).split(np.arange(25)))
    for f, (tr, va) in enumerate(folds):
        mean, var = predict_quantum_gp(
            spec, jnp.asarray(X[tr]), jnp.asarray(Y[tr]), jnp.asarray(X[va]),
            jnp.asarray(theta), noise_std=0.1,
        )
        want = nlpd(Y[va], np.asarray(mean), np.asarray(var))
        assert np.isclose(out["fold_nlpds"][f], want, rtol=1e-5), f


def test_evaluate_predictions_matches_sklearn():
    from sklearn.metrics import mean_absolute_error, mean_squared_error, r2_score
    rng = np.random.RandomState(0)
    y = rng.randn(50)
    yp = y + 0.3 * rng.randn(50)
    var = np.abs(rng.randn(50)) + 0.1
    m = evaluate_predictions(y, yp, var)
    assert np.isclose(m["mse"], mean_squared_error(y, yp))
    assert np.isclose(m["mae"], mean_absolute_error(y, yp))
    assert np.isclose(m["r2"], r2_score(y, yp))
    assert 0 <= m["within_1sigma"] <= 1 and 0 <= m["within_2sigma"] <= 1
    assert "nlpd" in m and np.isfinite(m["nlpd"])


@pytest.mark.slow
def test_cv_float32_mode_close_to_f64():
    spec = _spec()
    X, Y, theta = _toy(N=30, seed=8)
    a = k_fold_cross_validation_consensus(spec, X, Y, theta, noise_std=0.1,
                                          k_folds=3, random_seed=1)
    b = k_fold_cross_validation_consensus(spec, X, Y, theta, noise_std=0.1,
                                          k_folds=3, random_seed=1, cv_dtype="float32")
    assert np.isclose(a["mean_nlpd"], b["mean_nlpd"], rtol=1e-3, atol=1e-4)


def _ill_conditioned(n: int = 64, cond: float = 1e13) -> np.ndarray:
    """SPD matrix with an exactly prescribed condition number."""
    rng = np.random.RandomState(7)
    Q, _ = np.linalg.qr(rng.randn(n, n))
    w = np.logspace(0.0, -np.log10(cond), n)
    return (Q * w[None, :]) @ Q.T


def test_condition_number_resolves_moderate_bucket_eigh():
    """cond ~ 1e13 must land between the reference's 1e12/1e15 buckets
    (main.py:2629-2642) — impossible with an f32 eigendecomposition."""
    from dqgp.ops.linalg import condition_number

    A = _ill_conditioned(cond=1e13)
    c = float(condition_number(jnp.asarray(A, jnp.float64), method="eigh"))
    assert 1e12 < c < 1e15
    assert np.isclose(c, 1e13, rtol=0.1)


def test_condition_number_iterative_matches():
    """The iterative path (power + inverse iteration) must bucket identically."""
    from dqgp.ops.linalg import condition_number

    for target in (1e6, 1e13):
        A = _ill_conditioned(cond=target)
        c = float(condition_number(jnp.asarray(A, jnp.float64), method="iterative"))
        assert np.isclose(c, target, rtol=0.25), (target, c)
    # well-conditioned sanity
    A = _ill_conditioned(cond=50.0)
    c = float(condition_number(jnp.asarray(A, jnp.float64), method="iterative"))
    assert np.isclose(c, 50.0, rtol=0.05)


def test_condition_number_iterative_indefinite_is_inf():
    from dqgp.ops.linalg import condition_number

    A = np.diag(np.array([1.0, -1.0, 2.0]))
    c = float(condition_number(jnp.asarray(A, jnp.float64), method="iterative"))
    assert np.isinf(c)

