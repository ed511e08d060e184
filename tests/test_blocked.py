"""Scale-out path: blocked matvec == dense Gram matvec; CG posterior ==
dense Cholesky posterior."""

import numpy as np
import jax.numpy as jnp
import pytest

from dqgp.models.circuits import build_circuit
from dqgp.models.gp.posterior import predict_quantum_gp
from dqgp.models.kernels import QuantumKernelSpec
from dqgp.models.kernels.quantum_kernel import gram_from_features, kernel_features
from dqgp.parallel.blocked import cg_solve, gp_posterior_large, gram_matvec


def _setup(kernel_type="projected", N=70, seed=0):
    spec = QuantumKernelSpec(
        circuit=build_circuit("hubregtsen", 3, 2, 1),
        kernel_type=kernel_type, outer_kernel="gaussian",
    )
    rng = np.random.RandomState(seed)
    X = jnp.asarray(rng.uniform(-0.9, 0.9, (N, 2)), jnp.float32)
    theta = jnp.asarray(rng.uniform(0, np.pi, spec.num_parameters), jnp.float32)
    F = kernel_features(spec, X, theta)
    Y = jnp.asarray(np.sin(np.asarray(X)[:, 0]) + 0.05 * rng.randn(N))
    return spec, X, theta, F, Y


@pytest.mark.parametrize("kernel_type", ["projected", "fidelity"])
def test_blocked_matvec_matches_dense(kernel_type):
    spec, X, theta, F, Y = _setup(kernel_type)
    N = F.shape[0]
    rng = np.random.RandomState(1)
    v = jnp.asarray(rng.randn(N, 3))
    mask = jnp.ones((N,), jnp.float64)
    K = np.asarray(gram_from_features(spec, F, F), np.float64)
    want = K @ np.asarray(v)
    got = np.asarray(gram_matvec(spec, F.astype(jnp.complex128 if kernel_type == "fidelity" else jnp.float64), v, mask, block=32))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_cg_solves_spd_system():
    rng = np.random.RandomState(2)
    A = rng.randn(40, 12)
    M = A @ A.T + 40 * np.eye(40)
    b = rng.randn(40, 2)
    res = cg_solve(lambda v: jnp.asarray(M) @ v, jnp.asarray(b), tol=1e-10, maxiter=200,
                   diag_precond=jnp.asarray(np.diag(M)))
    np.testing.assert_allclose(np.asarray(res.x), np.linalg.solve(M, b), rtol=1e-6, atol=1e-8)


@pytest.mark.slow
def test_large_posterior_matches_dense_cholesky():
    spec, X, theta, F, Y = _setup(N=90)
    Xte = X[80:]
    F_tr = F[:80].astype(jnp.float64)
    F_te = kernel_features(spec, Xte, theta).astype(jnp.float64)
    mean, var, res = gp_posterior_large(
        spec, F_tr, Y[:80].astype(jnp.float64), F_te, noise_std=0.1,
        block=32, cg_tol=1e-10, cg_maxiter=400,
    )
    want_mean, want_var = predict_quantum_gp(
        spec, X[:80], Y[:80], Xte, theta, noise_std=0.1
    )
    np.testing.assert_allclose(np.asarray(mean), np.asarray(want_mean), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(var), np.asarray(want_var), rtol=1e-3, atol=1e-6)
    assert int(res.iterations) < 400


@pytest.mark.slow
def test_gram_free_blocked_cholesky_matches_dense():
    from dqgp.parallel.blocked import gram_free_blocked_cholesky, nll_large
    from dqgp.models.gp.posterior import masked_nll_and_grad

    spec, X, theta, F, Y = _setup(N=75, seed=5)
    F64 = F.astype(jnp.float64)
    L, logdet = gram_free_blocked_cholesky(spec, F64, noise_std=0.1,
                                           jitter=0.0, block=16, dtype=jnp.float64)
    K = np.asarray(gram_from_features(spec, F64), np.float64)
    C = K + 0.01 * np.eye(75)
    want_L = np.linalg.cholesky(C)
    np.testing.assert_allclose(np.asarray(L)[:75, :75], want_L, rtol=1e-8, atol=1e-10)
    sign, want_ld = np.linalg.slogdet(C)
    assert np.isclose(float(logdet), want_ld, rtol=1e-10)

    nll, comps = nll_large(spec, F64, Y, noise_std=0.1, block=16, dtype=jnp.float64)
    # masked_nll_and_grad takes the noise-FREE Gram and adds sigma^2 itself
    ref = masked_nll_and_grad(
        jnp.asarray(K), jnp.zeros((0, 75, 75)), Y, jnp.ones(75), 0.1,
        compute_cond=False,
    )
    assert np.isclose(float(nll), float(ref.nll), rtol=1e-10)


@pytest.mark.slow
def test_pivoted_cholesky_approximates_gram():
    from dqgp.parallel.blocked import pivoted_cholesky

    spec, X, theta, F, Y = _setup(N=60, seed=9)
    F64 = F.astype(jnp.float64)
    K = np.asarray(gram_from_features(spec, F64), np.float64)
    L = np.asarray(pivoted_cholesky(spec, F64, rank=40))
    err_40 = np.linalg.norm(K - L.T @ L) / np.linalg.norm(K)
    L10 = np.asarray(pivoted_cholesky(spec, F64, rank=10))
    err_10 = np.linalg.norm(K - L10.T @ L10) / np.linalg.norm(K)
    assert err_40 < err_10  # monotone improvement
    assert err_40 < 1e-5    # smooth kernel -> fast spectral decay


@pytest.mark.slow
def test_preconditioned_cg_converges_faster():
    from dqgp.parallel.blocked import (
        cg_solve, gram_matvec, pivoted_cholesky, woodbury_preconditioner,
    )

    spec, X, theta, F, Y = _setup(N=80, seed=10)
    F64 = F.astype(jnp.float64)
    mask = jnp.ones(80, jnp.float64)
    sigma2 = 0.01

    def A(v):
        return gram_matvec(spec, F64, v, mask, block=32) + sigma2 * v

    b = jnp.asarray(Y, jnp.float64)[:, None]
    jacobi = jnp.ones(80, jnp.float64) + sigma2
    res_j = cg_solve(A, b, tol=1e-8, maxiter=300, diag_precond=jacobi)
    Lp = pivoted_cholesky(spec, F64, rank=40)
    res_p = cg_solve(A, b, tol=1e-8, maxiter=300,
                     diag_precond=woodbury_preconditioner(Lp, sigma2))
    assert int(res_p.iterations) < int(res_j.iterations)
    # both converge to the same solution
    np.testing.assert_allclose(np.asarray(res_p.x), np.asarray(res_j.x),
                               rtol=1e-4, atol=1e-7)


@pytest.mark.slow
def test_predict_quantum_gp_large_matches_dense():
    """The CG prediction route must agree with the dense posterior to
    cg_tol-governed accuracy (it is the CLI's path above
    --predict-cg-threshold)."""
    import jax.numpy as jnp

    from dqgp.models.circuits import build_circuit
    from dqgp.models.gp.posterior import predict_quantum_gp
    from dqgp.models.kernels import QuantumKernelSpec
    from dqgp.parallel.blocked import predict_quantum_gp_large

    spec = QuantumKernelSpec(
        circuit=build_circuit("hubregtsen", 3, 2, 1),
        kernel_type="projected", outer_kernel="matern",
    )
    rng = np.random.RandomState(0)
    Xtr = rng.uniform(-0.9, 0.9, (160, 2))
    Ytr = np.sin(3 * Xtr[:, 0]) + 0.1 * rng.randn(160)
    Xte = rng.uniform(-0.9, 0.9, (600, 2))  # > test_chunk: exercises chunking
    theta = rng.uniform(0, np.pi, spec.num_parameters)

    m_d, v_d = predict_quantum_gp(
        spec, jnp.asarray(Xtr), jnp.asarray(Ytr), jnp.asarray(Xte),
        jnp.asarray(theta, jnp.float64), noise_std=0.1)
    m_c, v_c = predict_quantum_gp_large(
        spec, Xtr, Ytr, Xte, theta, 0.1, cg_tol=1e-8, cg_maxiter=600)
    np.testing.assert_allclose(np.asarray(m_c), np.asarray(m_d),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(v_c), np.asarray(v_d),
                               rtol=1e-3, atol=1e-6)


@pytest.mark.slow
def test_predict_quantum_gp_large_fidelity():
    """Fidelity kernels carry complex features through the CG route."""
    import jax.numpy as jnp

    from dqgp.models.circuits import build_circuit
    from dqgp.models.gp.posterior import predict_quantum_gp
    from dqgp.models.kernels import QuantumKernelSpec
    from dqgp.parallel.blocked import predict_quantum_gp_large

    spec = QuantumKernelSpec(
        circuit=build_circuit("yz_cx", 3, 2, 1), kernel_type="fidelity")
    rng = np.random.RandomState(1)
    Xtr = rng.uniform(-0.9, 0.9, (96, 2))
    Ytr = np.sin(3 * Xtr[:, 0]) + 0.1 * rng.randn(96)
    Xte = rng.uniform(-0.9, 0.9, (24, 2))
    theta = rng.uniform(0, np.pi, spec.num_parameters)

    m_d, v_d = predict_quantum_gp(
        spec, jnp.asarray(Xtr), jnp.asarray(Ytr), jnp.asarray(Xte),
        jnp.asarray(theta, jnp.float64), noise_std=0.1)
    m_c, v_c = predict_quantum_gp_large(
        spec, Xtr, Ytr, Xte, theta, 0.1, cg_tol=1e-8, cg_maxiter=400)
    np.testing.assert_allclose(np.asarray(m_c), np.asarray(m_d),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(v_c), np.asarray(v_d),
                               rtol=1e-3, atol=1e-6)


# ---------------------------------------------------------------------------
# Low-rank regularization on the matrix-free paths (VERDICT r2 #7)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["thresholding", "tikhonov"])
def test_lowrank_regularizer_matches_dense_on_indefinite_matrix(method):
    """The low-rank eigenvalue clip must reproduce regularize_gram exactly
    (to eigensolver tolerance) when the clip rank covers the negative
    spectrum — verified on a synthetic symmetric matrix with a known
    2-eigenvalue negative part."""
    from dqgp.models.kernels.quantum_kernel import regularize_gram
    from dqgp.parallel.blocked import make_lowrank_regularizer_from_matvec

    rng = np.random.RandomState(0)
    n = 64
    Q, _ = np.linalg.qr(rng.randn(n, n))
    w = np.linspace(0.5, 3.0, n)
    w[0], w[1] = -0.8, -0.05  # a genuinely indefinite spectrum
    A = (Q * w) @ Q.T
    A = jnp.asarray((A + A.T) / 2, jnp.float64)

    reg = make_lowrank_regularizer_from_matvec(
        lambda v: A @ v, n, method, rank=8, dtype=jnp.float64)
    K_dense = regularize_gram(A, method)

    v = jnp.asarray(rng.randn(n, 3))
    got = reg.matvec(A @ v, v)
    np.testing.assert_allclose(np.asarray(got), np.asarray(K_dense @ v),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(
        np.asarray(jnp.diagonal(A) + reg.diag_correction()),
        np.asarray(jnp.diagonal(K_dense)), rtol=1e-6, atol=1e-8)
    assert not bool(reg.saturated)  # 8 >> 2 negatives: budget not exhausted
    np.testing.assert_allclose(float(reg.lambda_min), -0.8, rtol=1e-5)


@pytest.mark.slow
def test_cg_predictor_honors_regularization():
    """make_cg_predictor with spec.regularization set must match the dense
    predict_quantum_gp (whose square train Gram goes through
    regularize_gram) — the r2 NotImplementedError is gone."""
    spec = QuantumKernelSpec(
        circuit=build_circuit("hubregtsen", 3, 2, 1),
        kernel_type="projected", outer_kernel="matern",
        regularization="thresholding",
    )
    from dqgp.parallel.blocked import predict_quantum_gp_large

    rng = np.random.RandomState(2)
    Xtr = rng.uniform(-0.9, 0.9, (128, 2))
    Ytr = np.sin(3 * Xtr[:, 0]) + 0.1 * rng.randn(128)
    Xte = rng.uniform(-0.9, 0.9, (24, 2))
    theta = rng.uniform(0, np.pi, spec.num_parameters)

    m_d, v_d = predict_quantum_gp(
        spec, jnp.asarray(Xtr), jnp.asarray(Ytr), jnp.asarray(Xte),
        jnp.asarray(theta, jnp.float64), noise_std=0.1)
    m_c, v_c = predict_quantum_gp_large(
        spec, Xtr, Ytr, Xte, theta, 0.1, cg_tol=1e-8, cg_maxiter=400)
    np.testing.assert_allclose(np.asarray(m_c), np.asarray(m_d),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(v_c), np.asarray(v_d),
                               rtol=1e-3, atol=1e-6)


@pytest.mark.slow
def test_nll_large_honors_regularization():
    """nll_large with spec.regularization must match the dense NLL computed
    on the regularize_gram'ed Gram."""
    from dqgp.models.gp.posterior import masked_nll_core
    from dqgp.parallel.blocked import nll_large

    spec = QuantumKernelSpec(
        circuit=build_circuit("hubregtsen", 3, 2, 1),
        kernel_type="projected", outer_kernel="matern",
        regularization="tikhonov",
    )
    rng = np.random.RandomState(3)
    X = jnp.asarray(rng.uniform(-0.9, 0.9, (96, 2)), jnp.float32)
    y = jnp.asarray(np.sin(3 * np.asarray(X)[:, 0]) + 0.1 * rng.randn(96),
                    jnp.float64)
    theta = jnp.asarray(rng.uniform(0, np.pi, spec.num_parameters), jnp.float32)

    F = kernel_features(spec, X, theta)
    K_reg = gram_from_features(spec, F).astype(jnp.float64)  # regularized (square)
    res, _ = masked_nll_core(K_reg, y, jnp.ones((96,), jnp.float64), 0.1,
                             compute_cond=False)

    nll, comps = nll_large(spec, F, y, 0.1, block=32, dtype=jnp.float64)
    # Tolerance bound: the low-rank tikhonov shift is LOBPCG's lambda_min
    # estimate (~1e-8 absolute eigensolver tolerance vs the dense path's
    # exact eigh); the NLL amplifies a shift error by ~tr(C^-1)/2
    # (~N/(2 sigma^2) ~ 5e3 here), so NLL agreement is bounded at ~1e-4
    # absolute — the clip itself is roundoff-scale, so this is the
    # regularizer's accuracy floor, not slack.
    np.testing.assert_allclose(float(nll), float(res.nll), rtol=3e-5)
    np.testing.assert_allclose(float(comps["log_det_term"]),
                               float(res.log_det_term), rtol=3e-5, atol=1e-4)


@pytest.mark.slow
def test_sharded_lowrank_regularizer_matches_single_chip():
    """The sharded regularizer factory (LOBPCG over the row-sharded Gram
    matvec) must produce the same correction as the single-chip
    make_lowrank_regularizer — compared through its ACTION (matvec, diag,
    shift), since eigenvectors carry sign/rotation ambiguity."""
    import jax as _jax

    if len(_jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from dqgp.parallel.blocked import (
        make_lowrank_regularizer,
        make_sharded_lowrank_regularizer,
    )

    spec = QuantumKernelSpec(
        circuit=build_circuit("hubregtsen", 3, 2, 1),
        kernel_type="projected", outer_kernel="matern",
        regularization="tikhonov",
    )
    rng = np.random.RandomState(5)
    n = 64
    X = jnp.asarray(rng.uniform(-0.9, 0.9, (n, 2)), jnp.float32)
    theta = jnp.asarray(rng.uniform(0, np.pi, spec.num_parameters), jnp.float32)
    F = kernel_features(spec, X, theta)

    ref = make_lowrank_regularizer(spec, F, dtype=jnp.float32)

    mesh = Mesh(np.array(_jax.devices()[:4]), ("data",))
    shard = NamedSharding(mesh, P("data"))
    build = make_sharded_lowrank_regularizer(spec, mesh, dtype=jnp.float32)
    got = build(_jax.device_put(F, shard),
                _jax.device_put(jnp.ones((n,), jnp.float32), shard))

    # f32 LOBPCG under different reduction orders (sharded vs single-chip)
    # agrees to eigensolver tolerance (~1e-5 absolute at lambda_max ~ 1e1),
    # the documented accuracy floor of the correction itself.
    np.testing.assert_allclose(float(got.shift), float(ref.shift),
                               rtol=5e-2, atol=1e-5)
    np.testing.assert_allclose(float(got.lambda_min), float(ref.lambda_min),
                               rtol=5e-2, atol=1e-5)
    v = jnp.asarray(rng.randn(n, 2), jnp.float32)
    zero = jnp.zeros((n, 2), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(got.matvec(zero, v)), np.asarray(ref.matvec(zero, v)),
        rtol=5e-2, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(got.diag_correction()), np.asarray(ref.diag_correction()),
        rtol=5e-2, atol=1e-4)
