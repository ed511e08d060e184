"""Quantum kernel tests: fidelity/projected identities, outer kernels vs
sklearn, regularization, and parameter-shift gradients vs a slow oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from dqgp.models.circuits import build_circuit
from dqgp.models.kernels import (
    QuantumKernelSpec,
    create_quantum_kernel,
    gram,
    gram_and_shift_grads,
)
from dqgp.models.kernels.outer import outer_gram
from dqgp.models.kernels.quantum_kernel import (
    kernel_features,
    regularize_gram,
    shift_parameter_batch,
)
from dqgp.ops import statevector as sv


def _spec(kernel_type="fidelity", enc="yz_cx", n=3, d=2, layers=1, **kw):
    return QuantumKernelSpec(circuit=build_circuit(enc, n, d, layers),
                             kernel_type=kernel_type, **kw)


def _data(spec, N=6, seed=0):
    rng = np.random.RandomState(seed)
    X = jnp.asarray(rng.uniform(-0.9, 0.9, (N, spec.circuit.num_features)))
    theta = jnp.asarray(rng.uniform(0, np.pi, (spec.num_parameters,)))
    return X, theta


@pytest.mark.slow
def test_fidelity_gram_identities():
    spec = _spec("fidelity")
    X, theta = _data(spec)
    K = np.asarray(gram(spec, X, theta))
    # |<psi_i|psi_j>|^2: symmetric, unit diagonal, entries in [0, 1], PSD-ish
    np.testing.assert_allclose(K, K.T, atol=1e-6)
    np.testing.assert_allclose(np.diag(K), 1.0, atol=1e-5)
    assert np.all(K >= -1e-6) and np.all(K <= 1 + 1e-6)
    # matches the direct pairwise overlap computation
    states = np.asarray(sv.batched_states(spec.circuit, X, theta))
    want = np.abs(states @ states.conj().T) ** 2
    np.testing.assert_allclose(K, want, atol=1e-5)


def test_projected_gaussian_matches_manual():
    spec = _spec("projected", outer_kernel="gaussian")
    X, theta = _data(spec)
    K = np.asarray(gram(spec, X, theta))
    F = np.asarray(kernel_features(spec, X, theta))
    d2 = ((F[:, None, :] - F[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(K, np.exp(-d2), atol=1e-5)


def test_measurement_subsets():
    full = _spec("projected", measurement="XYZ")
    sub = _spec("projected", measurement="Z")
    X, theta = _data(full)
    Ff = np.asarray(kernel_features(full, X, theta))
    Fs = np.asarray(kernel_features(sub, X, theta))
    n = full.circuit.num_qubits
    assert Ff.shape[1] == 3 * n and Fs.shape[1] == n
    np.testing.assert_allclose(Fs, Ff[:, 2 * n :], atol=1e-6)


def test_outer_kernels_vs_sklearn():
    from sklearn.gaussian_process.kernels import (
        DotProduct, ExpSineSquared, Matern, RationalQuadratic,
    )
    rng = np.random.RandomState(0)
    FA = rng.randn(5, 4)
    FB = rng.randn(3, 4)
    cases = [
        ("matern", dict(length_scale=1.3, nu=1.5), Matern(length_scale=1.3, nu=1.5)),
        ("matern", dict(length_scale=0.7, nu=2.5), Matern(length_scale=0.7, nu=2.5)),
        ("matern", dict(length_scale=1.0, nu=0.5), Matern(length_scale=1.0, nu=0.5)),
        ("expsinesquared", dict(length_scale=1.2, periodicity=2.0),
         ExpSineSquared(length_scale=1.2, periodicity=2.0)),
        ("rationalquadratic", dict(length_scale=1.1, alpha=0.9),
         RationalQuadratic(length_scale=1.1, alpha=0.9)),
        ("dotproduct", dict(sigma_0=1.4), DotProduct(sigma_0=1.4)),
    ]
    for name, params, sk in cases:
        got = np.asarray(outer_gram(name, jnp.asarray(FA), jnp.asarray(FB), params))
        want = sk(FA, FB)
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)
    # gaussian vs exp(-gamma d^2)
    got = np.asarray(outer_gram("gaussian", jnp.asarray(FA), jnp.asarray(FB), {"gamma": 0.5}))
    d2 = ((FA[:, None] - FB[None]) ** 2).sum(-1)
    np.testing.assert_allclose(got, np.exp(-0.5 * d2), atol=1e-6)


def test_regularization():
    A = np.array([[1.0, 0.0], [0.0, -0.5]])
    thr = np.asarray(regularize_gram(jnp.asarray(A), "thresholding"))
    np.testing.assert_allclose(thr, np.diag([1.0, 0.0]), atol=1e-6)
    tik = np.asarray(regularize_gram(jnp.asarray(A), "tikhonov"))
    np.testing.assert_allclose(tik, np.diag([1.5, 0.0]), atol=1e-6)


def test_shift_parameter_batch_wraps_like_reference():
    theta = jnp.asarray([0.1, np.pi - 0.05])
    h = np.pi / 8
    batch = np.asarray(shift_parameter_batch(theta, h))
    assert batch.shape == (5, 2)
    # + shift of param 1 exceeds pi and must wrap (agent_riemannian.py:38-41)
    assert np.isclose(batch[2, 1], np.mod(np.pi - 0.05 + h, np.pi), atol=1e-6)
    assert np.all(batch >= 0) and np.all(batch < np.pi)


@pytest.mark.parametrize("kernel_type", ["fidelity", "projected"])
@pytest.mark.slow
def test_shift_grads_vs_slow_oracle(kernel_type):
    spec = _spec(kernel_type, n=2, d=1, layers=1)
    X, theta = _data(spec, N=4)
    h = float(np.pi / 8)
    K, dK = gram_and_shift_grads(spec, X, theta, h)
    K, dK = np.asarray(K), np.asarray(dK)
    # slow oracle: per-parameter central difference with wrapped params
    for p in range(spec.num_parameters):
        tp = np.mod(np.asarray(theta).copy(), np.pi); tp[p] += h
        tm = np.asarray(theta).copy(); tm[p] -= h
        Kp = np.asarray(gram(spec, X, jnp.asarray(np.mod(tp, np.pi))))
        Km = np.asarray(gram(spec, X, jnp.asarray(np.mod(tm, np.pi))))
        np.testing.assert_allclose(dK[p], (Kp - Km) / (2 * h), atol=2e-4)
    np.testing.assert_allclose(K, np.asarray(gram(spec, X, jnp.asarray(np.mod(np.asarray(theta), np.pi)))), atol=1e-6)


def test_quantum_kernel_facade():
    qk = create_quantum_kernel(3, num_features=2, num_layers=1,
                               encoding_type="hubregtsen", kernel_type="projected",
                               outer_kernel="matern")
    assert qk.num_parameters == 6
    rng = np.random.RandomState(0)
    X = rng.uniform(-0.9, 0.9, (5, 2))
    qk.assign_parameters(rng.uniform(0, np.pi, 6))
    K = qk.evaluate(X, X)
    assert K.shape == (5, 5)
    np.testing.assert_allclose(K, K.T, atol=1e-5)
    out = qk.evaluate_derivatives(X, X, values=("K", "dKdp"))
    assert out["dKdp"].shape == (6, 5, 5)
    np.testing.assert_allclose(out["K"], K, atol=1e-6)


def test_evaluate_value_equal_inputs_regularized():
    """evaluate(X, X.copy()) must take the symmetric (regularized) path when
    the spec carries regularization — squlearn regularizes square Grams."""
    from dqgp.models.kernels import create_quantum_kernel

    k = create_quantum_kernel(3, 2, 1, encoding_type="hubregtsen",
                              kernel_type="projected",
                              regularization="thresholding")
    rng = np.random.RandomState(0)
    X = rng.uniform(-0.9, 0.9, (12, 2))
    k.assign_parameters(rng.uniform(0, np.pi, k.num_parameters))
    K_sym = k.evaluate(X)
    K_copy = k.evaluate(X, X.copy())
    np.testing.assert_allclose(K_copy, K_sym, rtol=0, atol=0)


def test_evaluate_derivatives_rejects_cross_inputs():
    """evaluate_derivatives only has the symmetric case; a different XB must
    raise rather than silently return the (wrong-shape) symmetric answer."""
    from dqgp.models.kernels.quantum_kernel import QuantumKernel

    spec = _spec("projected")
    qk = QuantumKernel(spec)
    rng = np.random.RandomState(0)
    X = rng.uniform(-0.9, 0.9, (6, 2))
    qk.assign_parameters(rng.uniform(0, np.pi, spec.num_parameters))
    out = qk.evaluate_derivatives(X, X.copy())  # value-equal XB is fine
    assert out["K"].shape == (6, 6)
    with pytest.raises(NotImplementedError):
        qk.evaluate_derivatives(X, rng.uniform(-0.9, 0.9, (4, 2)))


def test_measurement_validation_at_construction():
    """Bad measurements fail with a clear ValueError when the spec is built,
    not a KeyError inside a jit trace; full Pauli strings must span exactly
    num_qubits and cannot be mixed with single-char per-qubit blocks."""
    from dqgp.models.circuits import build_circuit
    from dqgp.models.kernels import QuantumKernelSpec
    from dqgp.models.kernels.quantum_kernel import kernel_features

    circ = build_circuit("hubregtsen", 2, 2, 1)

    def make(m):
        return QuantumKernelSpec(circuit=circ, kernel_type="projected",
                                 measurement=m, outer_kernel="gaussian")

    with pytest.raises(ValueError):
        make(("X", "Q"))           # bad per-qubit char
    with pytest.raises(ValueError):
        make("XQ")                 # bad string char
    with pytest.raises(ValueError):
        make(())                   # empty tuple
    with pytest.raises(ValueError):
        make(("X", "XZ"))          # mixed block/full-string lengths
    with pytest.raises(ValueError):
        make(("XZI",))             # full string longer than num_qubits

    # valid full Pauli strings on 2 qubits produce one column each
    spec = make(("XI", "IZ", "YY"))
    rng = np.random.RandomState(1)
    X = jnp.asarray(rng.uniform(-0.9, 0.9, (5, 2)), jnp.float32)
    theta = jnp.asarray(rng.uniform(0, np.pi, spec.num_parameters), jnp.float32)
    F = kernel_features(spec, X, theta)
    assert F.shape == (5, 3)


@pytest.mark.slow
def test_full_parity_surface_grams_psd():
    """SURVEY.md parity checklist smoke: every encoding x kernel type (one
    outer kernel), every outer kernel (one encoding), and both
    regularizations produce finite, symmetric Grams; PSD is asserted where
    the kernel family guarantees it (expsinesquared/pairwise on
    multi-dimensional features are indefinite in sklearn too — verified
    eig_min -0.92 matches sklearn to 1e-5; that is exactly why the
    regularization options exist)."""
    from dqgp.models.circuits import ENCODING_TYPES, build_circuit
    from dqgp.models.kernels import QuantumKernelSpec
    from dqgp.models.kernels.quantum_kernel import gram

    rng = np.random.RandomState(0)
    X = jnp.asarray(rng.uniform(-0.9, 0.9, (12, 2)), jnp.float32)

    PSD_FAMILIES = {"gaussian", "matern", "rationalquadratic", "dotproduct"}

    def check(spec, expect_psd=None):
        theta = jnp.asarray(rng.uniform(0, np.pi, spec.num_parameters),
                            jnp.float32)
        K = np.asarray(gram(spec, X, theta), np.float64)
        assert np.isfinite(K).all(), spec
        np.testing.assert_allclose(K, K.T, atol=1e-6)
        if expect_psd is None:
            expect_psd = (spec.kernel_type == "fidelity"
                          or spec.outer_kernel in PSD_FAMILIES)
        if expect_psd:
            w = np.linalg.eigvalsh((K + K.T) / 2)
            assert w.min() > -1e-5, (spec.kernel_type, spec.outer_kernel, w.min())

    for enc in ENCODING_TYPES:
        for kt in ("fidelity", "projected"):
            check(QuantumKernelSpec(circuit=build_circuit(enc, 3, 2, 1),
                                    kernel_type=kt, outer_kernel="gaussian"))
    circ = build_circuit("hubregtsen", 3, 2, 1)
    for outer in ("gaussian", "matern", "expsinesquared", "rationalquadratic",
                  "dotproduct", "pairwisekernel"):
        check(QuantumKernelSpec(circuit=circ, kernel_type="projected",
                                outer_kernel=outer))
    for reg in ("thresholding", "tikhonov"):
        # regularization's whole job is restoring PSD — assert it even on
        # the indefinite expsinesquared family
        check(QuantumKernelSpec(circuit=circ, kernel_type="projected",
                                outer_kernel="expsinesquared",
                                regularization=reg), expect_psd=True)
