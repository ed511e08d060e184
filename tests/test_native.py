"""Native C++ components: the qsim oracle must agree with the JAX engine on
every encoding family; the hgt parser must agree with numpy parsing."""

import numpy as np
import jax.numpy as jnp
import pytest

from dqgp.models.circuits import ENCODING_TYPES, build_circuit
from dqgp.ops import statevector as sv
from dqgp.ops import qsim_native


needs_native = pytest.mark.skipif(
    not qsim_native.available(), reason="native toolchain unavailable"
)


@needs_native
@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_cpp_oracle_matches_jax_engine(enc):
    c = build_circuit(enc, 3, 2, 2)
    rng = np.random.RandomState(0)
    X = rng.uniform(-0.9, 0.9, (6, 2))
    theta = rng.uniform(0, np.pi, c.num_parameters)
    angles = np.asarray(
        sv.angle_matrix(c, jnp.asarray(X, jnp.float32), jnp.asarray(theta, jnp.float32)),
        np.float64,
    )
    want = np.asarray(sv.state_from_angles(c, jnp.asarray(angles, jnp.float32)))
    got = qsim_native.native_states(c, angles)
    np.testing.assert_allclose(got, want, atol=5e-6)


@needs_native
@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_cpp_oracle_matches_f64_pipeline(enc):
    """The round-3 f64 pipeline (complex128 states from f64 angles, used by
    the host cond backfill and gram(..., dtype=float64)) must agree with the
    independent C++ double-precision oracle to near machine precision —
    a far tighter gate-sequence pin than the f32 path's 5e-6."""
    c = build_circuit(enc, 3, 2, 2)
    rng = np.random.RandomState(2)
    X = rng.uniform(-0.9, 0.9, (6, 2))
    theta = rng.uniform(0, np.pi, c.num_parameters)
    angles = np.asarray(
        sv.angle_matrix(c, jnp.asarray(X, jnp.float64),
                        jnp.asarray(theta, jnp.float64), dtype=jnp.float64),
        np.float64,
    )
    want = np.asarray(sv.state_from_angles(
        c, jnp.asarray(angles, jnp.float64), jnp.complex128))
    assert want.dtype == np.complex128
    got = qsim_native.native_states(c, angles)
    np.testing.assert_allclose(got, want, atol=1e-12)


@needs_native
def test_cpp_pauli_features_match():
    c = build_circuit("kyriienko", 4, 2, 2)
    rng = np.random.RandomState(1)
    X = rng.uniform(-0.9, 0.9, (5, 2))
    theta = rng.uniform(0, np.pi, c.num_parameters)
    angles = np.asarray(
        sv.angle_matrix(c, jnp.asarray(X, jnp.float32), jnp.asarray(theta, jnp.float32)),
        np.float64,
    )
    want = np.asarray(sv.pauli_features(sv.state_from_angles(c, jnp.asarray(angles, jnp.float32)), 4))
    got = qsim_native.native_pauli_features(c, angles)
    np.testing.assert_allclose(got, want, atol=5e-6)


@needs_native
def test_native_hgt_matches_numpy(tmp_path):
    from dqgp.data.hgt_native import read_hgt

    n = 1201
    rng = np.random.RandomState(0)
    data = rng.randint(-32768, 8849, size=(n, n)).astype(">i2")
    p = str(tmp_path / "t.hgt")
    data.tofile(p)
    got = read_hgt(p, n)
    np.testing.assert_array_equal(got, data.astype(np.float64))


@needs_native
def test_facade_f64_matches_cpp_oracle():
    """QuantumKernel.evaluate with dtype auto->float64 on CPU must return
    reference-grade entries: the fidelity Gram computed in pure numpy f64
    from the C++ double-precision oracle's statevectors agrees at 1e-12
    (the squlearn surface it mirrors is genuinely f64 qiskit-aer,
    agent_riemannian.py:114-119)."""
    from dqgp.models.kernels.quantum_kernel import create_quantum_kernel

    qk = create_quantum_kernel(3, num_features=2, num_layers=2,
                               encoding_type="yz_cx", kernel_type="fidelity")
    assert qk._dtype == jnp.float64  # auto resolves to f64 on CPU
    c = qk.spec.circuit
    rng = np.random.RandomState(7)
    X = rng.uniform(-0.9, 0.9, (6, 2))
    theta = rng.uniform(0, np.pi, c.num_parameters)
    qk.assign_parameters(theta)
    K = qk.evaluate(X, X)

    angles = np.asarray(
        sv.angle_matrix(c, jnp.asarray(X, jnp.float64),
                        jnp.asarray(theta, jnp.float64), dtype=jnp.float64),
        np.float64,
    )
    psi = qsim_native.native_states(c, angles)          # (N, 2^n) complex128
    ov = psi @ psi.conj().T
    K_ref = (ov * ov.conj()).real
    np.testing.assert_allclose(K, K_ref, atol=1e-12)


@needs_native
def test_facade_f64_derivatives_match_cpp_oracle():
    """evaluate_derivatives in the f64 facade: K and every central-difference
    dK/dp agree with a from-scratch numpy-f64 construction through the C++
    oracle at 1e-10 (matches agent_riemannian.py:247-275 semantics)."""
    from dqgp.models.kernels.quantum_kernel import create_quantum_kernel

    qk = create_quantum_kernel(2, num_features=1, num_layers=1,
                               encoding_type="hubregtsen", kernel_type="fidelity")
    c = qk.spec.circuit
    rng = np.random.RandomState(3)
    X = rng.uniform(-0.9, 0.9, (4, 1))
    theta = rng.uniform(0, np.pi, c.num_parameters)
    qk.assign_parameters(theta)
    h = float(np.pi / 8)
    out = qk.evaluate_derivatives(X, values=("K", "dKdp"), h=h)

    def gram_f64(t):
        t = np.mod(t, np.pi)  # wrap-before-eval (agent_riemannian.py:38-41)
        angles = np.asarray(
            sv.angle_matrix(c, jnp.asarray(X, jnp.float64),
                            jnp.asarray(t, jnp.float64), dtype=jnp.float64),
            np.float64,
        )
        psi = qsim_native.native_states(c, angles)
        ov = psi @ psi.conj().T
        return (ov * ov.conj()).real

    np.testing.assert_allclose(out["K"], gram_f64(theta), atol=1e-12)
    for p in range(c.num_parameters):
        tp, tm = theta.copy(), theta.copy()
        tp[p] += h
        tm[p] -= h
        want = (gram_f64(tp) - gram_f64(tm)) / (2.0 * h)
        np.testing.assert_allclose(out["dKdp"][p], want, atol=1e-10)
