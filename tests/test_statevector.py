"""Golden tests for the batched statevector engine vs hand-computed states
and a numpy dense-matrix oracle (SURVEY.md §4: golden-value tests per gate)."""

import numpy as np
import jax.numpy as jnp
import pytest

from dqgp.ops.circuit import (
    CRX, CRY, CRZ, CX, CZ, ENC_ARCCOS, ENC_ID, H, RX, RY, RZ, RZZ, Circuit, Gate,
)
from dqgp.ops import statevector as sv


# ---------------------------------------------------------------------------
# Dense numpy oracle
# ---------------------------------------------------------------------------

I2 = np.eye(2)
PAULI = {
    "X": np.array([[0, 1], [1, 0]], complex),
    "Y": np.array([[0, -1j], [1j, 0]], complex),
    "Z": np.array([[1, 0], [0, -1]], complex),
}


def rot(axis, a):
    P = PAULI[axis]
    return np.cos(a / 2) * I2 - 1j * np.sin(a / 2) * P


def op_on(n, q, m):
    """Dense operator applying 2x2 m on qubit q (qubit 0 = LSB)."""
    out = np.array([[1.0 + 0j]])
    for k in range(n - 1, -1, -1):
        out = np.kron(out, m if k == q else I2)
    return out


def ctrl_op(n, c, t, m):
    dim = 1 << n
    out = np.eye(dim, dtype=complex)
    mt = op_on(n, t, m)
    for i in range(dim):
        if (i >> c) & 1:
            out[i, :] = 0
    # build properly: U = P0_c ⊗ I + P1_c ⊗ M_t
    P0 = np.array([[1, 0], [0, 0]], complex)
    P1 = np.array([[0, 0], [0, 1]], complex)
    out = op_on(n, c, P0) + op_on(n, c, P1) @ mt
    return out


def oracle_apply(n, gate: Gate, angle, state):
    k = gate.kind
    if k == H:
        U = op_on(n, gate.qubit, np.array([[1, 1], [1, -1]]) / np.sqrt(2))
    elif k == RX:
        U = op_on(n, gate.qubit, rot("X", angle))
    elif k == RY:
        U = op_on(n, gate.qubit, rot("Y", angle))
    elif k == RZ:
        U = op_on(n, gate.qubit, rot("Z", angle))
    elif k == CX:
        U = ctrl_op(n, gate.control, gate.qubit, PAULI["X"])
    elif k == CZ:
        U = ctrl_op(n, gate.control, gate.qubit, PAULI["Z"])
    elif k == CRX:
        U = ctrl_op(n, gate.control, gate.qubit, rot("X", angle))
    elif k == CRY:
        U = ctrl_op(n, gate.control, gate.qubit, rot("Y", angle))
    elif k == CRZ:
        U = ctrl_op(n, gate.control, gate.qubit, rot("Z", angle))
    elif k == RZZ:
        ZZ = op_on(n, gate.qubit, PAULI["Z"]) @ op_on(n, gate.control, PAULI["Z"])
        from scipy.linalg import expm
        U = expm(-0.5j * angle * ZZ)
    else:
        raise ValueError(k)
    return U @ state


def run_oracle(circ: Circuit, X, theta):
    angles = np.asarray(sv.angle_matrix(circ, jnp.asarray(X), jnp.asarray(theta)))
    N = X.shape[0]
    out = np.zeros((N, circ.dim), complex)
    for i in range(N):
        s = np.zeros(circ.dim, complex)
        s[0] = 1.0
        for gi, g in enumerate(circ.gates):
            s = oracle_apply(circ.num_qubits, g, angles[i, gi], s)
        out[i] = s
    return out


# ---------------------------------------------------------------------------


def test_single_qubit_ry():
    c = Circuit(1, 1, 1, (Gate(RY, 0, pidx=0, pc=1.0),))
    theta = jnp.array([0.7])
    X = jnp.zeros((1, 1))
    psi = np.asarray(sv.batched_states(c, X, theta))[0]
    want = np.array([np.cos(0.35), np.sin(0.35)])
    np.testing.assert_allclose(psi, want, atol=1e-6)


def test_hand_computed_bell_state():
    # H on qubit 0 then CX(0 -> 1) gives (|00> + |11>)/sqrt(2)
    c = Circuit(2, 1, 0, (Gate(H, 0), Gate(CX, 1, control=0)))
    psi = np.asarray(sv.batched_states(c, jnp.zeros((1, 1)), jnp.zeros(0)))[0]
    want = np.array([1, 0, 0, 1]) / np.sqrt(2)
    np.testing.assert_allclose(psi, want, atol=1e-6)


@pytest.mark.parametrize("kind", [RX, RY, RZ, CRX, CRY, CRZ, CX, CZ, H, RZZ])
def test_each_gate_vs_oracle(kind):
    n = 3
    if kind in (CX, CZ, CRX, CRY, CRZ, RZZ):
        g = Gate(kind, 2, control=0, pidx=0, pc=1.0) if kind in (CRX, CRY, CRZ, RZZ) \
            else Gate(kind, 2, control=0)
    else:
        g = Gate(kind, 1, pidx=0, pc=1.0) if kind != H else Gate(H, 1)
    # prepend rotations so the state is generic
    pre = (
        Gate(RY, 0, fidx=0, fc=1.0, enc=ENC_ID),
        Gate(RX, 1, fidx=0, fc=0.7, enc=ENC_ID),
        Gate(RY, 2, fidx=0, fc=-1.3, enc=ENC_ID),
        Gate(CX, 1, control=0),
    )
    nparams = 1
    c = Circuit(n, 1, nparams, pre + (g,))
    rng = np.random.RandomState(0)
    X = rng.uniform(-1, 1, (4, 1))
    theta = rng.uniform(0, np.pi, (nparams,))
    got = np.asarray(sv.batched_states(c, jnp.asarray(X), jnp.asarray(theta)))
    want = run_oracle(c, X, theta)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # normalization
    np.testing.assert_allclose(np.sum(np.abs(got) ** 2, axis=1), 1.0, atol=1e-5)


def test_angle_matrix_model():
    c = Circuit(
        1, 2, 2,
        (
            Gate(RY, 0, const=0.5, pidx=1, pc=2.0, fidx=1, fc=3.0, enc=ENC_ID),
            Gate(RX, 0, pidx=0, pf=1.0, fidx=0, enc=ENC_ARCCOS),
        ),
    )
    X = jnp.array([[0.5, -0.25]])
    theta = jnp.array([1.5, 0.25])
    A = np.asarray(sv.angle_matrix(c, X, theta))
    assert np.isclose(A[0, 0], 0.5 + 2.0 * 0.25 + 3.0 * (-0.25), atol=1e-6)
    assert np.isclose(A[0, 1], 1.5 * np.arccos(0.5), atol=1e-6)


def test_pauli_features_vs_oracle():
    rng = np.random.RandomState(3)
    n = 3
    gates = (
        Gate(RY, 0, pidx=0, pc=1.0),
        Gate(RX, 1, pidx=1, pc=1.0),
        Gate(H, 2),
        Gate(CX, 1, control=0),
        Gate(RZ, 2, pidx=2, pc=1.0),
        Gate(CRY, 0, control=2, pidx=3, pc=1.0),
    )
    c = Circuit(n, 1, 4, gates)
    X = rng.uniform(-1, 1, (5, 1))
    theta = rng.uniform(0, np.pi, (4,))
    states = sv.batched_states(c, jnp.asarray(X), jnp.asarray(theta))
    F = np.asarray(sv.pauli_features(states, n))
    st = np.asarray(states)
    for q in range(n):
        for pi, pname in enumerate("XYZ"):
            U = op_on(n, q, PAULI[pname])
            want = np.real(np.einsum("bi,ij,bj->b", st.conj(), U, st))
            np.testing.assert_allclose(F[:, pi * n + q], want, atol=1e-5)


def test_pauli_string_expectation():
    c = Circuit(2, 1, 1, (Gate(RY, 0, pidx=0, pc=1.0), Gate(CX, 1, control=0)))
    theta = jnp.array([1.1])
    states = sv.batched_states(c, jnp.zeros((1, 1)), theta)
    # <ZZ> of cos|00> + sin|11> is 1
    got = float(sv.pauli_string_expectation(states, "ZZ")[0])
    assert np.isclose(got, 1.0, atol=1e-6)
    # <XX> = 2 cos sin = sin(theta)
    got_xx = float(sv.pauli_string_expectation(states, "XX")[0])
    assert np.isclose(got_xx, np.sin(1.1), atol=1e-6)


FAMILIES = ["chebyshev", "yz_cx", "hubregtsen", "kyriienko",
            "multi_control", "layered", "random", "highdim"]


@pytest.mark.parametrize("encoding", FAMILIES)
def test_f32_engine_matches_complex128_oracle(encoding):
    """The f32/complex64 engine that runs on the card agrees with the dense
    complex128 oracle at the on-card smoke tolerance (atol 2e-5, rtol 2e-4):
    projected XYZ features and the fidelity Gram |Psi Psi^H|^2."""
    from dqgp.models.circuits import build_circuit

    circ = build_circuit(encoding, 3, 2, 2)
    rng = np.random.RandomState(5)
    X = rng.uniform(-0.95, 0.95, (12, 2))
    theta = rng.uniform(0, np.pi, circ.num_parameters)
    angles = np.asarray(sv.angle_matrix(circ, jnp.asarray(X), jnp.asarray(theta),
                                        jnp.float64))
    ref = np.zeros((len(X), circ.dim), complex)
    for i in range(len(X)):
        s = np.zeros(circ.dim, complex)
        s[0] = 1.0
        for gi, g in enumerate(circ.gates):
            s = oracle_apply(circ.num_qubits, g, angles[i, gi], s)
        ref[i] = s
    n = circ.num_qubits
    ref_feats = np.stack(
        [np.real(np.einsum("bi,ij,bj->b", ref.conj(), op_on(n, q, PAULI[p]), ref))
         for p in "XYZ" for q in range(n)], axis=-1)

    states = sv.batched_states(circ, jnp.asarray(X, jnp.float32),
                               jnp.asarray(theta, jnp.float32))
    assert states.dtype == jnp.complex64
    feats = np.asarray(sv.pauli_features(states, n))
    np.testing.assert_allclose(feats, ref_feats, atol=2e-5, rtol=2e-4)
    st = np.asarray(states)
    np.testing.assert_allclose(np.abs(st @ st.conj().T) ** 2,
                               np.abs(ref @ ref.conj().T) ** 2,
                               atol=2e-5, rtol=2e-4)
