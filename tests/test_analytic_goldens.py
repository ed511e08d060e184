"""Analytic circuit goldens — an evidence channel independent of the shared IR.

The C++ oracle (native/qsim_ref.cpp) consumes the builder's own ``Circuit``
IR, so it can pin the *engine* but not the *circuit definitions* (a wrong
gate sequence would pass the oracle; VERDICT r3, Missing #1). These tests
close that gap offline: each one hand-builds the published circuit for
2 qubits / 1 layer as LITERAL 4x4 kron products of textbook gate matrices —
defined below straight from the exp(-i theta P / 2) expansions — and, for
three families, additionally as pure closed-form trig amplitude formulas
derived on paper with no matrices at all. The expected values never flow
through ops/circuit.py, ops/statevector.py, or the C++
oracle. The pipeline (build_circuit -> angle_matrix -> states -> Gram /
features / shift gradients) must reproduce them at 1e-12 through the
complex128 path.

Circuit structures asserted (paper order, 2 qubits / 1 layer / 1 feature;
references: main.py:68-106 of the reference for the family list, plus the
papers cited in models/circuits/library.py:14-18):

* hubregtsen  (arXiv:2105.02276 Fig. 2): H, Rz(x) on each qubit; trainable
              Ry(p) block; CRZ(p) ring.                       P(2,1L) = 3
* yz_cx       (arXiv:2108.01039): Ry(p + x) Rz(p + x) per qubit; CX chain.
                                                              P(2,1L) = 4
* kyriienko   (arXiv:2011.10395): Chebyshev tower Ry(2(q+1) arccos x);
              HEA block Ry(p) Rz(p) per qubit; CX chain.      P(2,1L) = 4
* chebyshev   (squlearn ChebyshevPQC): initial Ry(p) block; per layer
              Rx(p * arccos x) towers, CRZ(p) ring, Ry(p) block.
                                                              P(2,1L) = 7
* multi_control: H + Rz(x) encoding; CRX(p) ring; Ry(p) block. P(2,1L) = 3
* layered     (gates=['RX','RY','RZ']): Rx(p + x), Ry(p), Rz(p) blocks;
              CX chain.                                       P(2,1L) = 6
* highdim     (features cycled across qubits, alternating Ry/Rz(p + x_f);
              CX ring).                                   P(2,1L) = 2, d=2

``random`` is excluded: its draw scheme is a documented non-match
(docs/PARITY.md tier [guess]; squlearn's RandomEncodingCircuit uses its own
RNG stream, so no offline golden can represent it).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from dqgp.models.circuits import build_circuit
from dqgp.models.kernels.quantum_kernel import (
    QuantumKernelSpec,
    gram,
    gram_and_shift_grads,
    kernel_features,
)

ATOL = 1e-12

# ---------------------------------------------------------------------------
# Independent mini-toolbox: textbook gate matrices + kron placement. Nothing
# below imports from dqgp.ops — that independence is the whole point.
# ---------------------------------------------------------------------------

I2 = np.eye(2, dtype=complex)
P0 = np.array([[1, 0], [0, 0]], dtype=complex)
P1 = np.array([[0, 0], [0, 1]], dtype=complex)
X_PAULI = np.array([[0, 1], [1, 0]], dtype=complex)
Y_PAULI = np.array([[0, -1j], [1j, 0]], dtype=complex)
Z_PAULI = np.array([[1, 0], [0, -1]], dtype=complex)
H_MAT = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2.0)


def rx(t):
    """exp(-i t X / 2) = cos(t/2) I - i sin(t/2) X."""
    c, s = np.cos(t / 2), np.sin(t / 2)
    return np.array([[c, -1j * s], [-1j * s, c]])


def ry(t):
    """exp(-i t Y / 2) = cos(t/2) I - i sin(t/2) Y."""
    c, s = np.cos(t / 2), np.sin(t / 2)
    return np.array([[c, -s], [s, c]], dtype=complex)


def rz(t):
    """exp(-i t Z / 2) = diag(e^{-it/2}, e^{+it/2})."""
    return np.array([[np.exp(-1j * t / 2), 0], [0, np.exp(1j * t / 2)]])


def on(U, q):
    """U acting on qubit q of a 2-qubit register, qubit 0 = least-significant
    bit of the state index (matching the documented IR convention,
    ops/circuit.py Gate docstring — but built here with plain np.kron)."""
    return np.kron(I2, U) if q == 0 else np.kron(U, I2)


def ctrl(U, control, target):
    """Controlled-U (2 qubits): |0><0|_c (x) I + |1><1|_c (x) U_t."""
    assert {control, target} == {0, 1}
    if control == 0:
        return np.kron(I2, P0) + np.kron(U, P1)
    return np.kron(P0, I2) + np.kron(P1, U)


def apply(ops, state=None):
    """Apply a list of 4x4 matrices in circuit (left-to-right) order."""
    psi = np.zeros(4, dtype=complex) if state is None else state
    if state is None:
        psi[0] = 1.0
    for U in ops:
        psi = U @ psi
    return psi


def pauli_expect(psi, P, q):
    """<psi| P_q |psi> via the literal 4x4 operator."""
    return float(np.real(np.conj(psi) @ (on(P, q) @ psi)))


def test_ctrl_helper_is_textbook_cnot():
    """Sanity-pin the in-test helper itself against the CNOT truth table."""
    cx01 = ctrl(X_PAULI, 0, 1)  # control q0 (LSB), target q1
    # Basis order |q1 q0>: index i = 2*q1 + q0.
    for i, expect in [(0b00, 0b00), (0b01, 0b11), (0b10, 0b10), (0b11, 0b01)]:
        e = np.zeros(4)
        e[i] = 1.0
        out = cx01 @ e
        assert np.argmax(np.abs(out)) == expect and abs(out[expect] - 1) < 1e-15
    cx10 = ctrl(X_PAULI, 1, 0)
    for i, expect in [(0b00, 0b00), (0b01, 0b01), (0b10, 0b11), (0b11, 0b10)]:
        e = np.zeros(4)
        e[i] = 1.0
        out = cx10 @ e
        assert np.argmax(np.abs(out)) == expect


# ---------------------------------------------------------------------------
# Golden statevectors: literal matrix products, paper order.
# ---------------------------------------------------------------------------

X0 = 0.37  # feature value (inside every family's domain)
TH = np.array([0.576, 2.450, 1.875, 1.401, 0.314, 1.443, 0.912])  # angle pool


def pipeline_state(name, theta, x=X0, d=1, layers=1):
    """The state under test: full pipeline, complex128, one sample."""
    circ = build_circuit(name, num_qubits=2, num_features=d, num_layers=layers)
    assert circ.num_parameters == len(theta), (
        f"{name}: expected P={len(theta)} at (2 qubits, {layers} layer(s)), "
        f"got {circ.num_parameters}"
    )
    from dqgp.ops.statevector import batched_states  # engine entry point

    Xarr = jnp.asarray(np.atleast_2d(x), jnp.float64)
    return np.asarray(
        batched_states(circ, Xarr, jnp.asarray(theta, jnp.float64), jnp.complex128)
    )[0]


def expected_hubregtsen(theta, x):
    p0, p1, p2 = theta
    return apply([
        on(H_MAT, 0), on(rz(x), 0),
        on(H_MAT, 1), on(rz(x), 1),
        on(ry(p0), 0), on(ry(p1), 1),
        ctrl(rz(p2), 0, 1),
    ])


def test_hubregtsen_golden_matrices():
    th = TH[:3]
    np.testing.assert_allclose(
        pipeline_state("hubregtsen", th), expected_hubregtsen(th, X0), atol=ATOL)


def test_hubregtsen_closed_form_amplitudes():
    """No matrices at all: the state is a product through the Ry block,
    psi_{q1 q0} = A1[q1] A0[q0] * e^{i p2 (2 q1 - 1)/2 [q0 = 1]}, with
    A_k = Ry(p_k) Rz(x) H |0> = [ (c e^{-ix/2} - s e^{ix/2})/sqrt2,
                                  (s e^{-ix/2} + c e^{ix/2})/sqrt2 ]."""
    p0, p1, p2 = TH[:3]
    x = X0

    def qubit_amp(p):
        c, s = np.cos(p / 2), np.sin(p / 2)
        em, ep = np.exp(-1j * x / 2), np.exp(1j * x / 2)
        return np.array([(c * em - s * ep), (s * em + c * ep)]) / np.sqrt(2.0)

    a0, a1 = qubit_amp(p0), qubit_amp(p1)
    expected = np.empty(4, dtype=complex)
    for q1 in (0, 1):
        for q0 in (0, 1):
            crz_phase = np.exp(1j * p2 * (2 * q1 - 1) / 2) if q0 == 1 else 1.0
            expected[2 * q1 + q0] = a1[q1] * a0[q0] * crz_phase
    np.testing.assert_allclose(
        pipeline_state("hubregtsen", TH[:3]), expected, atol=ATOL)


def expected_yz_cx(theta, x):
    p0, p1, p2, p3 = theta
    return apply([
        on(ry(p0 + x), 0), on(rz(p1 + x), 0),
        on(ry(p2 + x), 1), on(rz(p3 + x), 1),
        ctrl(X_PAULI, 0, 1),
    ])


def test_yz_cx_golden_matrices():
    th = TH[:4]
    np.testing.assert_allclose(
        pipeline_state("yz_cx", th), expected_yz_cx(th, X0), atol=ATOL)


def test_yz_cx_closed_form_amplitudes():
    """Rz(b) Ry(a) |0> = cos(a/2) e^{-ib/2} |0> + sin(a/2) e^{ib/2} |1>;
    the CX (control q0, target q1) then maps |q1 q0> -> |q1 xor q0, q0>."""
    p0, p1, p2, p3 = TH[:4]
    x = X0

    def qubit_amp(a, b):
        return np.array([
            np.cos(a / 2) * np.exp(-1j * b / 2),
            np.sin(a / 2) * np.exp(1j * b / 2),
        ])

    a0 = qubit_amp(p0 + x, p1 + x)
    a1 = qubit_amp(p2 + x, p3 + x)
    expected = np.empty(4, dtype=complex)
    for q1 in (0, 1):
        for q0 in (0, 1):
            expected[2 * (q1 ^ q0) + q0] = a1[q1] * a0[q0]
    np.testing.assert_allclose(
        pipeline_state("yz_cx", TH[:4]), expected, atol=ATOL)


def expected_kyriienko(theta, x):
    p0, p1, p2, p3 = theta
    phi = np.arccos(x)
    return apply([
        on(ry(2.0 * phi), 0), on(ry(4.0 * phi), 1),
        on(ry(p0), 0), on(rz(p1), 0),
        on(ry(p2), 1), on(rz(p3), 1),
        ctrl(X_PAULI, 0, 1),
    ])


def test_kyriienko_golden_matrices():
    th = TH[:4]
    np.testing.assert_allclose(
        pipeline_state("kyriienko", th), expected_kyriienko(th, X0), atol=ATOL)


def test_kyriienko_closed_form_amplitudes():
    """Consecutive Ry rotations add: Ry(p) Ry(2(q+1) arccos x) |0> =
    Ry(p + 2(q+1) arccos x) |0>; then as in yz_cx."""
    p0, p1, p2, p3 = TH[:4]
    phi = np.arccos(X0)

    def qubit_amp(a, b):
        return np.array([
            np.cos(a / 2) * np.exp(-1j * b / 2),
            np.sin(a / 2) * np.exp(1j * b / 2),
        ])

    a0 = qubit_amp(p0 + 2 * phi, p1)
    a1 = qubit_amp(p2 + 4 * phi, p3)
    expected = np.empty(4, dtype=complex)
    for q1 in (0, 1):
        for q0 in (0, 1):
            expected[2 * (q1 ^ q0) + q0] = a1[q1] * a0[q0]
    np.testing.assert_allclose(
        pipeline_state("kyriienko", TH[:4]), expected, atol=ATOL)


def expected_chebyshev(theta, x):
    p = theta
    phi = np.arccos(np.clip(x, -1.0, 1.0))
    return apply([
        on(ry(p[0]), 0), on(ry(p[1]), 1),               # initial Ry block
        on(rx(p[2] * phi), 0), on(rx(p[3] * phi), 1),   # Chebyshev towers
        ctrl(rz(p[4]), 0, 1),                           # CRZ ring
        on(ry(p[5]), 0), on(ry(p[6]), 1),               # closing Ry block
    ])


def test_chebyshev_golden_matrices():
    th = TH[:7]
    np.testing.assert_allclose(
        pipeline_state("chebyshev", th), expected_chebyshev(th, X0), atol=ATOL)


def expected_multi_control(theta, x):
    p0, p1, p2 = theta
    return apply([
        on(H_MAT, 0), on(rz(x), 0),
        on(H_MAT, 1), on(rz(x), 1),
        ctrl(rx(p0), 0, 1),
        on(ry(p1), 0), on(ry(p2), 1),
    ])


def test_multi_control_golden_matrices():
    th = TH[:3]
    np.testing.assert_allclose(
        pipeline_state("multi_control", th), expected_multi_control(th, X0),
        atol=ATOL)


def expected_layered(theta, x):
    p = theta
    return apply([
        on(rx(p[0] + x), 0), on(rx(p[1] + x), 1),
        on(ry(p[2]), 0), on(ry(p[3]), 1),
        on(rz(p[4]), 0), on(rz(p[5]), 1),
        ctrl(X_PAULI, 0, 1),
    ])


def test_layered_golden_matrices():
    th = TH[:6]
    np.testing.assert_allclose(
        pipeline_state("layered", th), expected_layered(th, X0), atol=ATOL)


def expected_highdim(theta, x2):
    p0, p1 = theta
    return apply([
        on(ry(p0 + x2[0]), 0),   # layer 0, qubit 0: (0+0) even -> Ry, feature 0
        on(rz(p1 + x2[1]), 1),   # layer 0, qubit 1: (0+1) odd  -> Rz, feature 1
        ctrl(X_PAULI, 0, 1),
    ])


def test_highdim_golden_matrices():
    th = TH[:2]
    x2 = np.array([0.37, -0.61])
    np.testing.assert_allclose(
        pipeline_state("highdim", th, x=x2, d=2), expected_highdim(th, x2),
        atol=ATOL)


# ---------------------------------------------------------------------------
# Multi-layer stacking goldens: 2 qubits / 2 layers as literal matrix
# products. The single-layer goldens above pin each family's per-layer gate
# content; these pin the CROSS-layer composition — layer-block repetition
# order and the parameter index advancing across layers — which the
# parameter-count formulas alone cannot distinguish from, e.g., a circuit
# that re-uses layer-0 parameters or permutes blocks between layers.
# Stacking structure source: the same published descriptions as the 1-layer
# goldens (each family repeats its full encoding+variational layer block;
# chebyshev additionally has a single non-repeated initial Ry block).
# The expected values below never flow through the IR/engine/oracle.
# ---------------------------------------------------------------------------

TH2 = np.array([0.576, 2.450, 1.875, 1.401, 0.314, 1.443, 0.912,
                2.118, 0.207, 1.766, 2.901, 0.655])  # 12-angle pool


def expected_hubregtsen_2layers(theta, x):
    p = theta  # 6 params: [Ry q0, Ry q1, CRZ] x 2 layers
    layer = lambda k: [  # noqa: E731
        on(H_MAT, 0), on(rz(x), 0),
        on(H_MAT, 1), on(rz(x), 1),
        on(ry(p[3 * k + 0]), 0), on(ry(p[3 * k + 1]), 1),
        ctrl(rz(p[3 * k + 2]), 0, 1),
    ]
    return apply(layer(0) + layer(1))


def test_hubregtsen_two_layer_golden():
    th = TH2[:6]
    np.testing.assert_allclose(
        pipeline_state("hubregtsen", th, layers=2),
        expected_hubregtsen_2layers(th, X0), atol=ATOL)


def expected_yz_cx_2layers(theta, x):
    p = theta  # 8 params: [Ry q0, Rz q0, Ry q1, Rz q1] x 2 layers
    layer = lambda k: [  # noqa: E731
        on(ry(p[4 * k + 0] + x), 0), on(rz(p[4 * k + 1] + x), 0),
        on(ry(p[4 * k + 2] + x), 1), on(rz(p[4 * k + 3] + x), 1),
        ctrl(X_PAULI, 0, 1),
    ]
    return apply(layer(0) + layer(1))


def test_yz_cx_two_layer_golden():
    th = TH2[:8]
    np.testing.assert_allclose(
        pipeline_state("yz_cx", th, layers=2),
        expected_yz_cx_2layers(th, X0), atol=ATOL)


def expected_chebyshev_2layers(theta, x):
    p = theta  # 12 params: initial Ry block (2) + [Rx towers (2), CRZ (1),
    phi = np.arccos(np.clip(x, -1.0, 1.0))  # Ry block (2)] x 2 layers
    layer = lambda k: [  # noqa: E731
        on(rx(p[2 + 5 * k + 0] * phi), 0), on(rx(p[2 + 5 * k + 1] * phi), 1),
        ctrl(rz(p[2 + 5 * k + 2]), 0, 1),
        on(ry(p[2 + 5 * k + 3]), 0), on(ry(p[2 + 5 * k + 4]), 1),
    ]
    return apply([on(ry(p[0]), 0), on(ry(p[1]), 1)] + layer(0) + layer(1))


def test_chebyshev_two_layer_golden():
    th = TH2[:12]
    np.testing.assert_allclose(
        pipeline_state("chebyshev", th, layers=2),
        expected_chebyshev_2layers(th, X0), atol=ATOL)


def expected_kyriienko_2layers(theta, x):
    p = theta  # 8 params: [Ry q0, Rz q0, Ry q1, Rz q1] HEA x 2 layers; the
    phi = np.arccos(x)  # Chebyshev-tower feature map repeats per layer
    layer = lambda k: [  # noqa: E731
        on(ry(2.0 * phi), 0), on(ry(4.0 * phi), 1),
        on(ry(p[4 * k + 0]), 0), on(rz(p[4 * k + 1]), 0),
        on(ry(p[4 * k + 2]), 1), on(rz(p[4 * k + 3]), 1),
        ctrl(X_PAULI, 0, 1),
    ]
    return apply(layer(0) + layer(1))


def test_kyriienko_two_layer_golden():
    th = TH2[:8]
    np.testing.assert_allclose(
        pipeline_state("kyriienko", th, layers=2),
        expected_kyriienko_2layers(th, X0), atol=ATOL)


# ---------------------------------------------------------------------------
# Golden kernels: Gram entries, projected features, and the shift gradients,
# all derived from the literal-matrix states.
# ---------------------------------------------------------------------------

XPAIR = np.array([[0.37], [-0.52]])


def test_fidelity_gram_golden():
    """K_ab = |<psi(x_a)|psi(x_b)>|^2 from the literal-matrix states must
    match the full fidelity pipeline (states -> matmul) exactly."""
    th = TH[:3]
    spec = QuantumKernelSpec(
        circuit=build_circuit("hubregtsen", 2, 1, 1), kernel_type="fidelity")
    psis = [expected_hubregtsen(th, float(x)) for x in XPAIR[:, 0]]
    expected = np.empty((2, 2))
    for a in range(2):
        for b in range(2):
            expected[a, b] = abs(np.vdot(psis[a], psis[b])) ** 2
    K = np.asarray(gram(spec, jnp.asarray(XPAIR), jnp.asarray(th),
                        dtype=jnp.float64))
    np.testing.assert_allclose(K, expected, atol=ATOL)


def test_projected_features_and_gram_golden():
    """Pauli features from literal 4x4 operators; the Gaussian outer kernel
    entry exp(-gamma ||f_a - f_b||^2) written out by hand."""
    th = TH[:4]
    circ = build_circuit("yz_cx", 2, 1, 1)
    spec = QuantumKernelSpec(circuit=circ, kernel_type="projected",
                             measurement="XYZ", outer_kernel="gaussian")
    psis = [expected_yz_cx(th, float(x)) for x in XPAIR[:, 0]]
    # Feature layout documented in ops/statevector.pauli_features:
    # [X_0, X_1, Y_0, Y_1, Z_0, Z_1].
    feats = np.array([
        [pauli_expect(p, P, q) for P in (X_PAULI, Y_PAULI, Z_PAULI)
         for q in (0, 1)]
        for p in psis
    ])
    got = np.asarray(kernel_features(spec, jnp.asarray(XPAIR),
                                     jnp.asarray(th), dtype=jnp.float64))
    np.testing.assert_allclose(got, feats, atol=ATOL)

    gamma = 1.0  # squlearn default outer Gaussian: exp(-gamma ||df||^2)
    expected = np.exp(-gamma * ((feats[:, None, :] - feats[None, :, :]) ** 2)
                      .sum(-1))
    K = np.asarray(gram(spec, jnp.asarray(XPAIR), jnp.asarray(th),
                        dtype=jnp.float64))
    np.testing.assert_allclose(K, expected, atol=ATOL)


def test_shift_gradients_golden():
    """The central-difference Gram gradient, recomputed here from literal
    matrices with the reference's exact recipe (wrap to [0, pi) BEFORE
    evaluating, h = pi/8; agent_riemannian.py:38-41, 247-275)."""
    th = TH[:3]
    h = float(np.pi / 8)
    spec = QuantumKernelSpec(
        circuit=build_circuit("hubregtsen", 2, 1, 1), kernel_type="fidelity")

    def literal_gram(theta):
        theta = np.mod(theta, np.pi)
        psis = [expected_hubregtsen(theta, float(x)) for x in XPAIR[:, 0]]
        return np.array([[abs(np.vdot(pa, pb)) ** 2 for pb in psis]
                         for pa in psis])

    expected_dK = np.stack([
        (literal_gram(th + h * np.eye(3)[p]) - literal_gram(th - h * np.eye(3)[p]))
        / (2 * h)
        for p in range(3)
    ])
    K, dK = gram_and_shift_grads(spec, jnp.asarray(XPAIR), jnp.asarray(th),
                                 dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(K), literal_gram(th), atol=ATOL)
    np.testing.assert_allclose(np.asarray(dK), expected_dK, atol=ATOL)


# ---------------------------------------------------------------------------
# Parameter-count formulas from the published structures, at sizes beyond the
# 2-qubit goldens (ring(n) = 1 for n == 2 else n).
# ---------------------------------------------------------------------------

def _ring_len(n):
    return 1 if n == 2 else n


@pytest.mark.parametrize("n,layers", [(2, 1), (3, 1), (3, 2), (4, 3), (5, 4)])
def test_parameter_count_formulas(n, layers):
    expected = {
        "chebyshev": n + layers * (2 * n + _ring_len(n)),
        "yz_cx": 2 * n * layers,
        "hubregtsen": layers * (n + _ring_len(n)),
        "kyriienko": 2 * n * layers,
        "multi_control": layers * (_ring_len(n) + n),
        "layered": 3 * n * layers,
        "highdim": n * layers,
    }
    for name, P in expected.items():
        circ = build_circuit(name, n, 1, layers)
        assert circ.num_parameters == P, (name, n, layers, circ.num_parameters, P)
    # The reference-embedded pin: hubregtsen (3 qubits, 1 layer) has exactly
    # 6 params (main.py:2020-2021 --kernel-params example).
    assert build_circuit("hubregtsen", 3, 1, 1).num_parameters == 6
