"""3-qubit analytic goldens — pinning what 2-qubit goldens provably cannot.

At 2 qubits every entangling layout collapses to the single pair (0, 1):
ring == chain == all-to-all, and per-qubit parameter ordering has only one
nontrivial permutation. So the 2-qubit goldens in test_analytic_goldens.py
cannot distinguish a ring from a chain, cannot see the ring-closure pair
(n-1, 0), and cannot pin CX/CRX *direction* across multiple pairs. These
tests close that hole at 3 qubits / 1 layer, where:

* ring = (0,1), (1,2), (2,0)  — the closure pair (2,0) exists;
* chain = (0,1), (1,2)        — no closure;
* CX/CRX direction matters on every pair (CRZ alone is control-target
  symmetric);
* parameter indices spread across 3 qubits, pinning the interleaved
  per-qubit (Ry, Rz) ordering of yz_cx/kyriienko vs the blocked per-kind
  ordering of layered/chebyshev;
* highdim's feature cycling q -> x[q mod d] becomes visible at d=2.

As in the 2-qubit module, every expected state is a LITERAL matrix product
(8x8 kron placements of textbook gates defined in-test from the
exp(-i theta P / 2) expansions, paper order per the citations in
models/circuits/library.py:14-18 and the reference's family list,
main.py:68-106). Nothing flows through ops/circuit.py, ops/statevector.py,
or the C++ oracle. The complex128 pipeline must
reproduce each state at 1e-12.

A final discriminating-power test proves the goldens would actually catch
the regressions they exist for: chain->ring, flipped CX direction, and
swapped parameter interleave all move the expected state by >= 0.1 in L2.

``random`` is excluded for the same reason as in the 2-qubit module
(documented non-match, docs/PARITY.md tier [guess]).
"""

import numpy as np

import jax.numpy as jnp

from dqgp.models.circuits import build_circuit

ATOL = 1e-12

# ---------------------------------------------------------------------------
# Independent 3-qubit toolbox (plain numpy, defined here — not imported).
# ---------------------------------------------------------------------------

I2 = np.eye(2, dtype=complex)
P0 = np.array([[1, 0], [0, 0]], dtype=complex)
P1 = np.array([[0, 0], [0, 1]], dtype=complex)
X_PAULI = np.array([[0, 1], [1, 0]], dtype=complex)
H_MAT = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2.0)


def rx(t):
    c, s = np.cos(t / 2), np.sin(t / 2)
    return np.array([[c, -1j * s], [-1j * s, c]])


def ry(t):
    c, s = np.cos(t / 2), np.sin(t / 2)
    return np.array([[c, -s], [s, c]], dtype=complex)


def rz(t):
    return np.array([[np.exp(-1j * t / 2), 0], [0, np.exp(1j * t / 2)]])


def on3(U, q):
    """U on qubit q of 3; qubit 0 is the least-significant bit of the state
    index (ops/circuit.py Gate docstring), so the kron order is m2 (x) m1 (x) m0."""
    mats = [I2, I2, I2]
    mats[q] = U
    return np.kron(np.kron(mats[2], mats[1]), mats[0])


def ctrl3(U, control, target):
    """Controlled-U on 3 qubits: P0_c (x) I + P1_c (x) U_t, literal kron."""
    assert control != target
    m_off = [I2, I2, I2]
    m_off[control] = P0
    m_on = [I2, I2, I2]
    m_on[control] = P1
    m_on[target] = U
    return (np.kron(np.kron(m_off[2], m_off[1]), m_off[0])
            + np.kron(np.kron(m_on[2], m_on[1]), m_on[0]))


def apply(ops):
    psi = np.zeros(8, dtype=complex)
    psi[0] = 1.0
    for U in ops:
        psi = U @ psi
    return psi


def test_ctrl3_helper_truth_table():
    """Sanity-pin ctrl3 itself: CX(control=2, target=0) flips bit 0 iff bit 2
    is set — checked over all 8 basis states from the index arithmetic."""
    cx20 = ctrl3(X_PAULI, 2, 0)
    for i in range(8):
        expect = i ^ 1 if (i >> 2) & 1 else i
        e = np.zeros(8)
        e[i] = 1.0
        out = cx20 @ e
        assert np.argmax(np.abs(out)) == expect and abs(out[expect] - 1) < 1e-15
    cx01 = ctrl3(X_PAULI, 0, 1)
    for i in range(8):
        expect = i ^ 2 if i & 1 else i
        e = np.zeros(8)
        e[i] = 1.0
        assert np.argmax(np.abs(cx01 @ e)) == expect


# ---------------------------------------------------------------------------
# Pipeline state under test.
# ---------------------------------------------------------------------------

X0 = 0.37
X1 = -0.52  # second feature for the highdim d=2 cycling test
# First six values = the reference's own --kernel-params example for
# hubregtsen at (3 qubits, 1 layer) (main.py:2020-2021, BASELINE config #1).
TH = np.array([0.576, 2.450, 1.875, 1.401, 0.314, 1.443,
               0.912, 2.071, 0.233, 1.694, 2.818, 0.655])


def pipeline_state(name, theta, x=X0, d=1, layers=1):
    circ = build_circuit(name, num_qubits=3, num_features=d, num_layers=layers)
    assert circ.num_parameters == len(theta), (
        f"{name}: expected P={len(theta)} at (3 qubits, {layers} layer(s)), "
        f"got {circ.num_parameters}"
    )
    from dqgp.ops.statevector import batched_states

    Xarr = jnp.asarray(np.atleast_2d(x), jnp.float64)
    return np.asarray(
        batched_states(circ, Xarr, jnp.asarray(theta, jnp.float64), jnp.complex128)
    )[0]


# ---------------------------------------------------------------------------
# Expected states: literal matrix products, paper order.
# ---------------------------------------------------------------------------


def expected_hubregtsen3(th, x):
    """arXiv:2105.02276 at 3 qubits: H + Rz(x) per qubit, Ry(p) block,
    CRZ(p) ring (0,1)(1,2)(2,0). P = 6 — the reference's own 6-value
    --kernel-params example pins this count (main.py:2020-2021)."""
    return apply(
        [U for q in range(3) for U in (on3(H_MAT, q), on3(rz(x), q))]
        + [on3(ry(th[q]), q) for q in range(3)]
        + [ctrl3(rz(th[3]), 0, 1), ctrl3(rz(th[4]), 1, 2), ctrl3(rz(th[5]), 2, 0)]
    )


def expected_yz_cx3(th, x):
    """arXiv:2108.01039 at 3 qubits: per qubit Ry(p + x) then Rz(p + x)
    (interleaved parameter order p0,p1 | p2,p3 | p4,p5), CX chain (0,1)(1,2)."""
    return apply(
        [U for q in range(3)
         for U in (on3(ry(th[2 * q] + x), q), on3(rz(th[2 * q + 1] + x), q))]
        + [ctrl3(X_PAULI, 0, 1), ctrl3(X_PAULI, 1, 2)]
    )


def expected_kyriienko3(th, x):
    """arXiv:2011.10395 at 3 qubits: Chebyshev tower Ry(2(q+1) arccos x),
    HEA block Ry(p) Rz(p) per qubit (interleaved), CX chain."""
    a = np.arccos(x)
    return apply(
        [on3(ry(2.0 * (q + 1) * a), q) for q in range(3)]
        + [U for q in range(3)
           for U in (on3(ry(th[2 * q]), q), on3(rz(th[2 * q + 1]), q))]
        + [ctrl3(X_PAULI, 0, 1), ctrl3(X_PAULI, 1, 2)]
    )


def expected_chebyshev3(th, x):
    """squlearn ChebyshevPQC at 3 qubits: initial Ry(p) block (p0..p2), per
    layer Rx(p * arccos x) towers (p3..p5), CRZ(p) ring (p6..p8), Ry(p)
    block (p9..p11). Blocked (not interleaved) parameter order. P = 12."""
    a = np.arccos(x)
    return apply(
        [on3(ry(th[q]), q) for q in range(3)]
        + [on3(rx(th[3 + q] * a), q) for q in range(3)]
        + [ctrl3(rz(th[6]), 0, 1), ctrl3(rz(th[7]), 1, 2), ctrl3(rz(th[8]), 2, 0)]
        + [on3(ry(th[9 + q]), q) for q in range(3)]
    )


def expected_multi_control3(th, x):
    """MultiControl at 3 qubits: H + Rz(x) per qubit, trainable CRX(p) ring
    (0,1)(1,2)(2,0) — CRX is direction-asymmetric, so this pins control ->
    target orientation — then Ry(p) block. P = 6."""
    return apply(
        [U for q in range(3) for U in (on3(H_MAT, q), on3(rz(x), q))]
        + [ctrl3(rx(th[0]), 0, 1), ctrl3(rx(th[1]), 1, 2), ctrl3(rx(th[2]), 2, 0)]
        + [on3(ry(th[3 + q]), q) for q in range(3)]
    )


def expected_layered3(th, x):
    """Layered gates=['RX','RY','RZ'] at 3 qubits: Rx(p + x) block (p0..p2),
    Ry(p) block (p3..p5), Rz(p) block (p6..p8), CX chain. P = 9."""
    return apply(
        [on3(rx(th[q] + x), q) for q in range(3)]
        + [on3(ry(th[3 + q]), q) for q in range(3)]
        + [on3(rz(th[6 + q]), q) for q in range(3)]
        + [ctrl3(X_PAULI, 0, 1), ctrl3(X_PAULI, 1, 2)]
    )


def expected_highdim3(th, x):
    """HighDim at 3 qubits, layer 0: alternating Ry/Rz(p + x[q mod d]) —
    q0 Ry, q1 Rz, q2 Ry — then a CX ring (0,1)(1,2)(2,0). P = 3.
    ``x`` is a length-d vector; feature f cycles q -> x[q mod d]."""
    x = np.atleast_1d(x)
    d = len(x)
    rots = [ry if q % 2 == 0 else rz for q in range(3)]
    return apply(
        [on3(rots[q](th[q] + x[q % d]), q) for q in range(3)]
        + [ctrl3(X_PAULI, 0, 1), ctrl3(X_PAULI, 1, 2), ctrl3(X_PAULI, 2, 0)]
    )


def test_hubregtsen_3q_golden():
    th = TH[:6]
    np.testing.assert_allclose(
        pipeline_state("hubregtsen", th), expected_hubregtsen3(th, X0), atol=ATOL)


def test_yz_cx_3q_golden():
    th = TH[:6]
    np.testing.assert_allclose(
        pipeline_state("yz_cx", th), expected_yz_cx3(th, X0), atol=ATOL)


def test_kyriienko_3q_golden():
    th = TH[:6]
    np.testing.assert_allclose(
        pipeline_state("kyriienko", th), expected_kyriienko3(th, X0), atol=ATOL)


def test_chebyshev_3q_golden():
    th = TH[:12]
    np.testing.assert_allclose(
        pipeline_state("chebyshev", th), expected_chebyshev3(th, X0), atol=ATOL)


def test_multi_control_3q_golden():
    th = TH[:6]
    np.testing.assert_allclose(
        pipeline_state("multi_control", th), expected_multi_control3(th, X0),
        atol=ATOL)


def test_layered_3q_golden():
    th = TH[:9]
    np.testing.assert_allclose(
        pipeline_state("layered", th), expected_layered3(th, X0), atol=ATOL)


def test_highdim_3q_golden_d1():
    th = TH[:3]
    np.testing.assert_allclose(
        pipeline_state("highdim", th), expected_highdim3(th, np.array([X0])),
        atol=ATOL)


def test_highdim_3q_golden_d2_feature_cycling():
    """d=2 at 3 qubits forces the feature wrap q2 -> x0: the only offline
    check that the f % d cycling lands features on the right qubits."""
    th = TH[:3]
    x = np.array([X0, X1])
    np.testing.assert_allclose(
        pipeline_state("highdim", th, x=x, d=2), expected_highdim3(th, x),
        atol=ATOL)


# ---------------------------------------------------------------------------
# Discriminating power: the goldens must actually separate the regressions
# they exist to catch. (At 2 qubits each of these perturbations is exactly
# zero — that is the gap this module closes.)
# ---------------------------------------------------------------------------


def test_goldens_discriminate_topology_direction_and_ordering():
    th6 = TH[:6]

    # chain -> ring on yz_cx: a spurious closure CX(2,0) moves the state.
    good = expected_yz_cx3(th6, X0)
    ringed = ctrl3(X_PAULI, 2, 0) @ good
    assert np.linalg.norm(good - ringed) > 0.1

    # flipped CX direction on the chain's second pair.
    flipped = apply(
        [U for q in range(3)
         for U in (on3(ry(th6[2 * q] + X0), q), on3(rz(th6[2 * q + 1] + X0), q))]
        + [ctrl3(X_PAULI, 0, 1), ctrl3(X_PAULI, 2, 1)]
    )
    assert np.linalg.norm(good - flipped) > 0.1

    # flipped CRX orientation on multi_control's closure pair (0,2) vs (2,0).
    mc_good = expected_multi_control3(th6, X0)
    mc_flip = apply(
        [U for q in range(3) for U in (on3(H_MAT, q), on3(rz(X0), q))]
        + [ctrl3(rx(th6[0]), 0, 1), ctrl3(rx(th6[1]), 1, 2), ctrl3(rx(th6[2]), 0, 2)]
        + [on3(ry(th6[3 + q]), q) for q in range(3)]
    )
    assert np.linalg.norm(mc_good - mc_flip) > 0.1

    # swapped parameter interleave (Rz before Ry per qubit) on kyriienko.
    ky_good = expected_kyriienko3(th6, X0)
    a = np.arccos(X0)
    ky_swapped = apply(
        [on3(ry(2.0 * (q + 1) * a), q) for q in range(3)]
        + [U for q in range(3)
           for U in (on3(rz(th6[2 * q]), q), on3(ry(th6[2 * q + 1]), q))]
        + [ctrl3(X_PAULI, 0, 1), ctrl3(X_PAULI, 1, 2)]
    )
    assert np.linalg.norm(ky_good - ky_swapped) > 0.1

    # broken feature cycling on highdim at d=2: feeding x[q % 1] (x0
    # everywhere) instead of x[q % 2] must move the state — i.e. the d=2
    # golden genuinely pins which feature lands on which qubit (ADVICE r4).
    th3 = TH[:3]
    x2 = np.array([X0, X1])
    hd_good = expected_highdim3(th3, x2)
    hd_cycle_broken = expected_highdim3(th3, np.array([X0]))  # q -> x[q % 1]
    assert abs(X0 - X1) > 0.1  # the perturbation is non-trivial by input
    assert np.linalg.norm(hd_good - hd_cycle_broken) > 0.1
