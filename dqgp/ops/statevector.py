"""Batched statevector engine (pure XLA reference path).

Replacement for the reference's per-pair qiskit-aer C++ simulator
calls (agent_riemannian.py:116-119, main.py:245): instead of simulating the
encoding circuit once per Gram *pair* (O(N^2) circuit runs), we prepare all N
sample states in ONE batched pass — the key algebraic win is that both kernel
families factor through per-sample states (fidelity Gram = |Psi Psi^H|^2, one
matmul; projected features = per-qubit Pauli expectations, O(N) states).

Everything here is traced once under jit with a static ``Circuit``; the gate
loop unrolls into a handful of fused elementwise XLA kernels over the
(batch, 2^n) state array.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .circuit import (
    CRX, CRY, CRZ, CX, CZ, ENC_ARCCOS, H, RX, RY, RZ, RZZ,
    Circuit, Gate,
)

_SQRT1_2 = 0.7071067811865476


def angle_matrix(
    circuit: Circuit, X: jax.Array, theta: jax.Array, dtype=jnp.float32
) -> jax.Array:
    """Compute the (N, G) rotation-angle matrix for every sample and gate.

    angle[n, g] = const_g + pc_g * theta[pidx_g]
                  + (fc_g + pf_g * theta[pidx_g]) * enc_g(X[n, fidx_g])

    ``dtype`` selects the precision of the whole downstream state pipeline:
    float32 (default, the training path) or float64 (reporting
    paths that need reference-grade f64 Grams — the reference simulates in
    double-precision qiskit-aer; under DQGP_X64=0 a float64 request silently
    degrades to float32 like every other f64 use in the package).
    """
    arr = circuit.static_arrays()
    Xf = X.astype(dtype)
    th = theta.astype(dtype)

    # Pad so parameter-free circuits (and pidx=-1 gates clamped to 0) index safely.
    th_pad = jnp.concatenate([th, jnp.zeros((1,), dtype)])
    th_g = th_pad[arr["pidx"]] * arr["has_p"]                  # (G,)
    xg = Xf[:, arr["fidx"]]                                    # (N, G)
    # arccos hard-clipped to its domain; the chebyshev data path additionally
    # clips inputs to [-0.99, 0.99] as the reference does (main.py:224-236).
    encoded = jnp.where(
        arr["enc"][None, :] == ENC_ARCCOS,
        jnp.arccos(jnp.clip(xg, -1.0, 1.0)),
        xg,
    ) * arr["has_f"][None, :]

    a = (
        arr["const"][None, :]
        + arr["pc"][None, :] * th_g[None, :]
        + (arr["fc"][None, :] + arr["pf"][None, :] * th_g[None, :]) * encoded
    )
    return a


def _split(state: jax.Array, q: int, n: int):
    """View the batched state (B, 2^n) with qubit q isolated: returns s0, s1
    of shape (B, 2^(n-1-q), 2^q) — qubit 0 is the least-significant bit."""
    b = state.shape[0]
    s = state.reshape(b, 1 << (n - 1 - q), 2, 1 << q)
    return s[:, :, 0, :], s[:, :, 1, :]


def _merge(n0: jax.Array, n1: jax.Array, q: int, n: int):
    b = n0.shape[0]
    return jnp.stack([n0, n1], axis=2).reshape(b, 1 << n)


def _control_mask(control: int, n: int) -> np.ndarray:
    idx = np.arange(1 << n)
    return ((idx >> control) & 1).astype(bool)


def _real_dtype(cdtype) -> jnp.dtype:
    """Real dtype matching a complex state dtype (trig precision must track
    the state's precision: f32 angles inside a complex128 pipeline would cap
    the whole f64 path at f32 accuracy)."""
    return jnp.float64 if cdtype == jnp.complex128 else jnp.float32


def apply_gate(state: jax.Array, gate: Gate, angle: jax.Array, n: int) -> jax.Array:
    """Apply one gate to a batch of states. ``angle`` has shape (B,)."""
    q = gate.qubit
    kind = gate.kind

    if kind == CX:
        idx = np.arange(1 << n)
        perm = np.where((idx >> gate.control) & 1, idx ^ (1 << q), idx)
        return jnp.take(state, jnp.asarray(perm), axis=-1)

    if kind == CZ:
        idx = np.arange(1 << n)
        sign = np.where(((idx >> gate.control) & 1) & ((idx >> q) & 1), -1.0, 1.0)
        return state * jnp.asarray(sign, state.dtype)

    if kind == RZZ:
        # exp(-i a/2 Z_c Z_t): phase e^{-ia/2} where bits agree, e^{+ia/2} otherwise.
        idx = np.arange(1 << n)
        agree = (((idx >> gate.control) & 1) == ((idx >> q) & 1))
        sgn = jnp.asarray(np.where(agree, 1.0, -1.0), _real_dtype(state.dtype))
        half = (0.5 * angle).astype(_real_dtype(state.dtype))[:, None]
        # e^{-i a/2 * (±1)} = cos(a/2) ∓ i sin(a/2)
        phase = jnp.cos(half) - 1j * sgn[None, :] * jnp.sin(half)
        return state * phase.astype(state.dtype)

    if kind == H:
        s0, s1 = _split(state, q, n)
        return _merge((s0 + s1) * _SQRT1_2, (s0 - s1) * _SQRT1_2, q, n)

    half = (0.5 * angle).astype(_real_dtype(state.dtype))
    c = jnp.cos(half)[:, None, None].astype(state.dtype)
    s = jnp.sin(half)[:, None, None]

    def rotated(st):
        s0, s1 = _split(st, q, n)
        if kind in (RX, CRX):
            isn = (1j * s).astype(st.dtype)
            return _merge(c * s0 - isn * s1, -isn * s0 + c * s1, q, n)
        if kind in (RY, CRY):
            sn = s.astype(st.dtype)
            return _merge(c * s0 - sn * s1, sn * s0 + c * s1, q, n)
        if kind in (RZ, CRZ):
            e_m = (jnp.cos(half) - 1j * jnp.sin(half))[:, None, None].astype(st.dtype)
            e_p = (jnp.cos(half) + 1j * jnp.sin(half))[:, None, None].astype(st.dtype)
            return _merge(e_m * s0, e_p * s1, q, n)
        raise ValueError(f"unsupported gate kind {kind}")

    new = rotated(state)
    if kind in (CRX, CRY, CRZ):
        mask = jnp.asarray(_control_mask(gate.control, n))
        return jnp.where(mask[None, :], new, state)
    return new


def state_from_angles(
    circuit: Circuit, angles: jax.Array, dtype=jnp.complex64
) -> jax.Array:
    """Run the gate sequence on |0...0> for a batch of per-sample angles.

    angles: (B, G) — one row per sample (from ``angle_matrix``).
    Returns (B, 2^n) complex states.
    """
    b = angles.shape[0]
    state = jnp.zeros((b, circuit.dim), dtype).at[:, 0].set(1.0)
    for gi, gate in enumerate(circuit.gates):
        state = apply_gate(state, gate, angles[:, gi], circuit.num_qubits)
    return state


def batched_states(
    circuit: Circuit, X: jax.Array, theta: jax.Array, dtype=jnp.complex64
) -> jax.Array:
    """States Psi(x_i; theta) for a whole batch: (N, 2^n)."""
    return state_from_angles(
        circuit, angle_matrix(circuit, X, theta, _real_dtype(dtype)), dtype
    )


def pauli_features(state: jax.Array, num_qubits: int) -> jax.Array:
    """Single-qubit Pauli expectations: (B, 3*n) ordered [X_0..X_{n-1}, Y.., Z..].

    These are the projected-quantum-kernel features (squlearn measurement
    "XYZ"; reference main.py:1994-1995). Ordering is documented but
    immaterial: every supported outer kernel is invariant to feature
    permutation (they depend only on distances / dot products).
    """
    xs, ys, zs = [], [], []
    for q in range(num_qubits):
        s0, s1 = _split(state, q, num_qubits)
        cross = jnp.sum(jnp.conj(s0) * s1, axis=(1, 2))
        xs.append(2.0 * jnp.real(cross))
        ys.append(2.0 * jnp.imag(cross))
        zs.append(jnp.sum(jnp.abs(s0) ** 2 - jnp.abs(s1) ** 2, axis=(1, 2)))
    return jnp.stack(xs + ys + zs, axis=-1).astype(_real_dtype(state.dtype))


def pauli_string_expectation(state: jax.Array, pauli: str) -> jax.Array:
    """<psi| P |psi> for a full n-qubit Pauli string like "XXIZ".

    Character k of ``pauli`` acts on qubit k (qubit 0 = least-significant bit).
    Used for squlearn-style explicit multi-qubit measurement lists.
    """
    n = len(pauli)
    if state.shape[-1] != (1 << n):
        raise ValueError("pauli string length does not match state size")
    phi = state
    for q, ch in enumerate(pauli.upper()):
        if ch == "I":
            continue
        s0, s1 = _split(phi, q, n)
        if ch == "X":
            phi = _merge(s1, s0, q, n)
        elif ch == "Y":
            phi = _merge(-1j * s1, 1j * s0, q, n)
        elif ch == "Z":
            phi = _merge(s0, -s1, q, n)
        else:
            raise ValueError(f"bad Pauli character {ch!r}")
    return jnp.real(jnp.sum(jnp.conj(state) * phi, axis=-1))
