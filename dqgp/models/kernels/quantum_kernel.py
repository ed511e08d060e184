"""Quantum kernels: fidelity and projected, batched into matmuls.

Replaces the reference's squlearn FidelityKernel / ProjectedQuantumKernel
usage (main.py:43-145; agent_riemannian.py:87-111). Key algebraic re-design
(SURVEY.md §7): both kernels factor through per-sample statevectors, so

* fidelity:   K = |Psi_A Psi_B^H|^2     — one batched state pass + one matmul
              (the reference runs N^2 independent circuit simulations);
* projected:  F(x) = single-qubit Pauli expectations of |psi(x)>, then an
              outer kernel on F — O(N) state preparations, one matmul.

Parameter-shift gradients batch all 2P+1 shifted parameter vectors through a
single vmapped state pass. For reference parity the "shift rule" is exactly
the reference's central finite difference with h = pi/8 and parameters wrapped
to the torus BEFORE evaluation (agent_riemannian.py:38-41, 247-275 — the wrap
changes the physics near the period boundary, so it is load-bearing).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ...ops.circuit import Circuit
from ...ops.statevector import (
    angle_matrix,
    batched_states,
    pauli_features,
    pauli_string_expectation,
    state_from_angles,
)
from ...manifold import PERIOD
from .outer import outer_gram
from ..circuits import build_circuit

Measurement = Union[str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class QuantumKernelSpec:
    """Static (hashable) kernel description — usable as a jit static arg."""

    circuit: Circuit
    kernel_type: str = "fidelity"          # 'fidelity' | 'projected'
    measurement: Measurement = "XYZ"       # chars of single-qubit Paulis, or
                                           # a tuple of full Pauli strings
    outer_kernel: str = "gaussian"
    outer_kernel_params: Tuple[Tuple[str, float], ...] = ()
    regularization: Optional[str] = None   # 'thresholding' | 'tikhonov' | None

    def __post_init__(self):
        if self.kernel_type not in ("fidelity", "projected"):
            raise ValueError(
                f"Unknown kernel type: {self.kernel_type}. Supported: 'fidelity', 'projected'"
            )
        if isinstance(self.measurement, list):
            object.__setattr__(self, "measurement", tuple(self.measurement))
        # Validate measurements HERE so bad specs fail with a clear error at
        # construction, not a KeyError deep inside a jit trace. Semantics:
        # a string (or a tuple of single chars) = per-qubit Pauli blocks from
        # 'XYZ'; a tuple of longer strings = full n-qubit Pauli strings over
        # 'IXYZ', each exactly num_qubits long. Fidelity kernels never
        # consult the field, so only projected specs are validated — a
        # nonconforming value in the dead field must not break working code.
        if self.kernel_type != "projected":
            return
        m = self.measurement
        if isinstance(m, str):
            if not m or any(c not in "XYZ" for c in m.upper()):
                raise ValueError(
                    f"Bad measurement string {m!r}; use chars from 'XYZ'")
        else:
            if not m:
                raise ValueError("measurement tuple is empty")
            if all(len(p) == 1 for p in m):
                if any(p.upper() not in "XYZ" for p in m):
                    raise ValueError(
                        f"Bad per-qubit measurement {m!r}; single-char "
                        f"entries must come from 'XYZ'")
            else:
                n = self.circuit.num_qubits
                for p in m:
                    if len(p) != n or any(c not in "IXYZ" for c in p.upper()):
                        raise ValueError(
                            f"Bad Pauli string {p!r} in measurement {m!r}: "
                            f"full strings must be exactly num_qubits={n} "
                            f"chars from 'IXYZ' (single chars = per-qubit "
                            f"blocks, which cannot be mixed with full "
                            f"strings)")

    @property
    def num_parameters(self) -> int:
        return self.circuit.num_parameters

    @property
    def outer_params(self) -> Dict[str, float]:
        return dict(self.outer_kernel_params)


# ---------------------------------------------------------------------------
# Feature computation
# ---------------------------------------------------------------------------


def _measurement_selector(spec: QuantumKernelSpec) -> Tuple[str, ...]:
    m = spec.measurement
    if isinstance(m, str):
        chars = tuple(m.upper())
        if not chars or any(c not in "XYZ" for c in chars):
            raise ValueError(f"Bad measurement string {m!r}; use chars from 'XYZ'")
        return chars
    return tuple(p.upper() for p in m)


def features_from_angles(spec: QuantumKernelSpec, angles: jax.Array) -> jax.Array:
    """Features from a precomputed (B, G) angle matrix through the XLA
    gate-by-gate engine. Shapes: (B, 2^n) complex for fidelity, (B, D) real
    for projected.

    Precision follows ``angles.dtype``: float64 angles (from
    ``angle_matrix(..., dtype=float64)``) run the whole pipeline in
    complex128/float64 — the reference-grade precision of qiskit-aer's
    double-precision statevectors, used by reporting paths like the
    driver's host condition-number backfill.
    """
    n = spec.circuit.num_qubits
    f64 = angles.dtype == jnp.float64
    cdtype = jnp.complex128 if f64 else jnp.complex64
    m = _measurement_selector(spec) if spec.kernel_type == "projected" else None
    states = state_from_angles(spec.circuit, angles, cdtype)

    if spec.kernel_type == "projected" and all(len(s) == 1 for s in m):
        full = pauli_features(states, n)
        blocks = {"X": full[:, :n], "Y": full[:, n : 2 * n], "Z": full[:, 2 * n :]}
        return jnp.concatenate([blocks[c] for c in m], axis=-1)
    if spec.kernel_type == "fidelity":
        return states
    # explicit multi-qubit Pauli strings
    cols = [pauli_string_expectation(states, p) for p in m]
    return jnp.stack(cols, axis=-1).astype(jnp.float64 if f64 else jnp.float32)


def kernel_features(
    spec: QuantumKernelSpec, X: jax.Array, theta: jax.Array, dtype=jnp.float32
) -> jax.Array:
    """Per-sample features: complex states for fidelity, Pauli-expectation
    vectors for projected. Shapes: (N, 2^n) complex64 / (N, D) float32.
    ``dtype=float64`` runs the reference-grade complex128 pipeline
    (see ``features_from_angles``)."""
    return features_from_angles(spec, angle_matrix(spec.circuit, X, theta, dtype))


def regularize_gram(K: jax.Array, method: Optional[str]) -> jax.Array:
    """Square-Gram regularization (squlearn semantics, main.py:2011-2013):

    * thresholding — eigenvalue clip at 0 (drop negative spectrum);
    * tikhonov    — shift by the most negative eigenvalue if any.
    """
    if method is None:
        return K
    if method == "thresholding":
        w, v = jnp.linalg.eigh(K)
        w = jnp.maximum(w, 0.0)
        return (v * w[..., None, :]) @ jnp.swapaxes(v, -1, -2)
    if method == "tikhonov":
        w = jnp.linalg.eigvalsh(K)
        lam_min = jnp.min(w)
        shift = jnp.where(lam_min < 0.0, -lam_min, 0.0)
        return K + shift * jnp.eye(K.shape[-1], dtype=K.dtype)
    raise ValueError(f"Unknown regularization {method!r}")


def gram_from_features(
    spec: QuantumKernelSpec, FA: jax.Array, FB: Optional[jax.Array] = None
) -> jax.Array:
    """Gram matrix from precomputed features; FB=None means symmetric Gram
    (and triggers regularization, which squlearn applies to square Grams)."""
    symmetric = FB is None
    FB = FA if FB is None else FB
    if spec.kernel_type == "fidelity":
        # K = |<psi_a|psi_b>|^2 via two real matmuls.
        ar, ai = jnp.real(FA), jnp.imag(FA)
        br, bi = jnp.real(FB), jnp.imag(FB)
        re = ar @ br.T + ai @ bi.T
        im = ar @ bi.T - ai @ br.T
        K = re * re + im * im
    else:
        K = outer_gram(spec.outer_kernel, FA, FB, spec.outer_params)
    if symmetric:
        K = regularize_gram(K, spec.regularization)
    return K


def gram(
    spec: QuantumKernelSpec,
    XA: jax.Array,
    theta: jax.Array,
    XB: Optional[jax.Array] = None,
    dtype=jnp.float32,
) -> jax.Array:
    """K(XA, XB; theta). XB=None computes the symmetric training Gram.
    ``dtype=float64`` builds the Gram through the complex128 statevector
    pipeline — entry accuracy then matches the reference's double-precision
    qiskit-aer construction (reporting paths; the training step stays
    f32)."""
    FA = kernel_features(spec, XA, theta, dtype)
    FB = None if XB is None else kernel_features(spec, XB, theta, dtype)
    return gram_from_features(spec, FA, FB)


# ---------------------------------------------------------------------------
# Parameter-shift (central-difference) Gram gradients — reference parity
# ---------------------------------------------------------------------------


def shift_parameter_batch(theta: jax.Array, h: float, period: float = PERIOD) -> jax.Array:
    """(2P+1, P) batch: [wrap(theta); wrap(theta +/- h e_p) ...].

    Row 0 is the unshifted point; rows 1+2p / 2+2p are +/- shifts of
    parameter p. All rows wrapped to [0, period) exactly as the reference's
    worker does (agent_riemannian.py:38-41)."""
    P = theta.shape[0]
    eye = jnp.eye(P, dtype=theta.dtype)
    plus = theta[None, :] + h * eye
    minus = theta[None, :] - h * eye
    stacked = jnp.concatenate([theta[None, :], plus, minus], axis=0)
    return jnp.mod(stacked, period)


def gram_and_shift_grads(
    spec: QuantumKernelSpec,
    X: jax.Array,
    theta: jax.Array,
    h: float = float(np.pi / 8),
    period: float = PERIOD,
    dtype=jnp.float32,
) -> Tuple[jax.Array, jax.Array]:
    """(K, dK/dtheta) with the reference's central difference.

    dK[p] = (K(wrap(theta + h e_p)) - K(wrap(theta - h e_p))) / (2h)
    (agent_riemannian.py:247-275 — note: finite difference, not the exact
    two-term parameter-shift rule; SURVEY.md §2.6 quirk (b)).

    Returns K (N, N) and dK (P, N, N). All 2P+1 Gram evaluations run as one
    vmapped batch — the reference fans them out as separate OS processes that
    each rebuild the circuit from scratch. ``dtype=float64`` routes every
    shifted Gram through the complex128 pipeline (see ``gram``).
    """
    thetas = shift_parameter_batch(theta, h, period)          # (2P+1, P)
    # Angle matrices per shifted theta are cheap elementwise work; the state
    # preparation for ALL shifts is then ONE flattened batch through the
    # feature engine.
    A = jax.vmap(lambda t: angle_matrix(spec.circuit, X, t, dtype))(thetas)  # (S, N, G)
    S, N, G = A.shape
    flat = features_from_angles(spec, A.reshape(S * N, G))
    feats = flat.reshape(S, N, flat.shape[-1])
    grams = jax.vmap(lambda f: gram_from_features(spec, f))(feats)
    K = grams[0]
    P = theta.shape[0]
    dK = (grams[1 : 1 + P] - grams[1 + P :]) / (2.0 * h)
    return K, dK


# ---------------------------------------------------------------------------
# Facade mirroring the squlearn kernel API used by the reference
# ---------------------------------------------------------------------------


class QuantumKernel:
    """API-parity facade over the functional kernel ops.

    Mirrors the squlearn surface the reference touches:
    ``num_parameters`` / ``assign_parameters`` / ``_parameters`` /
    ``evaluate`` / ``evaluate_derivatives`` (main.py:198-205, 245, 1413-1430;
    agent_riemannian.py:114-118, 402-404).

    Precision: the squlearn surface this mirrors is genuinely float64
    (qiskit-aer simulates in double precision, agent_riemannian.py:114-119),
    so ``dtype="auto"`` resolves to float64 wherever x64 is enabled and the
    returned entries are reference-grade — pinned against the C++
    double-precision oracle at 1e-12 (test_native.py). Pass
    ``dtype="float32"``/``"float64"`` to force either.
    """

    def __init__(self, spec: QuantumKernelSpec, dtype: str = "auto"):
        from ...config import resolve_gram_dtype

        self.spec = spec
        self._dtype = jnp.dtype(resolve_gram_dtype(dtype))
        self._parameters: Optional[jnp.ndarray] = None
        dt = self._dtype
        self._gram_jit = jax.jit(
            lambda XA, th, XB: gram(spec, XA, th, XB, dtype=dt), static_argnums=()
        )
        self._sym_gram_jit = jax.jit(lambda XA, th: gram(spec, XA, th, dtype=dt))
        self._grads_jit = jax.jit(
            lambda X, th, h: gram_and_shift_grads(spec, X, th, h, dtype=dt)
        )

    @property
    def num_parameters(self) -> int:
        return self.spec.num_parameters

    @property
    def encoding_circuit(self) -> Circuit:
        return self.spec.circuit

    def assign_parameters(self, params) -> None:
        self._parameters = jnp.asarray(params, self._dtype)

    def evaluate(self, XA, XB=None) -> np.ndarray:
        # Symmetric-vs-cross is decided on Python object identity — a value
        # comparison would force a host<->device sync on every call. The one
        # case where the routing changes the RESULT is a regularized kernel
        # (squlearn regularizes square Grams only), so there a value-equal
        # XB still gets the symmetric path, paying the comparison.
        if self._parameters is None:
            raise ValueError("parameters not assigned")
        XA_j = jnp.asarray(XA)
        symmetric = XB is None or XB is XA
        if (not symmetric and self.spec.regularization is not None
                and np.shape(XB) == np.shape(XA)):  # metadata only, no sync
            symmetric = np.array_equal(np.asarray(XB), np.asarray(XA))
        if symmetric:
            K = self._sym_gram_jit(XA_j, self._parameters)
        else:
            K = self._gram_jit(XA_j, self._parameters, jnp.asarray(XB))
        return np.asarray(K, np.float64)

    def evaluate_derivatives(self, XA, XB=None, values=("K", "dKdp"), h=float(np.pi / 8)):
        if self._parameters is None:
            raise ValueError("parameters not assigned")
        # Only the symmetric (XA, XA) case exists: the reference never asks
        # for cross derivatives (agent_riemannian.py:402-404 passes (X, X)).
        # Silently returning the symmetric answer for a different XB would
        # be wrong values AND wrong shape — refuse instead. (Cold facade
        # path, so a value comparison is affordable here.)
        if XB is not None and XB is not XA and not (
                np.shape(XB) == np.shape(XA)
                and np.array_equal(np.asarray(XB), np.asarray(XA))):
            raise NotImplementedError(
                "evaluate_derivatives supports only the symmetric case "
                "(XB is None or XB == XA); cross-Gram derivatives are not "
                "part of the reference surface")
        K, dK = self._grads_jit(jnp.asarray(XA), self._parameters, h)
        out = {}
        if "K" in values:
            out["K"] = np.asarray(K, np.float64)
        if "dKdp" in values:
            out["dKdp"] = np.asarray(dK, np.float64)
        return out


def create_quantum_kernel(
    num_qubits: int,
    num_features: int = 1,
    num_layers: int = 2,
    use_parameter_shift: bool = True,
    encoding_type: str = "yz_cx",
    kernel_type: str = "fidelity",
    measurement: Measurement = "XYZ",
    outer_kernel: str = "gaussian",
    outer_kernel_params: Optional[Dict[str, float]] = None,
    regularization: Optional[str] = None,
    apply_outer_params: bool = False,
    dtype: str = "auto",
) -> QuantumKernel:
    """Flag-compatible twin of the reference's factory (main.py:43-145).

    ``use_parameter_shift`` selected qiskit-aer vs PennyLane in the reference;
    here both gradient styles run on the same XLA engine, so it is accepted
    and ignored. ``apply_outer_params=False`` reproduces the reference quirk
    that CLI outer-kernel hyperparameters never reach the main-path kernels
    (main.py:127-133, SURVEY.md §2.1) — set True to actually honor them.
    ``dtype`` is the facade's evaluation precision (see ``QuantumKernel``).
    """
    del use_parameter_shift
    circuit = build_circuit(encoding_type, num_qubits, num_features, num_layers)
    params = tuple(sorted((outer_kernel_params or {}).items())) if apply_outer_params else ()
    spec = QuantumKernelSpec(
        circuit=circuit,
        kernel_type=kernel_type,
        measurement=measurement,
        outer_kernel=outer_kernel,
        outer_kernel_params=params,
        regularization=regularization,
    )
    return QuantumKernel(spec, dtype=dtype)
