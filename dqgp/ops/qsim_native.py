"""ctypes wrapper over the C++ reference statevector simulator
(native/qsim_ref.cpp) — the independent oracle used by the test suite to
cross-validate the JAX engine, in the role qiskit-aer plays for
the reference (SURVEY.md §2.11)."""

from __future__ import annotations

import ctypes

import numpy as np

from ..native_build import load_native
from .circuit import Circuit


def available() -> bool:
    return load_native("qsim_ref") is not None


def native_states(circuit: Circuit, angles: np.ndarray) -> np.ndarray:
    """angles: (B, G) float64 -> complex128 states (B, 2^n)."""
    lib = load_native("qsim_ref")
    if lib is None:
        raise RuntimeError("native qsim_ref unavailable")
    B, G = angles.shape
    assert G == circuit.num_gates
    kinds = np.array([g.kind for g in circuit.gates], np.int32)
    qubits = np.array([g.qubit for g in circuit.gates], np.int32)
    controls = np.array([g.control for g in circuit.gates], np.int32)
    A = np.ascontiguousarray(angles, np.float64)
    out = np.empty((B, circuit.dim, 2), np.float64)

    fn = lib.simulate_states
    fn.restype = ctypes.c_int
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_f64 = ctypes.POINTER(ctypes.c_double)
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   p_i32, p_i32, p_i32, p_f64, p_f64]
    rc = fn(circuit.num_qubits, B, G,
            kinds.ctypes.data_as(p_i32), qubits.ctypes.data_as(p_i32),
            controls.ctypes.data_as(p_i32),
            A.ctypes.data_as(p_f64), out.ctypes.data_as(p_f64))
    if rc != 0:
        raise RuntimeError(f"qsim_ref failed with code {rc}")
    return out[..., 0] + 1j * out[..., 1]


def native_pauli_features(circuit: Circuit, angles: np.ndarray) -> np.ndarray:
    """angles: (B, G) -> features (B, 3n) ordered [X block, Y block, Z block]."""
    lib = load_native("qsim_ref")
    if lib is None:
        raise RuntimeError("native qsim_ref unavailable")
    states = native_states(circuit, angles)
    B = states.shape[0]
    n = circuit.num_qubits
    inter = np.empty((B, circuit.dim, 2), np.float64)
    inter[..., 0] = states.real
    inter[..., 1] = states.imag
    feats = np.empty((B, 3 * n), np.float64)
    fn = lib.pauli_features
    p_f64 = ctypes.POINTER(ctypes.c_double)
    fn.restype = None
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, p_f64, p_f64]
    fn(n, B, np.ascontiguousarray(inter).ctypes.data_as(p_f64),
       feats.ctypes.data_as(p_f64))
    return feats
