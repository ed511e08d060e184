"""A fake `squlearn` package backed by this repo's IR + XLA oracle.

Purpose: prove the `scripts/verify_squlearn.py` harness END TO END in this
offline environment (SURVEY.md §7 hard-part #1 mitigation). The fake exposes
the exact module layout / class names / call signatures the reference uses
(/root/reference/main.py:25-35, 68-145) — `encoding_circuit` classes with
`num_parameters` and `get_circuit`, `kernel.FidelityKernel` /
`kernel.ProjectedQuantumKernel` with `assign_parameters` + `evaluate`, and
`util.Executor` — but computes everything with `dqgp` itself.

Two modes:

* ``install(perturbed=False)`` — positive control: the verifier must report
  every case OK (the fake IS the repo, so parity is exact by construction;
  what's being tested is the harness plumbing: adapters, gate rendering,
  statevector/Gram comparison, fixture writing).
* ``install(perturbed=True)`` — negative control: every CRZ/CRX ring gate
  has its control/target REVERSED (a realistic transcription error — exactly
  the class of divergence the 3-qubit analytic goldens pinned in round 4).
  The fake stays self-consistent (its gate list, statevectors, and Grams all
  reflect the reversed ring), so the verifier must FAIL the affected
  families on real semantic grounds, not on a formatting artifact.
"""

from __future__ import annotations

import dataclasses
import sys
import types
from typing import List

import numpy as np

MODULE_NAME = "fake_squlearn_mod"


def _perturb(circ):
    """Reverse control/target of every controlled-rotation ring gate."""
    from dqgp.ops.circuit import CRX, CRY, CRZ, Circuit

    gates = []
    changed = False
    for g in circ.gates:
        if g.kind in (CRX, CRY, CRZ):
            gates.append(dataclasses.replace(g, qubit=g.control, control=g.qubit))
            changed = True
        else:
            gates.append(g)
    if not changed:
        return circ
    return Circuit(circ.num_qubits, circ.num_features, circ.num_parameters,
                   tuple(gates), name=circ.name + "_perturbed",
                   requires_clipping=circ.requires_clipping)


class _FakeInstruction:
    def __init__(self, name: str, qubits, params):
        self.operation = types.SimpleNamespace(name=name, params=list(params))
        self.qubits = tuple(qubits)


class _FakeBoundCircuit:
    """Quacks like a qiskit QuantumCircuit for the verifier's needs."""

    def __init__(self, circ, x: np.ndarray, theta: np.ndarray):
        self._circ = circ
        self._x = np.asarray(x, float)
        self._theta = np.asarray(theta, float)

    @property
    def data(self) -> List[_FakeInstruction]:
        import jax.numpy as jnp

        from dqgp.ops import statevector as sv
        from dqgp.ops.circuit import KIND_NAMES, PARAMETERIZED

        ang = np.asarray(sv.angle_matrix(
            self._circ, jnp.asarray(self._x[None, :], jnp.float64),
            jnp.asarray(self._theta, jnp.float64), jnp.float64))[0]
        out = []
        for gi, g in enumerate(self._circ.gates):
            qubits = (g.control, g.qubit) if g.control >= 0 else (g.qubit,)
            params = [float(ang[gi])] if g.kind in PARAMETERIZED else []
            out.append(_FakeInstruction(KIND_NAMES[g.kind], qubits, params))
        return out

    def _dqgp_fake_state(self) -> np.ndarray:
        import jax.numpy as jnp

        from dqgp.ops import statevector as sv

        ang = sv.angle_matrix(self._circ, jnp.asarray(self._x[None, :], jnp.float64),
                              jnp.asarray(self._theta, jnp.float64), jnp.float64)
        return np.asarray(sv.state_from_angles(self._circ, ang, jnp.complex128))[0]


def _make_encoding_class(encoding_name: str, perturbed: bool):
    class _Enc:
        def __init__(self, num_qubits, num_features=1, num_layers=2, **kw):
            from dqgp.models.circuits import build_circuit

            self._circ = build_circuit(encoding_name, num_qubits,
                                       num_features, num_layers)
            if perturbed:
                self._circ = _perturb(self._circ)

        @property
        def num_parameters(self):
            return self._circ.num_parameters

        def get_circuit(self, x, theta):
            return _FakeBoundCircuit(self._circ, x, theta)

    _Enc.__name__ = encoding_name
    return _Enc


class _FakeKernelBase:
    def __init__(self, encoding_circuit, executor=None, **kw):
        self._enc = encoding_circuit
        self._theta = None
        self._kw = kw

    def assign_parameters(self, theta):
        self._theta = np.asarray(theta, float)

    def _spec(self, kernel_type):
        from dqgp.models.kernels.quantum_kernel import QuantumKernelSpec

        return QuantumKernelSpec(
            circuit=self._enc._circ, kernel_type=kernel_type,
            measurement=self._kw.get("measurement", "XYZ"),
            outer_kernel=self._kw.get("outer_kernel", "gaussian"),
            outer_kernel_params=(),
            regularization=self._kw.get("regularization"))

    def _evaluate(self, kernel_type, X, Y):
        import jax.numpy as jnp

        from dqgp.models.kernels.quantum_kernel import gram

        assert self._theta is not None, "assign_parameters first"
        return np.asarray(gram(self._spec(kernel_type),
                               jnp.asarray(X, jnp.float64),
                               jnp.asarray(self._theta, jnp.float64),
                               dtype=jnp.float64))


class FidelityKernel(_FakeKernelBase):
    def evaluate(self, X, Y):
        return self._evaluate("fidelity", X, Y)


class ProjectedQuantumKernel(_FakeKernelBase):
    def evaluate(self, X, Y):
        return self._evaluate("projected", X, Y)


class Executor:
    def __init__(self, name):
        self.name = name


_CLASS_NAMES = {
    "chebyshev": "ChebyshevPQC",
    "yz_cx": "YZ_CX_EncodingCircuit",
    "hubregtsen": "HubregtsenEncodingCircuit",
    "kyriienko": "KyriienkoEncodingCircuit",
    "multi_control": "MultiControlEncodingCircuit",
    "layered": "LayeredEncodingCircuit",
    "random": "RandomEncodingCircuit",
    "highdim": "HighDimEncodingCircuit",
}


def install(perturbed: bool = False) -> types.ModuleType:
    """Register ``fake_squlearn_mod(.encoding_circuit/.kernel/.util)``."""
    root = types.ModuleType(MODULE_NAME)
    root.__version__ = "0.9.1-fake" + ("-perturbed" if perturbed else "")
    ec = types.ModuleType(MODULE_NAME + ".encoding_circuit")
    for enc_name, cls_name in _CLASS_NAMES.items():
        setattr(ec, cls_name, _make_encoding_class(enc_name, perturbed))
    kn = types.ModuleType(MODULE_NAME + ".kernel")
    kn.FidelityKernel = FidelityKernel
    kn.ProjectedQuantumKernel = ProjectedQuantumKernel
    ut = types.ModuleType(MODULE_NAME + ".util")
    ut.Executor = Executor
    root.encoding_circuit = ec
    root.kernel = kn
    root.util = ut
    sys.modules[MODULE_NAME] = root
    sys.modules[ec.__name__] = ec
    sys.modules[kn.__name__] = kn
    sys.modules[ut.__name__] = ut
    return root
