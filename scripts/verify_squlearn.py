#!/usr/bin/env python
"""Turnkey squlearn-0.9.1 parity verifier (the FIRST command to run when a
network/pip environment exists).

The one correctness risk no offline round can discharge is exact
gate-sequence equality between this repo's re-derived encoding circuits
(`dqgp/models/circuits/library.py`) and squlearn 0.9.1's classes as the
reference instantiates them (/root/reference/main.py:68-106,
agent_riemannian.py:51-85). This script discharges it end to end:

    pip install squlearn==0.9.1 qiskit==1.0.2 qiskit-aer==0.14.2
    python scripts/verify_squlearn.py --out fixtures --report results_round5/squlearn_parity.json

For every case (8 encodings x {2,3,4} qubits x {1,2} layers, d=2) it

  1. compares trainable **parameter counts** (squlearn `num_parameters` vs
     the IR builder),
  2. compares the **bound gate sequence**: the squlearn circuit is rendered
     via qiskit with concrete (x, theta) bound, each instruction reduced to
     (gate name, qubit tuple, numeric angles); the IR renders itself the same
     way through `dqgp.ops.statevector.angle_matrix` — equality here IS
     gate-for-gate parity (names, wiring, angle algebra) up to 1e-9,
  3. compares **statevectors** on random inputs (both conventions are
     little-endian / qubit-0 = LSB),
  4. compares **fidelity and projected (XYZ, gaussian) Gram matrices**
     against `dqgp.models.kernels` at f64 grade, and
  5. writes one `.npz` **fixture per case** in the exact contract
     `tests/test_reference_fixtures.py` consumes — dropping them into
     `fixtures/` permanently un-skips that test.

Because squlearn is unavailable offline, the harness itself is proven in CI
with a **fake squlearn** backed by this repo's own IR + XLA oracle
(`--fake`), plus a negative control (`--fake-perturbed`) that injects a real
semantic divergence (reversed CRZ ring direction) and must make the script
exit non-zero. See tests/test_verify_squlearn.py.

Exit code 0 = all cases pass; 1 = any mismatch; 2 = squlearn missing.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import sys
import tempfile
from typing import List, Optional, Sequence, Tuple

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Default verification grid: every encoding family at the sizes the reference
# configs exercise (BASELINE.md configs 1-6 span 3-6 qubits, 1-4 layers).
DEFAULT_QUBITS = (2, 3, 4)
DEFAULT_LAYERS = (1, 2)
NUM_FEATURES = 2
BATCH = 8  # samples per statevector/Gram comparison

ENCODINGS = (
    "chebyshev", "yz_cx", "hubregtsen", "kyriienko",
    "multi_control", "layered", "random", "highdim",
)

ANGLE_TOL = 1e-9       # bound-gate angle agreement (pure algebra)
STATE_TOL = 1e-9       # statevector agreement in complex128
GRAM_TOL = 1e-9        # Gram agreement through the f64 pipeline


@dataclasses.dataclass
class BoundGate:
    """A gate instruction reduced to comparable plain data."""

    name: str
    qubits: Tuple[int, ...]
    angles: Tuple[float, ...]

    def close_to(self, other: "BoundGate", tol: float) -> bool:
        return (
            self.name == other.name
            and self.qubits == other.qubits
            and len(self.angles) == len(other.angles)
            and all(abs(a - b) <= tol for a, b in zip(self.angles, other.angles))
        )


# ---------------------------------------------------------------------------
# Reference adapter: wraps (real or fake) squlearn behind one small surface.
# ---------------------------------------------------------------------------


class ReferenceAdapter:
    """Builds squlearn circuits/kernels exactly as the reference does.

    Circuit class dispatch mirrors /root/reference/main.py:67-106 verbatim
    (class names and constructor arguments), so whatever module is passed in
    (real squlearn or the fake) is exercised through the reference's own
    instantiation pattern.
    """

    def __init__(self, squlearn_mod):
        self.sq = squlearn_mod
        ec = importlib.import_module(
            squlearn_mod.__name__ + ".encoding_circuit")
        kn = importlib.import_module(squlearn_mod.__name__ + ".kernel")
        ut = importlib.import_module(squlearn_mod.__name__ + ".util")
        # Constructor calls transcribed from /root/reference/main.py:68-106:
        # first arg positional, layered gets gates=['RX','RY','RZ'], random
        # uses squlearn's default seed.
        self._classes = {
            "chebyshev": lambda n, d, L: ec.ChebyshevPQC(
                n, num_features=d, num_layers=L),
            "yz_cx": lambda n, d, L: ec.YZ_CX_EncodingCircuit(
                n, num_features=d, num_layers=L),
            "hubregtsen": lambda n, d, L: ec.HubregtsenEncodingCircuit(
                n, num_features=d, num_layers=L),
            "kyriienko": lambda n, d, L: ec.KyriienkoEncodingCircuit(
                n, num_features=d, num_layers=L),
            "multi_control": lambda n, d, L: ec.MultiControlEncodingCircuit(
                n, num_features=d, num_layers=L),
            "layered": lambda n, d, L: ec.LayeredEncodingCircuit(
                n, num_features=d, num_layers=L, gates=["RX", "RY", "RZ"]),
            "random": lambda n, d, L: ec.RandomEncodingCircuit(
                n, num_features=d, num_layers=L),
            "highdim": lambda n, d, L: ec.HighDimEncodingCircuit(
                n, num_features=d, num_layers=L),
        }
        self._FidelityKernel = kn.FidelityKernel
        self._ProjectedQuantumKernel = kn.ProjectedQuantumKernel
        self._Executor = ut.Executor

    def encoding(self, name: str, n: int, d: int, L: int):
        return self._classes[name](n, d, L)

    def num_parameters(self, enc) -> int:
        return int(enc.num_parameters)

    def bound_gates(self, enc, x: np.ndarray, theta: np.ndarray) -> List[BoundGate]:
        """Render the circuit with concrete (x, theta) as comparable data."""
        qc = enc.get_circuit(np.asarray(x, float), np.asarray(theta, float))
        out: List[BoundGate] = []
        for inst in qc.data:
            op = inst.operation if hasattr(inst, "operation") else inst[0]
            qubits = inst.qubits if hasattr(inst, "qubits") else inst[1]
            name = op.name.lower()
            if name in ("barrier", "id"):
                continue
            qidx = tuple(
                q if isinstance(q, int) else qc.find_bit(q).index
                for q in qubits)
            angles = tuple(float(p) for p in op.params)
            out.append(BoundGate(name, qidx, angles))
        return out

    def statevector(self, enc, x: np.ndarray, theta: np.ndarray) -> np.ndarray:
        qc = enc.get_circuit(np.asarray(x, float), np.asarray(theta, float))
        if hasattr(qc, "_dqgp_fake_state"):  # fake adapter shortcut
            return qc._dqgp_fake_state()
        from qiskit.quantum_info import Statevector

        return np.asarray(Statevector.from_instruction(qc).data)

    def gram(self, name: str, n: int, d: int, L: int, kernel_type: str,
             X: np.ndarray, theta: np.ndarray) -> np.ndarray:
        """Kernel construction exactly as create_quantum_kernel does
        (main.py:109-145): statevector executor, parameter_seed=0,
        use_expectation / evaluate_duplicates='all' for fidelity; XYZ
        measurement + gaussian outer (squlearn defaults) for projected."""
        enc = self.encoding(name, n, d, L)
        executor = self._Executor("statevector_simulator")
        if kernel_type == "fidelity":
            k = self._FidelityKernel(
                enc, executor=executor, parameter_seed=0,
                use_expectation=True, evaluate_duplicates="all")
        else:
            k = self._ProjectedQuantumKernel(
                enc, executor=executor, measurement="XYZ",
                outer_kernel="gaussian", parameter_seed=0)
        k.assign_parameters(np.asarray(theta, float))
        return np.asarray(k.evaluate(X, X), float)


# ---------------------------------------------------------------------------
# This repo's side of each comparison.
# ---------------------------------------------------------------------------


def _repo_circuit(name: str, n: int, d: int, L: int):
    from dqgp.models.circuits import build_circuit

    return build_circuit(name, n, d, L)


def _repo_bound_gates(circ, x: np.ndarray, theta: np.ndarray) -> List[BoundGate]:
    import jax.numpy as jnp

    from dqgp.ops import statevector as sv
    from dqgp.ops.circuit import KIND_NAMES, PARAMETERIZED

    ang = np.asarray(sv.angle_matrix(
        circ, jnp.asarray(x[None, :], jnp.float64),
        jnp.asarray(theta, jnp.float64), jnp.float64))[0]
    out: List[BoundGate] = []
    for gi, g in enumerate(circ.gates):
        name = KIND_NAMES[g.kind]
        if g.control >= 0:
            qubits = (g.control, g.qubit)
        else:
            qubits = (g.qubit,)
        angles = (float(ang[gi]),) if g.kind in PARAMETERIZED else ()
        out.append(BoundGate(name, qubits, angles))
    return out


def _repo_statevector(circ, x: np.ndarray, theta: np.ndarray) -> np.ndarray:
    import jax.numpy as jnp

    from dqgp.ops import statevector as sv

    ang = sv.angle_matrix(circ, jnp.asarray(x[None, :], jnp.float64),
                          jnp.asarray(theta, jnp.float64), jnp.float64)
    return np.asarray(sv.state_from_angles(circ, ang, jnp.complex128))[0]


def _repo_gram(name: str, n: int, d: int, L: int, kernel_type: str,
               X: np.ndarray, theta: np.ndarray) -> np.ndarray:
    import jax.numpy as jnp

    from dqgp.models.kernels import create_quantum_kernel
    from dqgp.models.kernels.quantum_kernel import gram

    k = create_quantum_kernel(
        num_qubits=n, num_features=d, num_layers=L, encoding_type=name,
        kernel_type=kernel_type, measurement="XYZ", outer_kernel="gaussian")
    return np.asarray(gram(k.spec, jnp.asarray(X, jnp.float64),
                           jnp.asarray(theta, jnp.float64), dtype=jnp.float64))


# ---------------------------------------------------------------------------
# Case runner
# ---------------------------------------------------------------------------


def run_case(adapter: ReferenceAdapter, name: str, n: int, L: int,
             out_dir: Optional[str]) -> dict:
    d = NUM_FEATURES
    rng = np.random.RandomState(hash((name, n, L)) % (2**31))
    rec: dict = {"encoding": name, "num_qubits": n, "num_layers": L,
                 "num_features": d, "checks": {}, "ok": False}

    enc = adapter.encoding(name, n, d, L)
    p_ref = adapter.num_parameters(enc)
    circ = _repo_circuit(name, n, d, L)
    rec["checks"]["param_count"] = {
        "reference": p_ref, "repo": circ.num_parameters,
        "ok": p_ref == circ.num_parameters}
    if p_ref != circ.num_parameters:
        return rec
    P = p_ref

    lo, hi = (-0.99, 0.99) if circ.requires_clipping else (-1.0, 1.0)
    X = rng.uniform(lo, hi, (BATCH, d))
    theta = np.round(rng.uniform(0, np.pi, P), 4)  # U(0, pi) as main.py:211

    # 2. bound gate sequences
    gates_ok, gate_diffs = True, []
    for b in range(min(BATCH, 2)):
        ref_g = adapter.bound_gates(enc, X[b], theta)
        rep_g = _repo_bound_gates(circ, X[b], theta)
        if len(ref_g) != len(rep_g):
            gates_ok = False
            gate_diffs.append(f"gate count {len(ref_g)} vs {len(rep_g)}")
            break
        for i, (a, c) in enumerate(zip(ref_g, rep_g)):
            if not a.close_to(c, ANGLE_TOL):
                gates_ok = False
                gate_diffs.append(f"gate {i}: ref {a} vs repo {c}")
                if len(gate_diffs) > 4:
                    break
        if not gates_ok:
            break
    rec["checks"]["gate_sequence"] = {"ok": gates_ok, "diffs": gate_diffs[:5]}

    # 3. statevectors
    sv_max = 0.0
    for b in range(BATCH):
        s_ref = adapter.statevector(enc, X[b], theta)
        s_rep = _repo_statevector(circ, X[b], theta)
        sv_max = max(sv_max, float(np.abs(s_ref - s_rep).max()))
    rec["checks"]["statevector"] = {"max_abs_diff": sv_max,
                                    "ok": sv_max <= STATE_TOL}

    # 4. Grams (both kernel types)
    gram_ok = True
    for kt in ("fidelity", "projected"):
        K_ref = adapter.gram(name, n, d, L, kt, X, theta)
        K_rep = _repo_gram(name, n, d, L, kt, X, theta)
        dmax = float(np.abs(K_ref - K_rep).max())
        rec["checks"][f"gram_{kt}"] = {"max_abs_diff": dmax,
                                       "ok": dmax <= GRAM_TOL}
        gram_ok &= dmax <= GRAM_TOL
        # 5. fixture (written even on failure — the failing fixture is the
        # bug report; test_reference_fixtures will flag it identically)
        if out_dir:
            fx = os.path.join(
                out_dir, f"squlearn_{name}_{n}q_{L}L_{kt}.npz")
            np.savez(fx, X=X, theta=theta, K=K_ref, encoding=name,
                     num_qubits=n, num_features=d, num_layers=L,
                     kernel_type=kt, measurement="XYZ",
                     outer_kernel="gaussian")

    rec["ok"] = (gates_ok and rec["checks"]["statevector"]["ok"] and gram_ok)
    return rec


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="fixture output dir (default: fixtures/ for real "
                         "squlearn, a temp dir for --fake)")
    ap.add_argument("--report", default=None, help="JSON report path")
    ap.add_argument("--encodings", nargs="*", default=list(ENCODINGS))
    ap.add_argument("--qubits", nargs="*", type=int, default=list(DEFAULT_QUBITS))
    ap.add_argument("--layers", nargs="*", type=int, default=list(DEFAULT_LAYERS))
    ap.add_argument("--fake", action="store_true",
                    help="use the repo-backed fake squlearn (harness self-test)")
    ap.add_argument("--fake-perturbed", action="store_true",
                    help="fake squlearn with an injected gate-order divergence; "
                         "the script MUST fail (negative control)")
    args = ap.parse_args(argv)

    if args.fake or args.fake_perturbed:
        from scripts import fake_squlearn

        fake_squlearn.install(perturbed=args.fake_perturbed)
        squlearn = importlib.import_module("fake_squlearn_mod")
        out_dir = args.out or tempfile.mkdtemp(prefix="dqgp_fake_fixtures_")
    else:
        try:
            import squlearn  # type: ignore
        except ImportError:
            print("squlearn is not installed. Run:\n"
                  "  pip install squlearn==0.9.1 qiskit==1.0.2 "
                  "qiskit-aer==0.14.2\n"
                  "then re-run this script. (Offline harness self-test: "
                  "--fake / --fake-perturbed.)", file=sys.stderr)
            return 2
        ver = getattr(squlearn, "__version__", "?")
        if ver != "0.9.1":
            print(f"WARNING: squlearn {ver} != 0.9.1 (the reference pin); "
                  "mismatches may be version skew.", file=sys.stderr)
        out_dir = args.out or os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "fixtures")
    os.makedirs(out_dir, exist_ok=True)

    adapter = ReferenceAdapter(squlearn)
    results = []
    n_fail = 0
    for name in args.encodings:
        for n in args.qubits:
            for L in args.layers:
                try:
                    rec = run_case(adapter, name, n, L, out_dir)
                except Exception as e:  # a crash is a failure, not an abort
                    rec = {"encoding": name, "num_qubits": n, "num_layers": L,
                           "ok": False, "error": f"{type(e).__name__}: {e}"}
                ok = rec.get("ok", False)
                n_fail += not ok
                results.append(rec)
                status = "OK  " if ok else "FAIL"
                print(f"[{status}] {name:13s} {n}q {L}L  "
                      + ("" if ok else json.dumps(
                          {k: v for k, v in rec.get('checks', {}).items()
                           if not v.get('ok', True)} or
                          {"error": rec.get("error")})[:200]))

    summary = {"total": len(results), "failed": n_fail,
               "fixtures_dir": out_dir, "results": results}
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(summary, f, indent=1, default=str)
    print(f"\n{len(results) - n_fail}/{len(results)} cases passed; "
          f"fixtures -> {out_dir}")
    if n_fail == 0 and not (args.fake or args.fake_perturbed):
        print("All parity checks passed. The fixtures above permanently "
              "un-skip tests/test_reference_fixtures.py.")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
