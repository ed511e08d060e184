"""CI proof of the turnkey squlearn-parity harness (VERDICT r4 item 2).

squlearn itself is unavailable offline, so `scripts/verify_squlearn.py` is
exercised against the repo-backed fake squlearn (`scripts/fake_squlearn.py`):

* positive control — the fake IS the repo, so every check (param counts,
  bound gate sequences, statevectors, both Grams) must pass and fixtures in
  the `tests/test_reference_fixtures.py` contract must be written;
* negative control — a perturbed fake (controlled-rotation rings reversed)
  must FAIL on gate-sequence, statevector, AND Gram grounds, proving the
  harness detects real semantic divergence, not just formatting drift.

When a networked machine runs `pip install squlearn==0.9.1` and then
`python scripts/verify_squlearn.py`, the exact code paths tested here run
against the real reference stack.
"""

import glob
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts import verify_squlearn  # noqa: E402


def test_positive_control_passes_and_writes_fixtures(tmp_path):
    rc = verify_squlearn.main([
        "--fake", "--out", str(tmp_path),
        "--encodings", "hubregtsen", "chebyshev",
        "--qubits", "3", "--layers", "1",
        "--report", str(tmp_path / "report.json"),
    ])
    assert rc == 0
    fixtures = sorted(glob.glob(str(tmp_path / "*.npz")))
    # 2 encodings x 1 size x 2 kernel types
    assert len(fixtures) == 4
    z = np.load(fixtures[0], allow_pickle=False)
    for key in ("X", "theta", "K", "encoding", "num_qubits", "num_features",
                "num_layers", "kernel_type", "measurement", "outer_kernel"):
        assert key in z.files, f"fixture missing {key}"
    assert (tmp_path / "report.json").exists()


def test_positive_fixtures_satisfy_reference_fixture_test(tmp_path):
    """A fixture the verifier writes must pass the drop-in fixture test's own
    checks (same assertions test_reference_fixtures.py runs)."""
    import jax.numpy as jnp

    from dqgp.models.kernels import create_quantum_kernel
    from dqgp.models.kernels.quantum_kernel import gram

    rc = verify_squlearn.main([
        "--fake", "--out", str(tmp_path),
        "--encodings", "yz_cx", "--qubits", "3", "--layers", "2",
    ])
    assert rc == 0
    path = str(tmp_path / "squlearn_yz_cx_3q_2L_projected.npz")
    z = np.load(path, allow_pickle=False)
    kernel = create_quantum_kernel(
        num_qubits=int(z["num_qubits"]), num_features=int(z["num_features"]),
        num_layers=int(z["num_layers"]), encoding_type=str(z["encoding"]),
        kernel_type=str(z["kernel_type"]), measurement=str(z["measurement"]),
        outer_kernel=str(z["outer_kernel"]))
    assert kernel.num_parameters == z["theta"].shape[0]
    K64 = np.asarray(gram(kernel.spec, jnp.asarray(z["X"], jnp.float64),
                          jnp.asarray(z["theta"], jnp.float64),
                          dtype=jnp.float64))
    np.testing.assert_allclose(K64, np.asarray(z["K"]), rtol=1e-7, atol=1e-7)


def test_negative_control_fails_on_semantic_grounds(tmp_path):
    """At 2 layers the first CRZ ring is mid-circuit, so reversing it breaks
    EVERY semantic check: gates, statevectors, and both Grams."""
    rc = verify_squlearn.main([
        "--fake-perturbed", "--out", str(tmp_path),
        "--encodings", "chebyshev", "--qubits", "3", "--layers", "2",
        "--report", str(tmp_path / "report.json"),
    ])
    assert rc == 1
    import json

    rep = json.load(open(tmp_path / "report.json"))
    assert rep["failed"] == rep["total"] == 1
    checks = rep["results"][0]["checks"]
    assert not checks["gate_sequence"]["ok"]
    assert not checks["statevector"]["ok"]
    assert not checks["gram_fidelity"]["ok"]
    assert not checks["gram_projected"]["ok"]
    # param counts still match (the perturbation is wiring, not arity)
    assert checks["param_count"]["ok"]


def test_negative_control_catches_gram_invisible_gauge_divergence(tmp_path):
    """Why the verifier checks GATES, not just Grams: hubregtsen's CRZ ring
    at 1 layer is trainable-only and terminal, so reversing it is a gauge
    transformation — fidelity picks up a fixed diagonal phase, projected
    features a fixed per-qubit XY rotation, and BOTH Grams are exactly
    invariant. Only the gate-sequence and statevector checks can see it."""
    rc = verify_squlearn.main([
        "--fake-perturbed", "--out", str(tmp_path),
        "--encodings", "hubregtsen", "--qubits", "3", "--layers", "1",
        "--report", str(tmp_path / "report.json"),
    ])
    assert rc == 1
    import json

    checks = json.load(open(tmp_path / "report.json"))["results"][0]["checks"]
    assert not checks["gate_sequence"]["ok"]
    assert not checks["statevector"]["ok"]
    assert checks["gram_fidelity"]["ok"]      # invariant, by the algebra above
    assert checks["gram_projected"]["ok"]     # gaussian outer: distance-preserving


def test_negative_control_noop_on_ringless_family(tmp_path):
    """highdim has no controlled rotations -> the perturbation is a no-op and
    the case passes: failures come from real divergence only."""
    rc = verify_squlearn.main([
        "--fake-perturbed", "--out", str(tmp_path),
        "--encodings", "highdim", "--qubits", "3", "--layers", "1",
    ])
    assert rc == 0


def test_missing_squlearn_exits_2(monkeypatch, tmp_path):
    import builtins

    real_import = builtins.__import__

    def block_squlearn(name, *a, **kw):
        if name == "squlearn" or name.startswith("squlearn."):
            raise ImportError("No module named 'squlearn'")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", block_squlearn)
    monkeypatch.delitem(sys.modules, "squlearn", raising=False)
    rc = verify_squlearn.main(["--out", str(tmp_path)])
    assert rc == 2
