"""bench.py orchestrator logic — no device work, everything stubbed.

The timed modes themselves need the GPU; what IS testable on CPU is the
orchestration policy: the no-GPU refusal, baseline-cache staleness, the
two-point timer's noise-floor error, headline fallback, and a parent process
that never initialises JAX.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402


@pytest.fixture
def fresh_bench(monkeypatch):
    """bench with REPO pointed at a temp dir and the slow baseline stubbed."""
    with tempfile.TemporaryDirectory() as d:
        monkeypatch.setattr(bench, "REPO", d)
        monkeypatch.setattr(bench, "baseline_iteration_time",
                            lambda *a, **k: 40.0)
        monkeypatch.setattr(bench, "_power_limit",
                            lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
        yield bench


def _record_from(capsys_or_buf):
    return json.loads(capsys_or_buf.getvalue().strip().splitlines()[-1])


def _mode_map(overrides=None):
    base = {
        "device": {"platform": "gpu", "device_kind": "NVIDIA H100",
                   "count": 1},
        "gram": {"gram_seconds": 1e-4, "entries_per_sec": 1e10},
        "parity_gate": {"nlpd_parity_ok": True, "cv_nlpd_f32": 1.0,
                        "cv_nlpd_f64": 1.0, "cv_nlpd_mixed": 1.0,
                        "z_max_abs_dev": 0.0, "z_max_abs_dev_mixed": 0.0},
        "admm_f32": {"iter_seconds": 0.01},
        "admm_parity": {"iter_seconds": 0.2},
        "admm_mixed": {"iter_seconds": 0.02},
        "admm_chained": {"chained_ms_per_iter": 2.5},
    }
    base.update(overrides or {})
    return base


def test_no_gpu_exits_nonzero_without_timing(fresh_bench, monkeypatch):
    calls = []

    def run_mode(mode, timeout):
        calls.append(mode)
        return {"platform": "cpu", "device_kind": "cpu", "count": 1}

    monkeypatch.setattr(fresh_bench, "_run_mode", run_mode)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as e:
        fresh_bench.main()
    assert e.value.code != 0
    assert calls == ["device"]           # nothing timed, no CPU fallback
    rec = _record_from(buf)
    assert rec["value"] is None and "no GPU" in rec["error"]


def test_happy_path_record(fresh_bench, monkeypatch):
    modes = _mode_map()
    monkeypatch.setattr(fresh_bench, "_run_mode", lambda m, t: modes[m])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fresh_bench.main()
    rec = _record_from(buf)
    assert rec["value"] == 100.0                       # 1 / 0.01
    assert rec["vs_baseline"] == 2000.0                # 40 / 0.02 (mixed)
    assert rec["nlpd_parity_ok"] is True
    assert rec["gram_entries_per_sec_chip"] == 1e10
    assert rec["chained_ms_per_iter"] == 2.5
    assert rec["device"]["kind"] == "NVIDIA H100"
    assert "700.00 W" in rec["device"]["name_power_limit"]
    assert "errors" not in rec


def test_headline_falls_back_to_mixed(fresh_bench, monkeypatch):
    modes = _mode_map({"admm_f32": {"error": "admm_f32: timeout after 1500s"}})
    monkeypatch.setattr(fresh_bench, "_run_mode", lambda m, t: modes[m])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fresh_bench.main()
    rec = _record_from(buf)
    assert rec["value"] == 50.0                        # 1 / 0.02 mixed
    assert "mixed-solver mode" in rec["unit"]
    assert any("admm_f32" in e for e in rec["errors"])


def test_baseline_cache_staleness(fresh_bench):
    class Spec:
        num_parameters = 40

    fresh_bench.get_baseline_seconds(Spec(), [])
    path = os.path.join(fresh_bench.REPO, "BASELINE_LOCAL.json")
    with open(path) as f:
        rec = json.load(f)
    # cache hit: same config
    assert fresh_bench.get_baseline_seconds(Spec(), []) == 40.0
    # stale config -> recompute (stub returns 40.0 again, but the file
    # must be rewritten with the CURRENT config)
    rec["config"]["qubits"] = 99
    rec["baseline_iteration_seconds"] = 123.0
    with open(path, "w") as f:
        json.dump(rec, f)
    assert fresh_bench.get_baseline_seconds(Spec(), []) == 40.0
    with open(path) as f:
        assert json.load(f)["config"]["qubits"] == bench.NUM_QUBITS


def test_two_point_time_raises_on_noise_floor():
    with pytest.raises(RuntimeError, match="noise floor"):
        bench._two_point_time(lambda k: (lambda: 0.0),
                              k_lo=4, k_hi=8, max_k=16)


def test_two_point_time_measures_linear_cost():
    import time as _time

    def make_k_program(k):
        def f():
            _time.sleep(0.002 * k)
            return 1.0
        return f

    dt = bench._two_point_time(make_k_program, k_lo=4, k_hi=24,
                               repeats=2, min_delta=0.02)
    assert 0.0015 < dt < 0.004, dt


def test_np_angles_match_angle_matrix():
    """The parent's NumPy baseline builds its angles without jnp; they must
    be the engine's angles."""
    import jax.numpy as jnp

    from dqgp.ops.statevector import angle_matrix

    spec, X, _, _ = bench.make_problem()
    theta = np.random.RandomState(3).uniform(0, np.pi, spec.num_parameters)
    ref = angle_matrix(spec.circuit, jnp.asarray(X[:64], jnp.float64),
                       jnp.asarray(theta, jnp.float64), jnp.float64)
    np.testing.assert_allclose(bench._np_angles(spec.circuit, X[:64], theta),
                               np.asarray(ref), rtol=1e-12, atol=1e-12)


def test_parent_never_initialises_jax():
    """One process per card: the orchestrator's own work (problem setup and
    the NumPy baseline) must not create a JAX backend, or it would reserve
    the card its mode children need."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import bench\n"
        "from jax._src import xla_bridge\n"
        "spec, X, Y, splits = bench.make_problem()\n"
        "theta = [0.1] * spec.num_parameters\n"
        "K = bench._np_projected_gram(spec.circuit, X[:16], theta)\n"
        "assert K.shape == (16, 16)\n"
        "print('BACKENDS', sorted(xla_bridge._backends))\n" % REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-1000:]
    assert r.stdout.strip().splitlines()[-1] == "BACKENDS []"
