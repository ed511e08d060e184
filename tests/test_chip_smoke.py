"""chip_smoke.py: refuses a CPU-only host, and its phases (engine, ADMM
trajectory, trainer, CLI, the four-device paths) pass at tiny sizes on the
CPU mesh. The ``gpu``-marked cases run the same phases on a card."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def test_refuses_cpu_only_host():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_phase_engine_tiny():
    out = cs.phase_engine(n=32)
    assert set(out) == {"features", "projected_gram", "fidelity_gram"}
    assert all(nbad == 0 for _, nbad in out.values())


def test_phase_trajectory_tiny():
    out = cs.phase_trajectory(n=64, iters=2)
    assert out["dz"] <= cs.Z_TOL and out["dnlpd"] <= cs.NLPD_TOL


def test_phase_trainer_tiny():
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # device-mode cond floor on CPU
        out = cs.phase_trainer(n=64, n_test=16, iters=2, n_large=256)
    assert max(out["cg"].values()) <= cs.CG_RTOL
    assert out["metrics"]["nlpd"] == out["metrics"]["nlpd"]  # finite, not NaN


def test_phase_cli_tiny():
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        metrics = cs.phase_cli(n=40, iters=1)
    assert "test_nlpd" in metrics and "cv_best_nlpd" in metrics


def test_phase_four_train_tiny():
    assert cs.phase_four_train(n=64, iters=2) <= cs.Z_TOL


def test_phase_four_step2d_tiny():
    assert cs.phase_four_step2d(n=64) <= cs.Z_TOL


def test_phase_four_large_tiny():
    out = cs.phase_four_large(n=256, n_test=8, block=32)
    assert out["nll"] <= cs.LARGE_RTOL
    assert max(out["mean"], out["var"]) <= cs.CG_RTOL


@pytest.mark.gpu
def test_engine_on_card(gpu):
    cs.phase_engine(n=1000, device=gpu)


@pytest.mark.gpu
def test_trajectory_on_card(gpu):
    cs.phase_trajectory(iters=3, device=gpu)
