"""Regression against PARITY_TARGETS.json (pinned-seed parity anchors).

BASELINE.md's procedure calls for recorded reference numbers; with the pip
reference unavailable offline, PARITY_TARGETS.json records this repo's own
CPU float64 parity-mode results at fixed seeds (scripts/
record_parity_targets.py). This test re-runs the small anchor config and
demands bit-identical selected hyperparameters and matching metrics — any
future kernel/GP/ADMM change that silently alters parity numerics fails
here before it can masquerade as a perf win.
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGETS_PATH = os.path.join(REPO, "PARITY_TARGETS.json")


@pytest.fixture(scope="module")
def targets():
    if not os.path.exists(TARGETS_PATH):
        pytest.skip("PARITY_TARGETS.json not recorded yet")
    with open(TARGETS_PATH) as f:
        return json.load(f)


def test_targets_cover_baseline_configs(targets):
    cfgs = targets["configs"]
    assert "config1_small" in cfgs
    assert "config1" in cfgs
    # BASELINE config: fidelity kernel + 6-qubit kyriienko synthetic sweep
    kernels = {c["config"].get("kernel") for c in cfgs.values()}
    assert "fidelity" in kernels
    # BASELINE configs #2-#4: all four SRTM regions present
    regions = {c["config"].get("region") for c in cfgs.values()}
    assert {"maharashtra", "oregon_coast", "great_lakes",
            "washington_coast"} <= regions
    for c in cfgs.values():
        assert np.isfinite(c["cv_nlpd_best"])
        assert np.isfinite(c["test_nlpd"])
        assert c["test_r2"] > 0.0, c["config"]


@pytest.mark.slow
def test_config1_small_regression(targets):
    from sklearn.model_selection import train_test_split

    from dqgp.data import generate_quantum_gp_data, split_data_numpy
    from dqgp.driver import TrainConfig, train
    from dqgp.models.circuits import build_circuit
    from dqgp.models.gp import evaluate_predictions, predict_quantum_gp
    from dqgp.models.kernels import QuantumKernelSpec

    rec = targets["configs"]["config1_small"]
    c = rec["config"]
    spec = QuantumKernelSpec(
        circuit=build_circuit(c["encoding"], c["qubits"], 2, c["layers"]),
        kernel_type="projected",
        outer_kernel="matern",
    )
    X, Y, theta_star = generate_quantum_gp_data(
        num_samples=c["n"], input_dim=2, spec=spec,
        noise_std=0.1, param_seed=42, data_seed=42,
    )
    Xtr, Xte, Ytr, Yte = train_test_split(X, Y, test_size=0.1, random_state=42)
    splits = split_data_numpy(Xtr, Ytr, n_agents=c["agents"],
                              partition_method="regional")
    result = train(
        spec, splits, Xtr, Ytr,
        TrainConfig(max_iter=c["max_iter"], verbose=False),
        ground_truth_params=theta_star,
    )
    hyper = result.z_best_cv if result.z_best_cv is not None else result.z
    # selected hyperparameters are 4-dp quantized -> must match exactly
    np.testing.assert_array_equal(np.round(np.asarray(hyper), 4),
                                  np.asarray(rec["z_best"]))
    assert abs(result.cv_best - rec["cv_nlpd_best"]) < 1e-4

    mean, var = predict_quantum_gp(
        spec, jnp.asarray(Xtr), jnp.asarray(Ytr), jnp.asarray(Xte),
        jnp.asarray(hyper), noise_std=0.1,
    )
    m = evaluate_predictions(Yte, np.asarray(mean), np.asarray(var))
    assert abs(float(m["nlpd"]) - rec["test_nlpd"]) < 1e-4
    assert abs(float(m["r2"]) - rec["test_r2"]) < 1e-4
    assert abs(float(result.error_best) - rec["gt_recovery_riemannian"]) < 1e-4


@pytest.mark.slow
def test_config2_small_srtm_regression(targets):
    """SRTM anchor: bit-identical selected z against the recorded target.

    srtm_data/ is gitignored, so the tiles any checkout reproduces are the
    deterministic synthetics of scripts/make_synthetic_tiles.py — this test
    regenerates them and re-runs the small SRTM config, catching both parity
    numerics drift AND silent tile-data drift (on 2026-08-16 the workspace's
    real tiles were replaced by synthetics and no test noticed)."""
    import sys

    from sklearn.model_selection import train_test_split

    from dqgp.data import split_data_numpy
    from dqgp.data.real_world import load_srtm_elevation_dataset
    from dqgp.driver import TrainConfig, train
    from dqgp.models.circuits import build_circuit
    from dqgp.models.gp import evaluate_predictions, predict_quantum_gp
    from dqgp.models.kernels import QuantumKernelSpec

    if "config2_small" not in targets["configs"]:
        pytest.skip("config2_small not recorded")
    rec = targets["configs"]["config2_small"]
    c = rec["config"]

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        from make_synthetic_tiles import ensure_tiles
    finally:
        sys.path.pop(0)
    # dedicated synthetic-tile dir: the anchor must not silently pick up
    # real tiles a workspace may have in (gitignored) srtm_data/
    tile_dir = os.path.join(REPO, "srtm_data_synth")
    ensure_tiles(tile_dir)

    spec = QuantumKernelSpec(
        circuit=build_circuit(c["encoding"], c["qubits"], 2, c["layers"]),
        kernel_type="projected", outer_kernel="matern",
    )
    X, Y = load_srtm_elevation_dataset(
        region=c["region"], max_samples=c["n"], subsample_factor=10,
        random_state=42, data_dir=tile_dir,
    )
    Xtr, Xte, Ytr, Yte = train_test_split(X, Y, test_size=0.1, random_state=42)
    splits = split_data_numpy(Xtr, Ytr, n_agents=c["agents"],
                              partition_method="regional")
    result = train(spec, splits, Xtr, Ytr,
                   TrainConfig(max_iter=c["max_iter"], verbose=False))
    hyper = result.z_best_cv if result.z_best_cv is not None else result.z
    np.testing.assert_array_equal(np.round(np.asarray(hyper), 4),
                                  np.asarray(rec["z_best"]))
    assert abs(result.cv_best - rec["cv_nlpd_best"]) < 1e-4

    mean, var = predict_quantum_gp(
        spec, jnp.asarray(Xtr), jnp.asarray(Ytr), jnp.asarray(Xte),
        jnp.asarray(hyper), noise_std=0.1,
    )
    m = evaluate_predictions(Yte, np.asarray(mean), np.asarray(var))
    assert abs(float(m["nlpd"]) - rec["test_nlpd"]) < 1e-4
    assert abs(float(m["r2"]) - rec["test_r2"]) < 1e-4
