"""Post-training analytics: correlation harness + GT-vs-trained comparison."""

import numpy as np

from dqgp.utils.analysis import compare_gt_vs_trained, nll_error_correlation
from dqgp.utils import plotting


def _fake_history(m=10, seed=0):
    rng = np.random.RandomState(seed)
    err = np.linspace(2.0, 0.5, m) + 0.01 * rng.randn(m)
    hist = []
    for i in range(m):
        # log-det strongly tracks the error; quadratic is noise
        comps = [{
            "log_det_term": float(10 * err[i] + 0.01 * rng.randn()),
            "quadratic_term": float(rng.randn()),
            "constant_term": 5.0,
            "total": float(10 * err[i] + 5.0),
        } for _ in range(3)]
        hist.append({
            "iteration": i + 1,
            "avg_nll": float(np.mean([c["total"] for c in comps])),
            "nll_components": comps,
        })
    return hist, err.tolist()


def test_nll_error_correlation_finds_best_component():
    hist, err = _fake_history()
    out = nll_error_correlation(hist, err)
    assert out["available"]
    assert out["components"]["log_det_term"] > 0.99
    assert abs(out["components"]["quadratic_term"]) < 0.9
    assert out["best_predictor"] in ("log_det_term", "total")
    assert nll_error_correlation([], [])["available"] is False


def test_compare_gt_vs_trained_buckets():
    trained = {"rmse": 0.10, "r2": 0.95, "nlpd": -0.5, "mae": 0.08}
    gt = {"rmse": 0.20, "r2": 0.90, "nlpd": -0.4, "mae": 0.081}
    out = compare_gt_vs_trained(trained, gt)
    assert out["metrics"]["rmse"]["trained_better"]
    assert out["metrics"]["rmse"]["significance"] == "significant"
    assert out["metrics"]["mae"]["significance"] == "marginal"
    assert out["metrics"]["r2"]["trained_better"]
    assert "beat" in out["verdict"] or "match" in out["verdict"]


def test_real_world_plot_written(tmp_path):
    rng = np.random.RandomState(0)
    X2 = rng.rand(200, 2)
    Y = rng.rand(200)
    p = plotting.plot_real_world_dataset(X2, Y, "srtm_elevation", region="maharashtra",
                                         save_plot=True, output_dir=str(tmp_path))
    import os
    assert p and os.path.exists(p)
    X3 = rng.rand(100, 3)
    p3 = plotting.plot_real_world_dataset(X3, rng.rand(100), "robot_push",
                                          save_plot=True, output_dir=str(tmp_path))
    assert p3 and os.path.exists(p3)


def test_plot_dataset_branches(tmp_path):
    rng = np.random.RandomState(1)
    for d in (1, 2, 4):
        X = rng.rand(40, d)
        Y = rng.rand(40)
        p = plotting.plot_dataset(X, Y, save_plot=True, output_dir=str(tmp_path / f"d{d}"))
        import os
        assert p and os.path.exists(p), d
    # train/test coloring branch
    p = plotting.plot_dataset(rng.rand(30, 1), rng.rand(30), save_plot=True,
                              output_dir=str(tmp_path / "tt"),
                              train_indices=np.arange(20), test_indices=np.arange(20, 30))
    assert p
