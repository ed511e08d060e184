#!/usr/bin/env python
"""Bound the mixed-CV model-selection risk (VERDICT r5 #8).

The mixed CV fold solves are ~1e-4-grade (split-f64 matvec floor,
ops/linalg.py): fold-NLPD near-ties within ~1e-5 could select a DIFFERENT
best-CV z than the reference's exact-f64 CV would. This experiment runs the
north-star bench problem for 25 ADMM iterations with the SAME f64 agent
trajectory (gp_dtype=float64 isolates the CV dtype as the only difference)
under cv_dtype mixed vs float64, across 3 ADMM-init seeds, and reports:

* per-iteration argmin flips: at each iteration t, does the best-so-far CV
  iteration index (argmin over consensus_cv_score[0..t]) differ?
* final selection flip: do the two runs select a different z_best_cv?
* the per-iteration |mixed - f64| CV-score deviation (max / median),
* the test-NLPD delta of the SELECTED models (predict with each run's
  z_best_cv on a held-out grid) — the user-facing impact of any flip.

Writes results_round5/mixed_cv_selection.json. CPU or GPU:

    JAX_PLATFORMS=cpu python scripts/mixed_cv_selection.py
    python scripts/mixed_cv_selection.py
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dqgp  # noqa: F401  (pins the platform from the env)
from bench import NOISE_STD, RHO, L_CONST, make_problem  # noqa: E402

ITERS = 25
SEEDS = (42, 43, 44)
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "results_round5", "mixed_cv_selection.json")


def run(spec, splits, X, Y, seed, cv_dtype):
    from dqgp.driver import TrainConfig, train

    cfg = TrainConfig(
        max_iter=ITERS, rho=RHO, L=L_CONST, noise_std=NOISE_STD,
        gp_dtype="float64", cv_dtype=cv_dtype, compute_cond=False,
        cv_patience=10_000, tolerance=0.0, seed=seed, verbose=False,
    )
    res = train(spec, splits, X, Y, cfg)
    scores = np.array([row["consensus_cv_score"] for row in res.cv_history])
    return res, scores


def main():
    import jax

    spec, X, Y, splits = make_problem()
    # held-out evaluation grid for the user-facing impact of a flip
    rng = np.random.RandomState(123)
    X_te = rng.uniform(-0.99, 0.99, (200, 2))
    Y_te = np.sin(3 * X_te[:, 0]) * np.cos(2 * X_te[:, 1])

    from dqgp.models.gp.metrics import evaluate_predictions
    from dqgp.models.gp.posterior import predict_quantum_gp

    per_seed = []
    for seed in SEEDS:
        r64, s64 = run(spec, splits, X, Y, seed, "float64")
        rmx, smx = run(spec, splits, X, Y, seed, "mixed")
        n = min(len(s64), len(smx))
        s64, smx = s64[:n], smx[:n]
        # the agent trajectory is identical by construction; double-check
        assert np.array_equal(np.asarray(r64.z), np.asarray(rmx.z)), (
            "gp_dtype=float64 trajectories must be CV-dtype independent")
        argmin_flips = int(np.sum(
            [int(np.argmin(s64[: t + 1])) != int(np.argmin(smx[: t + 1]))
             for t in range(n)]))
        dev = np.abs(s64 - smx)
        final_flip = bool(int(np.argmin(s64)) != int(np.argmin(smx)))

        nlpds = {}
        for tag, res in (("f64", r64), ("mixed", rmx)):
            zb = res.z_best_cv if res.z_best_cv is not None else res.z
            mean, var = predict_quantum_gp(
                spec, X, Y, X_te, np.asarray(zb), noise_std=NOISE_STD)
            m = evaluate_predictions(Y_te, np.asarray(mean),
                                     np.sqrt(np.asarray(var)))
            nlpds[tag] = float(m["nlpd"])
        per_seed.append({
            "seed": seed,
            "iterations": n,
            "argmin_flip_iters": argmin_flips,
            "final_selection_flip": final_flip,
            "selected_iter_f64": int(np.argmin(s64)),
            "selected_iter_mixed": int(np.argmin(smx)),
            "cv_score_dev_max": float(dev.max()),
            "cv_score_dev_median": float(np.median(dev)),
            "test_nlpd_f64_selected": nlpds["f64"],
            "test_nlpd_mixed_selected": nlpds["mixed"],
            "test_nlpd_delta": abs(nlpds["f64"] - nlpds["mixed"]),
        })
        print(json.dumps(per_seed[-1]), flush=True)

    summary = {
        "iters": ITERS,
        "backend": jax.default_backend(),
        "any_final_flip": any(r["final_selection_flip"] for r in per_seed),
        "max_test_nlpd_delta": max(r["test_nlpd_delta"] for r in per_seed),
        "max_cv_score_dev": max(r["cv_score_dev_max"] for r in per_seed),
        "runs": per_seed,
    }
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: summary[k] for k in
                      ("any_final_flip", "max_test_nlpd_delta",
                       "max_cv_score_dev")}))
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
