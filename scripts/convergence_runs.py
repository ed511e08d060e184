#!/usr/bin/env python
"""Convergence runs for BASELINE config #5 and the great_lakes diagnosis.

Round-2 verdict items #3 (weak: the 10-iteration fidelity sweep trails GT
NLPD at d=3/d=5; great_lakes is the unexplained worst SRTM region). This
script runs:

* fidelity/kyriienko 6-qubit, d = 1..6, n = 200, 100 ADMM iterations
  (BASELINE config #5 asks for convergence, not a snapshot) — target:
  trained NLPD within 0.05 of (or beating) the ground-truth-parameter NLPD
  on >= 5/6 dims.
* great_lakes at 100 iterations, plus controlled variants probing the three
  hypotheses for its weak 25-iteration numbers (R^2 0.72, NLPD 3.6,
  2-sigma 0.53): more iterations, a different sampling seed (tile-sampling
  luck), and a larger model (5 qubits / 4 layers, the washington config
  that scores R^2 0.87 on its region).

Writes one JSON summary to results_round3/convergence_runs.json.

    python scripts/convergence_runs.py
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_config(name, extra_args, iters, chain_iters=10):
    from dqgp.cli import main as cli_main

    with tempfile.NamedTemporaryFile(suffix=".json", delete=False) as f:
        metrics_path = f.name
    argv = extra_args + [
        "--max-iter", str(iters), "--no-plot", "--quiet",
        "--chain-iters", str(chain_iters),
        "--metrics-json", metrics_path,
    ]
    t0 = time.time()
    try:
        cli_main(argv)
        with open(metrics_path) as f:
            m = json.load(f)
        tm = m.get("test_metrics") or {}
        gt = m.get("gt_metrics") or {}
        row = {
            "iterations": m["iterations"],
            "cv_best_nlpd": m["cv_best_nlpd"],
            "test_r2": tm.get("r2"),
            "test_nlpd": tm.get("nlpd"),
            "within_2sigma": tm.get("within_2sigma"),
            "gt_test_nlpd": gt.get("nlpd"),
            "gt_test_r2": gt.get("r2"),
            "gt_error_best": m.get("gt_error_best"),
            "wall_s": round(time.time() - t0, 1),
        }
    except Exception as e:  # keep the sweep alive; record the failure
        row = {"error": f"{type(e).__name__}: {e}",
               "wall_s": round(time.time() - t0, 1)}
    finally:
        os.unlink(metrics_path)
    print(f"{name}: {json.dumps(row)}", flush=True)
    return row


GREAT_LAKES_BASE = [
    "--real-world-dataset", "srtm", "--srtm-region", "great_lakes",
    "--dataset-max-samples", "1000", "--dataset-normalize",
    "--encoding", "chebyshev", "--kernel-type", "projected",
    "--num-qubits", "4", "--num-layers", "3", "--outer-kernel", "matern",
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--chain-iters", type=int, default=10)
    ap.add_argument("--out", type=str,
                    default="results_round3/convergence_runs.json")
    ap.add_argument("--skip-great-lakes", action="store_true")
    args = ap.parse_args()

    results = {}
    # BASELINE config #5: 6-qubit kyriienko fidelity kernel, 1-6D, converged
    for d in range(1, 7):
        results[f"fidelity_{d}d_100it"] = run_config(
            f"fidelity_{d}d_100it",
            ["--input-dim", str(d), "--n-dataset", "200",
             "--encoding", "kyriienko", "--kernel-type", "fidelity",
             "--num-qubits", "6", "--num-layers", "1", "--data-seed", "42"],
            args.iters, args.chain_iters,
        )

    if not args.skip_great_lakes:
        results["great_lakes_100it"] = run_config(
            "great_lakes_100it", GREAT_LAKES_BASE, args.iters,
            args.chain_iters)
        results["great_lakes_seed7"] = run_config(
            "great_lakes_seed7", GREAT_LAKES_BASE + ["--seed", "7"],
            25, args.chain_iters)
        results["great_lakes_5q4l"] = run_config(
            "great_lakes_5q4l",
            ["--real-world-dataset", "srtm", "--srtm-region", "great_lakes",
             "--dataset-max-samples", "1000", "--dataset-normalize",
             "--encoding", "chebyshev", "--kernel-type", "projected",
             "--num-qubits", "5", "--num-layers", "4",
             "--outer-kernel", "matern", "--n-agents", "8"],
            25, args.chain_iters)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
