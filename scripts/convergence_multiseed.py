#!/usr/bin/env python
"""Multi-seed convergence runs for BASELINE configs #1 and #5 (VERDICT r3 #3).

Round 3 ran each of config #5's 6 dims ONCE — every dim CV-patience... no:
consensus-stopped at exactly iteration 17, and the "d=1 converged-optimum"
diagnosis rested on that single seed. Round-4 investigation (recorded in
docs/ROUND4.md) found the mechanism: at the 6-qubit fidelity configs the
per-agent NLL gradients are |g| <= ~1e-4, so under the reference's parity
semantics — gradient rounded to 4 dp, theta update -(g + psi)/(rho + L) with
rho = L = 100, theta/psi rounded to 4 dp — the data term contributes
< 5e-7 per step, far below theta's own 4-dp resolution. The trajectory is
therefore DATA-INDEPENDENT: a pure psi/z contraction of the seed-42 init
that reaches consensus (all ||z - theta_i|| < 1e-6) at iteration 17 with
bit-identical z for every input dim (verified: identical z and
gt_error_best across all 6 dims in results_round3/convergence_runs.json).
"Converged optimum" was the wrong reading for d=1 — the optimizer never
moves; the final z IS the contracted initialization.

This script quantifies the consequence with restarts: 3 ADMM-init seeds per
config (the dataset stays pinned at data-seed 42 so the restarts probe the
OPTIMIZER, not dataset luck), reporting per-dim mean +/- std of test NLPD
and the GT gap (test NLPD - ground-truth-parameter NLPD), plus stop reason
and iteration count. Config #1 (3q hubregtsen projected+matern, n=1000) has
O(1) gradients, so its restarts genuinely explore the torus.

    python scripts/convergence_multiseed.py
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEEDS = (42, 7, 123)


def run_one(name, extra_args, iters, chain_iters, seed):
    from dqgp.cli import main as cli_main

    with tempfile.NamedTemporaryFile(suffix=".json", delete=False) as f:
        metrics_path = f.name
    argv = extra_args + [
        "--max-iter", str(iters), "--no-plot", "--quiet",
        "--chain-iters", str(chain_iters),
        "--seed", str(seed),
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
            "seed": seed,
            "iterations": m["iterations"],
            "converged_by": m["converged_by"],
            "cv_best_nlpd": m["cv_best_nlpd"],
            "test_nlpd": tm.get("nlpd"),
            "test_r2": tm.get("r2"),
            "within_2sigma": tm.get("within_2sigma"),
            "gt_test_nlpd": gt.get("nlpd"),
            "gt_gap_nlpd": (tm.get("nlpd") - gt.get("nlpd")
                            if tm.get("nlpd") is not None
                            and gt.get("nlpd") is not None else None),
            "gt_error_best": m.get("gt_error_best"),
            "final_z_head": (m.get("final_z") or [])[:4],
            "wall_s": round(time.time() - t0, 1),
        }
    except Exception as e:
        row = {"seed": seed, "error": f"{type(e).__name__}: {e}",
               "wall_s": round(time.time() - t0, 1)}
    finally:
        os.unlink(metrics_path)
    print(f"{name} seed={seed}: {json.dumps(row)}", flush=True)
    return row


def summarize(rows):
    import numpy as np

    ok = [r for r in rows if "error" not in r and r.get("test_nlpd") is not None]
    if not ok:
        return {}
    s = {}
    for key in ("test_nlpd", "gt_gap_nlpd", "test_r2", "iterations"):
        vals = [r[key] for r in ok if r.get(key) is not None]
        if vals:
            s[f"{key}_mean"] = float(np.mean(vals))
            s[f"{key}_std"] = float(np.std(vals))
    s["stop_reasons"] = sorted({r["converged_by"] for r in ok})
    # Are the restarts genuinely distinct optimizations? Identical final z
    # across seeds would mean the init seed does not even reach the result.
    heads = {tuple(np.round(r["final_z_head"], 4)) for r in ok}
    s["distinct_final_z"] = len(heads)
    return s


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--chain-iters", type=int, default=10)
    ap.add_argument("--out", type=str,
                    default="results_round4/convergence_multiseed.json")
    ap.add_argument("--skip-config1", action="store_true")
    args = ap.parse_args()

    results = {}

    if not args.skip_config1:
        rows = [run_one("config1", [
            "--input-dim", "2", "--n-dataset", "1000", "--data-seed", "42",
            "--encoding", "hubregtsen", "--kernel-type", "projected",
            "--num-qubits", "3", "--num-layers", "1",
            "--outer-kernel", "matern",
        ], args.iters, args.chain_iters, s) for s in SEEDS]
        results["config1"] = {"runs": rows, "summary": summarize(rows)}

    for d in range(1, 7):
        rows = [run_one(f"fidelity_{d}d", [
            "--input-dim", str(d), "--n-dataset", "200", "--data-seed", "42",
            "--encoding", "kyriienko", "--kernel-type", "fidelity",
            "--num-qubits", "6", "--num-layers", "1",
        ], args.iters, args.chain_iters, s) for s in SEEDS]
        results[f"fidelity_{d}d"] = {"runs": rows, "summary": summarize(rows)}

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
