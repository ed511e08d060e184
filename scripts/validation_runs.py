#!/usr/bin/env python
"""Reproduce the end-to-end validation table.

Drives the CLI path for each small BASELINE-shaped config (synthetic 2D,
SRTM maharashtra/washington via the synthetic stand-in tiles, SST,
robot-push) and the 1-6D fidelity sweep, writing one JSON summary to
results_round2/validation_runs.json. Each config runs in-process through
``dqgp.cli.main`` with ``--metrics-json`` capture.

    python scripts/validation_runs.py [--iters N]

Wall time is dominated by one fused-program compile per distinct shape.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


CONFIGS = {
    "config1_synthetic2d": [
        "--input-dim", "2", "--n-dataset", "1000", "--encoding", "hubregtsen",
        "--kernel-type", "projected", "--num-qubits", "3", "--num-layers", "1",
        "--outer-kernel", "matern", "--data-seed", "42",
    ],
    "config2_srtm_maharashtra": [
        "--real-world-dataset", "srtm", "--srtm-region", "maharashtra",
        "--dataset-max-samples", "1000", "--dataset-normalize",
        "--encoding", "chebyshev", "--kernel-type", "projected",
        "--num-qubits", "4", "--num-layers", "3", "--outer-kernel", "matern",
    ],
    "config4_srtm_washington": [
        "--real-world-dataset", "srtm", "--srtm-region", "washington_coast",
        "--dataset-max-samples", "1000", "--dataset-normalize",
        "--encoding", "chebyshev", "--kernel-type", "projected",
        "--num-qubits", "5", "--num-layers", "4", "--outer-kernel", "matern",
        "--n-agents", "8",
    ],
    "config3_srtm_great_lakes": [
        "--real-world-dataset", "srtm", "--srtm-region", "great_lakes",
        "--dataset-max-samples", "1000", "--dataset-normalize",
        "--encoding", "chebyshev", "--kernel-type", "projected",
        "--num-qubits", "4", "--num-layers", "3", "--outer-kernel", "matern",
    ],
    "config3_srtm_oregon": [
        "--real-world-dataset", "srtm", "--srtm-region", "oregon_coast",
        "--dataset-max-samples", "1000", "--dataset-normalize",
        "--encoding", "chebyshev", "--kernel-type", "projected",
        "--num-qubits", "4", "--num-layers", "3", "--outer-kernel", "matern",
    ],
    "sst": [
        "--real-world-dataset", "sst", "--dataset-max-samples", "1000",
        "--dataset-normalize", "--encoding", "yz_cx",
        "--kernel-type", "projected", "--num-qubits", "4", "--num-layers", "2",
    ],
    "robot_push": [
        "--real-world-dataset", "robot_push", "--dataset-max-samples", "1000",
        "--dataset-normalize", "--encoding", "multi_control",
        "--kernel-type", "projected", "--num-qubits", "4", "--num-layers", "2",
    ],
}

FIDELITY_DIMS = [1, 2, 3, 4, 5, 6]


def run_config(name, extra_args, iters, chain_iters=1):
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
        row = {
            "iterations": m["iterations"],
            "cv_best_nlpd": m["cv_best_nlpd"],
            "test_r2": (m.get("test_metrics") or {}).get("r2"),
            "test_nlpd": (m.get("test_metrics") or {}).get("nlpd"),
            "within_2sigma": (m.get("test_metrics") or {}).get("within_2sigma"),
            "gt_error_best": m.get("gt_error_best"),
            "wall_s": round(time.time() - t0, 1),
        }
    except Exception as e:  # keep the sweep alive; record the failure
        row = {"error": f"{type(e).__name__}: {e}", "wall_s": round(time.time() - t0, 1)}
    finally:
        os.unlink(metrics_path)
    print(f"{name}: {json.dumps(row)}", flush=True)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chain-iters", type=int, default=1,
                    help="forwarded to the CLI: ADMM iterations per device "
                         "dispatch (identical trajectory, less host "
                         "overhead)")
    ap.add_argument("--iters", type=int, default=25,
                    help="ADMM iterations per config")
    ap.add_argument("--skip-fidelity", action="store_true")
    ap.add_argument("--only", type=str, default=None,
                    help="comma-separated config names to run (default all); "
                         "fidelity dims still run unless --skip-fidelity")
    ap.add_argument("--out", type=str,
                    default="results_round2/validation_runs.json")
    args = ap.parse_args()

    only = set(args.only.split(",")) if args.only else None
    if only:
        unknown = only - set(CONFIGS)
        if unknown:
            raise SystemExit(f"--only names not in CONFIGS: {sorted(unknown)}")

    results = {}
    # merge into an existing output file so partial (--only) runs extend it
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    for name, cfg in CONFIGS.items():
        if only and name not in only:
            continue
        results[name] = run_config(name, cfg, args.iters, args.chain_iters)

    if not args.skip_fidelity:
        # BASELINE config #5: 6-qubit kyriienko fidelity kernel, 1-6D
        for d in FIDELITY_DIMS:
            results[f"fidelity_{d}d"] = run_config(
                f"fidelity_{d}d",
                ["--input-dim", str(d), "--n-dataset", "200",
                 "--encoding", "kyriienko", "--kernel-type", "fidelity",
                 "--num-qubits", "6", "--num-layers", "1", "--data-seed", "42"],
                min(args.iters, 10),
                args.chain_iters,
            )

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
