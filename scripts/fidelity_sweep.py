#!/usr/bin/env python
"""BASELINE config sweep: fidelity kernel, 6-qubit kyriienko encoding,
synthetic quantum-GP data across input dims 1-6 (the reference's README
sweep axis). CPU float64 parity mode, fixed seeds — reproducible anywhere:

    JAX_PLATFORMS=cpu python scripts/fidelity_sweep.py

Writes results_round2/fidelity_sweep_cpu.json.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp


def main():
    from dqgp.data.splits import train_test_split

    from dqgp.data import generate_quantum_gp_data, split_data_numpy
    from dqgp.driver import TrainConfig, train
    from dqgp.models.circuits import build_circuit
    from dqgp.models.gp import evaluate_predictions, predict_quantum_gp
    from dqgp.models.kernels import QuantumKernelSpec

    out = {}
    for dim in range(1, 7):
        spec = QuantumKernelSpec(
            circuit=build_circuit("kyriienko", 6, dim, 2),
            kernel_type="fidelity",
        )
        X, Y, theta_star = generate_quantum_gp_data(
            num_samples=240, input_dim=dim, spec=spec,
            noise_std=0.1, param_seed=42, data_seed=42,
        )
        Xtr, Xte, Ytr, Yte = train_test_split(X, Y, test_size=0.1,
                                              random_state=42)
        splits = split_data_numpy(Xtr, Ytr, n_agents=4,
                                  partition_method="regional")
        t0 = time.time()
        res = train(spec, splits, Xtr, Ytr,
                    TrainConfig(max_iter=3, verbose=False),
                    ground_truth_params=theta_star)
        hyper = res.z_best_cv if res.z_best_cv is not None else res.z
        mean, var = predict_quantum_gp(
            spec, jnp.asarray(Xtr), jnp.asarray(Ytr), jnp.asarray(Xte),
            jnp.asarray(hyper), noise_std=0.1)
        m = evaluate_predictions(Yte, np.asarray(mean), np.asarray(var),
                                 verbose=False)
        out[f"{dim}d"] = {
            "P": spec.num_parameters,
            "cv_nlpd_best": round(res.cv_best, 6),
            "test_nlpd": round(float(m["nlpd"]), 6),
            "test_r2": round(float(m["r2"]), 6),
            "gt_recovery_riemannian": round(float(res.error_best), 6),
            "wall_seconds": round(time.time() - t0, 1),
        }
        print(f"{dim}D: P={out[f'{dim}d']['P']} r2={out[f'{dim}d']['test_r2']:.4f} "
              f"nlpd={out[f'{dim}d']['test_nlpd']:.4f} "
              f"({out[f'{dim}d']['wall_seconds']}s)", flush=True)

    path = os.path.join(REPO, "results_round2", "fidelity_sweep_cpu.json")
    with open(path, "w") as f:
        json.dump({"config": "fidelity kernel, kyriienko 6q 2L, n=240, "
                             "4 agents, 3 iters, CPU f64 parity mode, seed 42",
                   "dims": out}, f, indent=1)
    print("wrote", path)


if __name__ == "__main__":
    main()
