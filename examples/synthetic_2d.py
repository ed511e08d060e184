#!/usr/bin/env python
"""BASELINE config #1: 2D synthetic quantum-GP regression, 3-qubit 1-layer
hubregtsen encoding, projected kernel + matern outer, 4 agents.

Equivalent CLI:
    python main.py --input-dim 2 --n-dataset 1000 --encoding hubregtsen \
        --kernel-type projected --num-layers 1 --num-qubits 3 \
        --outer-kernel matern --rho 100 --L 100 --n-agents 4
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

from dqgp.data import generate_quantum_gp_data, split_data_numpy
from dqgp.driver import TrainConfig, train
from dqgp.models.circuits import build_circuit
from dqgp.models.gp import evaluate_predictions, predict_quantum_gp
from dqgp.models.kernels import QuantumKernelSpec

spec = QuantumKernelSpec(
    circuit=build_circuit("hubregtsen", num_qubits=3, num_features=2, num_layers=1),
    kernel_type="projected",
    outer_kernel="matern",
)

X, Y, theta_star = generate_quantum_gp_data(
    1000, 2, spec, noise_std=0.1, data_seed=42, param_seed=42
)
n_train = 900
Xtr, Ytr, Xte, Yte = X[:n_train], Y[:n_train], X[n_train:], Y[n_train:]
splits = split_data_numpy(Xtr, Ytr, n_agents=4, partition_method="regional")

result = train(
    spec, splits, Xtr, Ytr,
    TrainConfig(rho=100.0, L=100.0, noise_std=0.1, max_iter=30, cv_folds=5),
    ground_truth_params=theta_star,
)

hyper = result.z_best_cv if result.z_best_cv is not None else result.z
mean, var = predict_quantum_gp(
    spec, jnp.asarray(Xtr), jnp.asarray(Ytr), jnp.asarray(Xte),
    jnp.asarray(hyper), noise_std=0.1,
)
metrics = evaluate_predictions(Yte, np.asarray(mean), np.asarray(var), verbose=True)
print(f"\nbest CV-NLPD: {result.cv_best:.4f}  "
      f"GT recovery (Riemannian distance): {result.error_best:.4f}")
