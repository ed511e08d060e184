"""Golden-trajectory regression anchor: the parity-mode 4-decimal
quantization makes short ADMM trajectories bit-stable across refactors —
any change to update order, rounding, or kernel numerics shows up here."""

import numpy as np
import pytest

from dqgp.data import generate_quantum_gp_data, split_data_numpy
from dqgp.driver import TrainConfig, train
from dqgp.models.circuits import build_circuit
from dqgp.models.kernels import QuantumKernelSpec

# Recorded from the round-1 implementation (CPU, f64 GP, parity mode).
# If an INTENTIONAL numerics change invalidates this, re-record and explain
# in the commit message.
GOLDEN_Z = [0.5339, 0.8038, 0.5769]


def _z_trajectory():
    spec = QuantumKernelSpec(
        circuit=build_circuit("hubregtsen", 2, 2, 1),
        kernel_type="projected", outer_kernel="gaussian",
    )
    X, Y, _ = generate_quantum_gp_data(
        24, 2, spec, data_range=(-0.95, 0.95), noise_std=0.05,
        data_seed=3, param_seed=3,
    )
    splits = split_data_numpy(X, Y, 2, "sequential")
    cfg = TrainConfig(rho=100.0, L=100.0, noise_std=0.05, max_iter=3,
                      seed=3, compute_cond=False, verbose=False, run_cv=False)
    res = train(spec, splits, X, Y, cfg)
    return np.round(res.z, 4), np.round(res.theta, 4)


def test_trajectory_is_deterministic_and_matches_golden():
    z1, th1 = _z_trajectory()
    z2, th2 = _z_trajectory()
    np.testing.assert_array_equal(z1, z2)
    np.testing.assert_array_equal(th1, th2)
    np.testing.assert_array_equal(z1, np.asarray(GOLDEN_Z))
