#!/usr/bin/env python
"""BASELINE config #7 (beyond the reference's reach): GP posterior at
n = 50,000 samples with a 10-qubit circuit — matrix-free CG posterior and
Gram-free blocked Cholesky NLL; the 50k x 50k Gram is never materialized.

Run with smaller N first: python examples/scale_out_50k.py 20000
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from dqgp.models.circuits import build_circuit
from dqgp.models.kernels import QuantumKernelSpec
from dqgp.models.kernels.quantum_kernel import kernel_features
from dqgp.parallel.blocked import gp_posterior_large, nll_large

N = int(sys.argv[1]) if len(sys.argv) > 1 else 50_000
M = 512  # test points

spec = QuantumKernelSpec(
    circuit=build_circuit("chebyshev", num_qubits=10, num_features=2, num_layers=2),
    kernel_type="projected",
    outer_kernel="matern",
)
print(f"N={N}, qubits=10, P={spec.num_parameters}")

rng = np.random.RandomState(0)
X = jnp.asarray(rng.uniform(-0.99, 0.99, (N + M, 2)), jnp.float32)
theta = jnp.asarray(rng.uniform(0, np.pi, spec.num_parameters), jnp.float32)

t0 = time.time()
F = kernel_features(spec, X, theta)  # one batched state pass
F.block_until_ready()
print(f"features for {N + M} samples: {time.time() - t0:.2f}s -> {F.shape}")

F_tr, F_te = F[:N].astype(jnp.float32), F[N:].astype(jnp.float32)
Y = jnp.asarray(np.sin(3 * np.asarray(X)[:N, 0]) + 0.1 * rng.randn(N), jnp.float32)

t0 = time.time()
mean, var, res = gp_posterior_large(
    spec, F_tr, Y, F_te, noise_std=0.1, block=4096, cg_tol=1e-5, cg_maxiter=600,
    precond_rank=256,
)
jax.block_until_ready((mean, var))
print(f"CG posterior (mean+var for {M} test pts): {time.time() - t0:.2f}s, "
      f"{int(res.iterations)} CG iters, residual {float(res.residual_norm):.2e}")

# Single-chip exact-NLL ceiling is ~37k (f32 factor 5.1 GB; at 50k the
# factor alone is 9.4 GB and XLA's transient copy exceeds HBM — use
# make_distributed_cholesky_nll across >=2 chips for that regime).
n_chol = min(N, 36 * 1024)
t0 = time.time()
nll, comps = nll_large(spec, F_tr[:n_chol], Y[:n_chol], noise_std=0.1, block=1024)
print(f"exact NLL via gram-free blocked Cholesky (n={n_chol}): {float(nll):.2f} "
      f"({time.time() - t0:.2f}s)")
