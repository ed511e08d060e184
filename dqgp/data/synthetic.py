"""Synthetic data generation: quantum-GP sampling + classical test functions.

Twin of the reference's generators with identical RNG semantics so fixed
seeds reproduce the same X / ground-truth parameters:

* ``generate_quantum_gp_data`` (main.py:161-292): theta* ~ U(0, pi) under
  ``np.random.seed(param_seed)`` rounded to 4dp; X ~ U(data_range) under
  ``np.random.seed(data_seed)`` (time-based if None); chebyshev inputs clipped
  to [-0.99, 0.99]; K built by the quantum kernel (here: one batched pass
  instead of N^2 circuit runs); 1e-6 jitter; Y = chol(K) z + noise with an
  eigendecomposition fallback (eigenvalues clamped >= 1e-10).
* ``generate_data_numpy`` (main.py:457-522): 1D sine mix, 2D log-normalized
  Goldstein-Price, 3D negated Hartmann.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.kernels.quantum_kernel import QuantumKernelSpec, gram

# One fused program per spec instead of op-by-op dispatch.
_gram_jit = jax.jit(gram, static_argnums=(0,))
_gram_jit64 = jax.jit(
    lambda spec, X, th: gram(spec, X, th, dtype=jnp.float64), static_argnums=(0,)
)


def generate_quantum_gp_data(
    num_samples: int,
    input_dim: int,
    spec: QuantumKernelSpec,
    data_range: Tuple[float, float] = (-2.0, 2.0),
    noise_std: float = 0.1,
    kernel_params: Optional[np.ndarray] = None,
    data_seed: Optional[int] = None,
    param_seed: int = 42,
    verbose: bool = False,
    gram_dtype: str = "auto",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sample (X, Y, theta*) from a quantum-GP prior. Reference main.py:161-292.

    ``gram_dtype`` selects the precision of the ground-truth Gram K the
    samples are drawn from. The reference builds it in double precision
    (qiskit-aer statevectors, main.py:245, 270-287), so ``"auto"`` resolves
    to float64 wherever x64 is on — the
    f32-vs-f64 pipeline gap is ~1e-4 in K entries, i.e. generated Y from the
    f32 pipeline differs from a true reference dataset at that scale
    (round-3 fixture check).
    The numpy RNG sequence (X, theta*, z, noise) is identical either way —
    only K's entries move.
    """
    if input_dim < 1 or input_dim > 6:
        raise ValueError(f"Input dimension must be between 1 and 6, got {input_dim}")
    if spec.circuit.num_features != input_dim:
        raise ValueError("spec.circuit.num_features must equal input_dim")

    P = spec.num_parameters
    if kernel_params is not None:
        if len(kernel_params) != P:
            raise ValueError(f"Expected {P} parameters, got {len(kernel_params)}")
        ground_truth_params = np.round(np.asarray(kernel_params, np.float64).copy(), 4)
    else:
        np.random.seed(param_seed)
        ground_truth_params = np.round(np.random.uniform(0, np.pi, P), 4)

    if data_seed is None:
        data_seed = int(time.time() * 1000) % 2**32  # reference: main.py:216-218
    np.random.seed(data_seed)
    if verbose:
        print(f"Using data generation seed: {data_seed}")

    X = np.random.uniform(data_range[0], data_range[1], size=(num_samples, input_dim))
    if spec.circuit.requires_clipping:
        X = np.clip(X, -0.99, 0.99)  # arccos domain guard (main.py:224-236)

    from ..config import resolve_gram_dtype

    gram_dtype = resolve_gram_dtype(gram_dtype)
    if gram_dtype == "float64":
        # np.array (copy) not np.asarray: a dtype-matching f64 jax array on
        # CPU aliases device memory read-only, and the diagonal jitter below
        # mutates K in place.
        K = np.array(
            _gram_jit64(spec, jnp.asarray(X, jnp.float64),
                        jnp.asarray(ground_truth_params, jnp.float64)),
            np.float64,
        )
    else:
        K = np.asarray(
            _gram_jit(spec, jnp.asarray(X, jnp.float32),
                      jnp.asarray(ground_truth_params, jnp.float32)),
            np.float64,
        )
    if np.any(np.isnan(K)) or np.any(np.isinf(K)):
        raise ValueError("Kernel matrix contains NaN or infinite values")

    # in-place diagonal jitter: `K + 1e-6*np.eye(N)` would allocate two more
    # N x N f64 matrices (~17 GB extra at the recommended 2D size of 32,400)
    K[np.diag_indices_from(K)] += 1e-6
    try:
        L = np.linalg.cholesky(K)
        z = np.random.normal(0, 1, num_samples)
        Y = L @ z
        Y = Y + np.random.normal(0, noise_std, num_samples)
    except np.linalg.LinAlgError:
        eigenvals, eigenvecs = np.linalg.eigh(K)
        eigenvals = np.maximum(eigenvals, 1e-10)
        z = np.random.normal(0, 1, num_samples)
        Y = eigenvecs @ (np.sqrt(eigenvals) * z)
        Y = Y + np.random.normal(0, noise_std, num_samples)

    return X, Y, ground_truth_params


def generate_data_numpy(
    num_samples: int,
    input_dim: int = 1,
    noise_std: float = 0.1,
    data_seed: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Classical test functions (main.py:457-522), RNG-identical."""
    if data_seed is None:
        data_seed = int(time.time() * 1000) % 2**32
    np.random.seed(data_seed)

    if input_dim == 1:
        X = np.random.uniform(0, 1, size=(num_samples, 1))
        x = X[:, 0]
        Y = 5 * x**2 * np.sin(12 * x) + (x**3 - 0.5) * np.sin(3 * x - 0.5) + 4 * np.cos(2 * x)
        Y = Y + np.random.normal(0, noise_std, num_samples)
    elif input_dim == 2:
        X = np.random.uniform(-2.0, 2.0, size=(num_samples, 2))
        x1, x2 = X[:, 0], X[:, 1]
        fact1 = 1 + (x1 + x2 + 1) ** 2 * (
            19 - 14 * x1 + 3 * x1**2 - 14 * x2 + 6 * x1 * x2 + 3 * x2**2
        )
        fact2 = 30 + (2 * x1 - 3 * x2) ** 2 * (
            18 - 32 * x1 + 12 * x1**2 + 48 * x2 - 36 * x1 * x2 + 27 * x2**2
        )
        Y = (np.log(fact1 * fact2) - 8.693) / 2.427
        Y = Y + np.random.normal(0, noise_std, num_samples)
    elif input_dim == 3:
        X = np.random.uniform(0.0, 1.0, size=(num_samples, 3))
        alpha = np.array([1.0, 1.2, 3.0, 3.2])
        A = np.array([[3.0, 10.0, 30.0], [0.1, 10.0, 35.0],
                      [3.0, 10.0, 30.0], [0.1, 10.0, 35.0]])
        Pm = 1e-4 * np.array([[3689.0, 1170.0, 2673.0], [4699.0, 4387.0, 7470.0],
                              [1091.0, 8732.0, 5547.0], [381.0, 5743.0, 8828.0]])
        Y = np.zeros(num_samples)
        for i in range(4):
            inner = np.sum(A[i, :] * (X - Pm[i, :]) ** 2, axis=1)
            Y += alpha[i] * np.exp(-inner)
        Y = -Y
        Y = Y + np.random.normal(0, noise_std, num_samples)
    else:
        raise ValueError(f"Unsupported input dimension: {input_dim}")
    return X, Y


def save_quantum_dataset(X, Y, dataset_name: str, output_dir: str = "quantum_datasets") -> str:
    """CSV export ``{name}_{d}d_{N}.csv`` (main.py:433-455)."""
    os.makedirs(output_dir, exist_ok=True)
    combined = np.column_stack((X, Y))
    filename = os.path.join(output_dir, f"{dataset_name}_{X.shape[1]}d_{X.shape[0]}.csv")
    header = ",".join([f"X{i+1}" for i in range(X.shape[1])] + ["Y"])
    np.savetxt(filename, combined, delimiter=",", header=header, comments="")
    return filename
