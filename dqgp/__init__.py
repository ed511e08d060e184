"""dqgp — distributed Quantum Gaussian Process Regression in JAX.

A ground-up JAX/XLA re-design of the capabilities of
``mpala-lab/distributed-quantum-gaussian-processes`` (quantum-kernel GPs whose
encoding-circuit parameters are optimized by multi-agent Riemannian ADMM
consensus on a torus manifold).

Architecture:

* ``dqgp.ops``      — circuit IR, batched statevector engine, GP linear
                      algebra. The reference's per-pair C++ statevector calls
                      (qiskit-aer) become one batched state-preparation pass +
                      Gram-as-matmul.
* ``dqgp.models``   — encoding-circuit library, fidelity/projected quantum
                      kernels with outer kernels, GP posterior/NLL/metrics/CV.
* ``dqgp.manifold`` — torus manifold, Riemannian optimizers, ADMM algebra
                      (pure jittable functions; class API mirrors the
                      reference's public surface).
* ``dqgp.parallel`` — multi-agent execution on a ``jax.sharding.Mesh``:
                      agents are a named mesh axis, the consensus circular
                      mean is a ``psum`` of (cos, sin) sums, data stays
                      device-resident (the reference re-pickles every round
                      over ProcessPoolExecutor pipes).
* ``dqgp.data``     — synthetic quantum-GP sampling, classical test
                      functions, real-world loaders (SST / robot-push /
                      SRTM .hgt), partitioning, splits and scalers.
* ``dqgp.utils``    — metrics history, analysis, plotting.

Precision: statevectors run in complex64 (fidelity entries are magnitudes —
well conditioned); Gram/Cholesky/NLPD run in float64 unless ``DQGP_X64=0``.
"""

from __future__ import annotations

import os

import jax

# GP-side linear algebra wants f64 for parity with the reference's LAPACK
# numerics; the statevector path explicitly uses complex64/float32 regardless.
if os.environ.get("DQGP_X64", "1") != "0":
    jax.config.update("jax_enable_x64", True)

# GPU f32 matmuls may run in TF32 (~3 decimal digits) by default; Gram
# matrices built from nearly-parallel feature vectors then lose PSD-ness and
# the Cholesky NaNs. GP numerics need true f32 products.
jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: JAX_COMPILATION_CACHE_DIR when the
# environment sets it (jax reads it itself), else a fixed directory in the
# checkout — the path is part of the cache key, so it must not move.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     ".jax_cache"))

__version__ = "0.1.0"

from . import manifold  # noqa: E402,F401


def __getattr__(name):  # lazy top-level conveniences (avoid import cycles)
    if name in ("QuantumKernelSpec", "QuantumKernel", "create_quantum_kernel"):
        from .models import kernels as _k

        return getattr(_k, name)
    if name == "build_circuit":
        from .models.circuits import build_circuit

        return build_circuit
    if name in ("TrainConfig", "TrainResult", "train"):
        from . import driver as _d

        return getattr(_d, name)
    if name == "RiemannianAgent":
        from .agent import RiemannianAgent

        return RiemannianAgent
    raise AttributeError(name)
