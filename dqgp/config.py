"""Precision policy: the one home for the dtype modes shared by the driver,
the QuantumKernel facade, dataset generation and noise fitting."""

from __future__ import annotations


def resolve_dtype_mode(mode: str) -> str:
    """Resolve a GP/CV linalg dtype mode ("auto" | "float64" | "mixed" |
    "float32") to a concrete one.

    "auto" is direct "float64": LAPACK-grade numerics, matching the
    reference. "mixed" (``ops/linalg.solve_psd_mixed``: f32 factorization +
    f64 refinement, with an automatic f64 re-run on refinement failure) stays
    an explicit mode.
    """
    return "float64" if mode == "auto" else mode


def resolve_gram_dtype(dtype: str) -> str:
    """Resolve a Gram/statevector-pipeline dtype request ("auto" | "float32"
    | "float64") to a concrete one.

    "auto" picks float64 wherever x64 is on — reference-grade entries,
    matching qiskit-aer's double precision — and float32 otherwise.
    An EXPLICIT "float64" without x64 raises: jnp would silently build f32
    arrays and the caller would get f32-grade values under an f64 label.
    """
    import jax

    if dtype == "auto":
        return "float64" if jax.config.jax_enable_x64 else "float32"
    if dtype not in ("float32", "float64"):
        raise ValueError(
            f"dtype must be 'auto'/'float32'/'float64', got {dtype!r}")
    if dtype == "float64" and not jax.config.jax_enable_x64:
        raise ValueError(
            "dtype='float64' requires x64 (unset DQGP_X64=0 or enable "
            "jax_enable_x64); with x64 off the values would silently be "
            "float32-grade")
    return dtype
