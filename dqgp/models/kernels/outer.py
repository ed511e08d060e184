"""Outer kernels for the projected quantum kernel, in pure JAX.

The reference reaches these through squlearn's ProjectedQuantumKernel, which
wraps sklearn kernels (Matern / ExpSineSquared / RationalQuadratic /
DotProduct / PairwiseKernel) plus its own Gaussian RBF (main.py:57-63,
126-137). Defaults match sklearn/squlearn defaults because the reference's
CLI-provided outer-kernel hyperparameters never reach the main-path kernels
(SURVEY.md §2.1 quirk; main.py:127-133): gaussian gamma=1.0, matern
length_scale=1.0 nu=1.5, expsinesquared length_scale=1.0 periodicity=1.0,
rationalquadratic length_scale=1.0 alpha=1.0, dotproduct sigma_0=1.0,
pairwisekernel metric='linear' gamma=1.0.

All outer kernels depend on features only through pairwise distances or dot
products, so they reduce to one matmul plus elementwise ops.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import jax
import jax.numpy as jnp

OUTER_KERNELS = (
    "gaussian", "matern", "expsinesquared", "rationalquadratic",
    "dotproduct", "pairwisekernel",
)


def _sqdist(FA: jax.Array, FB: jax.Array) -> jax.Array:
    """Pairwise squared euclidean distances via one matmul."""
    sq_a = jnp.sum(FA * FA, axis=-1, keepdims=True)
    sq_b = jnp.sum(FB * FB, axis=-1, keepdims=True)
    d2 = sq_a + sq_b.T - 2.0 * FA @ FB.T
    return jnp.maximum(d2, 0.0)


def outer_gram(
    name: str,
    FA: jax.Array,
    FB: jax.Array,
    params: Optional[Dict[str, float]] = None,
) -> jax.Array:
    """Gram matrix of the named outer kernel between feature sets.

    FA: (N, D), FB: (M, D) -> (N, M).
    """
    p = dict(params or {})
    if name == "gaussian":
        gamma = p.get("gamma", 1.0)
        return jnp.exp(-gamma * _sqdist(FA, FB))

    if name == "matern":
        ls = p.get("length_scale", 1.0)
        nu = p.get("nu", 1.5)
        d = jnp.sqrt(_sqdist(FA, FB) + 1e-30) / ls
        if nu == 0.5:
            return jnp.exp(-d)
        if nu == 1.5:
            k = d * math.sqrt(3.0)
            return (1.0 + k) * jnp.exp(-k)
        if nu == 2.5:
            k = d * math.sqrt(5.0)
            return (1.0 + k + k * k / 3.0) * jnp.exp(-k)
        if nu == float("inf"):
            return jnp.exp(-0.5 * d * d)
        raise NotImplementedError(
            f"Matern nu={nu}: only the closed forms nu in {{0.5, 1.5, 2.5, inf}} "
            "are supported (general nu needs Bessel K_v)."
        )

    if name == "expsinesquared":
        ls = p.get("length_scale", 1.0)
        periodicity = p.get("periodicity", 1.0)
        d = jnp.sqrt(_sqdist(FA, FB) + 1e-30)
        s = jnp.sin(jnp.pi * d / periodicity)
        return jnp.exp(-2.0 * (s / ls) ** 2)

    if name == "rationalquadratic":
        ls = p.get("length_scale", 1.0)
        alpha = p.get("alpha", 1.0)
        d2 = _sqdist(FA, FB)
        return (1.0 + d2 / (2.0 * alpha * ls * ls)) ** (-alpha)

    if name == "dotproduct":
        sigma_0 = p.get("sigma_0", 1.0)
        return sigma_0 * sigma_0 + FA @ FB.T

    if name == "pairwisekernel":
        metric = p.get("metric", "linear")
        gamma = p.get("gamma", 1.0)
        if metric == "linear":
            return FA @ FB.T
        if metric == "rbf":
            return jnp.exp(-gamma * _sqdist(FA, FB))
        if metric == "poly":
            degree = p.get("degree", 3)
            coef0 = p.get("coef0", 1.0)
            return (gamma * FA @ FB.T + coef0) ** degree
        raise NotImplementedError(f"pairwisekernel metric={metric!r}")

    raise ValueError(f"Unknown outer kernel {name!r}. Supported: {OUTER_KERNELS}")
