"""Marginal-likelihood noise fitting (beyond-reference capability).

The reference treats ``noise_std`` as a CLI constant (default 0.1,
main.py:1958) that both samples the synthetic data AND parameterizes every
GP fit — correct for synthetic configs (the generating noise is known) but
misspecified on real data: round-3/4 SRTM validation showed the reference
config (4 qubits / 3 layers chebyshev) with sigma = 0.1 under-covering badly
(maharashtra 2-sigma coverage 0.48, NLPD 4.9 on normalized Y whose residual
scale is ~0.5). Fitting sigma by maximizing the training marginal likelihood
at the selected hyperparameters — plus evaluating the OBSERVED-Y predictive
variance (latent variance + sigma^2; the reference's predict returns latent
variance only, main.py:1429-1466) — restores calibration at the reference
config with no extra qubits: maharashtra NLPD 4.91 -> 0.89, 2-sigma
0.48 -> 0.95; great_lakes NLPD 2.23 -> 0.86, 2-sigma 0.61 -> 0.94
(docs/PERFORMANCE.md, round 4).

Implementation: ONE symmetric eigendecomposition of the noise-free training
Gram K = V diag(w) V^T (host f64 — same placement as the driver's
condition-number backfill), after which the negative log marginal likelihood
at any sigma is O(N) in the eigenbasis:

    nmll(sigma) = 1/2 sum_i log(w_i + s) + 1/2 sum_i q_i^2 / (w_i + s)
                  + N/2 log(2 pi),        s = sigma^2 + jitter, q = V^T y

so the 1-D fit is exact and cheap (golden-section over log sigma after a
coarse grid). Both additive knobs default OFF — the parity surface is
untouched.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..kernels.quantum_kernel import QuantumKernelSpec, gram

# One fused program per (spec, dtype) instead of op-by-op dispatch (same
# rationale as data/synthetic._gram_jit).
_gram_jit = jax.jit(
    lambda spec, X, th, dt: gram(spec, X, th, dtype=dt),
    static_argnums=(0, 3),
)


class NoiseFitResult(NamedTuple):
    noise_std: float        # argmax-likelihood sigma
    nmll: float             # negative log marginal likelihood at the optimum
    nmll_at_input: float    # same at the caller's current sigma (comparison)
    grid_sigma: np.ndarray  # coarse-grid abscissae (diagnostics/plots)
    grid_nmll: np.ndarray


def _nmll_from_eigs(w: np.ndarray, q2: np.ndarray, sigma: float,
                    jitter: float) -> float:
    s = sigma * sigma + jitter
    d = w + s
    return float(0.5 * np.sum(np.log(d)) + 0.5 * np.sum(q2 / d)
                 + 0.5 * len(w) * np.log(2.0 * np.pi))


def fit_noise_std(
    spec: QuantumKernelSpec,
    X_train: np.ndarray,
    Y_train: np.ndarray,
    theta: np.ndarray,
    current_noise_std: float = 0.1,
    jitter: float = 1e-6,
    bounds: Tuple[float, float] = (1e-3, 3.0),
    grid_points: int = 48,
    K: Optional[np.ndarray] = None,
) -> NoiseFitResult:
    """Fit ``noise_std`` by maximizing the training marginal likelihood.

    The Gram is built once through one jitted program at the resolved
    pipeline precision (``config.resolve_gram_dtype("auto")``: f64 with x64
    on, else f32, whose ~1e-4 entry gap moves the fitted sigma far less than
    the fit's own curvature) and
    eigendecomposed on the host in f64; a caller that already has the
    noise-free training Gram can pass it as ``K``. Eigenvalues are clamped
    at 0 (roundoff negatives) so every gridpoint's log term is finite.
    """
    if K is None:
        from ...config import resolve_gram_dtype

        dt = jnp.dtype(resolve_gram_dtype("auto"))
        K = np.asarray(
            _gram_jit(spec, jnp.asarray(X_train, dt), jnp.asarray(theta, dt),
                      dt),
            np.float64,
        )
    else:
        K = np.asarray(K, np.float64)
    w, V = np.linalg.eigh(K)
    w = np.maximum(w, 0.0)
    q2 = (V.T @ np.asarray(Y_train, np.float64)) ** 2

    lo, hi = bounds
    grid = np.geomspace(lo, hi, grid_points)
    vals = np.array([_nmll_from_eigs(w, q2, s, jitter) for s in grid])
    i = int(np.argmin(vals))

    # golden-section refinement on log sigma, bracketed by the grid
    a = np.log(grid[max(i - 1, 0)])
    b = np.log(grid[min(i + 1, grid_points - 1)])
    invphi = (np.sqrt(5.0) - 1.0) / 2.0
    c, d = b - invphi * (b - a), a + invphi * (b - a)
    fc = _nmll_from_eigs(w, q2, float(np.exp(c)), jitter)
    fd = _nmll_from_eigs(w, q2, float(np.exp(d)), jitter)
    for _ in range(40):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - invphi * (b - a)
            fc = _nmll_from_eigs(w, q2, float(np.exp(c)), jitter)
        else:
            a, c, fc = c, d, fd
            d = a + invphi * (b - a)
            fd = _nmll_from_eigs(w, q2, float(np.exp(d)), jitter)
    sigma = float(np.exp((a + b) / 2.0))
    return NoiseFitResult(
        noise_std=sigma,
        nmll=_nmll_from_eigs(w, q2, sigma, jitter),
        nmll_at_input=_nmll_from_eigs(w, q2, current_noise_std, jitter),
        grid_sigma=grid,
        grid_nmll=vals,
    )
