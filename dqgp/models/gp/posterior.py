"""GP posterior prediction and per-agent NLL + gradient.

Numerics mirror the reference exactly:

* predict path (main.py:1364-1488): C = K + sigma^2 I + 1e-6 I, Cholesky
  solve, mean = K_*^T alpha, var = diag(K_**) - sum(v^2) clamped >= 1e-10,
  explicit-inverse fallback.
* agent NLL path (agent_riemannian.py:409-471): C = K + sigma^2 I (NO jitter),
  gradient dL/dtheta_p = 0.5 * sum((C^{-1} - alpha alpha^T) * dK_p^T),
  NLL = 0.5 logdet + 0.5 y^T C^{-1} y + 0.5 N log(2 pi), with the three
  components reported separately for the correlation analytics.

Ragged agent shards are padded to a static size and masked (see
``masked_identity_pad``) so the whole multi-agent step is one fused XLA
program over the mesh.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ...ops.linalg import (
    condition_number,
    contraction_dtype,
    get_psd_solver,
    masked_identity_pad,
)
from ..kernels.quantum_kernel import (
    QuantumKernelSpec,
    kernel_features,
    gram_from_features,
)
from .metrics import outer_diag


class NLLResult(NamedTuple):
    nll: jax.Array
    grad: jax.Array
    log_det_term: jax.Array
    quadratic_term: jax.Array
    constant_term: jax.Array
    condition_number: jax.Array
    chol_ok: jax.Array


def masked_nll_core(
    K: jax.Array,
    y: jax.Array,
    mask: jax.Array,
    noise_std: float,
    compute_cond: bool = True,
    fallback: bool = True,
    solver: str = "direct",
) -> Tuple[NLLResult, jax.Array]:
    """NLL (components, cond) plus the gradient bracket C^{-1} - alpha alpha^T.

    The bracket is what every gradient flavor contracts against shifted-Gram
    panels (grad_p = 0.5 * tr[bracket @ dK_p]); exposing it lets the streamed
    and mesh-sharded gradient paths reuse one solve. The returned result's
    ``grad`` field is an empty placeholder. ``solver="mixed"`` routes the f64
    solve through ``solve_psd_mixed`` (f32 factor + f64 refinement).
    """
    dtype = K.dtype
    mask = mask.astype(dtype)
    y = (y * mask).astype(dtype)
    Km = masked_identity_pad(K, mask)
    C = Km + (noise_std**2) * jnp.diag(mask)  # sigma^2 only on real rows

    res = get_psd_solver(solver)(C, y, fallback=fallback)
    alpha = res.C_inv_y
    bracket = res.C_inv - jnp.outer(alpha, alpha)

    n_real = jnp.sum(mask)
    log_det_term = 0.5 * res.logdet  # padded block contributes log(1) = 0
    quadratic_term = 0.5 * jnp.dot(y, alpha)
    constant_term = 0.5 * n_real * jnp.log(2.0 * jnp.pi)
    nll = log_det_term + quadratic_term + constant_term

    if compute_cond:
        # The reference conditions the noise-free C (agent_riemannian.py:411:
        # np.linalg.cond(C) on C BEFORE the sigma^2 shift). Padded rows would
        # inject eigenvalues of exactly 1 (distorting cond for
        # non-unit-diagonal kernels), so pad the diagonal with the mean real
        # diagonal instead — it lies in [lambda_min, lambda_max] and leaves
        # max/min untouched.
        diag_mean = jnp.sum(jnp.diagonal(K) * mask) / jnp.maximum(jnp.sum(mask), 1.0)
        m2 = mask[:, None] * mask[None, :]
        K_cond = K * m2 + jnp.diag((1.0 - mask) * diag_mean)
        cond = condition_number(K_cond)
    else:
        cond = jnp.asarray(jnp.nan, dtype)
    out = NLLResult(
        nll, jnp.zeros((0,), dtype), log_det_term, quadratic_term,
        constant_term, cond, res.chol_ok,
    )
    return out, bracket


def masked_nll_and_grad(
    K: jax.Array,
    dK: jax.Array,
    y: jax.Array,
    mask: jax.Array,
    noise_std: float,
    compute_cond: bool = True,
    fallback: bool = True,
    solver: str = "direct",
) -> NLLResult:
    """NLL, its three components, and d(NLL)/dtheta for one (padded) agent.

    K: (N, N) Gram; dK: (P, N, N); y: (N,); mask: (N,) with 1 = real row.
    Reference: agent_riemannian.py:409-471. With ``solver="mixed"`` the
    trace contraction also runs in f32 (the absolute error is orders below
    the 4-dp gradient rounding).
    """
    dtype = K.dtype
    res, bracket = masked_nll_core(
        K, y, mask, noise_std, compute_cond=compute_cond, fallback=fallback,
        solver=solver,
    )
    # Gradient: 0.5 * sum((C^{-1} - alpha alpha^T) ∘ dK_p^T)
    cdt = contraction_dtype(solver, dtype)
    m2 = mask.astype(cdt)[:, None] * mask.astype(cdt)[None, :]
    dKm = dK.astype(cdt) * m2[None, :, :]
    grad = 0.5 * jnp.einsum("ij,pji->p", bracket.astype(cdt), dKm)
    return res._replace(grad=grad.astype(dtype))


def gp_posterior_from_grams(
    K_tt: jax.Array,
    K_st: jax.Array,
    K_ss_diag: jax.Array,
    y_train: jax.Array,
    noise_std: float,
    jitter: float = 1e-6,
    train_mask: Optional[jax.Array] = None,
    solver: str = "direct",
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Posterior mean/var from precomputed Grams. Returns (mean, var, chol_ok).

    Reference semantics main.py:1433-1466: noise + jitter on the training
    Gram, Cholesky solve, variance clamp at 1e-10.
    """
    dtype = K_tt.dtype
    n = K_tt.shape[0]
    if train_mask is None:
        train_mask = jnp.ones((n,), dtype)
    m = train_mask.astype(dtype)
    Km = masked_identity_pad(K_tt, m)
    C = Km + (noise_std**2 + jitter) * jnp.diag(m)
    y = y_train * m
    K_st = K_st * m[None, :]

    # C^{-1} is only materialized on the (rare) fallback path — the Cholesky
    # path uses L directly for mean and variance. NOTE: need_inverse stays
    # False for the mixed solver too. Deriving the mean from the
    # Newton-Schulz-polished inverse (need_inverse=True) was tried: it
    # removes the sequential refinement chain, but adds two f64 (N, N) matmul
    # rounds per fold, which with the fused per-iteration CV became the
    # training iteration's dominant device cost. The refinement mean is
    # vector-shaped (O(N^2) per solve).
    res = get_psd_solver(solver)(C, y, need_inverse=False)
    if solver == "mixed-flag" and dtype == jnp.float64:
        # vmapped hot path (fused CV folds): alpha is already split-refined
        # ~1e-4-grade, so the split-f32 product loses nothing (see
        # ops.linalg.split_f64_matvec).
        from ...ops.linalg import split_f64_matvec

        mean = split_f64_matvec(K_st, res.C_inv_y)
    else:
        mean = K_st @ res.C_inv_y
    # var = diag(K_**) - sum(v^2), v = L^{-1} K_st^T on the Cholesky path;
    # on the fallback path use the explicit inverse (main.py:1476-1482).
    from jax.scipy.linalg import solve_triangular

    # With the mixed solver, run the variance triangular solve in f32 (L is
    # an f32-accurate factor on the happy path; an f64 triangular solve
    # would give the direct path's cost right back). Predictive
    # variances are O(1) magnitudes clamped at 1e-10 — f32 roundoff is
    # immaterial. BUT when the mixed solver's residual gate fails and the
    # lax.cond f64 rescue runs, res.L is the rescue's f64-grade factor and
    # the variance must be computed at full dtype or the rescue's accuracy
    # is thrown away — res.l_exact carries which case happened at runtime.
    vdt = contraction_dtype(solver, dtype)

    def chol_var_at(vd):
        v = solve_triangular(res.L.astype(vd), K_st.T.astype(vd), lower=True)
        return K_ss_diag - jnp.sum(v * v, axis=0).astype(dtype)

    def chol_var(_):
        if vdt == dtype:
            return chol_var_at(dtype)
        return jax.lax.cond(res.l_exact,
                            lambda _: chol_var_at(dtype),
                            lambda _: chol_var_at(vdt), None)

    def inv_var(_):
        return K_ss_diag - jnp.sum((K_st @ res.C_inv) * K_st, axis=1)

    if solver.endswith("-flag"):
        # Flag solvers (vmapped callers) have no in-program rescue: on
        # failure C_inv_y is already NaN (the mean, hence the fold score,
        # propagates it), so the inverse-based variance branch — whose
        # matmul would execute unconditionally under vmap's cond->select
        # lowering — is dead weight; take the triangular form directly (at
        # vdt: a flag solver's L is f32-grade by construction).
        var = chol_var_at(vdt)
    else:
        var = jax.lax.cond(res.chol_ok, chol_var, inv_var, None)
    var = jnp.maximum(var, 1e-10)
    return mean, var, res.chol_ok


from functools import partial


@partial(jax.jit, static_argnums=(0,),
         static_argnames=("noise_std", "jitter", "solver"))
def predict_quantum_gp(
    spec: QuantumKernelSpec,
    X_train: jax.Array,
    Y_train: jax.Array,
    X_test: jax.Array,
    theta: jax.Array,
    noise_std: float = 0.1,
    jitter: float = 1e-6,
    solver: str = "auto",
) -> Tuple[jax.Array, jax.Array]:
    """End-to-end posterior predict (mean, var) — main.py:1364-1488 twin.

    Features are computed once per input set; the test-test Gram is never
    materialized (only its diagonal is needed for the predictive variance —
    the reference computes the full K_test_test, main.py:1429-1431).

    solver="auto" follows ``config.resolve_dtype_mode("auto")``: float64 ->
    the direct LAPACK-grade solve, mixed -> f32 factor + f64 refinement
    (with a lax.cond f64 rescue on refinement failure — this call is
    un-vmapped).
    """
    if solver == "auto":
        from ...config import resolve_dtype_mode

        solver = {"float64": "direct", "mixed": "mixed"}[resolve_dtype_mode("auto")]
    if jax.config.jax_enable_x64:
        dtype = jnp.float64
        fdtype = jnp.complex128 if spec.kernel_type == "fidelity" else dtype
    else:
        dtype = jnp.float32
        fdtype = jnp.complex64 if spec.kernel_type == "fidelity" else jnp.float32
    F_tr = kernel_features(spec, X_train, theta).astype(fdtype)
    F_te = kernel_features(spec, X_test, theta).astype(fdtype)
    K_tt = gram_from_features(spec, F_tr).astype(dtype)
    K_st = gram_from_features(spec, F_te, F_tr).astype(dtype)
    if spec.kernel_type == "fidelity":
        K_ss_diag = jnp.ones((X_test.shape[0],), dtype)
    else:
        K_ss_diag = outer_diag(spec.outer_kernel, F_te, spec.outer_params).astype(dtype)
    mean, var, _ = gp_posterior_from_grams(
        K_tt, K_st, K_ss_diag, Y_train.astype(dtype), noise_std, jitter,
        solver=solver,
    )
    return mean, var
