"""k-fold cross-validation of consensus hyperparameters (NLPD model selection).

Twin of ``k_fold_cross_validation_consensus`` (main.py:1490-1596) with the
redesign from SURVEY.md §7 "hard parts" #4: the reference runs
5 *complete* GP fits per ADMM iteration, rebuilding the quantum kernel and
re-simulating every circuit per fold (main.py:1399, 1420-1430). Here the
per-sample features are computed ONCE per consensus vector, fold Grams are
gathered sub-blocks, and all folds evaluate as one vmapped, jitted program.

Fold indices replicate sklearn's ``KFold(shuffle=True, random_state=seed)``
exactly (the reference seeds it with ``args.seed + iter`` each iteration,
main.py:2665); folds are padded to static shapes and masked.
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels.quantum_kernel import (
    QuantumKernelSpec,
    gram_from_features,
    kernel_features,
)
from ...data.splits import kfold_indices
from .metrics import _LOG_2PI, outer_diag
from .posterior import gp_posterior_from_grams


def kfold_pad_indices_np(n: int, k: int, seed: int):
    """sklearn-compatible shuffled k-fold indices, padded to static shapes —
    host-side (numpy int32) form.

    Returns (train_idx, train_mask, val_idx, val_mask) with shapes
    (k, t_max) / (k, v_max); padding uses index 0 with mask 0. Masks are
    int32 0/1 — every consumer casts them to its working dtype
    (``cv_fold_scores_impl``'s fold body)."""
    folds = list(kfold_indices(n, k, seed))
    t_max = max(len(tr) for tr, _ in folds)
    v_max = max(len(va) for _, va in folds)

    def pad(idx, size):
        out = np.zeros((size,), np.int32)
        m = np.zeros((size,), np.int32)
        out[: len(idx)] = idx
        m[: len(idx)] = 1
        return out, m

    tr_i = np.zeros((k, t_max), np.int32)
    tr_m = np.zeros((k, t_max), np.int32)
    va_i = np.zeros((k, v_max), np.int32)
    va_m = np.zeros((k, v_max), np.int32)
    for f, (tr, va) in enumerate(folds):
        tr_i[f], tr_m[f] = pad(tr, t_max)
        va_i[f], va_m[f] = pad(va, v_max)
    return tr_i, tr_m, va_i, va_m


def kfold_pad_indices(n: int, k: int, seed: int):
    """Device-array form of :func:`kfold_pad_indices_np` (one transfer per
    array — per-chunk callers pack the numpy form into a single buffer
    instead)."""
    tr_i, tr_m, va_i, va_m = kfold_pad_indices_np(n, k, seed)
    return (jnp.asarray(tr_i), jnp.asarray(tr_m.astype(np.float64)),
            jnp.asarray(va_i), jnp.asarray(va_m.astype(np.float64)))


def cv_fold_scores_impl(
    spec: QuantumKernelSpec,
    X: jax.Array,
    Y: jax.Array,
    theta: jax.Array,
    tr_i: jax.Array,
    tr_m: jax.Array,
    va_i: jax.Array,
    va_m: jax.Array,
    noise_std: float = 0.1,
    jitter: float = 1e-6,
    cv_dtype: str = "float64",
    rescue: bool = False,
):
    """Per-fold (nlpd, r2, rmse) — traceable body; jit via ``_cv_fold_scores``
    or fuse into a larger program (the driver fuses it into the ADMM step so
    each training iteration is ONE executable).

    cv_dtype "mixed" = f64 fold numerics through ``solve_psd_mixed`` (f32
    factorization + split-f32 refinement on the vmapped hot path): fold
    solves ~1e-4-grade relative — an order beyond cv_dtype "float32"'s
    eps_f32*cond, moving fold NLPDs only ~1e-5 vs true f64 — at near-f32
    fold cost (the flagged-fold f64 re-score below retains full reference
    accuracy where it matters).

    The fold body is vmapped, so the default solvers are the "-flag"
    variants: a failed factorization yields NaN scores instead of compiling
    an eigh-pinv rescue that vmap's cond->select lowering would execute on
    every call. ``rescue=True`` (host-side re-score of flagged folds only)
    restores the full in-program fallback chain — the reference's predict
    path rescues a failed Cholesky with an explicit inverse
    (main.py:1476-1482), so a flagged fold must be re-scored, not penalized."""
    F = kernel_features(spec, X, theta)  # once per consensus vector
    solver = "direct" if rescue else "direct-flag"
    if cv_dtype == "mixed":
        cv_dtype, solver = "float64", ("mixed" if rescue else "mixed-flag")
    if cv_dtype == "float64" and not jax.config.jax_enable_x64:
        cv_dtype = "float32"
    dtype = jnp.dtype(cv_dtype)
    # Upcast features so the GP-side Gram/solve numerics match the reference's
    # f64 LAPACK path (statevector work itself stays in f32/c64). cv_dtype
    # "float32" trades ~1e-4 NLPD noise for faster folds (model selection
    # only needs NLPD ordering). The mixed solver keeps the Gram construction
    # in f32 too — its factorization is f32 regardless, features are
    # f32-accurate to begin with, and f64 outer-kernel matmuls/exponentials
    # would otherwise dominate the fused step+CV program (the .astype(dtype)
    # below still hands f64 Grams to the solve).
    if dtype == jnp.float64 and solver.startswith("direct"):
        F = F.astype(jnp.complex128 if spec.kernel_type == "fidelity" else dtype)

    def fold(tr_idx, tr_mask, va_idx, va_mask):
        tr_mask = tr_mask.astype(dtype)
        va_mask = va_mask.astype(dtype)
        F_tr = F[tr_idx] * tr_mask[:, None].astype(F.dtype)
        F_va = F[va_idx]
        y_tr = Y[tr_idx].astype(dtype) * tr_mask
        y_va = Y[va_idx].astype(dtype)

        K_tt = gram_from_features(spec, F_tr).astype(dtype)
        K_vt = gram_from_features(spec, F_va, F_tr).astype(dtype)
        if spec.kernel_type == "fidelity":
            K_vv_diag = jnp.ones((F_va.shape[0],), dtype)
        else:
            K_vv_diag = outer_diag(spec.outer_kernel, F_va, spec.outer_params).astype(dtype)

        mean, var, _ = gp_posterior_from_grams(
            K_tt, K_vt, K_vv_diag, y_tr, noise_std, jitter,
            train_mask=tr_mask.astype(dtype), solver=solver,
        )
        r = y_va - mean
        var_safe = jnp.maximum(var, 1e-10)
        per_point = 0.5 * _LOG_2PI + 0.5 * jnp.log(var_safe) + 0.5 * r * r / var_safe
        nv = jnp.sum(va_mask)
        fold_nlpd = jnp.sum(per_point * va_mask) / nv
        ss_res = jnp.sum(r * r * va_mask)
        y_mean = jnp.sum(y_va * va_mask) / nv
        ss_tot = jnp.sum((y_va - y_mean) ** 2 * va_mask)
        fold_r2 = 1.0 - ss_res / ss_tot
        fold_rmse = jnp.sqrt(ss_res / nv)
        return fold_nlpd, fold_r2, fold_rmse

    return jax.vmap(fold)(tr_i, tr_m, va_i, va_m)


_cv_fold_scores = partial(jax.jit, static_argnums=(0,),
                          static_argnames=("noise_std", "jitter", "cv_dtype",
                                           "rescue"))(
    cv_fold_scores_impl
)


def aggregate_cv_scores(nlpds, r2s, rmses, k_folds: int) -> Dict:
    """Reference failure semantics (main.py:1564-1596): non-finite folds
    score +inf; valid only if >= k//2 folds succeed."""
    nlpds = np.asarray(nlpds, np.float64)
    r2s = np.asarray(r2s, np.float64)
    rmses = np.asarray(rmses, np.float64)

    fold_nlpds = [float(v) if np.isfinite(v) else float("inf") for v in nlpds]
    fold_r2s = [float(v) if np.isfinite(nlpds[i]) else -float("inf")
                for i, v in enumerate(r2s)]
    fold_rmses = [float(v) if np.isfinite(nlpds[i]) else float("inf")
                  for i, v in enumerate(rmses)]

    valid = [v for v in fold_nlpds if not np.isinf(v)]
    if len(valid) >= k_folds // 2:
        mean_nlpd = float(np.mean(valid))
        std_nlpd = float(np.std(valid))
        mean_r2 = float(np.mean([r for r, v in zip(fold_r2s, fold_nlpds)
                                 if not np.isinf(v)]))
        mean_rmse = float(np.mean([r for r, v in zip(fold_rmses, fold_nlpds)
                                   if not np.isinf(v)]))
    else:
        mean_nlpd = float("inf")
        std_nlpd = float("inf")
        mean_r2 = -float("inf")
        mean_rmse = float("inf")

    return {
        "mean_nlpd": mean_nlpd,
        "std_nlpd": std_nlpd,
        "mean_r2": mean_r2,
        "mean_rmse": mean_rmse,
        "fold_nlpds": fold_nlpds,
        "fold_r2s": fold_r2s,
        "fold_rmses": fold_rmses,
        "valid_folds": len(valid),
        "total_folds": k_folds,
    }


def k_fold_cross_validation_consensus(
    spec: QuantumKernelSpec,
    X_train,
    Y_train,
    consensus_params,
    noise_std: float,
    k_folds: int = 5,
    random_seed: int = 42,
    jitter: float = 1e-6,
    cv_dtype: str = "float64",
    rescue: bool = False,
) -> Dict:
    """Aggregate CV results with the reference's failure semantics
    (main.py:1564-1596): failed folds (non-finite) score +inf, and the run is
    valid only if at least k//2 folds succeed.

    The vmapped fold program flags failed factorizations as NaN instead of
    compiling an in-program rescue (see ``cv_fold_scores_impl``). A flagged
    fold is not necessarily one the reference would fail on — mixed: cond
    beyond the f32 factorization's ~1e7 reach but well inside f64 LAPACK's;
    direct: the reference's predict path rescues a failed Cholesky with an
    explicit inverse (main.py:1476-1482). So any non-finite fold triggers a
    float64 re-score with the full fallback chain (``rescue=True``); the
    +inf penalty is reserved for folds the reference itself would fail on.

    ``rescue=True`` skips the flag pass and scores every fold through the
    float64 fallback chain directly — for callers that already KNOW a fold
    flags at this dtype (e.g. the driver re-scoring a flagged fused-f64
    iteration; re-running the identical direct-flag program would
    deterministically flag again)."""
    n = int(np.asarray(X_train).shape[0])
    tr_i, tr_m, va_i, va_m = kfold_pad_indices(n, k_folds, random_seed)
    args = (
        spec,
        jnp.asarray(X_train),
        jnp.asarray(Y_train),
        jnp.asarray(consensus_params),
        tr_i, tr_m, va_i, va_m,
    )
    kw = dict(noise_std=float(noise_std), jitter=float(jitter))
    nlpds = None
    if not rescue:
        nlpds, r2s, rmses = _cv_fold_scores(*args, cv_dtype=cv_dtype, **kw)
    if nlpds is None or not np.all(np.isfinite(np.asarray(nlpds))):
        nlpds, r2s, rmses = _cv_fold_scores(*args, cv_dtype="float64",
                                            rescue=True, **kw)
    return aggregate_cv_scores(nlpds, r2s, rmses, k_folds)
