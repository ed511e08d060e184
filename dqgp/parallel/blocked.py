"""Scale-out GP: blocked Gram assembly and a matrix-free CG posterior.

BASELINE config #7 targets n ~ 50k samples at 10-12 qubits — beyond the
reference's reach (its Gram is a monolithic O(N^2) numpy array and its solve
a dense LAPACK Cholesky; SURVEY.md §5.7 calls for blocked Gram construction
as this system's analogue of blockwise/ring attention).

Key observation: per-sample FEATURES are tiny (N x 3n floats — 7 MB at
N=50k), only the Gram is huge (50k^2 f32 = 10 GB). So:

* features are computed once (one batched statevector pass);
* the Gram is never materialized — ``gram_matvec`` streams column blocks of
  K (one outer-kernel block + one matmul per tile);
* the posterior solve is conjugate gradients on (K + sigma^2 I) with a
  diagonal (Jacobi) preconditioner, batched over right-hand sides, jittable
  via ``lax.while_loop``;
* across a mesh, rows shard over the ``data`` axis: every device keeps the
  full (tiny) feature matrix and its row shard of the products; the CG dot
  products psum over the axis.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..models.gp.metrics import outer_diag
from ..models.kernels.quantum_kernel import QuantumKernelSpec, gram_from_features


class LowRankRegularizer(NamedTuple):
    """Low-rank correction representing squlearn's square-Gram regularization
    matrix-free: K_reg = K + V diag(w) V^T + shift * I.

    * thresholding — w_i = -lambda_i for the captured negative eigenvalues
      (subtracting the negative spectrum == eigenvalue clip at 0), shift = 0.
    * tikhonov     — w = 0, shift = max(0, -lambda_min) (the reference adds
      the most negative eigenvalue to the diagonal, main.py:2011-2013 /
      regularize_gram).

    Exact when ``rank`` >= the number of negative eigenvalues (kernel Grams
    are PSD in exact arithmetic; negatives come from f32 roundoff and are
    few and tiny). ``saturated`` is True when every captured pair was
    negative — the rank budget MAY have missed further negatives; callers
    can retry with a larger rank.

    Accuracy contract: the eigenpairs come from LOBPCG, not an exact eigh,
    so the correction carries ~1e-8-absolute eigenvalue tolerance (vs the
    dense ``regularize_gram``'s LAPACK-exact clip). Downstream NLLs amplify
    a tikhonov shift error by ~tr(C^-1)/2, so NLL agreement with the dense
    path is bounded at ~1e-4 absolute — ample for a roundoff-scale clip,
    but do not assert tighter.
    """

    V: jax.Array          # (N, r) captured eigenvectors
    w: jax.Array          # (r,) correction weights (0 for non-negative pairs)
    shift: jax.Array      # scalar diagonal shift (tikhonov)
    lambda_min: jax.Array # smallest captured eigenvalue of K
    saturated: jax.Array  # bool: rank budget possibly insufficient

    def matvec(self, Kv: jax.Array, v: jax.Array) -> jax.Array:
        """K_reg @ v given K @ v (v: (N,) or (N, R))."""
        corr = self.V @ (self.w[:, None] * (self.V.T @ jnp.atleast_2d(v.T).T))
        return Kv + corr.reshape(Kv.shape) + self.shift * v

    def diag_correction(self) -> jax.Array:
        """diag(K_reg) - diag(K): (N,)."""
        return jnp.sum(self.V * self.V * self.w[None, :], axis=1) + self.shift


def make_lowrank_regularizer_from_matvec(
    matvec: Callable[[jax.Array], jax.Array],
    n: int,
    method: str,
    rank: int = 16,
    lobpcg_iters: int = 200,
    power_iters: int = 24,
    dtype=jnp.float32,
) -> LowRankRegularizer:
    """Low-rank eigenvalue clip from a generic symmetric matvec.

    Finds the ``rank`` smallest eigenpairs of K via LOBPCG on (c I - K)
    (c >= lambda_max from power iteration, so the operator is PSD and its
    TOP eigenpairs are K's bottom ones), then builds the correction for
    ``method`` ('thresholding' | 'tikhonov'). Fully jittable.
    """
    if method not in ("thresholding", "tikhonov"):
        raise ValueError(f"Unknown regularization {method!r}")
    from jax.experimental.sparse.linalg import lobpcg_standard

    rank = int(min(rank, max(1, n // 5)))  # lobpcg needs n >= ~5k

    # lambda_max upper bound: power iteration + a safety margin.
    v0 = jnp.ones((n, 1), dtype) + jnp.linspace(0, 0.5, n, dtype=dtype)[:, None]

    def pw(_, v):
        w_ = matvec(v)
        return w_ / jnp.maximum(jnp.linalg.norm(w_), jnp.finfo(dtype).tiny)

    v1 = jax.lax.fori_loop(0, power_iters, pw, v0 / jnp.linalg.norm(v0))
    lam_max = jnp.sum(v1 * matvec(v1))
    c = 1.05 * jnp.abs(lam_max) + 1e-3

    def flipped(X):
        return c * X - matvec(X)

    # Deterministic full-rank start block (no RNG inside jit).
    i = jnp.arange(n, dtype=dtype)[:, None]
    j = jnp.arange(rank, dtype=dtype)[None, :]
    X0 = jnp.cos(i * (j + 1) * 0.37 + j) + 1e-3
    theta, U, _ = lobpcg_standard(flipped, X0.astype(dtype), m=lobpcg_iters)
    lam = c - theta                                   # ascending smallest of K
    neg = lam < 0.0
    if method == "thresholding":
        w = jnp.where(neg, -lam, 0.0).astype(dtype)
        shift = jnp.zeros((), dtype)
    else:  # tikhonov
        w = jnp.zeros_like(lam).astype(dtype)
        shift = jnp.maximum(-jnp.min(lam), 0.0).astype(dtype)
    return LowRankRegularizer(
        V=U.astype(dtype), w=w, shift=shift,
        lambda_min=jnp.min(lam).astype(dtype), saturated=jnp.all(neg),
    )


def make_lowrank_regularizer(
    spec: QuantumKernelSpec,
    F: jax.Array,
    rank: int = 16,
    block: int = 2048,
    lobpcg_iters: int = 200,
    dtype=jnp.float32,
) -> LowRankRegularizer:
    """``make_lowrank_regularizer_from_matvec`` on the feature-factored Gram
    (the training Gram only — squlearn regularizes square Grams, never the
    cross Grams, quantum_kernel.regularize_gram)."""
    n = F.shape[0]
    mask = jnp.ones((n,), dtype)

    def mv(v):
        return gram_matvec(spec, F, v.astype(dtype), mask, block)

    return make_lowrank_regularizer_from_matvec(
        mv, n, spec.regularization, rank=rank, lobpcg_iters=lobpcg_iters,
        dtype=dtype)


def make_sharded_lowrank_regularizer(
    spec: QuantumKernelSpec,
    mesh,
    rank: int = 16,
    block: int = 2048,
    lobpcg_iters: int = 200,
    data_axis: str = "data",
    dtype=jnp.float32,
):
    """``make_lowrank_regularizer`` with the Gram's rows sharded over
    ``data_axis`` — the distributed eigensolver the multi-chip paths need.

    Returns a jitted ``build(F_local, mask_local) -> LowRankRegularizer``
    with F/mask row-sharded along ``data_axis``. The K @ X products inside
    LOBPCG run as shard_map programs (each device streams column blocks of
    its row panel and keeps its rows of the result); LOBPCG's own small
    (r x r) algebra runs under ordinary jit sharding propagation. The
    returned V's rows carry whatever sharding propagation assigns — pass it
    through an explicit in_spec when consuming it inside shard_map.
    """
    from jax.sharding import PartitionSpec as P

    def matmat(F, m, X):
        def body(F_local, m_local, X_full):
            F_full = jax.lax.all_gather(F_local, data_axis, tiled=True)
            m_full = jax.lax.all_gather(m_local, data_axis, tiled=True)
            n_full = F_full.shape[0]
            if n_full <= block:
                rows = gram_from_features(spec, F_local, F_full).astype(X_full.dtype)
                rows = rows * (m_local[:, None] * m_full[None, :])
                return rows @ X_full
            Fp, n_pad = _pad_rows(F_full, block)
            mp, _ = _pad_rows(m_full[:, None], block)
            Xp, _ = _pad_rows(X_full, block)
            nbk = n_pad // block
            Fb = Fp.reshape(nbk, block, Fp.shape[-1])
            mb = mp.reshape(nbk, block, 1)
            Xb = Xp.reshape(nbk, block, Xp.shape[-1])

            def tile(carry, xs):
                F_j, m_j, X_j = xs
                K_cols = gram_from_features(spec, F_local, F_j).astype(X_full.dtype)
                K_cols = K_cols * (m_local[:, None] * m_j.transpose(1, 0))
                return carry + K_cols @ X_j, None

            acc0 = jnp.zeros((F_local.shape[0], X_full.shape[-1]), X_full.dtype)
            try:
                acc0 = jax.lax.pcast(acc0, (data_axis,), to="varying")
            except (AttributeError, TypeError):
                acc0 = jax.lax.pvary(acc0, (data_axis,))
            out, _ = jax.lax.scan(tile, acc0, (Fb, mb, Xb))
            return out

        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(data_axis), P(data_axis), P()),
            out_specs=P(data_axis),
        )(F, m, X)

    @jax.jit
    def build(F_local, mask_local):
        n = F_local.shape[0]

        def mv(X):
            X2 = jnp.atleast_2d(X.T).T.astype(dtype)
            out = matmat(F_local, mask_local.astype(dtype), X2)
            return out.reshape(X.shape)

        return make_lowrank_regularizer_from_matvec(
            mv, n, spec.regularization, rank=rank,
            lobpcg_iters=lobpcg_iters, dtype=dtype)

    return build


def _pad_rows(F: jax.Array, block: int) -> Tuple[jax.Array, int]:
    n = F.shape[0]
    n_pad = ((n + block - 1) // block) * block
    if n_pad != n:
        F = jnp.pad(F, ((0, n_pad - n),) + ((0, 0),) * (F.ndim - 1))
    return F, n_pad


def _k_diag(spec: QuantumKernelSpec, F: jax.Array, dtype) -> jax.Array:
    """diag(K) from features: fidelity kernels are 1 on the diagonal; outer
    kernels delegate to ``outer_diag``."""
    if spec.kernel_type == "fidelity":
        return jnp.ones((F.shape[0],), dtype)
    return outer_diag(spec.outer_kernel, F, spec.outer_params).astype(dtype)


def gram_matvec(
    spec: QuantumKernelSpec,
    F: jax.Array,            # (N, D) features (rows may be zero-padded)
    v: jax.Array,            # (N, R) right-hand sides
    row_mask: jax.Array,     # (N,) 1 for real rows
    block: int = 2048,
) -> jax.Array:
    """(K ∘ mask) @ v without materializing K; O(N * block) live memory."""
    # Clamp the tile width to N rounded up to a lane-friendly multiple:
    # padding a small problem to a full default block (e.g. 216 -> 2048)
    # wastes up to ~10x compute per matvec and bloats compile-time constant
    # folding. Shapes are static under jit, so this is a trace-time choice.
    block = min(block, max(256, -(-F.shape[0] // 256) * 256))
    Fp, n_pad = _pad_rows(F, block)
    mp, _ = _pad_rows(row_mask[:, None], block)
    vp, _ = _pad_rows(v, block)
    n_blocks = n_pad // block
    Fb = Fp.reshape(n_blocks, block, Fp.shape[-1])
    mb = mp.reshape(n_blocks, block, 1)

    def body(carry, xs):
        F_j, m_j, v_j = xs
        # K[:, j_block]: (N, block) — one outer-kernel tile per step
        K_cols = gram_from_features(spec, Fp, F_j) * (mp * m_j.transpose(1, 0))
        return carry + K_cols @ v_j, None

    vb = vp.reshape(n_blocks, block, vp.shape[-1])
    out, _ = jax.lax.scan(body, jnp.zeros((n_pad, v.shape[-1]), v.dtype), (Fb, mb, vb))
    return out[: F.shape[0]]


class CGResult(NamedTuple):
    x: jax.Array
    iterations: jax.Array
    residual_norm: jax.Array


def cg_solve(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,            # (N, R) — the local row shard when axis_name set
    tol: float = 1e-6,
    maxiter: int = 256,
    diag_precond: Optional[Union[jax.Array, Callable]] = None,  # (N,) diag or r -> M^{-1} r
    axis_name: Optional[str] = None,
) -> CGResult:
    """Preconditioned CG, batched over RHS columns (jittable).

    ``diag_precond`` may be a diagonal (Jacobi) or any callable applying an
    SPD approximate inverse (e.g. the pivoted-Cholesky/Woodbury preconditioner
    below). With ``axis_name`` the solver runs inside shard_map with rows
    sharded over that mesh axis: all inner products become psums."""
    if callable(diag_precond):
        precond = diag_precond
    elif diag_precond is not None:
        Minv = 1.0 / diag_precond[:, None]

        def precond(r):
            return r * Minv
    else:
        def precond(r):
            return r

    def colsum(x):
        local = jnp.sum(x, axis=0, keepdims=True)
        if axis_name is not None:
            local = jax.lax.psum(local, axis_name)
        return local

    b_norm = jnp.sqrt(colsum(b * b)) + 1e-30

    def cond(state):
        _, r, _, _, it = state
        rel = jnp.max(jnp.sqrt(colsum(r * r)) / b_norm)
        return jnp.logical_and(it < maxiter, rel > tol)

    def step(state):
        x, r, z, p, it = state
        Ap = matvec(p)
        rz = colsum(r * z)
        alpha = rz / (colsum(p * Ap) + 1e-30)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z_new = precond(r_new)
        beta = colsum(r_new * z_new) / (rz + 1e-30)
        p_new = z_new + beta * p
        return (x, r_new, z_new, p_new, it + 1)

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    x, r, _, _, it = jax.lax.while_loop(cond, step, (x0, r0, z0, z0, jnp.zeros((), jnp.int32)))
    return CGResult(x, it, jnp.max(jnp.sqrt(colsum(r * r))[0] / b_norm[0]))


def _cg_setup(
    spec: QuantumKernelSpec,
    F_train: jax.Array,
    y_train: jax.Array,
    sigma2: float,
    block: int,
    cg_tol: float,
    cg_maxiter: int,
    precond_rank: int,
    dtype,
):
    """Shared per-(F_train) CG state: the matvec closure, the preconditioner
    (rank-k pivoted-Cholesky/Woodbury, or Jacobi at rank 0), and the alpha
    solve. Used by ``gp_posterior_large`` and ``make_cg_predictor``.

    ``spec.regularization`` is honored via the low-rank eigenvalue clip:
    the matvec becomes K_reg @ v (+ sigma^2 v). The correction's magnitude
    is ~|lambda_min| (f32 roundoff scale), so the Woodbury preconditioner
    built from the UNregularized K stays an excellent preconditioner for
    K_reg and is not modified."""
    n = F_train.shape[0]
    mask = jnp.ones((n,), dtype)

    reg = None
    if spec.regularization is not None:
        reg = make_lowrank_regularizer(spec, F_train, block=block, dtype=dtype)

    def A(v):
        Kv = gram_matvec(spec, F_train, v, mask, block)
        if reg is not None:
            Kv = reg.matvec(Kv, v)
        return Kv + sigma2 * v

    if precond_rank > 0:
        Lp = pivoted_cholesky(spec, F_train, min(precond_rank, n))
        precond = woodbury_preconditioner(Lp.astype(dtype), sigma2)
    else:
        precond = _k_diag(spec, F_train, dtype) + sigma2
        if reg is not None:
            precond = precond + reg.diag_correction()

    res = cg_solve(A, y_train[:, None].astype(dtype), cg_tol, cg_maxiter, precond)
    return A, precond, res


def gp_posterior_large(
    spec: QuantumKernelSpec,
    F_train: jax.Array,      # (N, D)
    y_train: jax.Array,      # (N,)
    F_test: jax.Array,       # (M, D)
    noise_std: float,
    jitter: float = 1e-6,
    block: int = 2048,
    cg_tol: float = 1e-6,
    cg_maxiter: int = 512,
    precond_rank: int = 64,
    test_chunk: int = 512,
) -> Tuple[jax.Array, jax.Array, CGResult]:
    """Posterior mean and variance diagonal at scale, matrix-free.

    mean = K_*^T alpha with alpha from CG on (K + sigma^2 I);
    var  = k(x,x) - k_*^T (K + sigma^2 I)^{-1} k_* with the k_* solves batched
    through the same CG (exact GP math — no sparse/inducing approximation;
    accuracy is set by cg_tol). ``precond_rank > 0`` uses a rank-k
    pivoted-Cholesky/Woodbury preconditioner (smooth-kernel Grams are
    near-low-rank, so this collapses the CG iteration count); 0 falls back
    to Jacobi. Test points are processed ``test_chunk`` at a time so the CG
    while_loop state stays (N, test_chunk) rather than (N, M).

    Returns (mean, var, res) with ``res`` the alpha solve's CGResult —
    check ``res.residual_norm <= cg_tol`` before trusting the outputs
    (a maxiter-capped solve returns without converging).
    """
    dtype = y_train.dtype
    sigma2 = noise_std**2 + jitter
    A, precond, res = _cg_setup(spec, F_train, y_train, sigma2, block,
                                cg_tol, cg_maxiter, precond_rank, dtype)
    alpha = res.x[:, 0]

    means, vars_ = [], []
    for s in range(0, F_test.shape[0], test_chunk):
        F_c = F_test[s:s + test_chunk]
        K_ts = gram_from_features(spec, F_train, F_c).astype(dtype)  # (N, m)
        means.append(K_ts.T @ alpha)
        sol = cg_solve(A, K_ts, cg_tol, cg_maxiter, precond)
        vars_.append(jnp.maximum(
            _k_diag(spec, F_c, dtype) - jnp.sum(K_ts * sol.x, axis=0), 1e-10))
    return jnp.concatenate(means), jnp.concatenate(vars_), res


# ---------------------------------------------------------------------------
# Mesh-sharded variant: rows over a ``data`` axis
# ---------------------------------------------------------------------------


def make_sharded_posterior(
    spec: QuantumKernelSpec,
    mesh,
    noise_std: float,
    jitter: float = 1e-6,
    block: int = 2048,
    cg_tol: float = 1e-6,
    cg_maxiter: int = 512,
    data_axis: str = "data",
):
    """Posterior (mean, var) with training rows sharded over ``data_axis``.

    Per-sample features are tiny, so each device all-gathers the full feature
    matrix once and streams only its row shard of every Gram product; all CG
    inner products psum over the axis. This is the 50k-sample / multi-chip
    path of BASELINE config #7.

    Inputs to the returned fn: F_train (N, D) and y (N,) sharded along rows,
    row mask (N,) sharded, F_test (M, D) replicated. Outputs replicated.

    ``block`` bounds each device's live Gram tile to (N_local, block): the
    matvec streams column blocks of the local row panel through a scan
    (N <= block short-circuits to one dense panel per product).

    ``spec.regularization`` is honored via the sharded low-rank eigenvalue
    clip (``make_sharded_lowrank_regularizer``): the training-Gram matvec
    becomes K_reg @ v. Like the single-chip CG paths, the correction is
    roundoff-scale, so the Jacobi preconditioner just adds its diagonal.
    """
    from jax.sharding import PartitionSpec as P

    sigma2 = noise_std**2 + jitter
    regularized = spec.regularization is not None
    reg_build = (make_sharded_lowrank_regularizer(
        spec, mesh, block=block, data_axis=data_axis)
        if regularized else None)

    def body(F_local, y_local, m_local, F_test, V_local, w, shift):
        F_full = jax.lax.all_gather(F_local, data_axis, tiled=True)
        m_full = jax.lax.all_gather(m_local, data_axis, tiled=True)
        n_full = F_full.shape[0]

        def reg_corr(v_local):
            # (V diag(w) V^T + shift I) @ v with V rows sharded like v.
            vtv = jax.lax.psum(V_local.T @ v_local, data_axis)   # (r, R)
            return V_local @ (w[:, None] * vtv) + shift * v_local

        def k_diag(F):
            return _k_diag(spec, F, y_local.dtype)

        def A(v_local):
            v_full = jax.lax.all_gather(v_local, data_axis, tiled=True)
            if n_full <= block:
                rows = gram_from_features(spec, F_local, F_full).astype(v_local.dtype)
                rows = rows * (m_local[:, None] * m_full[None, :])
                Kv = rows @ v_full
                if regularized:
                    Kv = Kv + reg_corr(v_local)
                return Kv + sigma2 * v_local
            # stream column blocks: live tile is (N_local, block)
            Fp, n_pad = _pad_rows(F_full, block)
            mp, _ = _pad_rows(m_full[:, None], block)
            vp, _ = _pad_rows(v_full, block)
            nbk = n_pad // block
            Fb = Fp.reshape(nbk, block, Fp.shape[-1])
            mb = mp.reshape(nbk, block, 1)
            vb = vp.reshape(nbk, block, vp.shape[-1])

            def tile(carry, xs):
                F_j, m_j, v_j = xs
                K_cols = gram_from_features(spec, F_local, F_j).astype(v_local.dtype)
                K_cols = K_cols * (m_local[:, None] * m_j.transpose(1, 0))
                return carry + K_cols @ v_j, None

            acc0 = jnp.zeros((F_local.shape[0], v_local.shape[-1]), v_local.dtype)
            # mark the carry device-varying along the data axis (shard_map VMA)
            try:
                acc0 = jax.lax.pcast(acc0, (data_axis,), to="varying")
            except (AttributeError, TypeError):  # older jax spells it pvary
                acc0 = jax.lax.pvary(acc0, (data_axis,))
            out, _ = jax.lax.scan(tile, acc0, (Fb, mb, vb))
            if regularized:
                out = out + reg_corr(v_local)
            return out + sigma2 * v_local

        diag_local = k_diag(F_local) + sigma2
        if regularized:
            diag_local = diag_local + (
                jnp.sum(V_local * V_local * w[None, :], axis=1) + shift
            ).astype(diag_local.dtype)
        res = cg_solve(A, (y_local * m_local)[:, None], cg_tol, cg_maxiter,
                       diag_local, axis_name=data_axis)
        alpha_local = res.x

        K_st_local = gram_from_features(spec, F_local, F_test).astype(y_local.dtype)
        K_st_local = K_st_local * m_local[:, None]
        mean = jax.lax.psum(K_st_local.T @ alpha_local[:, 0], data_axis)

        sol = cg_solve(A, K_st_local, cg_tol, cg_maxiter, diag_local,
                       axis_name=data_axis)
        quad = jax.lax.psum(jnp.sum(K_st_local * sol.x, axis=0), data_axis)
        var = jnp.maximum(k_diag(F_test) - quad, 1e-10)
        return mean, var

    jitted = jax.jit(jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(data_axis), P(data_axis), P(data_axis), P(),
                  P(data_axis), P(), P()),
        out_specs=(P(), P()),
    ))

    if not regularized:
        z0 = jnp.zeros((), jnp.float32)

        def predict(F_local, y_local, m_local, F_test):
            # dummy rank-0 correction (V has 1 zero column so specs line up)
            V0 = jnp.zeros((F_local.shape[0], 1), jnp.float32)
            return jitted(F_local, y_local, m_local, F_test, V0,
                          jnp.zeros((1,), jnp.float32), z0)

        return predict

    def predict(F_local, y_local, m_local, F_test):
        reg = reg_build(F_local, m_local)
        return jitted(F_local, y_local, m_local, F_test, reg.V, reg.w,
                      reg.shift)

    return predict


# ---------------------------------------------------------------------------
# Gram-free blocked Cholesky: exact logdet/NLL at scale
# ---------------------------------------------------------------------------


def gram_free_blocked_cholesky(
    spec: QuantumKernelSpec,
    F: jax.Array,            # (N, D) features, N divisible by block after pad
    noise_std: float,
    jitter: float = 1e-6,
    block: int = 1024,
    dtype=jnp.float32,
):
    """Cholesky factor of (K + sigma^2 I) WITHOUT materializing K.

    Left-looking blocked factorization; each panel's Gram block is generated
    on the fly from the (tiny) feature matrix, so peak memory is the L factor
    itself (f32: 10 GB at N=50k) plus one (N, block) panel — the reference's
    dense f64 K + LAPACK path needs 40 GB before factoring even starts.

    L is stored as (nb, n_pad, block) panel slabs and each iteration writes
    slab k via a leading-axis dynamic-update-slice — XLA reliably aliases
    that in-place across fori_loop iterations, whereas updating column
    blocks of a flat (N, N) buffer duplicated the whole factor in HBM
    (observed 24 GB at N=50k). Maintains the invariant that slabs >= the
    current panel are zero, so the trailing correction is one einsum over
    the slab axis with no triangular masking.

    Returns (L, logdet) with L reassembled as (n_pad, n_pad) and logdet of
    the padded system equal to the true logdet (padded rows contribute
    log(1) = 0).
    """
    L_slabs, logdet, n_pad = _gram_free_blocked_cholesky_slabs(
        spec, F, noise_std, jitter, block, dtype
    )
    # (nb, n_pad, block) -> (n_pad, nb*block)
    L = jnp.transpose(L_slabs, (1, 0, 2)).reshape(n_pad, n_pad)
    return L, logdet


def _gram_free_blocked_cholesky_slabs(
    spec: QuantumKernelSpec,
    F: jax.Array,
    noise_std: float,
    jitter: float = 1e-6,
    block: int = 1024,
    dtype=jnp.float32,
):
    from jax.scipy.linalg import solve_triangular

    n = F.shape[0]
    # Low-rank regularization is built on the UNPADDED rows (its V is then
    # row-padded with zeros, so padded rows stay an identity block).
    reg = None
    if spec.regularization is not None:
        reg = make_lowrank_regularizer(spec, F, block=block, dtype=dtype)
    n_pad = ((n + block - 1) // block) * block
    mask = jnp.ones((n,), dtype)
    if n_pad != n:
        F = jnp.pad(F, ((0, n_pad - n),) + ((0, 0),) * (F.ndim - 1))
        mask = jnp.pad(mask, (0, n_pad - n))
        if reg is not None:
            reg = reg._replace(V=jnp.pad(reg.V, ((0, n_pad - n), (0, 0))))
    sigma2 = noise_std**2 + jitter
    nb = n_pad // block

    def k_panel(k):
        F_k = jax.lax.dynamic_slice_in_dim(F, k * block, block, 0)
        m_k = jax.lax.dynamic_slice_in_dim(mask, k * block, block, 0)
        P = gram_from_features(spec, F, F_k).astype(dtype)
        if reg is not None:
            V_k = jax.lax.dynamic_slice_in_dim(reg.V, k * block, block, 0)
            P = P + (reg.V * reg.w[None, :]) @ V_k.T
            if spec.regularization == "tikhonov":
                row_ids_ = jnp.arange(n_pad)[:, None]
                col_ids_ = k * block + jnp.arange(block)[None, :]
                on_diag_ = (row_ids_ == col_ids_).astype(dtype)
                P = P + reg.shift * on_diag_ * m_k[None, :]
        P = P * (mask[:, None] * m_k[None, :])
        row_ids = jnp.arange(n_pad)[:, None]
        col_ids = k * block + jnp.arange(block)[None, :]
        on_diag = (row_ids == col_ids).astype(dtype)
        return P + on_diag * (sigma2 * m_k[None, :] + (1.0 - m_k[None, :]))

    def body(k, L_slabs):
        panel = k_panel(k)                                  # (n_pad, block)
        # rows k*block..(k+1)*block of every slab: (nb, block, block)
        slab_krows = jax.lax.dynamic_slice_in_dim(L_slabs, k * block, block, 1)
        # correction = L[:, :] @ L[kB:(k+1)B, :]^T summed over slabs
        corr = jnp.einsum("jnb,jcb->nc", L_slabs, slab_krows)
        T = panel - corr
        S_kk = jax.lax.dynamic_slice_in_dim(T, k * block, block, 0)
        L_kk = jnp.linalg.cholesky(S_kk)
        panel_L = solve_triangular(L_kk, T.T, lower=True).T  # T @ L_kk^{-T}
        row_ids = jnp.arange(n_pad)[:, None]
        below = (row_ids >= (k + 1) * block).astype(dtype)
        panel_out = panel_L * below
        panel_out = jax.lax.dynamic_update_slice_in_dim(
            panel_out, jnp.tril(L_kk), k * block, 0
        )
        return L_slabs.at[k].set(panel_out)

    L_slabs = jax.lax.fori_loop(
        0, nb, body, jnp.zeros((nb, n_pad, block), dtype)
    )
    # diagonal entries: slab k holds columns kB..(k+1)B; its rows kB..(k+1)B
    diag_blocks = jnp.stack([
        jax.lax.dynamic_slice_in_dim(L_slabs[k], k * block, block, 0)
        for k in range(nb)
    ])  # (nb, block, block)
    diag = jnp.diagonal(diag_blocks, axis1=1, axis2=2).reshape(-1)
    logdet = 2.0 * jnp.sum(jnp.log(diag))
    return L_slabs, logdet, n_pad


def nll_large(
    spec: QuantumKernelSpec,
    F: jax.Array,
    y: jax.Array,
    noise_std: float,
    jitter: float = 0.0,
    block: int = 1024,
    dtype=jnp.float32,
):
    """Exact GP NLL (+components) at scale via the Gram-free blocked Cholesky.

    Matches agent_riemannian.py:442-460 semantics: 0.5 logdet + 0.5 y^T C^{-1} y
    + 0.5 N log(2 pi) with C = K + sigma^2 I. Works on the (nb, n_pad, block)
    slab factor directly (block forward substitution), so peak memory stays
    one L factor + one panel (the whole computation runs as ONE jitted
    program — an un-jitted fori_loop holds input AND output copies of the
    factor, doubling HBM)."""
    # noise_std/jitter ride as traced scalars: sigma2 enters the panel
    # diagonal additively, so a hyperparameter sweep over noise values must
    # not recompile the O(N^3) factorization program
    dtype = jnp.dtype(dtype)
    nll, ld, quad, const = _nll_large_jit(
        spec, F, y, jnp.asarray(float(noise_std), dtype),
        jnp.asarray(float(jitter), dtype),
        block=int(block), dtype_name=dtype.name,
    )
    return nll, {"log_det_term": ld, "quadratic_term": quad, "constant_term": const}


@partial(jax.jit, static_argnums=(0,), static_argnames=("block", "dtype_name"))
def _nll_large_jit(
    spec: QuantumKernelSpec,
    F: jax.Array,
    y: jax.Array,
    noise_std,
    jitter,
    block: int = 1024,
    dtype_name: str = "float32",
):
    from jax.scipy.linalg import solve_triangular

    dtype = jnp.dtype(dtype_name)
    n = F.shape[0]
    L_slabs, logdet, n_pad = _gram_free_blocked_cholesky_slabs(
        spec, F, noise_std, jitter, block, dtype
    )
    nb = n_pad // block
    y_pad = jnp.pad(y.astype(dtype), (0, n_pad - n))

    def fwd(k, w):
        # global rows kB..(k+1)B of L across all slabs: (nb, block, block)
        krows = jax.lax.dynamic_slice_in_dim(L_slabs, k * block, block, 1)
        y_k = jax.lax.dynamic_slice_in_dim(y_pad, k * block, block, 0)
        # rhs = y_k - L[kB:(k+1)B, :] @ w  (columns j > k of L are zero)
        rhs = y_k - jnp.einsum("jcb,jb->c", krows, w)
        L_kk = jax.lax.dynamic_slice_in_dim(krows, k, 1, 0)[0]
        w_k = solve_triangular(L_kk, rhs, lower=True)
        return w.at[k].set(w_k)

    w = jax.lax.fori_loop(0, nb, fwd, jnp.zeros((nb, block), dtype))
    quad = 0.5 * jnp.sum(w * w)
    const = 0.5 * n * jnp.log(2.0 * jnp.pi)
    ld = 0.5 * logdet
    return ld + quad + const, ld, quad, const


# ---------------------------------------------------------------------------
# Pivoted-Cholesky preconditioner (matrix-free, GPyTorch-style)
# ---------------------------------------------------------------------------


def pivoted_cholesky(
    spec: QuantumKernelSpec,
    F: jax.Array,            # (N, D) features
    rank: int,
    jitter: float = 1e-12,
) -> jax.Array:
    """Rank-``rank`` pivoted Cholesky of K from features, matrix-free.

    Greedy diagonal pivoting; each step evaluates ONE kernel row (N kernel
    entries) — total work O(rank * N * D) + O(rank^2 * N). Returns L with
    K ≈ L^T L, L: (rank, N). Jittable (static rank)."""
    n = F.shape[0]
    # single-precision features (f32, or c64 fidelity states) keep the
    # preconditioner in f32 — f64 here would dominate the setup
    dtype = (jnp.float32 if F.dtype in (jnp.float32, jnp.complex64)
             else jnp.float64)

    d0 = _k_diag(spec, F, dtype)

    def body(j, carry):
        L, d = carry
        i = jnp.argmax(d)
        F_i = jax.lax.dynamic_slice_in_dim(F, i, 1, 0)          # (1, D)
        row = gram_from_features(spec, F, F_i)[:, 0].astype(dtype)  # (N,)
        L_col_i = jax.lax.dynamic_slice_in_dim(L, i, 1, 1)[:, 0]    # (rank,)
        row = row - L.T @ L_col_i
        piv = jnp.sqrt(jnp.maximum(d[i], jitter))
        l_j = row / piv
        # zero any contribution once the residual diagonal is exhausted
        l_j = jnp.where(d[i] > jitter, l_j, jnp.zeros_like(l_j))
        L = jax.lax.dynamic_update_slice_in_dim(L, l_j[None, :], j, 0)
        d = jnp.maximum(d - l_j * l_j, 0.0)
        return L, d

    L0 = jnp.zeros((rank, n), dtype)
    L, _ = jax.lax.fori_loop(0, rank, body, (L0, d0))
    return L


def woodbury_preconditioner(L: jax.Array, sigma2: float):
    """Callable applying (sigma^2 I + L^T L)^{-1} via Woodbury.

    L: (rank, N) from ``pivoted_cholesky``. Cost per application:
    two (rank x N) matmuls + one small triangular solve pair."""
    from jax.scipy.linalg import cho_factor, cho_solve

    rank = L.shape[0]
    small = sigma2 * jnp.eye(rank, dtype=L.dtype) + L @ L.T
    cf = cho_factor(small)

    def apply(r):
        # (sigma^2 I + U U^T)^{-1} r,  U = L^T
        Lr = L @ r                       # (rank, R)
        corr = L.T @ cho_solve(cf, Lr)   # (N, R)
        return (r - corr) / sigma2

    return apply


# ---------------------------------------------------------------------------
# Distributed Gram-free blocked Cholesky (rows sharded over a mesh axis)
# ---------------------------------------------------------------------------


def distributed_chol_bracket(
    spec: QuantumKernelSpec,
    F_loc: jax.Array,      # (n_loc, Dfeat) this device's feature rows
    F_full: jax.Array,     # (N, Dfeat)     gathered features (replicated)
    y_loc: jax.Array,      # (n_loc,)
    m_loc: jax.Array,      # (n_loc,)       1 = real row, 0 = padding
    m_full: jax.Array,     # (N,)
    *,
    sigma2: float,
    n_dev: int,
    data_axis: str = "data",
    dtype=jnp.float32,
):
    """Masked GP NLL + this device's bracket rows with the solve itself
    ROW-SHARDED over ``data_axis`` — for use INSIDE a ``shard_map`` (and under
    ``vmap`` over agent lanes: every collective is a psum/all_gather over the
    named axis, which batches cleanly).

    Semantics match ``posterior.masked_nll_core`` (main.py's masked agent NLL):
    C = K*mm^T + diag(1-m) + sigma^2 diag(m), y zeroed on padding, the padded
    block contributing log(1)=0 to the log-det and nothing to the quadratic
    term. Returns ``(nll, log_det_term, quadratic_term, constant_term,
    B_loc)`` where ``B_loc`` is this device's (n_loc, N) row block of the
    gradient bracket C^{-1} - alpha alpha^T — exactly what the 2-D training
    scan contracts shifted-Gram panels against.

    Layout (one row block per device, block size B = n_loc):
      * left-looking blocked Cholesky: per step k the diagonal device's
        row strip of L is reconstructed by a masked psum and every device
        triangular-solves its own rows — L never materializes whole
        (live memory O(N^2 / n_dev) per device vs the replicated solve's
        O(N^2)).
      * one blocked forward + backward substitution on (N, n_loc + 1)
        right-hand sides: this device's n_loc one-hot columns of I (giving
        its rows of C^{-1} by symmetry) plus the shared masked y (giving
        alpha, bit-identical on every device).

    Per-device flops are O(N^3 / n_dev) — the same parallel efficiency as
    the factorization itself. No flag/rescue machinery: a non-PSD diagonal
    block NaNs the factor and the NaN reaches the NLL (the driver's host
    f64 re-run path does not engage; use the replicated solve where the
    mixed/fallback semantics are required).

    ``dtype=float64`` runs the factorization and substitutions in f64, but
    the Gram PANELS are built from the f32 feature matrix like every other
    training path (package precision contract) — and XLA fuses the f32
    entry computation differently here than in the replicated solve's full
    Gram, so the two paths' C matrices differ at ~1e-7 absolute. Measured
    consequence (tests/test_training2d.py::test_mesh2d_distributed_solve_
    float64): f64 NLL agrees with the replicated f64 solve at ~1e-5
    relative (the f32-entry floor through the quadratic form), vs ~1e-4
    for the f32 solve.
    """
    from jax.scipy.linalg import solve_triangular

    dtype = jnp.dtype(dtype)
    n_loc = F_loc.shape[0]
    n_total = n_loc * n_dev
    d = jax.lax.axis_index(data_axis)
    row_ids = d * n_loc + jnp.arange(n_loc)
    m_loc = m_loc.astype(dtype)
    m_full_d = m_full.astype(dtype)
    ym_loc = (y_loc * m_loc).astype(dtype)

    def strip(M, k):
        """Global rows [k*B, (k+1)*B) of a row-sharded array — i.e. device
        k's block — replicated everywhere via a masked psum."""
        owned = jnp.where(d == k, M, jnp.zeros_like(M))
        return jax.lax.psum(owned, data_axis)

    def panel_local(k):
        """Local rows of C[:, kB:(k+1)B] (masked + shifted)."""
        F_k = jax.lax.dynamic_slice_in_dim(F_full, k * n_loc, n_loc, 0)
        m_k = jax.lax.dynamic_slice_in_dim(m_full_d, k * n_loc, n_loc, 0)
        Pnl = gram_from_features(spec, F_loc, F_k).astype(dtype)
        Pnl = Pnl * (m_loc[:, None] * m_k[None, :])
        col_ids = k * n_loc + jnp.arange(n_loc)[None, :]
        on_diag = (row_ids[:, None] == col_ids).astype(dtype)
        return Pnl + on_diag * ((1.0 - m_loc[:, None])
                                + dtype.type(sigma2) * m_loc[:, None])

    def chol_step(k, L_local):
        panel = panel_local(k)                       # (n_loc, B)
        L_krows = strip(L_local, k)                  # (B, N)
        T = panel - L_local @ L_krows.T              # (n_loc, B)
        S_kk = strip(T, k)                           # (B, B) diagonal block
        L_kk = jnp.linalg.cholesky(S_kk)
        panel_L = solve_triangular(L_kk, T.T, lower=True).T
        below = (row_ids[:, None] >= (k + 1) * n_loc).astype(dtype)
        panel_out = panel_L * below
        # diagonal device writes tril(L_kk) into its rows
        row_rel = row_ids[:, None] - k * n_loc
        in_diag = jnp.logical_and(row_rel >= 0, row_rel < n_loc)
        diag_vals = jnp.take(jnp.tril(L_kk),
                             jnp.clip(row_rel, 0, n_loc - 1)[:, 0], axis=0)
        panel_out = jnp.where(in_diag, diag_vals, panel_out)
        return jax.lax.dynamic_update_slice_in_dim(
            L_local, panel_out, k * n_loc, 1)

    # The carry must carry the same device-varying axes as the inputs —
    # under the agents x data training mesh that is BOTH axes, under a pure
    # data shard_map just one. Deriving the zero from F_loc inherits the
    # exact varying set either way.
    vary0 = (F_loc.ravel()[0] * 0).astype(dtype)
    L_local = jax.lax.fori_loop(
        0, n_dev, chol_step, jnp.zeros((n_loc, n_total), dtype) + vary0)

    diag_local = L_local[jnp.arange(n_loc), row_ids]
    log_det_term = 0.5 * jax.lax.psum(
        2.0 * jnp.sum(jnp.log(diag_local)), data_axis)

    # Forward substitution L V = [E_d | ym] on (N, n_loc + 1) RHS columns:
    # E_d's block-k rows are I when k == d (this device's one-hot columns),
    # ym's block-k rows are device k's masked y.
    eye_B = jnp.eye(n_loc, dtype=dtype)

    def fwd_step(k, V):
        L_krows = strip(L_local, k)                                  # (B, N)
        L_kk = jax.lax.dynamic_slice_in_dim(L_krows, k * n_loc, n_loc, 1)
        E_k = jnp.where(d == k, eye_B, jnp.zeros_like(eye_B))
        y_k = strip(ym_loc, k)
        rhs_k = jnp.concatenate([E_k, y_k[:, None]], axis=1)         # (B, n_loc+1)
        rhs = rhs_k - L_krows @ V
        V_k = solve_triangular(L_kk, rhs, lower=True)
        return jax.lax.dynamic_update_slice_in_dim(V, V_k, k * n_loc, 0)

    V = jax.lax.fori_loop(
        0, n_dev, fwd_step, jnp.zeros((n_total, n_loc + 1), dtype) + vary0)

    w = V[:, -1]
    # w is computed from replicated strips and is bit-identical on every
    # device, but VMA cannot infer that through the varying carry; pmax of
    # identical shard values is an exact replication marker (see
    # training2d's NLL scalars — pmean would round for non-power-of-two
    # device counts).
    quadratic_term = jax.lax.pmax(0.5 * jnp.sum(w * w), data_axis)

    # Backward substitution L^T Z = V, descending blocks. The trailing-row
    # coupling needs global column-block k of L: an all_gather of each
    # device's (n_loc, B) slab — O(N B) per step, O(N^2) total, the same
    # volume the factorization's strips already moved.
    def bwd_step(i, Z):
        k = n_dev - 1 - i
        Lcol_loc = jax.lax.dynamic_slice_in_dim(L_local, k * n_loc, n_loc, 1)
        Lcol = jax.lax.all_gather(Lcol_loc, data_axis, axis=0, tiled=True)
        L_kk = jax.lax.dynamic_slice_in_dim(Lcol, k * n_loc, n_loc, 0)
        below = (jnp.arange(n_total)[:, None] >= (k + 1) * n_loc).astype(dtype)
        V_k = jax.lax.dynamic_slice_in_dim(V, k * n_loc, n_loc, 0)
        rhs = V_k - (Lcol * below).T @ Z
        Z_k = solve_triangular(L_kk.T, rhs, lower=False)
        return jax.lax.dynamic_update_slice_in_dim(Z, Z_k, k * n_loc, 0)

    # zeros_like(V) inherits V's device-varying marker along the data axis
    Z = jax.lax.fori_loop(0, n_dev, bwd_step, jnp.zeros_like(V))

    alpha = Z[:, -1]                                             # (N,) replicated
    alpha_loc = jax.lax.dynamic_slice_in_dim(alpha, d * n_loc, n_loc, 0)
    # rows of C^{-1} owned locally = (columns for local indices)^T by symmetry
    B_loc = Z[:, :n_loc].T - alpha_loc[:, None] * alpha[None, :]

    n_real = jax.lax.psum(jnp.sum(m_loc), data_axis)
    constant_term = 0.5 * n_real * jnp.log(dtype.type(2.0 * jnp.pi))
    nll = log_det_term + quadratic_term + constant_term
    return nll, log_det_term, quadratic_term, constant_term, B_loc


def make_distributed_cholesky_nll(
    spec: QuantumKernelSpec,
    mesh,
    noise_std: float,
    n_total: int,
    block: int = 1024,
    jitter: float = 0.0,  # matches nll_large / the reference agent NLL (no jitter)
    dtype=jnp.float32,
    data_axis: str = "data",
    n_real: Optional[int] = None,
):
    """Exact GP NLL at multi-chip scale: a left-looking blocked Cholesky of
    (K + sigma^2 I) with the L factor ROW-SHARDED over ``data_axis`` — no chip
    ever holds the full factor, and K panels are generated on the fly from the
    (tiny, all-gathered) feature matrix.

    Per panel k: every device forms its local rows of the k-th Gram panel,
    the B x N row-strip of L owned by the diagonal device is reconstructed via
    a masked psum, the B x B diagonal Cholesky is computed redundantly, and
    each device triangular-solves its own rows. The forward substitution for
    the quadratic term walks the same block structure (one psum per block).

    Requires: n_total divisible by block; (n_total / block) divisible by the
    mesh size (each device owns an integer number of row blocks). For a REAL
    sample count that does not satisfy this, zero-pad F and y up to the next
    valid ``n_total`` (``pad_rows_for_distributed`` does both) and pass the
    true count as ``n_real``: padded rows are masked out of every Gram panel
    and carry an identity diagonal, so the factorization stays PSD, their
    logdet contribution is zero, the forward substitution leaves them at
    zero, and the constant term uses ``n_real`` — the returned NLL is
    EXACTLY the unpadded system's.

    Returns fn(F_local, y_local) -> (nll, log_det_term, quadratic_term,
    constant_term) with F (N, D) and y (N,) sharded along rows; outputs
    replicated scalars.

    ``spec.regularization`` is honored via the sharded low-rank eigenvalue
    clip: each Gram panel gains its slice of V diag(w) V^T (+ shift on the
    diagonal for tikhonov) before factoring.
    """
    from jax.scipy.linalg import solve_triangular
    from jax.sharding import PartitionSpec as P

    regularized = spec.regularization is not None
    reg_build = (make_sharded_lowrank_regularizer(
        spec, mesh, block=min(2048, n_total), data_axis=data_axis,
        dtype=dtype) if regularized else None)
    n_dev = mesh.shape[data_axis]
    if n_total % block != 0:
        raise ValueError(f"n_total={n_total} must be divisible by block={block}")
    nb = n_total // block
    if nb % n_dev != 0:
        raise ValueError(f"block count {nb} must divide over {n_dev} devices")
    rows_local = n_total // n_dev
    sigma2 = noise_std**2 + jitter
    n_real = n_total if n_real is None else int(n_real)
    if not 0 < n_real <= n_total:
        raise ValueError(f"n_real={n_real} must be in (0, n_total={n_total}]")
    ragged = n_real != n_total

    def body(F_local, y_local, V_local, w, shift):
        d = jax.lax.axis_index(data_axis)
        row0 = d * rows_local
        row_ids = row0 + jnp.arange(rows_local)                  # global rows
        F_full = jax.lax.all_gather(F_local, data_axis, tiled=True)
        if regularized:
            V_full = jax.lax.all_gather(V_local, data_axis, tiled=True)

        def k_panel_local(k):
            """Local rows of (K_reg + sigma^2 I)[:, kB:(k+1)B]."""
            F_k = jax.lax.dynamic_slice_in_dim(F_full, k * block, block, 0)
            Pnl = gram_from_features(spec, F_local, F_k).astype(dtype)
            col_ids = k * block + jnp.arange(block)[None, :]
            on_diag = (row_ids[:, None] == col_ids).astype(dtype)
            if regularized:
                V_k = jax.lax.dynamic_slice_in_dim(V_full, k * block, block, 0)
                Pnl = Pnl + (V_local * w[None, :]).astype(dtype) @ V_k.T.astype(dtype)
                Pnl = Pnl + shift.astype(dtype) * on_diag
            if ragged:
                # zero-padded feature rows do NOT produce zero Gram entries
                # (k(0, x) != 0 for these kernels) — mask them out and give
                # padded rows an identity diagonal so the factor stays PSD
                # with zero logdet contribution
                rvalid = (row_ids < n_real).astype(dtype)[:, None]
                cvalid = (col_ids < n_real).astype(dtype)
                Pnl = Pnl * rvalid * cvalid
                return Pnl + on_diag * jnp.where(rvalid > 0, sigma2,
                                                 1.0).astype(dtype)
            return Pnl + sigma2 * on_diag

        def extract_strip(M_local, k):
            """Masked-psum reconstruction of global rows [kB, (k+1)B) of a
            row-sharded matrix — replicated on every device."""
            owner_first = k * block - row0
            strip = jax.lax.dynamic_slice_in_dim(
                M_local, jnp.clip(owner_first, 0, rows_local - block), block, 0
            )
            owns = jnp.logical_and(owner_first >= 0,
                                   owner_first <= rows_local - block)
            strip = jnp.where(owns, strip, jnp.zeros_like(strip))
            return jax.lax.psum(strip, data_axis)

        def chol_step(k, L_local):
            panel = k_panel_local(k)                             # (rows_local, B)
            L_krows = extract_strip(L_local, k)                  # (B, N)
            T_local = panel - L_local @ L_krows.T                # (rows_local, B)
            S_kk = extract_strip(T_local, k)                     # (B, B) diagonal block
            L_kk = jnp.linalg.cholesky(S_kk)
            panel_L = solve_triangular(L_kk, T_local.T, lower=True).T
            below = (row_ids[:, None] >= (k + 1) * block).astype(dtype)
            panel_out = panel_L * below
            # the owner writes tril(L_kk) into its diagonal rows
            row_rel = row_ids[:, None] - k * block
            in_diag_block = jnp.logical_and(row_rel >= 0, row_rel < block)
            diag_vals = jnp.take(
                jnp.tril(L_kk), jnp.clip(row_rel, 0, block - 1)[:, 0], axis=0
            )
            panel_out = jnp.where(in_diag_block, diag_vals, panel_out)
            return jax.lax.dynamic_update_slice_in_dim(
                L_local, panel_out, k * block, 1
            )

        L0 = jnp.zeros((rows_local, n_total), dtype)
        # mark the carry as device-varying along the data axis (shard_map VMA)
        try:
            L0 = jax.lax.pcast(L0, (data_axis,), to="varying")
        except (AttributeError, TypeError):  # older jax spells it pvary
            L0 = jax.lax.pvary(L0, (data_axis,))
        L_local = jax.lax.fori_loop(0, nb, chol_step, L0)

        # logdet: local diagonal entries live where global row == column
        diag_local = L_local[jnp.arange(rows_local), row_ids]
        logdet = jax.lax.psum(2.0 * jnp.sum(jnp.log(diag_local)), data_axis)

        # forward substitution L w = y over blocks (one psum per block)
        y_loc = y_local.astype(dtype)

        def fwd_step(k, w_full):
            L_krows = extract_strip(L_local, k)                  # (B, N)
            y_k = extract_strip(y_loc[:, None], k)[:, 0]         # (B,)
            L_kk_cols = jax.lax.dynamic_slice_in_dim(L_krows, k * block, block, 1)
            rhs = y_k - L_krows @ w_full
            w_k = solve_triangular(L_kk_cols, rhs, lower=True)
            return jax.lax.dynamic_update_slice_in_dim(w_full, w_k, k * block, 0)

        wv = jax.lax.fori_loop(0, nb, fwd_step, jnp.zeros((n_total,), dtype))
        quad = 0.5 * jnp.sum(wv * wv)
        ld = 0.5 * logdet
        const = 0.5 * n_real * jnp.log(2.0 * jnp.pi)
        nll = ld + quad + const
        return nll, ld, quad, const

    jitted = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(data_axis), P(data_axis), P(data_axis), P(), P()),
        out_specs=(P(), P(), P(), P()),
    ))

    if not regularized:
        def nll_fn(F_local, y_local):
            V0 = jnp.zeros((n_total, 1), dtype)
            return jitted(F_local, y_local, V0, jnp.zeros((1,), dtype),
                          jnp.zeros((), dtype))

        return nll_fn

    def nll_fn(F_local, y_local):
        # padded rows are masked out of the eigen-clip's Gram too, so the
        # regularizer is computed on the REAL system
        mask = (jnp.arange(n_total) < n_real).astype(dtype)
        reg = reg_build(F_local, mask)
        return jitted(F_local, y_local, reg.V, reg.w, reg.shift)

    return nll_fn


def pad_rows_for_distributed(F: np.ndarray, y: np.ndarray, block: int,
                             n_devices: int):
    """Zero-pad (F, y) rows up to the next multiple of ``block * n_devices``
    so they satisfy ``make_distributed_cholesky_nll``'s layout requirements.

    Returns (F_pad, y_pad, n_total, n_real); pass ``n_total``/``n_real``
    through to the factory. Zero rows are the contract the ragged masking
    inside the factorization expects.
    """
    n_real = F.shape[0]
    step = block * n_devices
    n_total = ((n_real + step - 1) // step) * step
    if n_total != n_real:
        F = np.pad(np.asarray(F), ((0, n_total - n_real), (0, 0)))
        y = np.pad(np.asarray(y), (0, n_total - n_real))
    return F, y, n_total, n_real


def make_cg_predictor(
    spec: QuantumKernelSpec,
    X_train,
    Y_train,
    theta,
    noise_std: float,
    jitter: float = 1e-6,
    block: int = 4096,
    cg_tol: float = 1e-6,
    cg_maxiter: int = 400,
    precond_rank: int = 64,
    test_chunk: int = 512,
) -> Callable:
    """CG-posterior predictor with the expensive per-(X_train, theta) state
    computed ONCE: training features, the pivoted-Cholesky/Woodbury
    preconditioner, and the alpha solve. The returned callable evaluates
    (mean, var) for any X_eval — the CLI calls it for the test set, the
    train-subsample overfitting check, and (via a second predictor) the
    ground-truth comparison without re-simulating the training rows.

    dtype: f64 wherever x64 is on, else f32. Fidelity features stay
    complex. Eval points are chunked (``test_chunk``) so the variance
    path's live memory is bounded.

    Non-converged solves warn: a maxiter-capped CG whose residual is still
    above ~30x cg_tol yields inaccurate predictions with no other signal
    (the alpha solve is checked at factory time, the per-chunk variance
    solves once per predict() call — one scalar fetch each).
    """
    import warnings

    from ..models.kernels.quantum_kernel import kernel_features

    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    if spec.kernel_type == "fidelity":
        fdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
    else:
        fdtype = dtype
    theta32 = jnp.asarray(theta, jnp.float32)
    # one compiled feature pass (eager statevector ops would dispatch per
    # gate)
    feats = jax.jit(lambda X, t: kernel_features(spec, X, t))
    F_tr = feats(jnp.asarray(X_train, jnp.float32), theta32).astype(fdtype)
    y = jnp.asarray(Y_train, dtype)
    sigma2 = noise_std**2 + jitter

    A, precond, res = _cg_setup(spec, F_tr, y, sigma2, block,
                                cg_tol, cg_maxiter, precond_rank, dtype)
    alpha = res.x[:, 0]
    # residual_norm is relative to ||b||; the cond() exit test uses the max
    # over RHS columns of the same quantity, so converged means <= cg_tol
    # up to the final step's reduction — use a loose 30x band to avoid
    # false alarms from a last-iteration overshoot
    alpha_resid = float(res.residual_norm)
    if alpha_resid > 30 * cg_tol:
        warnings.warn(
            f"CG alpha solve did not converge: relative residual "
            f"{alpha_resid:.2e} after {int(res.iterations)} iterations "
            f"(cg_tol={cg_tol:.1e}); posterior mean/var will be inaccurate. "
            f"Raise cg_maxiter or precond_rank.", RuntimeWarning)

    def predict(X_eval) -> Tuple[jax.Array, jax.Array]:
        F_ev = feats(jnp.asarray(X_eval, jnp.float32), theta32).astype(fdtype)
        means, vars_, resids = [], [], []
        for s in range(0, F_ev.shape[0], test_chunk):
            F_c = F_ev[s:s + test_chunk]
            K_ts = gram_from_features(spec, F_tr, F_c).astype(dtype)  # (N, m)
            means.append(K_ts.T @ alpha)
            sol = cg_solve(A, K_ts, cg_tol, cg_maxiter, precond)
            resids.append(sol.residual_norm)
            vars_.append(jnp.maximum(
                _k_diag(spec, F_c, dtype) - jnp.sum(K_ts * sol.x, axis=0), 1e-10))
        worst = float(jnp.max(jnp.stack(resids)))  # one fetch per predict()
        if worst > 30 * cg_tol:
            warnings.warn(
                f"CG variance solve did not converge: worst relative "
                f"residual {worst:.2e} (cg_tol={cg_tol:.1e}); predictive "
                f"variances will be inaccurate.", RuntimeWarning)
        return jnp.concatenate(means), jnp.concatenate(vars_)

    predict.alpha_result = res
    return predict


def predict_quantum_gp_large(
    spec: QuantumKernelSpec,
    X_train,
    Y_train,
    X_test,
    theta,
    noise_std: float,
    **kwargs,
) -> Tuple[jax.Array, jax.Array]:
    """Drop-in twin of ``predict_quantum_gp`` for training sets whose dense
    Gram no longer fits (one-shot form of ``make_cg_predictor``)."""
    return make_cg_predictor(spec, X_train, Y_train, theta, noise_std,
                             **kwargs)(X_test)
