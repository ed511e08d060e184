"""GP linear algebra with the reference's numerical-fallback semantics.

The reference's solve chain is Cholesky -> LU -> pinv
(agent_riemannian.py:414-428) and Cholesky -> explicit inverse in the predict
path (main.py:1450-1486). Under XLA a failed Cholesky yields NaNs instead of
raising, so the fallback is expressed as a ``lax.cond`` on finiteness: the
happy path stays a single fused Cholesky program, and the (rare) indefinite
case pays for an eigendecomposition-based pseudo-inverse. Both branches are
compiled once; only one executes per call.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular


class SolveResult(NamedTuple):
    """Result of a PSD solve.

    Accuracy contract: ``C_inv``/``C_inv_y`` are accurate at ``C.dtype``
    whenever ``chol_ok`` is True (the mixed solver's residual gate enforces
    this) — EXCEPT the mixed solver's ``refine_style="split"`` (the
    ``"mixed-flag"`` hot path), whose ``C_inv_y`` is ~1e-4-grade relative
    (see ``split_f64_matvec``): cond-independent unlike a raw f32 solve,
    ample for fold scores/means, not for trajectory-critical quantities.
    ``logdet`` is f64-exact on the direct path; on the mixed path it
    derives from the f32 factor's diagonal and carries ~N*eps_f32 relative
    error (~1e-4 at N=1000) — fine for the 4-dp-rounded trajectory and the
    gated north-star NLL parity, but NLL log-det terms from the mixed solver
    should not be asserted beyond ~4 significant digits on ill-conditioned
    Grams. ``l_exact`` says whether ``L`` is a ``C.dtype``-grade factor
    (direct path / mixed's f64 rescue) or only f32-grade (mixed happy path);
    variance solves through ``L`` should pick their dtype from it.
    """

    C_inv: jax.Array        # (N, N)
    C_inv_y: jax.Array      # (N,)
    logdet: jax.Array       # scalar
    chol_ok: jax.Array      # bool scalar
    L: jax.Array            # Cholesky factor (garbage if chol_ok is False)
    l_exact: jax.Array      # bool scalar: L is accurate at C.dtype


def solve_psd_with_fallback(C: jax.Array, y: jax.Array, fallback: bool = True,
                            need_inverse: bool = True) -> SolveResult:
    """C^{-1}, C^{-1} y and logdet(C) via Cholesky, eigh-pinv on failure.

    Mirrors agent_riemannian.py:414-428 + the slogdet guard at :442-444 (the
    LU middle step is collapsed into the pinv branch: for any invertible C
    they agree to rounding; for singular C the reference also lands on pinv).

    ``fallback=False`` skips compiling the eigh branch entirely; a failed Cholesky then yields non-finite
    outputs, which callers surface as inf NLL / failed folds — the same
    observable outcome as the reference's exception paths.

    ``need_inverse=False`` skips the O(N^3) explicit C^{-1} on the Cholesky
    path (posterior/CV callers only need L and C^{-1} y; the inverse is only
    required for the NLL gradient's bracket matrix) — ~4x less linalg work
    per GP fit.
    """
    n = C.shape[-1]
    eye = jnp.eye(n, dtype=C.dtype)
    L = jnp.linalg.cholesky(C)
    chol_ok = jnp.all(jnp.isfinite(L))
    L_safe = jnp.where(chol_ok, L, eye)

    def chol_branch(_):
        w = solve_triangular(L_safe, y, lower=True)
        C_inv_y = solve_triangular(L_safe.T, w, lower=False)
        if need_inverse:
            Vi = solve_triangular(L_safe, eye, lower=True)
            C_inv = solve_triangular(L_safe.T, Vi, lower=False)
        else:
            C_inv = jnp.zeros_like(C)
        logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L_safe)))
        return C_inv, C_inv_y, logdet

    def pinv_branch(_):
        # Rescue path for a failed Cholesky: eigendecomposition in f32 (a
        # matrix that defeated f64 Cholesky has no f64-accurate inverse
        # anyway — the reference's pinv end-state is equally approximate).
        w32, V32 = jnp.linalg.eigh(C.astype(jnp.float32))
        w, V = w32.astype(C.dtype), V32.astype(C.dtype)
        cutoff = jnp.max(jnp.abs(w)) * n * jnp.finfo(jnp.float32).eps
        w_inv = jnp.where(jnp.abs(w) > cutoff, 1.0 / w, 0.0)
        C_inv = (V * w_inv[None, :]) @ V.T
        C_inv_y = C_inv @ y
        logdet = jnp.sum(jnp.log(jnp.abs(w) + 1e-8))
        return C_inv, C_inv_y, logdet

    if fallback:
        C_inv, C_inv_y, logdet = lax.cond(chol_ok, chol_branch, pinv_branch, None)
    else:
        nan = jnp.asarray(jnp.nan, C.dtype)
        C_inv, C_inv_y, logdet = chol_branch(None)
        C_inv = jnp.where(chol_ok, C_inv, nan)
        C_inv_y = jnp.where(chol_ok, C_inv_y, nan)
        logdet = jnp.where(chol_ok, logdet, nan)
    return SolveResult(C_inv, C_inv_y, logdet, chol_ok, L_safe,
                       jnp.asarray(True))


def split_f64_matvec(A: jax.Array, v: jax.Array) -> jax.Array:
    """A @ v for f64 operands via three f32 products summed in f64.

    Splitting A = A_hi + A_lo and v = v_hi + v_lo into f32 parts and
    dropping the lo*lo term keeps the product on f32 arithmetic:

        A @ v ~= A_hi v_hi + A_hi v_lo + A_lo v_hi   (each an f32 product)

    Accuracy: the f32 accumulation of A_hi v_hi rounds at the magnitude of
    sum_j |A_ij v_j|, so where A @ v cancels (residuals!) the absolute error
    is ~sqrt(N) * eps_f32 * || |A| |v| || — measured ~5e-5 relative residual
    floor at the north-star fold shapes (cond ~3e4), i.e. ~1e-4-grade
    solutions out of iterative refinement: error bounded near that floor
    independent of cond (a raw f32 solve degrades as eps_f32 * cond), well
    short of true f64. Use where that suffices (vmapped CV fold solves /
    posterior means); true-f64 callers keep the f64 product."""
    ah = A.astype(jnp.float32)
    al = (A - ah.astype(jnp.float64)).astype(jnp.float32)
    vh = v.astype(jnp.float32)
    vl = (v - vh.astype(jnp.float64)).astype(jnp.float32)
    return ((ah @ vh).astype(jnp.float64) + (ah @ vl).astype(jnp.float64)
            + (al @ vh).astype(jnp.float64))


def solve_psd_mixed(C: jax.Array, y: jax.Array, fallback: bool = True,
                    need_inverse: bool = True, refine_iters: int = 2,
                    rtol: Optional[float] = None, on_fail: str = "cond",
                    refine_style: str = "f64") -> SolveResult:
    """f64-grade PSD solve at near-f32 cost: f32 Cholesky + f64 refinement.

    Where f64 arithmetic is slow, the sequential triangular-solve stack of a
    direct f64 Cholesky solve is its worst case. This solver factors once in
    f32 and recovers f64 accuracy with matmul-shaped f64 work only:

    * ``C^{-1}`` — f32 explicit inverse polished by Newton-Schulz
      ``X <- X (2I - C X)`` (quadratic: f32's 1e-7 error -> ~1e-14 in two
      steps), each step two f64 matmuls.
    * ``C^{-1} y`` — with ``need_inverse`` (the gradient-bracket path),
      one f64 matvec ``X y`` through the polished inverse — no sequential
      triangular-solve chain. Without it, classical iterative refinement:
      f64 residual matvecs (O(N^2)), corrections through the f32 factor.
      Both converge to ~f64 roundoff when cond(C) is within f32's reach
      (~1e7), i.e. everywhere the reference's own f64 LAPACK path is
      meaningfully accurate.
    * ``logdet`` — from the f32 factor's diagonal, summed in f64 (relative
      error ~N*eps_f32; the NLL's log-det term is reporting/convergence
      signal, not a quantity the 4-dp-rounded trajectory depends on).

    A residual gate (``rtol``) marks systems the f32 factorization cannot
    serve (cond beyond ~1e7). What happens then is ``on_fail``:

    * ``"cond"`` — route to the direct f64 path (and its eigh-pinv rescue,
      still governed by ``fallback``) via ``lax.cond``. Correct ONLY for
      un-vmapped callers: under ``vmap``, XLA lowers ``cond`` to ``select``
      and BOTH branches execute every call — the f64 branch's cost would
      always be paid.
    * ``"flag"`` — outputs become NaN with ``chol_ok=False`` (exactly like
      ``solve_psd_with_fallback(fallback=False)``); the caller decides
      (CV folds: inf penalty, reference failure semantics; the training
      driver: re-run the iteration through the float64 step). This is the
      mode for vmapped/sharded hot paths.

    ``refine_style`` selects how the ``need_inverse=False`` refinement
    computes its f64 residual matvecs ``C @ x``:

    * ``"f64"`` (default) — the f64 product: residuals converge to ~1e-12.
    * ``"split"`` — :func:`split_f64_matvec` (three f32 products). Residual
      measurement and refinement then floor at the f32
      cancellation scale: ~1e-4-grade solutions regardless of cond
      (measured 0.6-2e-4 relative at north-star fold shapes, moving fold
      NLPDs ~1e-5 — far inside the 4-dp/1e-4 parity bars). The
      residual gate defaults to 1e-3 in this style (healthy systems sit at
      ~5e-5; f32-defeating systems, cond >~ 1e7, stall at >~ 0.1).

    ``rtol=None`` resolves per style: 1e-8 ("f64") / 1e-3 ("split"). An
    explicit value is honored, but in "split" style residuals below the
    ~sqrt(N)*eps_f32 floor are not measurable.

    For non-f64 inputs this is exactly ``solve_psd_with_fallback``.
    """
    if C.dtype != jnp.float64:
        # on_fail="flag" must keep its NaN-flagging contract here too: an
        # in-program eigh rescue would execute on EVERY call under a vmapped
        # caller (cond -> select) — exactly what the flag mode exists to
        # avoid. (Reached e.g. when DQGP_X64=0 downgrades a "mixed" caller's
        # f64 quantities to f32 while the solver string stays "mixed-flag".)
        return solve_psd_with_fallback(
            C, y, fallback=fallback and on_fail != "flag",
            need_inverse=need_inverse)
    if refine_style not in ("f64", "split"):
        raise ValueError(f"unknown refine_style {refine_style!r}")
    # Split products apply ONLY to the need_inverse=False refinement path:
    # with need_inverse=True (the trajectory-critical agent step) x comes
    # from the Newton-Schulz-polished inverse and the residual gate keeps
    # its original true-f64 measurement + 1e-8 threshold — bit-identical
    # flagging behavior to the pre-split solver.
    use_split = refine_style == "split" and not need_inverse
    if rtol is None:
        rtol = 1e-3 if use_split else 1e-8
    n = C.shape[-1]
    C32 = C.astype(jnp.float32)
    eye32 = jnp.eye(n, dtype=jnp.float32)
    L32 = jnp.linalg.cholesky(C32)
    ok32 = jnp.all(jnp.isfinite(L32))
    L_safe = jnp.where(ok32, L32, eye32)

    if use_split:
        C_lo = (C - C32.astype(jnp.float64)).astype(jnp.float32)

        def mv64(v):
            vh = v.astype(jnp.float32)
            vl = (v - vh.astype(jnp.float64)).astype(jnp.float32)
            return ((C32 @ vh).astype(jnp.float64)
                    + (C32 @ vl).astype(jnp.float64)
                    + (C_lo @ vh).astype(jnp.float64))
    else:
        def mv64(v):
            return C @ v

    def s32(b):
        w = solve_triangular(L_safe, b, lower=True)
        return solve_triangular(L_safe.T, w, lower=False)

    if need_inverse:
        # The polished explicit inverse is needed anyway (gradient bracket),
        # so derive x = X y from it: one f64 matvec instead of the
        # sequential initial-solve + refine_iters triangular-solve rounds
        # (triangular solves are latency-bound; this is the mixed step's
        # dominant serial chain). Accuracy matches the refinement
        # path: Newton-Schulz is quadratic, eps_f32^2 < 1e-13 relative.
        eye64 = jnp.eye(n, dtype=C.dtype)
        X = s32(eye32).astype(jnp.float64)

        def newton(_, Xk):
            return Xk @ (2.0 * eye64 - C @ Xk)

        X = lax.fori_loop(0, 2, newton, X)
        x = X @ y
    else:
        X = jnp.zeros_like(C)
        x = s32(y.astype(jnp.float32)).astype(jnp.float64)

        def refine(_, xk):
            r = y - mv64(xk)
            return xk + s32(r.astype(jnp.float32)).astype(jnp.float64)

        x = lax.fori_loop(0, refine_iters, refine, x)

    y_norm = jnp.maximum(jnp.linalg.norm(y), jnp.finfo(jnp.float64).tiny)
    rnorm = jnp.linalg.norm(y - mv64(x)) / y_norm
    ok = ok32 & (rnorm < rtol) & jnp.all(jnp.isfinite(x)) & jnp.all(jnp.isfinite(X))

    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L_safe).astype(jnp.float64)))

    if on_fail == "flag":
        nan = jnp.asarray(jnp.nan, C.dtype)
        return SolveResult(
            jnp.where(ok, X, nan), jnp.where(ok, x, nan),
            jnp.where(ok, logdet, nan), ok, L_safe.astype(C.dtype),
            jnp.asarray(False),
        )

    mixed = SolveResult(X, x, logdet, ok, L_safe.astype(C.dtype),
                        jnp.asarray(False))

    def direct(_):
        return solve_psd_with_fallback(C, y, fallback=fallback,
                                       need_inverse=need_inverse)

    return lax.cond(ok, lambda _: mixed, direct, None)


def contraction_dtype(solver: str, dtype) -> "jnp.dtype":
    """dtype for the big elementwise contractions around a mixed solve.

    With the mixed solver, f64 trace contractions / triangular variance
    solves would pay the f64 cost the solver exists to avoid; their f32
    roundoff is orders below the reference's 4-dp gradient rounding. One definition so every call site applies the same policy.
    """
    return jnp.float32 if (solver.startswith("mixed") and dtype == jnp.float64) else dtype


def get_psd_solver(solver: str):
    """'direct' -> solve_psd_with_fallback; 'mixed' -> solve_psd_mixed with
    the lax.cond f64 rescue (un-vmapped callers only); 'mixed-flag' ->
    solve_psd_mixed flagging failures as NaN (vmapped/sharded hot paths)."""
    if solver == "mixed":
        return solve_psd_mixed
    if solver == "mixed-flag":
        def mixed_flag(C, y, fallback: bool = True, need_inverse: bool = True):
            # flag solvers OWN their failure semantics: a caller's
            # ``fallback=True`` (a plain keyword that would override a
            # functools.partial binding) must not re-enable an in-program
            # rescue that vmap's cond->select lowering runs on every call.
            # refine_style="split": this is the vmapped HOT path (CV folds
            # inside the fused per-iteration program) — the split products
            # keep the residual matvecs in f32 at ~1e-4-grade solution
            # accuracy (fold NLPDs move ~1e-5, two orders inside every
            # parity bar). Flagged systems still re-score through the
            # true-f64 path at the host level, unchanged.
            del fallback
            return solve_psd_mixed(C, y, fallback=False,
                                   need_inverse=need_inverse, on_fail="flag",
                                   refine_style="split")
        return mixed_flag
    if solver == "direct":
        return solve_psd_with_fallback
    if solver == "direct-flag":
        # For vmapped/sharded hot paths: under vmap, lax.cond lowers to
        # select and the eigh-pinv rescue would execute on EVERY call (5
        # vmapped N^2 eigh per CV pass). Failures surface as NaN with
        # chol_ok=False; callers rescue at the host level.
        def direct_flag(C, y, fallback: bool = True, need_inverse: bool = True):
            del fallback  # see mixed_flag: the solver string wins
            return solve_psd_with_fallback(C, y, fallback=False,
                                           need_inverse=need_inverse)
        return direct_flag
    raise ValueError(
        f"unknown solver '{solver}' (use 'direct', 'direct-flag', 'mixed' "
        f"or 'mixed-flag')")


def condition_number(C: jax.Array, method: str = "auto") -> jax.Array:
    """2-norm condition number, resolvable past the reference's reporting
    buckets at 1e12/1e15 (main.py:2629-2642; np.linalg.cond at
    agent_riemannian.py:411, main.py:1441 is an f64 SVD).

    An f32 eigendecomposition cannot resolve cond beyond ~1e7 (absolute
    eigenvalue error ~ eps * lambda_max swamps small eigenvalues), so:

    * ``eigh`` (auto-selected with x64): f64 ``eigvalsh`` — for the
      symmetric Grams this is applied to, |eigenvalues| == singular values,
      and eigh is far cheaper to compile and run than SVD.
    * ``iterative`` (auto-selected without x64): power iteration for
      lambda_max and Cholesky inverse iteration for lambda_min —
      O(iters * N^2) matvecs / triangular solves. Accurate to a few percent,
      ample for order-of-magnitude buckets. Indefinite/singular C (failed
      f64 Cholesky) reports inf, which lands in the reference's "Poor"
      bucket just as its ~1e16+ SVD estimates do.
    """
    if method == "auto":
        use_eigh = bool(jax.config.jax_enable_x64)
    else:
        use_eigh = method == "eigh"
    if use_eigh:
        dt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        w = jnp.abs(jnp.linalg.eigvalsh(C.astype(dt)))
        cond = jnp.max(w, axis=-1) / jnp.min(w, axis=-1)
        return cond.astype(C.dtype)
    return _condition_number_iterative(C).astype(C.dtype)


def _condition_number_iterative(C: jax.Array, iters: int = 64) -> jax.Array:
    """Power iteration on C and (explicit) C^{-1}.

    The inverse is materialized once via two triangular solves with N
    right-hand sides — a single batched latency step — after which BOTH
    extremal eigenvalues are matmul-only power iterations that vmap freely
    over agents. (The textbook alternative, inverse iteration with two
    triangular solves per step, is latency-bound.)
    Indefinite/singular C (failed f64 Cholesky) reports inf.
    """
    dt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    A = C.astype(dt)
    n = A.shape[-1]
    tiny = jnp.asarray(jnp.finfo(dt).tiny, dt)
    # Deterministic non-degenerate start vector (no RNG inside jit).
    v0 = jnp.ones((n,), dt) + jnp.linspace(0.0, 0.5, n, dtype=dt)
    v0 = v0 / jnp.linalg.norm(v0)

    def power(M):
        def body(_, v):
            w = M @ v
            return w / jnp.maximum(jnp.linalg.norm(w), tiny)

        v = lax.fori_loop(0, iters, body, v0)
        return v @ (M @ v)

    lam_max = power(A)

    L = jnp.linalg.cholesky(A)
    ok = jnp.all(jnp.isfinite(L))
    L_safe = jnp.where(ok, L, jnp.eye(n, dtype=dt))
    Vi = solve_triangular(L_safe, jnp.eye(n, dtype=dt), lower=True)
    A_inv = solve_triangular(L_safe.T, Vi, lower=False)
    lam_min = 1.0 / jnp.maximum(power(A_inv), tiny)

    cond = jnp.abs(lam_max) / jnp.maximum(jnp.abs(lam_min), tiny)
    return jnp.where(ok, cond, jnp.asarray(jnp.inf, dt))


def masked_identity_pad(K: jax.Array, mask: jax.Array) -> jax.Array:
    """Zero padded rows/cols of a Gram and put 1 on padded diagonal entries.

    Padded block becomes an identity: its Cholesky is trivial, its logdet
    contribution is 0, and it decouples from the real block — the device-side
    answer to ragged per-agent shard sizes (static shapes for XLA).
    """
    m2 = mask[:, None] * mask[None, :]
    return K * m2 + jnp.diag(1.0 - mask)
