"""ADMM training on an agents x data 2-D mesh (scale-out config #7).

The reference cannot train at 50k samples / 64 agents at all: its per-agent
gradient materializes 2P+1 dense Grams in one process (SURVEY.md §5.7 calls
blocked Gram work this system's analogue of ring attention; the fan-out is
main.py:2530-2542). This module shards the ADMM iteration over TWO mesh
axes:

* ``agents`` — one agent block per mesh row; consensus is a psum of
  (cos, sin) sums over this axis (riemannian_optimizer.py:42-49 is exactly
  psum-shaped).
* ``data``   — each agent's rows are sharded over mesh columns. Per shifted
  parameter, every device computes features for ITS rows, all-gathers the
  (tiny, N x D) feature matrix along ``data``, builds only its (N_local, N)
  Gram panel, and contracts it against its row-slice of the solve bracket;
  the trace inner products psum over ``data``.

Live memory per device: O(N^2) for the (replicated) solve of one agent's
C = K + sigma^2 I plus one (N_local, N) panel — never the (2P+1, N, N)
shifted-Gram stack (that is 26 GB at P=65, N=5000; the panel is 100 MB).
The solve itself is replicated across the ``data`` axis (its O(N^3) is
amortized over the 2P panel sweeps that dominate at P >> 1); swapping in
the row-sharded distributed Cholesky (``blocked.make_distributed_cholesky_
nll``) is the documented upgrade path when N^2 itself stops fitting.

Semantics are identical to ``consensus.admm_iteration`` (same 4-dp parity
rounding, same proximal update, same NLL components); a CPU-mesh test
asserts step-for-step agreement with the single-device path.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import manifold as M
from ..models.gp.posterior import masked_nll_core
from ..ops.linalg import contraction_dtype
from ..models.kernels.quantum_kernel import (
    QuantumKernelSpec,
    gram_from_features,
    kernel_features,
)
from .consensus import AgentBatch, AgentStepOut


def agents_data_mesh(n_agent_rows: int, n_data_cols: int,
                     devices=None) -> Mesh:
    """2-D mesh: ``agents`` (rows) x ``data`` (cols), devices in
    ``jax.devices()`` order. The ``data`` axis carries the per-shift
    all-gathers; ``agents`` only moves P floats per iteration."""
    devs = np.asarray(list(devices if devices is not None else jax.devices()))
    need = n_agent_rows * n_data_cols
    if devs.size < need:
        raise ValueError(f"need {need} devices, have {devs.size}")
    grid = devs[:need].reshape(n_agent_rows, n_data_cols)
    return Mesh(grid, axis_names=("agents", "data"))


def _agent_local_2d(
    spec: QuantumKernelSpec,
    X_loc: jax.Array,        # (N_loc, D)   this device's rows of one agent
    Y_loc: jax.Array,        # (N_loc,)
    m_loc: jax.Array,        # (N_loc,)
    z: jax.Array,            # (P,) consensus (already wrapped + rounded)
    psi_i: jax.Array,        # (P,)
    *,
    rho: float,
    L: float,
    noise_std: float,
    shift_value: float,
    parity_round: bool,
    compute_cond: bool,
    gp_dtype: str,
    psd_fallback: bool,
    grad_method: str = "central",
    n_data_cols: int = 1,
    solve: str = "replicated",
):
    solver = "direct"
    if gp_dtype == "mixed":
        gp_dtype, solver = "float64", "mixed-flag"
    if gp_dtype == "float64" and not jax.config.jax_enable_x64:
        gp_dtype = "float32"
    dtype = jnp.dtype(gp_dtype)
    z_manifold = M.wrap(z)  # agents wrap consensus before evaluating, as in
    z32 = z_manifold.astype(jnp.float32)  # _agent_local / agent_riemannian.py:378
    n_loc = X_loc.shape[0]
    col = jax.lax.axis_index("data")

    y_full = jax.lax.all_gather(Y_loc, "data", axis=0, tiled=True)
    m_full = jax.lax.all_gather(m_loc, "data", axis=0, tiled=True)

    if grad_method == "autodiff":
        # Exact dNLL/dtheta through the sharded forward pass (the 1-D mesh's
        # better-than-reference mode, consensus._agent_local). The loss is
        # REPLICATED along "data" (every column computes the same NLL from
        # the gathered features), so each device differentiates loss/n_cols:
        # the all_gather transpose (a psum_scatter over "data") sums the
        # n_cols replica cotangents — the 1/n_cols cancels that — handing
        # every device exactly dL/dF_loc for ITS rows, and shard_map's
        # replicated-input gradient rule then psums the per-device partials
        # automatically (verified: an explicit psum here double-counts by
        # the axis size). Live memory stays O(N^2) (the Cholesky VJP's
        # cotangent), never (P,N,N). Like the 1-D path, autodiff keeps the
        # direct solver (mixed's refinement loop is well-defined under AD
        # but needlessly deep).
        #
        # The differentiation point must be marked VARYING over "agents":
        # z arrives replication-tracked as unvarying over that axis (it is a
        # psum over it), and the cotangent of an unvarying input gets an
        # automatic psum over "agents" to stay type-consistent — which would
        # sum every mesh row's gradient into every agent (verified: rows=1
        # exact, rows>1 scrambled). pcast(to='varying') severs exactly that
        # tie; each row then keeps its own per-agent gradient.
        def loss(t):
            F_loc_t = kernel_features(spec, X_loc, t.astype(jnp.float32))
            F_full_t = jax.lax.all_gather(F_loc_t, "data", axis=0, tiled=True)
            Kt = gram_from_features(spec, F_full_t)
            r, _ = masked_nll_core(
                Kt.astype(dtype), y_full.astype(dtype), m_full.astype(dtype),
                noise_std, compute_cond=compute_cond, fallback=psd_fallback,
            )
            return r.nll / n_data_cols, r

        t_at = jax.lax.pcast(z_manifold.astype(dtype), "agents", to="varying")
        (_, res), grad = jax.value_and_grad(loss, has_aux=True)(t_at)
    else:
        # Row-sharded features -> full feature matrix (tiny) via all-gather.
        F_loc = kernel_features(spec, X_loc, z32)
        F_full = jax.lax.all_gather(F_loc, "data", axis=0, tiled=True)

        # mixed: contract panels in f32 (see consensus._agent_local)
        cdt = contraction_dtype(solver, dtype)
        if solve == "distributed":
            # Row-sharded blocked Cholesky: no device ever materializes the
            # full (N, N) system or bracket — live memory O(N^2 / n_cols)
            # (blocked.distributed_chol_bracket; the upgrade path for when
            # one agent's N^2 stops fitting a chip).
            from .blocked import distributed_chol_bracket
            from ..models.gp.posterior import NLLResult

            nll_v, ld_v, quad_v, const_v, B_loc = distributed_chol_bracket(
                spec, F_loc, F_full, Y_loc, m_loc, m_full,
                sigma2=noise_std**2, n_dev=n_data_cols, dtype=dtype,
            )
            zero = jnp.zeros((0,), dtype)
            res = NLLResult(nll_v, zero, ld_v, quad_v, const_v,
                            jnp.asarray(jnp.nan, dtype),
                            jnp.asarray(True))
            B_loc = B_loc.astype(cdt)
        else:
            # Unshifted Gram + solve, replicated along "data" (see module
            # docstring).
            K = gram_from_features(spec, F_full)
            res, bracket = masked_nll_core(
                K.astype(dtype), y_full.astype(dtype), m_full.astype(dtype),
                noise_std, compute_cond=compute_cond, fallback=psd_fallback,
                solver=solver,
            )
            # This device's row block of the (symmetric) bracket.
            B_loc = jax.lax.dynamic_slice_in_dim(bracket, col * n_loc, n_loc,
                                                 axis=0).astype(cdt)
        m2_loc = (m_loc[:, None] * m_full[None, :]).astype(cdt)

        n_params = z32.shape[0]

        def shift_body(carry, p):
            e = jax.nn.one_hot(p, n_params, dtype=z32.dtype)
            t_plus = jnp.mod(z32 + shift_value * e, M.PERIOD)
            t_minus = jnp.mod(z32 - shift_value * e, M.PERIOD)
            Fp_loc = kernel_features(spec, X_loc, t_plus)
            Fm_loc = kernel_features(spec, X_loc, t_minus)
            Fp_full = jax.lax.all_gather(Fp_loc, "data", axis=0, tiled=True)
            Fm_full = jax.lax.all_gather(Fm_loc, "data", axis=0, tiled=True)
            if spec.regularization is None:
                # (N_loc, N) panels of the shifted Grams — rows local,
                # columns all.
                Kp_panel = gram_from_features(spec, Fp_loc, Fp_full)
                Km_panel = gram_from_features(spec, Fm_loc, Fm_full)
            else:
                # Square-Gram regularization (thresholding/tikhonov,
                # main.py:2011-2013) is a full-spectrum operation, so each
                # shifted Gram is built WHOLE from the gathered features
                # (symmetric call -> clipped, exactly like the 1-D paths'
                # per-shift clip) and this device's row panel sliced out.
                # The O(N^3) eigh replicates along "data" — the price of
                # the reference's per-shift semantics. Live memory stays
                # O(N^2), though with a ~2-3x constant: the Kp and Km full
                # Grams (plus eigh workspace) are live simultaneously per
                # scan step — same order as the replicated solve above.
                Kp_panel = jax.lax.dynamic_slice_in_dim(
                    gram_from_features(spec, Fp_full), col * n_loc, n_loc,
                    axis=0)
                Km_panel = jax.lax.dynamic_slice_in_dim(
                    gram_from_features(spec, Fm_full), col * n_loc, n_loc,
                    axis=0)
            dk = ((Kp_panel - Km_panel) / (2.0 * shift_value)).astype(cdt) * m2_loc
            # tr[B dK] = sum_{r local} <B[r, :], dK[r, :]> (B symmetric), psummed.
            g = 0.5 * jax.lax.psum(jnp.sum(B_loc * dk), "data").astype(dtype)
            return carry, g

        _, grad = jax.lax.scan(shift_body, None, jnp.arange(n_params))

    grad = M.round4(grad) if parity_round else grad
    theta_i = M.admm_update_theta(z_manifold, grad, psi_i, rho, L)
    psi_new = M.admm_update_psi(psi_i, theta_i, z_manifold, rho)
    if parity_round:
        theta_i = M.round4(theta_i)
        psi_new = M.round4(psi_new)
    # The NLL scalars are computed from all-gathered (hence replicated)
    # inputs, but shard_map cannot statically infer that; pmax over
    # identical shard values is an exact replication marker for ANY axis
    # size (pmean = psum/n would round in the last bit for non-power-of-two
    # column counts, breaking step-for-step agreement with the 1-D path).
    rep = lambda v: jax.lax.pmax(v, "data")
    return (theta_i, psi_new, rep(res.nll), rep(res.log_det_term),
            rep(res.quadratic_term), rep(res.constant_term),
            rep(res.condition_number))


def make_admm_step_2d(
    spec: QuantumKernelSpec,
    mesh: Mesh,
    *,
    rho: float,
    L: float,
    noise_std: float,
    shift_value: float = float(np.pi / 8),
    parity_round: bool = True,
    compute_cond: bool = False,
    gp_dtype: str = "float64",
    psd_fallback: bool = True,
    grad_method: str = "central",
    solve: str = "replicated",
):
    """Jitted ADMM iteration over an ("agents", "data") mesh.

    Expects theta/psi sharded P("agents") and the AgentBatch sharded
    P("agents", "data") (see ``shard_batch_to_mesh_2d``). Agent count must
    divide by mesh rows; per-agent padded size by mesh columns.

    ``grad_method``: "central"/"streamed" run the reference's h=pi/8 central
    difference as a panel scan (they are the same computation here — the 2-D
    path is streamed by construction); "autodiff" differentiates through the
    sharded statevector + Cholesky forward pass (exact gradients, one
    forward+backward instead of 2P panel sweeps).

    ``spec.regularization`` (thresholding/tikhonov) is honored with the
    reference's per-shift semantics: symmetric Grams — the solve's and,
    under "central"/"streamed", every shifted one — are spectrally clipped
    whole before the panel slice (the eigh replicates along ``data``; live
    memory stays O(N^2)). "autodiff" differentiates through the clip, as on
    the 1-D mesh.

    ``solve``: "replicated" (default) solves each agent's (N, N) system
    whole on every data column — its O(N^3) is amortized over the 2P panel
    sweeps, but one agent's N^2 must fit a chip. "distributed" row-shards
    the Cholesky factor, the substitutions, AND the gradient bracket over
    the ``data`` axis (``blocked.distributed_chol_bracket``): live memory
    drops to O(N^2 / n_cols) per device, removing the last single-chip
    ceiling on per-agent size. Restrictions (all static errors):
    central/streamed gradients only, no mixed solver (the f64 refinement
    loop is not distributed — use gp_dtype float32/float64), no
    square-Gram regularization (the per-shift clip materializes full Grams,
    defeating the sharded memory budget; use the replicated solve), and
    in-step condition numbers unavailable (``compute_cond=False``; the
    driver's host backfill is independent of the step and still works).
    ``psd_fallback`` is likewise inert under "distributed": the row-sharded
    Cholesky has no eigh-pinv rescue branch (a non-PSD factorization
    surfaces as NaN NLL rather than being silently repaired) — accepted
    rather than raised because it is the parameter's default; the driver
    logs a note when the combination is active.
    """
    if solve not in ("replicated", "distributed"):
        raise ValueError(f"solve must be 'replicated' or 'distributed', got {solve!r}")
    if solve == "distributed":
        if grad_method == "autodiff":
            raise ValueError(
                "solve='distributed' supports central/streamed gradients; "
                "autodiff differentiates the replicated solve (solve='replicated')")
        if gp_dtype == "mixed":
            raise ValueError(
                "solve='distributed' does not distribute the mixed solver's "
                "f64 refinement loop; use gp_dtype='float32'/'float64' or "
                "solve='replicated'")
        if spec.regularization is not None:
            raise ValueError(
                "solve='distributed' cannot apply square-Gram regularization "
                "(the per-shift spectral clip materializes full Grams, "
                "defeating the sharded memory budget); use solve='replicated'")
        if compute_cond:
            raise ValueError(
                "solve='distributed' cannot compute in-step condition numbers "
                "(needs the full spectrum); use compute_cond=False with the "
                "driver's host cond backfill")
    kwargs = dict(
        rho=rho, L=L, noise_std=noise_std, shift_value=shift_value,
        parity_round=parity_round, compute_cond=compute_cond,
        gp_dtype=gp_dtype, psd_fallback=psd_fallback,
        grad_method=grad_method, n_data_cols=mesh.shape["data"],
        solve=solve,
    )

    def body(theta, psi, X, Y, m):
        # Consensus from OLD state (main.py:2513-2525): psum over agents.
        # theta/psi are replicated along "data", so no data-axis reduction.
        xi = theta + psi / rho
        phase = 2.0 * jnp.pi * xi / M.PERIOD
        cos_sum = jax.lax.psum(jnp.sum(jnp.cos(phase), axis=0), "agents")
        sin_sum = jax.lax.psum(jnp.sum(jnp.sin(phase), axis=0), "agents")
        z = M.circular_mean_from_sums(cos_sum, sin_sum)
        if parity_round:
            z = M.round4(z)

        step = partial(_agent_local_2d, spec, **kwargs)
        outs = jax.vmap(lambda Xi, Yi, mi, pi: step(Xi, Yi, mi, z, pi))(
            X, Y, m, psi
        )
        theta_new, psi_new, nll, ld, quad, const, cond = outs
        return AgentStepOut(theta_new, psi_new, z, nll, ld, quad, const, cond)

    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P("agents"), P("agents"),
                  P("agents", "data"), P("agents", "data"), P("agents", "data")),
        out_specs=AgentStepOut(
            theta=P("agents"), psi=P("agents"), z=P(),
            nll=P("agents"), log_det_term=P("agents"),
            quadratic_term=P("agents"), constant_term=P("agents"),
            condition_number=P("agents"),
        ),
    )

    @jax.jit
    def step(theta, psi, batch: AgentBatch):
        return sharded(theta, psi, batch.X, batch.Y, batch.mask)

    return step


def shard_batch_to_mesh_2d(batch: AgentBatch, theta, psi, mesh: Mesh):
    """Place the batch once: rows of each agent over ``data``, agents over
    ``agents``; theta/psi over ``agents`` (replicated along ``data``)."""
    s2 = NamedSharding(mesh, P("agents", "data"))
    s1 = NamedSharding(mesh, P("agents"))
    return (
        AgentBatch(
            jax.device_put(batch.X, s2),
            jax.device_put(batch.Y, s2),
            jax.device_put(batch.mask, s2),
        ),
        jax.device_put(jnp.asarray(theta), s1),
        jax.device_put(jnp.asarray(psi), s1),
    )
