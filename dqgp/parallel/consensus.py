"""Multi-agent ADMM consensus on a device mesh.

Redesign of the reference's distribution substrate (SURVEY.md
§2.9, §5.8). The reference fans agents out as OS processes and re-pickles
each agent's full data shard every iteration (main.py:2530-2542); here:

* agents are a named mesh axis (``"agents"``) — each device owns a block of
  agents; within a device the agent block is vmapped;
* data shards are padded to a static per-agent size, masked, sharded onto the
  mesh ONCE, and stay device-resident;
* the consensus z-update is a ``psum`` of per-agent (cos, sin) sums followed
  by a local atan2 — the circular mean is exactly psum-shaped
  (riemannian_optimizer.py:42-49);
* the whole ADMM iteration (z update -> 2P+1 shifted Gram batch -> NLL +
  gradient -> theta/psi updates) is ONE jitted XLA program.

Semantics preserved: bulk-synchronous rounds; agents communicate only through
z; 4-decimal rounding of z / gradient / theta / psi in parity mode
(main.py:2523, 2551-2552; agent_riemannian.py:438, 485-486).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import manifold as M
from ..models.gp.posterior import masked_nll_and_grad
from ..models.kernels.quantum_kernel import QuantumKernelSpec, gram_and_shift_grads
from ..ops.linalg import contraction_dtype

# Every training step builds its Grams from float32 statevectors (complex64):
# entries carry f32 representation error whatever the GP solve dtype is.
STEP_GRAM_DTYPE = jnp.float32


class AgentBatch(NamedTuple):
    """Static-shape agent shards: (A, Nmax, D), (A, Nmax), (A, Nmax)."""

    X: jax.Array
    Y: jax.Array
    mask: jax.Array


class AgentStepOut(NamedTuple):
    theta: jax.Array            # (A, P)
    psi: jax.Array              # (A, P)
    z: jax.Array                # (P,) replicated
    nll: jax.Array              # (A,)
    log_det_term: jax.Array     # (A,)
    quadratic_term: jax.Array   # (A,)
    constant_term: jax.Array    # (A,)
    condition_number: jax.Array # (A,)


def make_agent_batch(agent_data_splits: Sequence[Tuple[np.ndarray, np.ndarray]],
                     pad_to: Optional[int] = None) -> AgentBatch:
    """Pack ragged per-agent (X_i, Y_i) into padded, masked device arrays.

    The reference keeps shards as ragged numpy arrays pickled to workers each
    round; static shapes let XLA compile one program for all agents.
    """
    n_max = pad_to or max(x.shape[0] for x, _ in agent_data_splits)
    d = agent_data_splits[0][0].shape[1]
    A = len(agent_data_splits)
    X = np.zeros((A, n_max, d), np.float32)
    Y = np.zeros((A, n_max), np.float64)
    mask = np.zeros((A, n_max), np.float64)
    for i, (Xi, Yi) in enumerate(agent_data_splits):
        ni = Xi.shape[0]
        if ni > n_max:
            raise ValueError(f"agent {i} has {ni} > pad_to={n_max} samples")
        X[i, :ni] = Xi
        Y[i, :ni] = Yi
        mask[i, :ni] = 1.0
    return AgentBatch(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(mask))


def agents_mesh(n_devices: Optional[int] = None,
                devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the ``agents`` axis. On one device this is a 1-device
    mesh (agent blocks vmapped locally); across devices the consensus psum
    is the only collective."""
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=("agents",))


# ---------------------------------------------------------------------------
# The per-agent local step (pure; vmapped over the agent block)
# ---------------------------------------------------------------------------


def _agent_local(
    spec: QuantumKernelSpec,
    X: jax.Array,           # (Nmax, D)
    Y: jax.Array,           # (Nmax,)
    mask: jax.Array,        # (Nmax,)
    z: jax.Array,           # (P,)
    psi_i: jax.Array,       # (P,)
    *,
    rho: float,
    L: float,
    noise_std: float,
    shift_value: float,
    parity_round: bool,
    compute_cond: bool,
    gp_dtype: str = "float64",
    psd_fallback: bool = True,
    grad_method: str = "central",
):
    """One agent's train_and_update (agent_riemannian.py:314-491), jittable.

    grad_method:
      * "central"  — the reference's h=pi/8 central difference over 2P+1
        wrapped parameter sets (parity mode; agent_riemannian.py:209-277).
        Materializes dK as (P, N, N) — fastest at small N (one flattened
        feature batch), O(P N^2) memory.
      * "streamed" — the SAME central difference, but the 2P shifted Grams
        are computed one parameter at a time inside a ``lax.scan`` and
        contracted against the solve bracket immediately, so live memory is
        O(N^2) regardless of P. Gradients match "central" to XLA
        reduction-order tolerance (~1e-7 relative); use it when (2P+1) N^2
        does not fit (the reference's scale ceiling — SURVEY.md §5.7).
      * "autodiff" — exact dNLL/dtheta by differentiating through the
        statevector simulation and the Cholesky solve (better-than-reference
        mode: one forward+backward pass instead of 2P+1 Gram evaluations).

    gp_dtype "mixed" = f64 quantities solved by ``solve_psd_mixed`` (f32
    factorization + f64 refinement). Applies to "central"/"streamed";
    "autodiff" keeps the direct solver (differentiating through the
    refinement loop is well-defined but needlessly deep).
    """
    z_manifold = M.wrap(z)
    solver = "direct"
    if gp_dtype == "mixed":
        gp_dtype, solver = "float64", "mixed-flag"
    if gp_dtype == "float64" and not jax.config.jax_enable_x64:
        gp_dtype = "float32"
    dtype = jnp.dtype(gp_dtype)

    if grad_method == "autodiff":
        from ..models.kernels.quantum_kernel import gram as _gram

        def loss(t):
            Kt = _gram(spec, X, t.astype(STEP_GRAM_DTYPE)).astype(dtype)
            r = masked_nll_and_grad(
                Kt, jnp.zeros((0,) + Kt.shape, dtype), Y.astype(dtype),
                mask.astype(dtype), noise_std,
                compute_cond=compute_cond, fallback=psd_fallback,
            )
            return r.nll, r

        (nll_val, res), grad_exact = jax.value_and_grad(loss, has_aux=True)(
            z_manifold.astype(dtype)
        )
        res = res._replace(grad=grad_exact)
    elif grad_method == "streamed":
        from ..models.gp.posterior import masked_nll_core
        from ..models.kernels.quantum_kernel import gram as _gram

        z32 = z_manifold.astype(STEP_GRAM_DTYPE)
        K = _gram(spec, X, z32)
        res, bracket = masked_nll_core(
            K.astype(dtype), Y.astype(dtype), mask.astype(dtype), noise_std,
            compute_cond=compute_cond, fallback=psd_fallback, solver=solver,
        )
        # mixed: contract in f32 (f64 elementwise reductions are the cost;
        # the error is orders below the 4-dp gradient rounding)
        cdt = contraction_dtype(solver, dtype)
        bracket_c = bracket.astype(cdt)
        m2 = (mask[:, None] * mask[None, :]).astype(cdt)
        n_params = z32.shape[0]

        def shift_body(carry, p):
            e = jax.nn.one_hot(p, n_params, dtype=z32.dtype)
            t_plus = jnp.mod(z32 + shift_value * e, M.PERIOD)
            t_minus = jnp.mod(z32 - shift_value * e, M.PERIOD)
            K_plus = _gram(spec, X, t_plus)
            K_minus = _gram(spec, X, t_minus)
            # difference in f32 then upcast — bit-identical to "central"
            dk = ((K_plus - K_minus) / (2.0 * shift_value)).astype(cdt) * m2
            g = 0.5 * jnp.sum(bracket_c * dk.T)
            return carry, g.astype(dtype)

        _, grads = jax.lax.scan(shift_body, None, jnp.arange(n_params))
        res = res._replace(grad=grads)
    else:
        K, dK = gram_and_shift_grads(spec, X, z_manifold.astype(STEP_GRAM_DTYPE),
                                     shift_value)
        res = masked_nll_and_grad(
            K.astype(dtype), dK, Y.astype(dtype), mask.astype(dtype),
            noise_std, compute_cond=compute_cond, fallback=psd_fallback,
            solver=solver,
        )
    grad = M.round4(res.grad) if parity_round else res.grad
    theta_i = M.admm_update_theta(z_manifold, grad, psi_i, rho, L)
    psi_new = M.admm_update_psi(psi_i, theta_i, z_manifold, rho)
    if parity_round:
        theta_i = M.round4(theta_i)
        psi_new = M.round4(psi_new)
    return (theta_i, psi_new, res.nll, res.log_det_term, res.quadratic_term,
            res.constant_term, res.condition_number)


def admm_iteration(
    spec: QuantumKernelSpec,
    theta: jax.Array,       # (A, P)
    psi: jax.Array,         # (A, P)
    batch: AgentBatch,
    *,
    rho: float,
    L: float,
    noise_std: float,
    shift_value: float = float(np.pi / 8),
    parity_round: bool = True,
    compute_cond: bool = True,
    gp_dtype: str = "float64",
    psd_fallback: bool = True,
    grad_method: str = "central",
    axis_name: Optional[str] = None,
) -> AgentStepOut:
    """One full bulk-synchronous ADMM round (main.py:2507-2555 semantics):

    1. z = round4(circular_mean(theta + psi/rho))    [consensus, from OLD state]
    2. every agent: Gram + shifted Grams at z, NLL gradient, proximal theta
       update, dual psi update.

    If ``axis_name`` is set the function body runs inside shard_map and the
    circular mean reduces with a psum over that axis; otherwise a plain
    axis-0 reduction (single-device / vmap path).
    """
    xi = theta + psi / rho
    phase = 2.0 * jnp.pi * xi / M.PERIOD
    cos_sum = jnp.sum(jnp.cos(phase), axis=0)
    sin_sum = jnp.sum(jnp.sin(phase), axis=0)
    if axis_name is not None:
        cos_sum = jax.lax.psum(cos_sum, axis_name)
        sin_sum = jax.lax.psum(sin_sum, axis_name)
    z = M.circular_mean_from_sums(cos_sum, sin_sum)
    if parity_round:
        z = M.round4(z)

    step = partial(
        _agent_local, spec,
        rho=rho, L=L, noise_std=noise_std, shift_value=shift_value,
        parity_round=parity_round, compute_cond=compute_cond,
        gp_dtype=gp_dtype, psd_fallback=psd_fallback, grad_method=grad_method,
    )
    outs = jax.vmap(lambda X, Y, m, p: step(X, Y, m, z, p))(
        batch.X, batch.Y, batch.mask, psi
    )
    theta_new, psi_new, nll, ld, quad, const, cond = outs
    return AgentStepOut(theta_new, psi_new, z, nll, ld, quad, const, cond)


def make_admm_step(
    spec: QuantumKernelSpec,
    mesh: Optional[Mesh] = None,
    *,
    rho: float,
    L: float,
    noise_std: float,
    shift_value: float = float(np.pi / 8),
    parity_round: bool = True,
    compute_cond: bool = True,
    gp_dtype: str = "float64",
    psd_fallback: bool = True,
    grad_method: str = "central",
):
    """Build the jitted per-iteration step.

    mesh=None (or 1 device): single-program vmap over agents.
    mesh with >1 devices: shard_map over the ``agents`` axis — theta/psi and
    the data batch are sharded along agents; z comes back replicated via psum.
    Agent count must be divisible by the mesh size.
    """
    kwargs = dict(
        rho=rho, L=L, noise_std=noise_std, shift_value=shift_value,
        parity_round=parity_round, compute_cond=compute_cond,
        gp_dtype=gp_dtype, psd_fallback=psd_fallback, grad_method=grad_method,
    )

    if mesh is None or mesh.size == 1:
        @jax.jit
        def step(theta, psi, batch):
            return admm_iteration(spec, theta, psi, batch, **kwargs)
        return step

    sharded_body = jax.shard_map(
        lambda theta, psi, X, Y, m: admm_iteration(
            spec, theta, psi, AgentBatch(X, Y, m), axis_name="agents", **kwargs
        ),
        mesh=mesh,
        in_specs=(P("agents"), P("agents"), P("agents"), P("agents"), P("agents")),
        out_specs=AgentStepOut(
            theta=P("agents"), psi=P("agents"), z=P(),
            nll=P("agents"), log_det_term=P("agents"),
            quadratic_term=P("agents"), constant_term=P("agents"),
            condition_number=P("agents"),
        ),
    )

    @jax.jit
    def step(theta, psi, batch):
        return sharded_body(theta, psi, batch.X, batch.Y, batch.mask)

    return step


def shard_batch_to_mesh(batch: AgentBatch, theta, psi, mesh: Mesh):
    """Place agent-blocked arrays onto the mesh once (device-resident data)."""
    spec_3 = NamedSharding(mesh, P("agents"))
    put = lambda a: jax.device_put(a, spec_3)
    return (
        AgentBatch(put(batch.X), put(batch.Y), put(batch.mask)),
        put(jnp.asarray(theta)),
        put(jnp.asarray(psi)),
    )
