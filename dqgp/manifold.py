"""Torus manifold, Riemannian optimizers, and Riemannian ADMM algebra.

JAX re-design of the reference's ``riemannian_optimizer.py``
(reference: riemannian_optimizer.py:26-428). Everything here is a pure,
jittable function over jnp arrays; thin classes mirror the reference's public
API (``TorusManifold``, ``RiemannianOptimizer``, ``RiemannianADMM``,
``create_riemannian_framework``) so that users of the reference find the same
surface.

Behavioral-parity notes (quirks of the reference that are load-bearing and are
reproduced here behind ``signed_log=False`` defaults):

* ``log_map`` in the reference wraps differences into ``[0, period)`` — it is
  NOT the signed shortest arc (riemannian_optimizer.py:115-121). The dual
  update therefore accumulates a non-negative wrapped difference. We reproduce
  this by default and expose the geometrically-correct signed variant via
  ``signed_log=True``.
* The reference's training loop never calls ``RiemannianOptimizer`` — the
  effective agent update is the closed-form proximal step
  ``theta = wrap(z - (grad + psi)/(rho + L))``
  (riemannian_optimizer.py:324-348; optimizer argument unused). The optimizer
  methods are still implemented because they are public API surface.
"""

from __future__ import annotations

from typing import Literal, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

PERIOD = float(np.pi)

# ---------------------------------------------------------------------------
# Pure functional torus ops (reference: riemannian_optimizer.py:53-146)
# ---------------------------------------------------------------------------


def wrap(x: jax.Array, period: float = PERIOD) -> jax.Array:
    """Wrap angles to [0, period]. Reference: riemannian_optimizer.py:73-83.

    XLA's mod computes x - floor(x/p)*p, so a subnormal negative x (|x| <
    ~1e-308*p) underflows x/p to -0.0 and comes back UNCHANGED — negative,
    outside the torus chart (np.mod returns p there; found by hypothesis).
    Flushing sub-``tiny`` results to zero restores the non-negativity
    invariant that the psi update and distance algebra rely on (a plain
    ``m < 0`` guard fails: XLA also flushes the subnormal inside the
    comparison, so it reads as -0.0 < 0 == False while the stored value
    stays negative). For every normal input this is a no-op, so reference
    parity is untouched. (Boundary note shared with np.mod: a tiny-but-
    normal negative x rounds to exactly p, hence the CLOSED upper end.)"""
    m = jnp.mod(x, period)
    tiny = jnp.finfo(jnp.result_type(m)).tiny
    return jnp.where(jnp.abs(m) < tiny, jnp.zeros_like(m), m)


def distance(x: jax.Array, y: jax.Array, period: float = PERIOD) -> jax.Array:
    """Riemannian distance on the torus: l2 norm of per-component shortest arcs.

    Reference: riemannian_optimizer.py:89-105 and main.py:12-23
    (``fast_riemannian_distance``).
    """
    diff = x - y
    wrapped = jnp.mod(diff + period / 2.0, period) - period / 2.0
    return jnp.linalg.norm(wrapped)


def signed_arc(x: jax.Array, y: jax.Array, period: float = PERIOD) -> jax.Array:
    """Per-component signed shortest arc from x to y, in [-period/2, period/2)."""
    return jnp.mod(y - x + period / 2.0, period) - period / 2.0


def exp_map(x: jax.Array, v: jax.Array, period: float = PERIOD) -> jax.Array:
    """Exponential map = addition + wrap. Reference: riemannian_optimizer.py:107-113."""
    return wrap(x + v, period)


def log_map(
    x: jax.Array, y: jax.Array, period: float = PERIOD, signed: bool = False
) -> jax.Array:
    """Log map from x to y.

    ``signed=False`` reproduces the reference exactly: ``wrap(y - x)`` in
    [0, period) (riemannian_optimizer.py:115-121) — NOT the signed shortest
    tangent. ``signed=True`` gives the geometrically correct signed arc.
    """
    if signed:
        return signed_arc(x, y, period)
    return wrap(y - x, period)


retraction = exp_map  # reference: riemannian_optimizer.py:123-129


def circular_mean(angles: jax.Array, period: float = PERIOD) -> jax.Array:
    """Karcher/circular mean per dimension over axis 0.

    Reference: riemannian_optimizer.py:26-51. This statistic is psum-shaped:
    the (cos, sin) sums reduce across agents with a single collective (see
    ``dqgp.parallel.consensus``).
    """
    phase = 2.0 * jnp.pi * angles / period
    cos_sum = jnp.sum(jnp.cos(phase), axis=0)
    sin_sum = jnp.sum(jnp.sin(phase), axis=0)
    return circular_mean_from_sums(cos_sum, sin_sum, period)


def circular_mean_from_sums(
    cos_sum: jax.Array, sin_sum: jax.Array, period: float = PERIOD
) -> jax.Array:
    """Finish a circular mean from pre-reduced (cos, sin) sums (psum output)."""
    mean_angle = jnp.arctan2(sin_sum, cos_sum) * period / (2.0 * jnp.pi)
    return jnp.mod(mean_angle, period)


def round4(x: jax.Array) -> jax.Array:
    """4-decimal quantization applied throughout the reference's ADMM loop.

    Reference: main.py:2407-2408,2460,2523,2551-2552 and
    agent_riemannian.py:438,485-486. Bit-level parity requires reproducing it;
    disable via the ``parity_round`` config knob in the driver.
    """
    return jnp.round(x, 4)


# Host-side numpy twins (driver bookkeeping; avoids per-primitive device
# dispatch for tiny one-off computations).


def np_circular_mean(angles: np.ndarray, period: float = PERIOD) -> np.ndarray:
    phase = 2.0 * np.pi * np.asarray(angles) / period
    return np.mod(
        np.arctan2(np.sum(np.sin(phase), axis=0), np.sum(np.cos(phase), axis=0))
        * period / (2.0 * np.pi),
        period,
    )


def np_distance(x: np.ndarray, y: np.ndarray, period: float = PERIOD) -> float:
    diff = np.asarray(x) - np.asarray(y)
    wrapped = np.mod(diff + period / 2.0, period) - period / 2.0
    return float(np.linalg.norm(wrapped))


# ---------------------------------------------------------------------------
# ADMM algebra (reference: riemannian_optimizer.py:285-399)
# ---------------------------------------------------------------------------


def admm_update_z(
    theta: jax.Array, psi: jax.Array, rho: float, period: float = PERIOD
) -> jax.Array:
    """Consensus update: circular mean of ``theta + psi/rho``.

    Reference: riemannian_optimizer.py:302-322.
    """
    xi = theta + psi / rho
    return circular_mean(xi, period)


def admm_update_theta(
    z: jax.Array,
    grad: jax.Array,
    psi: jax.Array,
    rho: float,
    L: float,
    period: float = PERIOD,
) -> jax.Array:
    """Proximal-linearized agent update: ``wrap(z - (grad + psi)/(rho + L))``.

    Reference: riemannian_optimizer.py:324-348. The reference's ``optimizer``
    argument is ignored there (load-bearing quirk), so the closed form IS the
    effective update.
    """
    return exp_map(z, -(grad + psi) / (rho + L), period)


def admm_update_psi(
    psi: jax.Array,
    theta: jax.Array,
    z: jax.Array,
    rho: float,
    period: float = PERIOD,
    signed_log: bool = False,
) -> jax.Array:
    """Dual update ``psi + rho * log_map(z, theta)``.

    Reference: riemannian_optimizer.py:350-368 (uses the unsigned wrapped
    log map — see module docstring).
    """
    return psi + rho * log_map(z, theta, period, signed=signed_log)


def admm_primal_residual(
    theta: jax.Array, z: jax.Array, period: float = PERIOD
) -> jax.Array:
    """Norm of per-agent Riemannian distances. Reference: riemannian_optimizer.py:370-386."""
    dists = jax.vmap(lambda t: distance(t, z, period))(theta)
    return jnp.linalg.norm(dists)


def admm_dual_residual(
    z_new: jax.Array, z_old: jax.Array, period: float = PERIOD
) -> jax.Array:
    """Riemannian distance between consecutive z. Reference: riemannian_optimizer.py:388-399."""
    return distance(z_new, z_old, period)


# ---------------------------------------------------------------------------
# Riemannian optimizers as functional (state, grad) -> (state, x) transforms
# (reference: riemannian_optimizer.py:149-282)
# ---------------------------------------------------------------------------


class OptState(NamedTuple):
    velocity: jax.Array
    prev_grad: jax.Array
    iteration: jax.Array  # int32 scalar


def opt_init(num_parameters: int) -> OptState:
    zeros = jnp.zeros((num_parameters,))
    return OptState(velocity=zeros, prev_grad=zeros, iteration=jnp.zeros((), jnp.int32))


def _clip_by_norm(g: jax.Array, max_norm: float) -> jax.Array:
    norm = jnp.linalg.norm(g)
    scale = jnp.where(norm > max_norm, max_norm / jnp.maximum(norm, 1e-30), 1.0)
    return g * scale


def _cap_step(direction: jax.Array, max_step: float) -> jax.Array:
    norm = jnp.linalg.norm(direction)
    scale = jnp.where(norm > max_step, max_step / jnp.maximum(norm, 1e-30), 1.0)
    return direction * scale


def opt_step(
    state: OptState,
    x: jax.Array,
    grad: jax.Array,
    *,
    method: Literal["gradient_descent", "momentum", "conjugate_gradient"],
    lr: float = 0.015,
    beta: float = 0.9,
    gradient_clip_norm: float = 1.0,
    max_step_size: float = 0.08,
    period: float = PERIOD,
) -> Tuple[OptState, jax.Array]:
    """One Riemannian optimizer step. Reference: riemannian_optimizer.py:180-282.

    ``method`` is static (selected at trace time) — the reference's methods are
    exposed for API parity; the ADMM training loop uses ``admm_update_theta``.
    """
    g = _clip_by_norm(grad, gradient_clip_norm)

    if method == "gradient_descent":
        direction = _cap_step(-lr * g, max_step_size)
        new_state = state._replace(iteration=state.iteration + 1)
        return new_state, exp_map(x, direction, period)

    if method == "momentum":
        velocity = _cap_step(beta * state.velocity - lr * g, max_step_size)
        new_state = OptState(velocity, state.prev_grad, state.iteration + 1)
        return new_state, exp_map(x, velocity, period)

    if method == "conjugate_gradient":
        # First iteration: plain gradient-descent step (reference :246-256).
        is_first = state.iteration == 0
        grad_diff = g - state.prev_grad
        beta_pr = jnp.dot(g, grad_diff) / (jnp.dot(state.prev_grad, state.prev_grad) + 1e-10)
        beta_pr = jnp.maximum(0.0, beta_pr)
        # Vector transport on the torus is identity (riemannian_optimizer.py:131-137).
        velocity = -g + beta_pr * state.velocity
        direction_cg = _cap_step(lr * velocity, max_step_size)
        direction_first = _cap_step(-lr * g, max_step_size)
        direction = jnp.where(is_first, direction_first, direction_cg)
        velocity = jnp.where(is_first, state.velocity, velocity)
        new_state = OptState(velocity, g, state.iteration + 1)
        return new_state, exp_map(x, direction, period)

    raise ValueError(f"Unknown method: {method}")


# ---------------------------------------------------------------------------
# Class API mirroring the reference's public surface
# ---------------------------------------------------------------------------


class TorusManifold:
    """Torus (S^1)^P with period pi. Reference: riemannian_optimizer.py:53-146."""

    def __init__(self, dimension: int, period: float = PERIOD):
        self.dim = dimension
        self.period = period
        self.name = f"Torus S^1 x ... x S^1 ({dimension}D, period={period:.3f})"

    def wrap_to_manifold(self, x):
        return wrap(jnp.asarray(x), self.period)

    def random_point(self, key: Optional[jax.Array] = None):
        if key is None:
            key = jax.random.PRNGKey(np.random.randint(0, 2**31 - 1))
        return jax.random.uniform(key, (self.dim,), minval=0.0, maxval=self.period)

    def distance(self, x, y):
        return distance(jnp.asarray(x), jnp.asarray(y), self.period)

    def exp_map(self, x, v):
        return exp_map(jnp.asarray(x), jnp.asarray(v), self.period)

    def log_map(self, x, y, signed: bool = False):
        return log_map(jnp.asarray(x), jnp.asarray(y), self.period, signed=signed)

    def retraction(self, x, v):
        return self.exp_map(x, v)

    def vector_transport(self, x, v, d):
        return v  # identity on the torus (riemannian_optimizer.py:131-137)

    def riemannian_gradient(self, x, euclidean_grad):
        return euclidean_grad  # induced metric (riemannian_optimizer.py:139-146)


class RiemannianOptimizer:
    """Stateful wrapper over ``opt_step``. Reference: riemannian_optimizer.py:149-282."""

    def __init__(
        self,
        manifold: TorusManifold,
        learning_rate: float = 0.015,
        method: str = "gradient_descent",
        beta: float = 0.9,
        gradient_clip_norm: float = 1.0,
        max_step_size: float = 0.08,
    ):
        self.manifold = manifold
        self.lr = learning_rate
        self.method = method
        self.beta = beta
        self.gradient_clip_norm = gradient_clip_norm
        self.max_step_size = max_step_size
        self.state = opt_init(manifold.dim)

    def step(self, x, grad):
        self.state, x_new = opt_step(
            self.state,
            jnp.asarray(x),
            jnp.asarray(grad),
            method=self.method,  # type: ignore[arg-type]
            lr=self.lr,
            beta=self.beta,
            gradient_clip_norm=self.gradient_clip_norm,
            max_step_size=self.max_step_size,
            period=self.manifold.period,
        )
        return x_new


class RiemannianADMM:
    """Stateless ADMM update rules. Reference: riemannian_optimizer.py:285-399."""

    def __init__(self, manifold: TorusManifold, rho: float = 1.0, signed_log: bool = False):
        self.manifold = manifold
        self.rho = rho
        self.signed_log = signed_log
        self.iteration = 0

    def update_z(self, theta, psi):
        return admm_update_z(jnp.asarray(theta), jnp.asarray(psi), self.rho, self.manifold.period)

    def update_theta(self, z, grad, psi, L, optimizer=None):
        # ``optimizer`` accepted-and-ignored for reference API parity
        # (riemannian_optimizer.py:324-348 ignores it too).
        return admm_update_theta(
            jnp.asarray(z), jnp.asarray(grad), jnp.asarray(psi), self.rho, L, self.manifold.period
        )

    def update_psi(self, psi, theta, z):
        return admm_update_psi(
            jnp.asarray(psi), jnp.asarray(theta), jnp.asarray(z), self.rho,
            self.manifold.period, signed_log=self.signed_log,
        )

    def compute_primal_residual(self, theta, z):
        return admm_primal_residual(jnp.asarray(theta), jnp.asarray(z), self.manifold.period)

    def compute_dual_residual(self, z_new, z_old):
        return admm_dual_residual(jnp.asarray(z_new), jnp.asarray(z_old), self.manifold.period)


def create_riemannian_framework(
    num_parameters: int,
    learning_rate: float = 0.01,
    rho: float = 1.0,
    method: str = "gradient_descent",
    gradient_clip_norm: float = 1.0,
    max_step_size: float = 0.1,
) -> Tuple[TorusManifold, RiemannianOptimizer, RiemannianADMM]:
    """Factory mirroring the reference. Reference: riemannian_optimizer.py:402-428."""
    manifold = TorusManifold(num_parameters)
    optimizer = RiemannianOptimizer(
        manifold, learning_rate, method,
        gradient_clip_norm=gradient_clip_norm, max_step_size=max_step_size,
    )
    admm = RiemannianADMM(manifold, rho)
    return manifold, optimizer, admm
