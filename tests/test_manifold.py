"""Unit tests for torus manifold ops and ADMM algebra vs numpy oracles
re-implementing the reference formulas (riemannian_optimizer.py)."""

import numpy as np
import jax.numpy as jnp
import pytest

from dqgp import manifold as M


def ref_circular_mean(angles, period=np.pi):
    cos_sum = np.sum(np.cos(2 * np.pi * angles / period), axis=0)
    sin_sum = np.sum(np.sin(2 * np.pi * angles / period), axis=0)
    mean = np.arctan2(sin_sum, cos_sum) * period / (2 * np.pi)
    return np.mod(mean, period)


def test_wrap_and_distance():
    x = jnp.array([0.1, 3.0, -0.2])
    assert np.allclose(M.wrap(x), np.mod(np.array(x), np.pi))
    # shortest arc: distance between 0.01 and pi-0.01 is 0.02 per component
    a = jnp.array([0.01])
    b = jnp.array([np.pi - 0.01])
    assert np.isclose(float(M.distance(a, b)), 0.02, atol=1e-6)


def test_log_map_parity_vs_signed():
    x = jnp.array([0.1])
    y = jnp.array([0.05])
    # reference (unsigned) log map wraps y-x into [0, pi)
    unsigned = float(M.log_map(x, y)[0])
    assert np.isclose(unsigned, np.mod(0.05 - 0.1, np.pi))
    signed = float(M.log_map(x, y, signed=True)[0])
    assert np.isclose(signed, -0.05, atol=1e-7)


def test_circular_mean_matches_reference():
    rng = np.random.RandomState(0)
    angles = rng.uniform(0, np.pi, size=(5, 7))
    got = np.asarray(M.circular_mean(jnp.asarray(angles)))
    want = ref_circular_mean(angles)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_admm_updates_match_reference_formulas():
    rng = np.random.RandomState(1)
    n_agents, P = 4, 6
    theta = rng.uniform(0, np.pi, (n_agents, P))
    psi = rng.uniform(0, 1, (n_agents, P))
    rho, L = 100.0, 100.0

    z = np.asarray(M.admm_update_z(jnp.asarray(theta), jnp.asarray(psi), rho))
    want_z = ref_circular_mean(theta + psi / rho)
    np.testing.assert_allclose(z, want_z, atol=1e-6)

    grad = rng.randn(P)
    th_new = np.asarray(M.admm_update_theta(jnp.asarray(z), jnp.asarray(grad), jnp.asarray(psi[0]), rho, L))
    want_th = np.mod(z - (grad + psi[0]) / (rho + L), np.pi)
    np.testing.assert_allclose(th_new, want_th, atol=1e-6)

    psi_new = np.asarray(M.admm_update_psi(jnp.asarray(psi[0]), jnp.asarray(th_new), jnp.asarray(z), rho))
    want_psi = psi[0] + rho * np.mod(th_new - z, np.pi)
    np.testing.assert_allclose(psi_new, want_psi, atol=1e-5)


def test_class_api_surface():
    man, opt, admm = M.create_riemannian_framework(4, rho=100.0)
    assert man.dim == 4
    theta = jnp.ones((3, 4)) * 0.5
    psi = jnp.zeros((3, 4))
    z = admm.update_z(theta, psi)
    np.testing.assert_allclose(np.asarray(z), 0.5, atol=1e-6)
    # optimizer methods run and stay on the manifold
    for method in ("gradient_descent", "momentum", "conjugate_gradient"):
        o = M.RiemannianOptimizer(man, method=method)
        x = jnp.array([0.1, 0.2, 3.0, 1.0])
        g = jnp.array([1.0, -1.0, 0.5, 0.0])
        for _ in range(3):
            x = o.step(x, g)
        assert np.all(np.asarray(x) >= 0) and np.all(np.asarray(x) < np.pi)


def test_optimizer_step_size_cap():
    man = M.TorusManifold(3)
    o = M.RiemannianOptimizer(man, learning_rate=10.0, method="gradient_descent",
                              gradient_clip_norm=100.0, max_step_size=0.05)
    x = jnp.zeros(3)
    x2 = o.step(x, jnp.array([1.0, 1.0, 1.0]))
    step = np.asarray(M.signed_arc(x, x2))
    assert np.isclose(np.linalg.norm(step), 0.05, atol=1e-5)
