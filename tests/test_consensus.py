"""Multi-agent ADMM step: single-device vmap path vs 8-device CPU mesh
(shard_map + psum) must agree exactly; semantics vs a per-agent oracle."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dqgp import manifold as M
from dqgp.models.circuits import build_circuit
from dqgp.models.gp.posterior import masked_nll_and_grad
from dqgp.models.kernels import QuantumKernelSpec, gram_and_shift_grads
from dqgp.parallel import (
    agents_mesh,
    make_admm_step,
    make_agent_batch,
)
from dqgp.parallel.consensus import shard_batch_to_mesh


def _setup(n_agents=8, n_per=6, seed=0):
    spec = QuantumKernelSpec(
        circuit=build_circuit("hubregtsen", 2, 2, 1),
        kernel_type="projected", outer_kernel="gaussian",
    )
    rng = np.random.RandomState(seed)
    splits = []
    for i in range(n_agents):
        ni = n_per - (i % 2)  # ragged shards on purpose
        X = rng.uniform(-0.9, 0.9, (ni, 2))
        Y = np.sin(X[:, 0]) + 0.1 * rng.randn(ni)
        splits.append((X, Y))
    batch = make_agent_batch(splits)
    P_ = spec.num_parameters
    theta = np.round(rng.rand(n_agents, P_), 4)
    psi = np.round(rng.rand(n_agents, P_), 4)
    return spec, batch, jnp.asarray(theta), jnp.asarray(psi), splits


@pytest.mark.slow
def test_single_device_step_matches_oracle():
    spec, batch, theta, psi, splits = _setup(n_agents=4)
    rho = L = 100.0
    step = make_admm_step(spec, None, rho=rho, L=L, noise_std=0.1)
    out = step(theta, psi, batch)

    # oracle: reference-order updates per agent
    z_want = np.round(np.asarray(M.admm_update_z(theta, psi, rho)), 4)
    np.testing.assert_allclose(np.asarray(out.z), z_want, atol=1e-12)

    for i, (X, Y) in enumerate(splits):
        K, dK = gram_and_shift_grads(
            spec, jnp.asarray(X, jnp.float32), jnp.asarray(np.mod(z_want, np.pi), jnp.float32)
        )
        res = masked_nll_and_grad(
            jnp.asarray(K, jnp.float64), jnp.asarray(dK, jnp.float64),
            jnp.asarray(Y), jnp.ones(len(Y)), 0.1,
        )
        grad4 = np.round(np.asarray(res.grad), 4)
        th_want = np.round(np.mod(z_want - (grad4 + np.asarray(psi[i])) / (rho + L), np.pi), 4)
        psi_want = np.round(np.asarray(psi[i]) + rho * np.mod(th_want - z_want, np.pi), 4)
        np.testing.assert_allclose(np.asarray(out.theta[i]), th_want, atol=2e-4)
        np.testing.assert_allclose(np.asarray(out.psi[i]), psi_want, atol=2e-2)
        # padded-vs-unpadded f32 Gram accumulation order differs slightly;
        # the solve amplifies it by the condition number
        assert np.isclose(float(out.nll[i]), float(res.nll), rtol=1e-3)


@pytest.mark.parametrize("n_devices", [2, 8])
def test_mesh_step_matches_single_device(n_devices):
    if len(jax.devices()) < n_devices:
        pytest.skip("not enough virtual devices")
    spec, batch, theta, psi, _ = _setup(n_agents=8)
    rho = L = 100.0
    step1 = make_admm_step(spec, None, rho=rho, L=L, noise_std=0.1, compute_cond=False)
    out1 = step1(theta, psi, batch)

    mesh = agents_mesh(n_devices)
    stepN = make_admm_step(spec, mesh, rho=rho, L=L, noise_std=0.1, compute_cond=False)
    batch_s, theta_s, psi_s = shard_batch_to_mesh(batch, theta, psi, mesh)
    outN = stepN(theta_s, psi_s, batch_s)

    np.testing.assert_allclose(np.asarray(outN.z), np.asarray(out1.z), atol=1e-9)
    np.testing.assert_allclose(np.asarray(outN.theta), np.asarray(out1.theta), atol=1e-9)
    np.testing.assert_allclose(np.asarray(outN.psi), np.asarray(out1.psi), atol=1e-9)
    np.testing.assert_allclose(np.asarray(outN.nll), np.asarray(out1.nll), rtol=1e-8)


def test_iterations_reduce_consensus_gap():
    spec, batch, theta, psi, _ = _setup(n_agents=4)
    step = make_admm_step(spec, None, rho=100.0, L=100.0, noise_std=0.1,
                          compute_cond=False)
    gaps = []
    for _ in range(8):
        out = step(theta, psi, batch)
        theta, psi = out.theta, out.psi
        gaps.append(float(jnp.max(jnp.linalg.norm(out.z - theta, axis=1))))
    # the reference's unsigned log_map kicks the duals on the first round
    # (SURVEY.md §2.8 quirk 2); after that the gap contracts geometrically
    assert gaps[-1] < 0.1 * gaps[1]
