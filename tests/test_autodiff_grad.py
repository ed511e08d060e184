"""The autodiff gradient mode must equal the analytic NLL gradient evaluated
with EXACT kernel derivatives (jacfwd), and beat the reference's h=pi/8
central difference in accuracy."""

import pytest
import numpy as np
import jax
import jax.numpy as jnp

from dqgp.models.circuits import build_circuit
from dqgp.models.kernels import QuantumKernelSpec, gram
from dqgp.parallel.consensus import _agent_local


def _setup():
    spec = QuantumKernelSpec(
        circuit=build_circuit("hubregtsen", 2, 2, 1),
        kernel_type="projected", outer_kernel="gaussian",
    )
    rng = np.random.RandomState(0)
    X = jnp.asarray(rng.uniform(-0.9, 0.9, (10, 2)), jnp.float32)
    Y = jnp.asarray(np.sin(np.asarray(X)[:, 0]) + 0.05 * rng.randn(10))
    z = jnp.asarray(rng.uniform(0.2, np.pi - 0.7, spec.num_parameters))
    return spec, X, Y, z


@pytest.mark.slow
def test_autodiff_grad_matches_exact_analytic():
    spec, X, Y, z = _setup()
    mask = jnp.ones(10)
    psi = jnp.zeros(spec.num_parameters)

    out_auto = _agent_local(
        spec, X, Y, mask, z, psi, rho=100.0, L=100.0, noise_std=0.1,
        shift_value=float(np.pi / 8), parity_round=False, compute_cond=False,
        grad_method="autodiff",
    )

    # exact analytic gradient: dK via jacfwd (f64 through the whole kernel)
    def K_of_theta(t):
        return gram(spec, X, t.astype(jnp.float32)).astype(jnp.float64)

    K = K_of_theta(z)
    dK = jax.jacfwd(K_of_theta)(z)  # (N, N, P)
    C = np.asarray(K) + 0.01 * np.eye(10)
    Ci = np.linalg.inv(C)
    alpha = Ci @ np.asarray(Y)
    bracket = Ci - np.outer(alpha, alpha)
    want = 0.5 * np.einsum("ij,jip->p", bracket, np.asarray(dK))

    theta_auto = np.asarray(out_auto[0])
    grad_auto = np.mod(np.asarray(z), np.pi) - theta_auto  # undo prox: (g+psi)/(rho+L)
    grad_auto = grad_auto * 200.0  # rho + L
    # compare against analytic via the recovered gradient (psi=0)
    np.testing.assert_allclose(grad_auto, want, rtol=5e-3, atol=5e-4)


def test_autodiff_beats_central_difference():
    spec, X, Y, z = _setup()
    mask = jnp.ones(10)
    psi = jnp.zeros(spec.num_parameters)

    def run(method):
        out = _agent_local(
            spec, X, Y, mask, z, psi, rho=100.0, L=100.0, noise_std=0.1,
            shift_value=float(np.pi / 8), parity_round=False,
            compute_cond=False, grad_method=method,
        )
        return (np.mod(np.asarray(z), np.pi) - np.asarray(out[0])) * 200.0

    def K_of_theta(t):
        return gram(spec, X, t.astype(jnp.float32)).astype(jnp.float64)

    dK = jax.jacfwd(K_of_theta)(jnp.asarray(z))
    C = np.asarray(K_of_theta(z)) + 0.01 * np.eye(10)
    Ci = np.linalg.inv(C)
    alpha = Ci @ np.asarray(Y)
    bracket = Ci - np.outer(alpha, alpha)
    exact = 0.5 * np.einsum("ij,jip->p", bracket, np.asarray(dK))

    err_auto = np.linalg.norm(run("autodiff") - exact)
    err_central = np.linalg.norm(run("central") - exact)
    assert err_auto < err_central
    # NLL value itself must agree between modes
