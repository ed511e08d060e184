"""Large virtual meshes (16/32 devices) with uneven shapes (VERDICT r5 #6).

The session-wide conftest pins an 8-device CPU mesh before jax initializes,
so each case re-execs a child interpreter with its own
``--xla_force_host_platform_device_count``. Children assert mesh-size
INVARIANCE: the sharded trajectory must equal the single-device (vmap) one —
the sharding is an execution layout, never a numerics change.

Covered unevenness:
* agents not divisible by the device count (driver shrinks the mesh,
  driver.py:342) with RAGGED per-agent shard sizes (pad+mask),
* a 2-D agents x data mesh whose per-agent padded size does not divide the
  data columns evenly (training2d pads to the column multiple),
* the distributed Gram-free Cholesky with n_real not divisible by
  block x devices (pad_rows_for_distributed + n_real masking) at 32 devices.
"""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_child(n_devices: int, body: str, timeout: int = 900):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    prelude = textwrap.dedent("""
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import numpy as np
        import jax.numpy as jnp
    """)
    proc = subprocess.run(
        [sys.executable, "-c", prelude + textwrap.dedent(body)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=timeout,
    )
    if proc.returncode != 0:
        raise AssertionError(
            f"child (devices={n_devices}) failed:\n{proc.stdout[-2000:]}\n"
            f"{proc.stderr[-4000:]}"
        )
    assert "CHILD_OK" in proc.stdout, proc.stdout[-2000:]


@pytest.mark.slow
def test_16dev_uneven_agents_ragged_shards():
    """12 agents on a 16-device request: the driver shrinks the agents mesh
    to 12 (one agent per device); random partition gives ragged per-agent
    sizes. f64 trajectory must equal the 1-device vmap run exactly."""
    _run_child(16, """
        assert len(jax.devices()) == 16
        from dqgp.data import split_data_numpy
        from dqgp.driver import TrainConfig, train
        from dqgp.models.circuits import build_circuit
        from dqgp.models.kernels import QuantumKernelSpec

        spec = QuantumKernelSpec(
            circuit=build_circuit("hubregtsen", 2, 2, 1),
            kernel_type="projected", outer_kernel="gaussian")
        rng = np.random.RandomState(0)
        X = rng.uniform(-0.9, 0.9, (130, 2))  # 130 over 12 agents: ragged
        Y = np.sin(2 * X[:, 0]) + 0.1 * rng.randn(130)
        splits = split_data_numpy(X, Y, 12, "random", random_seed=3)
        sizes = {len(s[0]) for s in splits}
        assert len(sizes) > 1, f"shards unexpectedly uniform: {sizes}"

        base = dict(max_iter=3, verbose=False, compute_cond=False,
                    gp_dtype="float64", cv_dtype="float64")
        a = train(spec, splits, X, Y, TrainConfig(**base))
        b = train(spec, splits, X, Y, TrainConfig(n_mesh_devices=1, **base))
        np.testing.assert_array_equal(np.asarray(a.z), np.asarray(b.z))
        np.testing.assert_array_equal(np.asarray(a.theta), np.asarray(b.theta))
        nla = [r["total_nll"] for r in a.nll_history]
        nlb = [r["total_nll"] for r in b.nll_history]
        # the f32 feature pipeline compiles differently under shard_map vs
        # vmap (XLA fusion), so NLL agrees to f32 grade, not bitwise — the
        # quantized trajectory (z/theta above) is still exactly equal
        np.testing.assert_allclose(nla, nlb, rtol=1e-5)
        print("CHILD_OK")
    """)


@pytest.mark.slow
def test_32dev_2d_mesh_ragged_per_agent_shards():
    """8 agents x 4 data columns on 32 devices with ragged per-agent shard
    sizes (sizes not divisible by 4 either): the 2-D sharded trajectory must
    equal the single-device run."""
    _run_child(32, """
        assert len(jax.devices()) == 32
        from dqgp.data import split_data_numpy
        from dqgp.driver import TrainConfig, train
        from dqgp.models.circuits import build_circuit
        from dqgp.models.kernels import QuantumKernelSpec

        spec = QuantumKernelSpec(
            circuit=build_circuit("hubregtsen", 2, 2, 1),
            kernel_type="projected", outer_kernel="gaussian")
        rng = np.random.RandomState(1)
        X = rng.uniform(-0.9, 0.9, (110, 2))  # 110 over 8 agents: ragged,
        Y = np.sin(2 * X[:, 0]) + 0.1 * rng.randn(110)  # max shard 14 (!%4)
        splits = split_data_numpy(X, Y, 8, "random", random_seed=5)

        base = dict(max_iter=3, verbose=False, compute_cond=False,
                    gp_dtype="float64", cv_dtype="float64")
        a = train(spec, splits, X, Y,
                  TrainConfig(data_mesh_cols=4, **base))
        b = train(spec, splits, X, Y, TrainConfig(n_mesh_devices=1, **base))
        np.testing.assert_array_equal(np.asarray(a.z), np.asarray(b.z))
        np.testing.assert_array_equal(np.asarray(a.theta), np.asarray(b.theta))
        print("CHILD_OK")
    """)


@pytest.mark.slow
def test_32dev_distributed_cholesky_ragged_blocks():
    """Distributed Gram-free Cholesky at 32 devices with n_real=300 (pads to
    block*32=512): must match the dense f64 NLL oracle exactly."""
    _run_child(32, """
        assert len(jax.devices()) == 32
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        from dqgp.models.circuits import build_circuit
        from dqgp.models.gp.posterior import masked_nll_and_grad
        from dqgp.models.kernels import QuantumKernelSpec
        from dqgp.models.kernels.quantum_kernel import (
            gram_from_features, kernel_features)
        from dqgp.parallel.blocked import (
            make_distributed_cholesky_nll, pad_rows_for_distributed)

        spec = QuantumKernelSpec(
            circuit=build_circuit("hubregtsen", 2, 2, 1),
            kernel_type="projected", outer_kernel="gaussian")
        rng = np.random.RandomState(2)
        N, block, n_dev = 300, 16, 32
        X = jnp.asarray(rng.uniform(-0.9, 0.9, (N, 2)), jnp.float32)
        theta = jnp.asarray(rng.uniform(0, np.pi, spec.num_parameters),
                            jnp.float32)
        F = np.asarray(kernel_features(spec, X, theta), np.float64)
        Y = np.sin(np.asarray(X)[:, 0]) + 0.05 * rng.randn(N)

        Fp, yp, n_total, n_real = pad_rows_for_distributed(F, Y, block, n_dev)
        assert (n_total, n_real) == (512, 300)
        mesh = Mesh(np.array(jax.devices()), ("data",))
        fn = make_distributed_cholesky_nll(
            spec, mesh, noise_std=0.1, n_total=n_total, block=block,
            dtype=jnp.float64, n_real=n_real)
        shard = NamedSharding(mesh, P("data"))
        nll, ld, quad, const = fn(jax.device_put(jnp.asarray(Fp), shard),
                                  jax.device_put(jnp.asarray(yp), shard))

        K = np.asarray(gram_from_features(spec, jnp.asarray(F)), np.float64)
        ref = masked_nll_and_grad(jnp.asarray(K), jnp.zeros((0, N, N)),
                                  jnp.asarray(Y), jnp.ones(N), 0.1,
                                  compute_cond=False)
        assert np.isclose(float(nll), float(ref.nll), rtol=1e-10)
        assert np.isclose(float(ld), float(ref.log_det_term), rtol=1e-10)
        assert np.isclose(float(quad), float(ref.quadratic_term), rtol=1e-9)
        print("CHILD_OK")
    """)
