#!/usr/bin/env python
"""BASELINE config #7 TRAINING (beyond the reference's reach): multi-agent
ADMM at scale via streamed gradients and an agents x data 2-D mesh.

The reference's per-agent gradient materializes 2P+1 dense Grams at once —
(2P+1) * N_i^2 floats (26 GB f32 at P=65, N_i=5000), so it cannot train
large shards at all. Here the shifted Grams stream one parameter at a time
against the solve bracket (O(N^2) live memory), and on a multi-device mesh
each agent's Gram panels are row-sharded over a ``data`` axis.

Single chip (streamed gradients, one agent block):
    python examples/scale_out_training.py --n-per-agent 4000 --agents 2

Virtual 8-device 2-D mesh (4 agent rows x 2 data columns):
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
    python examples/scale_out_training.py --mesh 4x2 --agents 8 \
        --n-per-agent 256 --qubits 6 --iters 3
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--n-per-agent", type=int, default=2048)
    ap.add_argument("--qubits", type=int, default=10)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--gp-dtype", type=str, default="auto",
                    choices=["auto", "float64", "mixed", "float32"],
                    help="auto = float64; mixed = f64-grade via f32 "
                         "factor + f64 refinement")
    ap.add_argument("--mesh", type=str, default=None,
                    help="AxD agent-rows x data-cols 2-D mesh, e.g. 4x2")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from dqgp.data import split_data_numpy
    from dqgp.driver import init_admm_state
    from dqgp.models.circuits import build_circuit
    from dqgp.models.kernels import QuantumKernelSpec
    from dqgp.parallel import (
        agents_data_mesh, make_admm_step, make_admm_step_2d,
        make_agent_batch, shard_batch_to_mesh_2d,
    )

    spec = QuantumKernelSpec(
        circuit=build_circuit("chebyshev", args.qubits, 2, args.layers),
        kernel_type="projected",
        outer_kernel="matern",
    )
    P = spec.num_parameters
    n = args.agents * args.n_per_agent
    dense_gb = (2 * P + 1) * args.n_per_agent**2 * 4 / 1e9
    print(f"N={n} ({args.agents} agents x {args.n_per_agent}), "
          f"{args.qubits} qubits, P={P}")
    print(f"dense dK per agent would be {dense_gb:.1f} GB; "
          f"streamed working set ~{2 * args.n_per_agent**2 * 8 / 1e9:.2f} GB")

    rng = np.random.RandomState(0)
    X = rng.uniform(-0.99, 0.99, (n, 2))
    Y = np.sin(3 * X[:, 0]) * np.cos(2 * X[:, 1]) + 0.1 * rng.randn(n)
    splits = split_data_numpy(X, Y, args.agents, "regional")
    # round per-agent padding up so the row axis divides by the data columns
    cols = int(args.mesh.split("x")[1]) if args.mesh else 1
    n_max = max(x.shape[0] for x, _ in splits)
    batch = make_agent_batch(splits, pad_to=((n_max + cols - 1) // cols) * cols)
    theta, psi, _ = init_admm_state(args.agents, P, 42, 100.0)
    theta, psi = jnp.asarray(theta), jnp.asarray(psi)

    from dqgp.config import resolve_dtype_mode

    gp_dtype = resolve_dtype_mode(args.gp_dtype)
    if args.mesh:
        rows, cols = map(int, args.mesh.split("x"))
        mesh = agents_data_mesh(rows, cols)
        batch, theta, psi = shard_batch_to_mesh_2d(batch, theta, psi, mesh)
        step = make_admm_step_2d(
            spec, mesh, rho=100.0, L=100.0, noise_std=0.1, compute_cond=False,
            gp_dtype=gp_dtype,
        )
        print(f"mesh: {rows} agent rows x {cols} data cols, gp_dtype={gp_dtype}")
    else:
        step = make_admm_step(
            spec, None, rho=100.0, L=100.0, noise_std=0.1,
            compute_cond=False, grad_method="streamed", gp_dtype=gp_dtype,
        )
        print(f"single device, grad_method='streamed', gp_dtype={gp_dtype}")

    # NB: the per-iteration NLL fetch is INSIDE the timed region; it is the
    # completion barrier of each step.
    def run_one(theta, psi):
        t0 = time.time()
        out = step(theta, psi, batch)
        nll_mean = float(np.mean(np.asarray(out.nll)))
        return out, nll_mean, time.time() - t0

    out, nll_mean, dt = run_one(theta, psi)
    print(f"iteration 1 (incl. compile): {dt:.1f} s, mean agent NLL {nll_mean:.3f}")
    for i in range(1, args.iters):
        out, nll_mean, dt = run_one(out.theta, out.psi)
        print(f"iteration {i + 1}: {dt:.2f} s, mean agent NLL {nll_mean:.3f}")
    assert np.all(np.isfinite(np.asarray(out.z)))
    print("z[:6] =", np.round(np.asarray(out.z[:6]), 4))


if __name__ == "__main__":
    main()
