#!/usr/bin/env python
"""Smoke run of the system's main path on one GPU, checked against the plain
references.

    python chip_smoke.py               # one card: phases 1-6 below
    python chip_smoke.py --four-cards  # four cards: the multi-device path only

Phases (one process; any failure propagates and the exit code is non-zero):

1. device — JAX must see GPU devices, else exit before anything else runs;
2. engine — projected XYZ features + matern Gram (chebyshev 4q/3L, N=1000)
   and the fidelity Gram |Psi Psi^H|^2 (kyriienko 6q, N=1000), computed on
   the card in f32/complex64, against the complex128/f64 engine on the CPU;
3. ADMM trajectory — 5 f64-GP iterations at the north star on the card vs
   the same program on the CPU (max |dz| and f64 CV-NLPD);
4. trainer — ``driver.train`` for 10 iterations with default settings, then
   predict/evaluate on held-out points, and the matrix-free CG predictor at
   N=8192 against the dense f64 posterior (to 1e-6: CG stops at a 1e-12
   residual);
5. CLI — ``dqgp.cli.main`` in-process at BASELINE config #1;
6. last line — ``{"ok": true, "device": {...}}``.

``--four-cards`` instead runs ``driver.train`` on a 4-device agents mesh
against the one-device run, one step on a 2x2 agents x data mesh against the
1-D step, and the distributed Cholesky NLL and sharded CG posterior over a
4-device data mesh at N=8192 against dense f64 (NLL to 1e-8, the CG
posterior to 1e-6).

f32 products stay at the package's ``jax_default_matmul_precision=highest``
(no TF32). Times printed here are smoke readings, not benchmarks.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

N_NORTH = 1000          # north star: SRTM-1000-shaped, 4 agents
N_AGENTS = 4
RHO = L_CONST = 100.0
NOISE_STD = 0.1
ENGINE_ATOL, ENGINE_RTOL = 2e-5, 2e-4   # bench.py's engine-equality bar
Z_TOL, NLPD_TOL = 5e-3, 0.05            # bench.py's parity-gate bars
N_LARGE = 8192                          # CG / distributed-NLL size
LARGE_RTOL = 1e-8   # exact (Cholesky) NLL vs dense f64
# CG posteriors stop at a relative residual of CG_TOL; the forward error is
# up to cond(K + s^2 I) (~1e6 at N=8192) times that, and the variance
# k_ss - k_st C^-1 k_ts cancels ~2 more digits.
CG_TOL, CG_RTOL = 1e-12, 1e-6


def card_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


# ---------------------------------------------------------------------------
# problems
# ---------------------------------------------------------------------------


def north_star_spec():
    from dqgp.models.circuits import build_circuit
    from dqgp.models.kernels import QuantumKernelSpec

    return QuantumKernelSpec(circuit=build_circuit("chebyshev", 4, 2, 3),
                             kernel_type="projected", outer_kernel="matern")


def fidelity_spec():
    from dqgp.models.circuits import build_circuit
    from dqgp.models.kernels import QuantumKernelSpec

    return QuantumKernelSpec(circuit=build_circuit("kyriienko", 6, 2, 2),
                             kernel_type="fidelity")


def north_star_data(n: int, seed: int = 0):
    """bench.py's north-star stand-in: chebyshev-range 2-D inputs."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(-0.99, 0.99, (n, 2))
    Y = np.sin(3 * X[:, 0]) * np.cos(2 * X[:, 1]) + 0.1 * rng.randn(n)
    return X, Y


def _max_dev(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bad = np.abs(got - want) > ENGINE_ATOL + ENGINE_RTOL * np.abs(want)
    return float(np.max(np.abs(got - want))), int(bad.sum())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(count: int = 1):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU; JAX found {devs[0].platform!r} "
                         f"devices")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found {len(devs)}")
    print(f"device_kind: {devs[0].device_kind} (x{len(devs)})")
    print(f"jax {jax.__version__}")
    print(f"nvidia-smi: {card_name_power()}")
    return devs


def phase_engine(n: int = N_NORTH, device=None, seed: int = 1):
    """Engine vs the complex128/f64 reference on the CPU device. Returns the
    max deviations per quantity."""
    import jax
    import jax.numpy as jnp

    from dqgp.models.kernels.quantum_kernel import (
        gram_from_features,
        kernel_features,
    )

    cpu = jax.devices("cpu")[0]
    device = device or jax.devices()[0]
    rng = np.random.RandomState(seed)
    out = {}
    for name, spec in (("projected", north_star_spec()),
                       ("fidelity", fidelity_spec())):
        X = rng.uniform(-0.99, 0.99, (n, spec.circuit.num_features))
        theta = rng.uniform(0, np.pi, spec.num_parameters)

        @jax.jit
        def engine(X, theta, spec=spec):
            F = kernel_features(spec, X, theta)
            return F, gram_from_features(spec, F)

        F, K = engine(jax.device_put(jnp.asarray(X, jnp.float32), device),
                      jax.device_put(jnp.asarray(theta, jnp.float32), device))
        with jax.default_device(cpu):
            F64 = kernel_features(spec, jnp.asarray(X), jnp.asarray(theta),
                                  dtype=jnp.float64)
            K64 = gram_from_features(spec, F64)
        if name == "projected":
            out["features"] = _max_dev(F, F64)
        out[f"{name}_gram"] = _max_dev(K, K64)
    for k, (dev, nbad) in out.items():
        print(f"engine {k}: max|dev| {dev:.3e} ({nbad} entries beyond atol "
              f"{ENGINE_ATOL:g} + rtol {ENGINE_RTOL:g}; f32 at matmul "
              f"precision 'highest', no TF32)")
        if nbad:
            raise AssertionError(f"engine {k} deviates from the f64 reference")
    return out


def _trajectory(spec, splits, iters, device):
    import jax
    import jax.numpy as jnp

    from dqgp.driver import init_admm_state
    from dqgp.parallel import make_admm_step, make_agent_batch

    with jax.default_device(device):
        batch = make_agent_batch(splits)
        theta, psi, _ = init_admm_state(len(splits), spec.num_parameters, 42,
                                        RHO)
        theta, psi = jnp.asarray(theta), jnp.asarray(psi)
        step = make_admm_step(spec, None, rho=RHO, L=L_CONST,
                              noise_std=NOISE_STD, gp_dtype="float64",
                              psd_fallback=True, compute_cond=False)
        zs = []
        for _ in range(iters):
            out = step(theta, psi, batch)
            theta, psi = out.theta, out.psi
            zs.append(np.asarray(out.z, np.float64))
    return np.stack(zs)


def phase_trajectory(n: int = N_NORTH, iters: int = 5, device=None):
    """ADMM z trajectory on the card vs the same program on the CPU."""
    import jax

    from dqgp.data import split_data_numpy
    from dqgp.models.gp.cv import k_fold_cross_validation_consensus

    cpu = jax.devices("cpu")[0]
    device = device or jax.devices()[0]
    spec = north_star_spec()
    X, Y = north_star_data(n)
    splits = split_data_numpy(X, Y, N_AGENTS, "regional")
    z_dev = _trajectory(spec, splits, iters, device)
    z_cpu = _trajectory(spec, splits, iters, cpu)
    dz = float(np.max(np.abs(z_dev - z_cpu)))
    flips = int(np.sum(np.any(np.round(z_dev, 4) != np.round(z_cpu, 4), axis=1)))
    nlpd = {}
    for name, z, d in (("device", z_dev[-1], device), ("cpu", z_cpu[-1], cpu)):
        with jax.default_device(d):
            nlpd[name] = k_fold_cross_validation_consensus(
                spec, X, Y, z, NOISE_STD, k_folds=5, random_seed=42,
                cv_dtype="float64")["mean_nlpd"]
    dn = abs(nlpd["device"] - nlpd["cpu"])
    print(f"ADMM {iters} iters vs CPU f64: max|dz| {dz:.3e} (<= {Z_TOL:g}), "
          f"4-dp flips {flips}/{iters}, CV-NLPD {nlpd['device']:.6f} vs "
          f"{nlpd['cpu']:.6f} (|d| {dn:.3e} <= {NLPD_TOL:g})")
    if not (dz <= Z_TOL and dn <= NLPD_TOL and np.isfinite(nlpd["device"])):
        raise AssertionError("ADMM trajectory diverges from the CPU reference")
    return {"dz": dz, "flips": flips, "dnlpd": dn}


def phase_trainer(n: int = N_NORTH, n_test: int = 200, iters: int = 10,
                  n_large: int = N_LARGE, card: str = ""):
    """driver.train with default settings, predict/evaluate, and the CG
    predictor at n_large vs the dense f64 posterior."""
    import jax.numpy as jnp

    from dqgp.data import split_data_numpy
    from dqgp.driver import TrainConfig, train
    from dqgp.models.gp import evaluate_predictions, predict_quantum_gp

    spec = north_star_spec()
    X, Y = north_star_data(n + n_test)
    Xtr, Ytr, Xte, Yte = X[:n], Y[:n], X[n:], Y[n:]
    splits = split_data_numpy(Xtr, Ytr, N_AGENTS, "regional")
    res = train(spec, splits, Xtr, Ytr,
                TrainConfig(max_iter=iters, n_mesh_devices=1, verbose=False))
    nll = np.array([h["total_nll"] for h in res.nll_history])
    cv = np.array([h["consensus_cv_score"] for h in res.cv_history])
    conds = np.array([h["condition_numbers"] for h in res.nll_history])
    if not (np.all(np.isfinite(res.z)) and np.all(np.isfinite(nll))
            and np.all(np.isfinite(cv)) and np.all(np.isfinite(conds))):
        raise AssertionError("trainer produced non-finite z / NLL / CV / cond")
    ms = 1e3 * float(np.mean([h["iter_time"] for h in res.nll_history[1:]]))
    print(f"trainer: {res.iterations} iters, NLL {nll[-1]:.4f}, best CV-NLPD "
          f"{res.cv_best:.4f}, cond max {conds.max():.3e}; wall "
          f"{ms:.2f} ms/iter after the first (smoke reading; {card})")
    z = res.z_best_cv if res.z_best_cv is not None else res.z
    mean, var = predict_quantum_gp(spec, jnp.asarray(Xtr), jnp.asarray(Ytr),
                                   jnp.asarray(Xte), jnp.asarray(z),
                                   noise_std=NOISE_STD)
    metrics = evaluate_predictions(Yte, np.asarray(mean), np.asarray(var),
                                   "Test", verbose=False)
    scalars = {k: v for k, v in metrics.items() if isinstance(v, float)}
    if not all(np.isfinite(v) for v in scalars.values()):
        raise AssertionError(f"non-finite test metrics {scalars}")
    print("predict: test " + ", ".join(f"{k} {v:.4f}"
                                       for k, v in sorted(scalars.items())))
    out = {"ms_per_iter": ms, "metrics": scalars}
    if n_large:
        out["cg"] = check_cg_predictor(spec, z, n_large)
    return out


def _dense_reference(spec, F_tr, y, F_te, jitter):
    """Plain f64 reference on the CPU device: explicit Grams, LAPACK
    Cholesky. Returns the posterior (mean, var) with noise^2 + jitter and
    the exact NLL with noise^2 alone."""
    import jax
    import jax.numpy as jnp
    from jax.scipy.linalg import solve_triangular

    from dqgp.models.gp.metrics import outer_diag
    from dqgp.models.kernels.quantum_kernel import gram_from_features

    with jax.default_device(jax.devices("cpu")[0]):
        F_tr, F_te, y = jnp.asarray(F_tr), jnp.asarray(F_te), jnp.asarray(y)
        K = gram_from_features(spec, F_tr)
        K_st = gram_from_features(spec, F_te, F_tr)
        k_ss = outer_diag(spec.outer_kernel, F_te, spec.outer_params)
        eye = jnp.eye(K.shape[0], dtype=K.dtype)
        L = jnp.linalg.cholesky(K + (NOISE_STD**2 + jitter) * eye)
        w = solve_triangular(L, y, lower=True)
        mean = K_st @ solve_triangular(L.T, w, lower=False)
        v = solve_triangular(L, K_st.T, lower=True)
        var = k_ss - jnp.sum(v * v, axis=0)
        L0 = jnp.linalg.cholesky(K + NOISE_STD**2 * eye)
        w0 = solve_triangular(L0, y, lower=True)
        nll = (0.5 * w0 @ w0 + jnp.sum(jnp.log(jnp.diagonal(L0)))
               + 0.5 * K.shape[0] * np.log(2 * np.pi))
        return np.asarray(mean), np.asarray(var), float(nll)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _features64(spec, X, z):
    import jax
    import jax.numpy as jnp

    from dqgp.models.kernels.quantum_kernel import kernel_features

    feats = jax.jit(lambda X, t: kernel_features(spec, X, t))
    return np.asarray(feats(jnp.asarray(X, jnp.float32),
                            jnp.asarray(z, jnp.float32)), np.float64)


def check_cg_predictor(spec, z, n: int, n_test: int = 256):
    """make_cg_predictor (the CLI's large-N predictor, f64 under x64) vs the
    dense f64 posterior on the same features."""
    import jax.numpy as jnp

    from dqgp.parallel.blocked import make_cg_predictor

    X, Y = north_star_data(n + n_test, seed=7)
    t0 = time.time()
    predict = make_cg_predictor(spec, X[:n], Y[:n], jnp.asarray(z, jnp.float64),
                                NOISE_STD, cg_tol=CG_TOL, cg_maxiter=4000)
    mean, var = predict(X[n:])
    mean, var = np.asarray(mean), np.asarray(var)
    wall = time.time() - t0
    F = _features64(spec, X, z)
    want_mean, want_var, _ = _dense_reference(spec, F[:n], Y[:n], F[n:], 1e-6)
    rm, rv = _rel(mean, want_mean), _rel(var, want_var)
    print(f"CG predictor N={n} (f64): rel dev mean {rm:.3e}, var {rv:.3e} "
          f"vs dense f64 (<= {CG_RTOL:g}); {wall:.1f} s incl. compile")
    if not (rm <= CG_RTOL and rv <= CG_RTOL):
        raise AssertionError("CG predictor deviates from the dense posterior")
    return {"mean": rm, "var": rv}


def phase_cli(n: int = 1000, iters: int = 3):
    from dqgp import cli

    summary = cli.main([
        "--input-dim", "2", "--n-dataset", str(n), "--encoding", "hubregtsen",
        "--kernel-type", "projected", "--num-qubits", "3", "--num-layers", "1",
        "--outer-kernel", "matern", "--n-agents", "4", "--max-iter", str(iters),
        "--no-plot", "--quiet"])
    metrics = {**{f"test_{k}": v for k, v in summary["test_metrics"].items()},
               **{f"train_{k}": v for k, v in summary["train_metrics"].items()}}
    metrics["cv_best_nlpd"] = summary["cv_best_nlpd"]
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"CLI produced non-finite metrics {metrics}")
    print(f"CLI config #1: {summary['iterations']} iters, test nlpd "
          f"{metrics['test_nlpd']:.4f}, test r2 {metrics['test_r2']:.4f}, "
          f"best CV-NLPD {metrics['cv_best_nlpd']:.4f}")
    return metrics


# ---------------------------------------------------------------------------
# four devices
# ---------------------------------------------------------------------------


def _peak_bytes(devs):
    return [(d.memory_stats() or {}).get("peak_bytes_in_use", 0) for d in devs]


def phase_four_train(n: int = N_NORTH, iters: int = 5):
    """driver.train on a 4-device agents mesh (one agent per device) vs the
    one-device run: same z trajectory."""
    import jax

    from dqgp.data import split_data_numpy
    from dqgp.driver import TrainConfig, train

    spec = north_star_spec()
    X, Y = north_star_data(n)
    splits = split_data_numpy(X, Y, N_AGENTS, "regional")
    traj = {}
    for n_dev in (1, 4):
        res = train(spec, splits, X, Y,
                    TrainConfig(max_iter=iters, n_mesh_devices=n_dev,
                                compute_cond=False, verbose=False))
        traj[n_dev] = np.stack([h["consensus_params"]
                                for h in res.cv_history])
    dz = float(np.max(np.abs(traj[4] - traj[1])))
    print(f"train on 4 devices vs 1: max|dz| over {iters} iters {dz:.3e} "
          f"(<= {Z_TOL:g}); peak bytes per device "
          f"{_peak_bytes(jax.devices()[:4])}")
    if not dz <= Z_TOL:
        raise AssertionError("4-device training diverges from 1-device")
    return dz


def phase_four_step2d(n: int = N_NORTH):
    """One ADMM step on a 2x2 agents x data mesh vs the 1-D step."""
    import jax
    import jax.numpy as jnp

    from dqgp.data import split_data_numpy
    from dqgp.driver import init_admm_state
    from dqgp.parallel import (
        agents_data_mesh,
        make_admm_step,
        make_admm_step_2d,
        make_agent_batch,
        shard_batch_to_mesh_2d,
    )

    spec = north_star_spec()
    X, Y = north_star_data(n)
    splits = split_data_numpy(X, Y, N_AGENTS, "regional")
    theta, psi, _ = init_admm_state(N_AGENTS, spec.num_parameters, 42, RHO)
    kw = dict(rho=RHO, L=L_CONST, noise_std=NOISE_STD, compute_cond=False)
    n_max = max(x.shape[0] for x, _ in splits)
    batch = make_agent_batch(splits, pad_to=n_max + n_max % 2)
    ref = make_admm_step(spec, None, **kw)(jnp.asarray(theta),
                                           jnp.asarray(psi), batch)
    mesh = agents_data_mesh(2, 2)
    b2, th2, ps2 = shard_batch_to_mesh_2d(batch, theta, psi, mesh)
    out = make_admm_step_2d(spec, mesh, **kw)(th2, ps2, b2)
    owners = sorted({s.device.id for s in b2.X.addressable_shards})
    d_theta = float(np.max(np.abs(np.asarray(out.theta) - np.asarray(ref.theta))))
    d_nll = float(np.max(np.abs(np.asarray(out.nll) - np.asarray(ref.nll))))
    print(f"2x2 agents x data step vs 1-D: max|dtheta| {d_theta:.3e} "
          f"(<= {Z_TOL:g}), max|dNLL| {d_nll:.3e}; batch shards on devices "
          f"{owners}")
    if not (d_theta <= Z_TOL and len(owners) == 4
            and np.all(np.isfinite(np.asarray(out.nll)))):
        raise AssertionError("2-D mesh step deviates from the 1-D step")
    return d_theta


def phase_four_large(n: int = N_LARGE, n_test: int = 256, block: int = 1024):
    """Distributed Cholesky NLL and sharded CG posterior over a 4-device
    data mesh vs dense f64."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from dqgp.parallel.blocked import (
        make_distributed_cholesky_nll,
        make_sharded_posterior,
    )

    spec = north_star_spec()
    z = np.random.RandomState(5).uniform(0, np.pi, spec.num_parameters)
    X, Y = north_star_data(n + n_test, seed=11)
    F = _features64(spec, X, z)
    F_tr, F_te, y = F[:n], F[n:], Y[:n]
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    shard, rep = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())
    F_s = jax.device_put(jnp.asarray(F_tr), shard)
    y_s = jax.device_put(jnp.asarray(y), shard)
    owners = sorted({s.device.id for s in F_s.addressable_shards})

    nll_fn = make_distributed_cholesky_nll(spec, mesh, noise_std=NOISE_STD,
                                           n_total=n, block=block,
                                           dtype=jnp.float64)
    nll = float(nll_fn(F_s, y_s)[0])
    post = make_sharded_posterior(spec, mesh, noise_std=NOISE_STD,
                                  cg_tol=CG_TOL, cg_maxiter=4000)
    mean, var = post(F_s, y_s,
                     jax.device_put(jnp.ones((n,), jnp.float64), shard),
                     jax.device_put(jnp.asarray(F_te), rep))

    want_mean, want_var, want_nll = _dense_reference(spec, F_tr, y, F_te,
                                                     1e-6)
    r_nll = abs(nll - want_nll) / abs(want_nll)
    rm, rv = _rel(mean, want_mean), _rel(var, want_var)
    print(f"data mesh N={n} (f64), shards on devices {owners}: distributed "
          f"NLL rel dev {r_nll:.3e} (<= {LARGE_RTOL:g}), sharded CG posterior "
          f"rel dev mean {rm:.3e} var {rv:.3e} (<= {CG_RTOL:g}); peak bytes "
          f"per device {_peak_bytes(jax.devices()[:4])}")
    if not (r_nll <= LARGE_RTOL and max(rm, rv) <= CG_RTOL
            and len(owners) == 4):
        raise AssertionError("data-mesh NLL/posterior deviate from dense f64")
    return {"nll": r_nll, "mean": rm, "var": rv}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-device path and its references")
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1
    devs = phase_device(count)
    import dqgp  # noqa: F401  (x64, matmul precision, compile cache)

    card = card_name_power()
    if args.four_cards:
        phase_four_train()
        phase_four_step2d()
        phase_four_large()
    else:
        phase_engine()
        phase_trajectory()
        phase_trainer(card=card)
        phase_cli()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
