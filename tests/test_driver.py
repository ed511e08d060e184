"""End-to-end: synthetic quantum-GP data -> distributed ADMM training ->
prediction -> metrics. Mirrors the reference's inline self-validation
(SURVEY.md §4): ground-truth recovery tracking and prediction quality."""

import numpy as np
import jax.numpy as jnp
import pytest

from dqgp.data import generate_quantum_gp_data, split_data_numpy
from dqgp.driver import TrainConfig, init_admm_state, load_checkpoint, train
from dqgp.models.circuits import build_circuit
from dqgp.models.gp import evaluate_predictions, predict_quantum_gp
from dqgp.models.kernels import QuantumKernelSpec


def _make_problem(n=48, seed=42):
    spec = QuantumKernelSpec(
        circuit=build_circuit("hubregtsen", 2, 2, 1),
        kernel_type="projected", outer_kernel="gaussian",
    )
    X, Y, gt = generate_quantum_gp_data(
        n, 2, spec, data_range=(-0.95, 0.95), noise_std=0.05,
        data_seed=seed, param_seed=seed,
    )
    return spec, X, Y, gt


@pytest.mark.slow
def test_end_to_end_training_and_prediction(tmp_path):
    spec, X, Y, gt = _make_problem()
    n_train = 40
    Xtr, Ytr, Xte, Yte = X[:n_train], Y[:n_train], X[n_train:], Y[n_train:]
    splits = split_data_numpy(Xtr, Ytr, 4, "random", random_seed=42)

    cfg = TrainConfig(
        rho=100.0, L=100.0, noise_std=0.05, max_iter=6, cv_folds=3,
        cv_patience=50, seed=42, compute_cond=False, verbose=False,
        checkpoint_dir=str(tmp_path), checkpoint_every=3,
    )
    res = train(spec, splits, Xtr, Ytr, cfg, ground_truth_params=gt)

    assert res.iterations == 6
    assert res.z.shape == (spec.num_parameters,)
    assert len(res.nll_history) == 6
    assert len(res.cv_history) == 6
    assert res.z_best_cv is not None and np.isfinite(res.cv_best)
    assert len(res.error_history) == 6  # GT tracking active

    # NLL should be finite and improving-or-stable
    assert np.isfinite(res.nll_history[-1]["total_nll"])

    # prediction with the selected parameters
    mean, var = predict_quantum_gp(
        spec, jnp.asarray(Xtr), jnp.asarray(Ytr), jnp.asarray(Xte),
        jnp.asarray(res.z), noise_std=0.05,
    )
    m = evaluate_predictions(Yte, np.asarray(mean), np.asarray(var))
    assert np.isfinite(m["nlpd"]) and np.isfinite(m["r2"])

    # checkpoint written and loadable
    ck = load_checkpoint(str(tmp_path / "ckpt_00003.npz"))
    assert ck["iteration"] == 3
    assert ck["theta"].shape == (4, spec.num_parameters)


def test_resume_matches_uninterrupted_run(tmp_path):
    """Checkpoint/resume must reproduce the uninterrupted trajectory
    (CV disabled: its per-iteration seed depends only on iteration count,
    which resume preserves; this isolates the ADMM state)."""
    spec, X, Y, gt = _make_problem(n=32)
    splits = split_data_numpy(X, Y, 4, "sequential")
    base = dict(rho=100.0, L=100.0, noise_std=0.05, cv_folds=3, seed=42,
                compute_cond=False, verbose=False, run_cv=False)

    cfg_full = TrainConfig(max_iter=6, **base)
    full = train(spec, splits, X, Y, cfg_full)

    cfg_a = TrainConfig(max_iter=3, checkpoint_dir=str(tmp_path), checkpoint_every=3, **base)
    train(spec, splits, X, Y, cfg_a)
    cfg_b = TrainConfig(max_iter=6, **base)
    resumed = train(spec, splits, X, Y, cfg_b,
                    resume_from=str(tmp_path / "ckpt_00003.npz"))

    np.testing.assert_allclose(resumed.z, full.z, atol=1e-12)
    np.testing.assert_allclose(resumed.theta, full.theta, atol=1e-12)
    np.testing.assert_allclose(resumed.psi, full.psi, atol=1e-12)


def test_init_state_matches_reference_rng():
    theta, psi, z = init_admm_state(3, 4, seed=42, rho=100.0)
    np.random.seed(42)
    want_theta = np.round(np.random.rand(3, 4), 4)
    want_psi = np.round(np.random.rand(3, 4), 4)
    np.testing.assert_array_equal(theta, want_theta)
    np.testing.assert_array_equal(psi, want_psi)
    assert z.shape == (4,)


def test_ground_truth_recovery_small():
    """With data generated FROM the model class, ADMM should move z toward
    the ground truth (relative to the initial error) — the reference's own
    runtime oracle (main.py:2736-2757)."""
    spec, X, Y, gt = _make_problem(n=40, seed=7)
    splits = split_data_numpy(X, Y, 2, "random", random_seed=7)
    from dqgp import manifold as M

    theta0, psi0, z0 = init_admm_state(2, spec.num_parameters, 7, 100.0)
    initial_err = float(M.distance(jnp.asarray(z0), jnp.asarray(gt)))

    cfg = TrainConfig(rho=100.0, L=100.0, noise_std=0.05, max_iter=15,
                      cv_folds=3, seed=7, compute_cond=False, verbose=False,
                      run_cv=False)
    res = train(spec, splits, X, Y, cfg, ground_truth_params=gt)
    assert res.error_best <= initial_err * 1.05


def test_cv_patience_with_no_valid_cv_does_not_crash():
    """Regression: patience exhausted before any finite CV score must not
    crash on z_best_cv=None (e.g. train set smaller than cv_folds)."""
    spec, X, Y, gt = _make_problem(n=8)
    splits = split_data_numpy(X, Y, 2, "sequential")
    cfg = TrainConfig(rho=100.0, L=100.0, noise_std=0.05, max_iter=5,
                      cv_folds=50,  # > n_train -> every CV call fails
                      cv_patience=2, seed=42, compute_cond=False, verbose=False)
    res = train(spec, splits, X, Y, cfg)
    assert res.converged_by == "cv_patience"
    assert res.z_best_cv is None
    assert np.all(np.isfinite(res.z))


@pytest.mark.slow
def test_chained_dispatch_matches_per_iteration():
    """chain_iters>1 runs k iterations per device program; the trajectory,
    CV history, and final state must match per-iteration dispatch exactly
    (rows replay through the same bookkeeping; parity rounding makes the
    comparison bit-level)."""
    spec, X, Y, gt = _make_problem(n=40)
    splits = split_data_numpy(X, Y, 4, "random", random_seed=42)
    base = dict(rho=100.0, L=100.0, noise_std=0.05, cv_folds=3, seed=42,
                compute_cond=False, verbose=False, max_iter=7)

    a = train(spec, splits, X, Y, TrainConfig(**base), ground_truth_params=gt)
    b = train(spec, splits, X, Y, TrainConfig(chain_iters=3, **base),
              ground_truth_params=gt)

    # 7 iterations over chunks of 3: the last chunk stops mid-chunk at
    # max_iter and discards the speculative row
    assert b.iterations == a.iterations == 7
    assert b.converged_by == a.converged_by
    np.testing.assert_array_equal(b.z, a.z)
    np.testing.assert_array_equal(b.theta, a.theta)
    np.testing.assert_array_equal(b.psi, a.psi)
    np.testing.assert_array_equal(b.z_best_cv, a.z_best_cv)
    assert b.error_history == a.error_history
    # NLL/CV scalars: XLA fuses the scan body differently from the
    # standalone program -> 1-ulp reduction-order noise (the 4-dp rounding
    # keeps the trajectory itself bit-identical)
    np.testing.assert_allclose(b.cv_best, a.cv_best, rtol=1e-12)
    for ha, hb in zip(a.cv_history, b.cv_history):
        np.testing.assert_allclose(hb["consensus_cv_score"],
                                   ha["consensus_cv_score"], rtol=1e-12)
    for ha, hb in zip(a.nll_history, b.nll_history):
        np.testing.assert_allclose(hb["agent_losses"], ha["agent_losses"],
                                   rtol=1e-12)


@pytest.mark.slow
def test_chained_dispatch_no_cv_and_checkpoints(tmp_path):
    """Chained mode without CV, mid-chunk checkpointing: checkpoint at an
    iteration inside a chunk must carry that iteration's theta/psi."""
    spec, X, Y, gt = _make_problem(n=32)
    splits = split_data_numpy(X, Y, 2, "sequential")
    base = dict(rho=100.0, L=100.0, noise_std=0.05, seed=42,
                compute_cond=False, verbose=False, run_cv=False, max_iter=6)

    a = train(spec, splits, X, Y, TrainConfig(**base))
    b = train(spec, splits, X, Y,
              TrainConfig(chain_iters=4, checkpoint_dir=str(tmp_path),
                          checkpoint_every=3, **base))
    np.testing.assert_array_equal(b.z, a.z)
    np.testing.assert_array_equal(b.theta, a.theta)

    ck = load_checkpoint(str(tmp_path / "ckpt_00003.npz"))
    assert ck["iteration"] == 3
    assert ck["theta"].shape == (2, spec.num_parameters)
    # iteration 3 is mid-chunk (chunk = iters 1-4): resume from it must
    # reproduce the uninterrupted trajectory
    resumed = train(spec, splits, X, Y, TrainConfig(**base),
                    resume_from=str(tmp_path / "ckpt_00003.npz"))
    np.testing.assert_allclose(resumed.z, a.z, atol=1e-12)
    np.testing.assert_allclose(resumed.theta, a.theta, atol=1e-12)


@pytest.mark.slow
def test_chained_dispatch_on_mesh():
    """Chained dispatch over a 4-device agents mesh (scan body contains the
    shard_map'd step) must reproduce the per-iteration trajectory on the
    SAME mesh. (Across device counts the psum reduction order can flip a
    value at a 4-dp rounding boundary — that looseness is pre-existing and
    covered by test_consensus; chaining itself must be exact.)"""
    spec, X, Y, gt = _make_problem(n=40)
    splits = split_data_numpy(X, Y, 4, "random", random_seed=42)
    base = dict(rho=100.0, L=100.0, noise_std=0.05, cv_folds=3, seed=42,
                compute_cond=False, verbose=False, max_iter=5,
                n_mesh_devices=4)

    a = train(spec, splits, X, Y, TrainConfig(**base))
    b = train(spec, splits, X, Y, TrainConfig(chain_iters=2, **base))
    np.testing.assert_array_equal(b.z, a.z)
    np.testing.assert_array_equal(b.theta, a.theta)
    np.testing.assert_array_equal(b.psi, a.psi)


@pytest.mark.slow
def test_host_cond_mode_matches_device():
    """cond_mode="host" backfills exact f64 eigvalsh condition numbers that
    match the in-program (device) values. Equal-size shards make the device
    path's diag-mean padding inert so both condition identical Grams."""
    spec, X, Y, gt = _make_problem()
    splits = split_data_numpy(X[:40], Y[:40], 4, "sequential")
    assert len({len(x) for x, _ in splits}) == 1  # equal shards, no padding

    base = dict(rho=100.0, L=100.0, noise_std=0.05, max_iter=3, cv_folds=3,
                seed=42, verbose=False)
    res_dev = train(spec, splits, X[:40], Y[:40],
                    TrainConfig(cond_mode="device", **base))
    res_host = train(spec, splits, X[:40], Y[:40],
                     TrainConfig(cond_mode="host", **base))

    for h_dev, h_host in zip(res_dev.nll_history, res_host.nll_history):
        c_dev = np.asarray(h_dev["condition_numbers"])
        c_host = np.asarray(h_host["condition_numbers"])
        assert np.all(np.isfinite(c_host))
        # entries of K are f32-accurate; lambda_min (hence cond) moves by
        # ~cond * eps_f32 between the two construction orders
        assert np.allclose(c_host, c_dev, rtol=0.02), (c_dev, c_host)
    # trajectories must be identical: cond is reporting-only
    assert np.array_equal(res_dev.z, res_host.z)


def test_host_cond_chunk_boundary():
    """host_condition_numbers chunks the iteration axis (CHUNK=16); T=18
    crosses a chunk boundary and the padded tail rows must not leak into
    the output. Direct comparison against unchunked per-row f64 conds."""
    from dqgp.driver import host_condition_numbers
    from dqgp.models.kernels.quantum_kernel import gram

    spec, X, Y, gt = _make_problem(n=24)
    splits = split_data_numpy(X, Y, 2, "sequential")
    rng = np.random.RandomState(3)
    P = spec.circuit.num_parameters
    Z = rng.uniform(0, np.pi, size=(18, P)).round(4)
    # parity rounding can emit 3.1416 > pi (round4(mod(x, pi)) at the
    # boundary); the backfill must wrap exactly as the device step does
    Z[16, 0] = 3.1416

    out = host_condition_numbers(spec, splits, Z)
    assert out.shape == (18, 2)
    assert np.all(np.isfinite(out))

    for t in (0, 15, 16, 17):  # both sides of the chunk boundary
        z_wrapped = np.mod(Z[t], np.pi)  # independent re-derivation of wrap
        for a, (X_i, _) in enumerate(splits):
            K = np.asarray(
                gram(spec, jnp.asarray(X_i, jnp.float64),
                     jnp.asarray(z_wrapped, jnp.float64),
                     dtype=jnp.float64), np.float64)
            w = np.abs(np.linalg.eigvalsh(K))
            expect = w.max() / max(w.min(), np.finfo(np.float64).tiny)
            # the backfill builds the same f64 Gram (complex128 pipeline);
            # only vmap-vs-direct fusion noise remains (~cond * eps_f64).
            # Row-mix-ups/padding leaks would be >>1e-6.
            np.testing.assert_allclose(out[t, a], expect, rtol=1e-6)


def test_host_cond_f64_resolves_beyond_f32_floor():
    """The host cond backfill builds each Gram through the complex128
    statevector pipeline, so it resolves condition numbers past the
    ~1e7-1e8 floor that f32-built Gram entries impose (the reference's
    np.linalg.cond runs on double-precision qiskit-aer Grams — round-2
    VERDICT weak #5). Near-duplicate inputs make the true Gram nearly
    rank-deficient: the tiny eigenvalues are O(dx^2) ~ 1e-14 relative,
    representable in f64 but pure noise at f32 entry accuracy."""
    from dqgp.driver import host_condition_numbers
    from dqgp.models.kernels.quantum_kernel import gram

    spec = QuantumKernelSpec(
        circuit=build_circuit("hubregtsen", 2, 2, 1),
        kernel_type="projected", outer_kernel="gaussian",
    )
    rng = np.random.RandomState(0)
    base = rng.uniform(-0.9, 0.9, size=(6, 2))
    X = np.repeat(base, 2, axis=0)          # 6 pairs of near-duplicates
    X[1::2] += 1e-7                          # feature gap ~1e-7 -> eig ~1e-14
    Y = rng.standard_normal(len(X))
    theta = rng.uniform(0, np.pi, size=spec.num_parameters).round(4)

    out = host_condition_numbers(spec, [(X, Y)], theta[None, :])
    cond_f64 = float(out[0, 0])

    K32 = np.asarray(
        gram(spec, jnp.asarray(X, jnp.float32), jnp.asarray(theta, jnp.float32)),
        np.float64)
    w32 = np.abs(np.linalg.eigvalsh(K32))
    cond_f32_built = w32.max() / max(w32.min(), np.finfo(np.float64).tiny)

    # f64 pipeline sees the true ~1e13-1e15 conditioning; the f32-built Gram
    # cannot even represent the pair separation, so its eigvalsh bottoms out
    # at entry-noise scale (~1e7-1e9).
    assert cond_f64 > 1e11, cond_f64
    assert cond_f32_built < 1e11, cond_f32_built
    assert cond_f64 > 30 * cond_f32_built, (cond_f64, cond_f32_built)


@pytest.mark.slow
def test_gram_f64_dtype_and_agreement():
    """gram(..., dtype=float64) returns a float64 Gram that agrees with the
    f32 production path to f32 accuracy (same physics, higher precision)."""
    from dqgp.models.kernels.quantum_kernel import gram

    for ktype in ("projected", "fidelity"):
        spec = QuantumKernelSpec(
            circuit=build_circuit("yz_cx", 3, 2, 2), kernel_type=ktype,
        )
        rng = np.random.RandomState(1)
        X = rng.uniform(-0.9, 0.9, size=(12, 2))
        theta = rng.uniform(0, np.pi, size=spec.num_parameters)
        K64 = np.asarray(gram(spec, jnp.asarray(X), jnp.asarray(theta),
                              dtype=jnp.float64))
        K32 = np.asarray(gram(spec, jnp.asarray(X, jnp.float32),
                              jnp.asarray(theta, jnp.float32)))
        assert K64.dtype == np.float64
        assert K32.dtype == np.float32
        np.testing.assert_allclose(K64, K32, atol=5e-6)


def test_cond_mode_rejects_unknown_values():
    """The Python API validates cond_mode eagerly — an unrecognized value
    must raise, not silently disable condition numbers (CLI has choices=,
    programmatic callers had no guard)."""
    spec, X, Y, gt = _make_problem(n=16)
    splits = split_data_numpy(X, Y, 2, "sequential")
    with pytest.raises(ValueError, match="cond_mode"):
        train(spec, splits, X, Y,
              TrainConfig(max_iter=1, cv_folds=2, verbose=False,
                          cond_mode="Host"))


def test_device_cond_on_f32_accelerator_warns(monkeypatch):
    """cond_mode="device" conditions a Gram built in the training step's
    dtype (f32 statevectors), which floors resolvable cond at ~1e7-1e8 — so
    the driver warns, keyed to that dtype (not the backend), once per
    process; host/off modes and an f64-built Gram stay silent."""
    import warnings

    import dqgp.driver as drv

    monkeypatch.setattr(drv, "_cond_floor_warned", False)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for mode, dt in (("host", jnp.float32), ("off", jnp.float32),
                         ("device", jnp.float64)):
            drv._warn_device_cond_floor(mode, dt)
        assert not rec
        drv._warn_device_cond_floor("device", jnp.float32)
        drv._warn_device_cond_floor("device", jnp.float32)
    assert len(rec) == 1 and "saturate" in str(rec[0].message)

    # integration: a real device-mode training run warns through
    # warnings.warn (once per process), pointing at the caller
    monkeypatch.setattr(drv, "_cond_floor_warned", False)
    spec, X, Y, gt = _make_problem(n=16)
    splits = split_data_numpy(X, Y, 2, "sequential")
    with pytest.warns(UserWarning, match="saturate"):
        train(spec, splits, X, Y,
              TrainConfig(max_iter=1, cv_folds=2, verbose=False,
                          cond_mode="device"))


def test_host_cond_without_cpu_backend_says_how(monkeypatch):
    """cond_mode='host' needs the CPU backend; a process without it (e.g.
    JAX_PLATFORMS=cuda) gets a clear error before training, not an opaque
    one after it."""
    import dqgp.driver as drv

    def no_cpu(backend=None):
        raise RuntimeError(f"Unknown backend {backend}")

    monkeypatch.setattr(drv.jax, "devices", no_cpu)
    with pytest.raises(RuntimeError, match="cuda,cpu"):
        drv.host_cpu_device()
