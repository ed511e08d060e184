"""Mixed-precision PSD solver (f32 factorization + f64 refinement).

The parity question: does gp_dtype="mixed" reproduce the float64 path's
results to (beyond) the reference's 4-decimal rounding? On CPU, float64 is
real LAPACK f64, so these tests pin mixed against the genuine article.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dqgp.ops.linalg import solve_psd_mixed, solve_psd_with_fallback


def _spd(n, cond, seed=0):
    """Symmetric PD matrix with the requested condition number."""
    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.randn(n, n))
    w = np.geomspace(1.0, 1.0 / cond, n)
    return jnp.asarray(Q @ np.diag(w) @ Q.T, jnp.float64)


def test_mixed_matches_direct_well_conditioned():
    n = 64
    C = _spd(n, cond=1e4)
    y = jnp.asarray(np.random.RandomState(1).randn(n))
    direct = jax.jit(lambda c, b: solve_psd_with_fallback(c, b))(C, y)
    mixed = jax.jit(lambda c, b: solve_psd_mixed(c, b))(C, y)
    assert bool(mixed.chol_ok)
    np.testing.assert_allclose(np.asarray(mixed.C_inv_y),
                               np.asarray(direct.C_inv_y), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(mixed.C_inv),
                               np.asarray(direct.C_inv), rtol=1e-7, atol=1e-7)
    # logdet comes from the f32 factor: ~N*eps_f32 relative
    np.testing.assert_allclose(float(mixed.logdet), float(direct.logdet),
                               rtol=1e-4, atol=1e-4)


def test_mixed_falls_back_on_ill_conditioned():
    """cond ~1e10 defeats the f32 factorization's refinement — the residual
    gate must route to the direct f64 branch, matching it exactly."""
    n = 48
    C = _spd(n, cond=1e10, seed=2)
    y = jnp.asarray(np.random.RandomState(3).randn(n))
    direct = jax.jit(lambda c, b: solve_psd_with_fallback(c, b))(C, y)
    mixed = jax.jit(lambda c, b: solve_psd_mixed(c, b))(C, y)
    np.testing.assert_allclose(np.asarray(mixed.C_inv_y),
                               np.asarray(direct.C_inv_y), rtol=1e-12)
    np.testing.assert_allclose(float(mixed.logdet), float(direct.logdet),
                               rtol=1e-12)


def test_mixed_indefinite_reaches_pinv_rescue():
    n = 16
    rng = np.random.RandomState(4)
    A = rng.randn(n, n)
    C = jnp.asarray((A + A.T) / 2, jnp.float64)  # indefinite
    y = jnp.asarray(rng.randn(n))
    direct = jax.jit(lambda c, b: solve_psd_with_fallback(c, b, fallback=True))(C, y)
    mixed = jax.jit(lambda c, b: solve_psd_mixed(c, b, fallback=True))(C, y)
    assert not bool(direct.chol_ok) and not bool(mixed.chol_ok)
    np.testing.assert_allclose(np.asarray(mixed.C_inv_y),
                               np.asarray(direct.C_inv_y), rtol=1e-10)


def test_split_f64_matvec_accuracy():
    """split_f64_matvec (three f32 products) matches the f64 product to
    the documented ~sqrt(N)*eps_f32 cancellation floor."""
    from dqgp.ops.linalg import split_f64_matvec

    rng = np.random.RandomState(6)
    A = jnp.asarray(rng.randn(300, 200) * (1 + rng.rand(300, 200)))
    v = jnp.asarray(rng.randn(200))
    exact = np.asarray(A, np.float64) @ np.asarray(v, np.float64)
    got = np.asarray(jax.jit(split_f64_matvec)(A, v))
    scale = np.linalg.norm(np.abs(np.asarray(A)) @ np.abs(np.asarray(v)))
    assert np.linalg.norm(got - exact) < 30 * np.finfo(np.float32).eps * scale


def test_mixed_split_refinement_accuracy_and_gate():
    """refine_style='split' (the mixed-flag hot path): ~1e-4-grade solutions
    on f32-servable systems (an order beyond a raw f32 solve), NaN flag on
    systems the f32 factorization cannot serve."""
    n = 256
    C = _spd(n, cond=1e4, seed=8)
    y = jnp.asarray(np.random.RandomState(9).randn(n))
    r = jax.jit(lambda c, b: solve_psd_mixed(
        c, b, fallback=False, need_inverse=False, on_fail="flag",
        refine_style="split"))(C, y)
    assert bool(r.chol_ok)
    xref = np.linalg.solve(np.asarray(C), np.asarray(y))
    rel = np.linalg.norm(np.asarray(r.C_inv_y) - xref) / np.linalg.norm(xref)
    assert rel < 2e-3, rel           # measured ~1e-4-2e-4 at these shapes

    C_bad = _spd(48, cond=1e9, seed=10)
    y_bad = jnp.asarray(np.random.RandomState(11).randn(48))
    rb = jax.jit(lambda c, b: solve_psd_mixed(
        c, b, fallback=False, need_inverse=False, on_fail="flag",
        refine_style="split"))(C_bad, y_bad)
    assert not bool(rb.chol_ok)
    assert np.all(np.isnan(np.asarray(rb.C_inv_y)))


def test_mixed_split_style_inert_for_need_inverse():
    """With need_inverse=True (the trajectory-critical agent-step path)
    refine_style='split' must be a no-op: x derives from the polished
    inverse and the residual gate keeps its true-f64 measurement —
    bit-identical results to the default style."""
    n = 96
    C = _spd(n, cond=1e5, seed=12)
    y = jnp.asarray(np.random.RandomState(13).randn(n))
    a = jax.jit(lambda c, b: solve_psd_mixed(
        c, b, fallback=False, need_inverse=True, on_fail="flag"))(C, y)
    b = jax.jit(lambda c, b: solve_psd_mixed(
        c, b, fallback=False, need_inverse=True, on_fail="flag",
        refine_style="split"))(C, y)
    np.testing.assert_array_equal(np.asarray(a.C_inv_y), np.asarray(b.C_inv_y))
    np.testing.assert_array_equal(np.asarray(a.C_inv), np.asarray(b.C_inv))
    assert bool(a.chol_ok) == bool(b.chol_ok)


def test_mixed_f32_input_passthrough():
    n = 8
    C = _spd(n, cond=10.0).astype(jnp.float32)
    y = jnp.asarray(np.random.RandomState(5).randn(n), jnp.float32)
    a = jax.jit(lambda c, b: solve_psd_mixed(c, b))(C, y)
    b = jax.jit(lambda c, b: solve_psd_with_fallback(c, b))(C, y)
    np.testing.assert_array_equal(np.asarray(a.C_inv_y), np.asarray(b.C_inv_y))


def _mini_problem():
    from dqgp.data import generate_quantum_gp_data, split_data_numpy
    from dqgp.models.circuits import build_circuit
    from dqgp.models.kernels import QuantumKernelSpec

    spec = QuantumKernelSpec(
        circuit=build_circuit("hubregtsen", 3, 2, 1),
        kernel_type="projected", outer_kernel="matern",
    )
    X, Y, _ = generate_quantum_gp_data(96, 2, spec, data_seed=11, param_seed=42)
    splits = split_data_numpy(X, Y, 4, "sequential")
    return spec, X, Y, splits


def test_admm_trajectory_mixed_equals_float64():
    """3 full ADMM iterations: the 4-dp-rounded (z, theta) trajectory in
    gp_dtype='mixed' must be bit-identical to gp_dtype='float64' (the
    reference-parity mode), and psi identical up to isolated 4-dp
    ROUNDING-BOUNDARY flips.

    Why psi gets the weaker bound: mixed differs from true f64 by ~1e-8
    relative, so any pre-rounding value within that of a .00005 boundary can
    legitimately round either way (np.round quantum = 1e-4).  psi grows as
    ~rho*pi per iteration under the reference's unsigned log_map
    (riemannian_optimizer.py:350-368), so at |psi| ~ 5e2 the boundary
    discrimination needs ~1e-7 relative accuracy and occasional single-quantum
    flips are expected by construction (the round-4 f64 dataset re-anchor
    surfaced exactly one, at psi = 469.81145).  Flips must be (a) rare,
    (b) exactly one quantum, and (c) must NOT leak into z or theta within the
    horizon (they are re-derived from the wrapped manifold state, magnitude
    < pi, where boundary discrimination is ~1e-8 relative - comfortably inside
    mixed accuracy)."""
    from dqgp.driver import init_admm_state
    from dqgp.parallel import make_admm_step, make_agent_batch

    spec, X, Y, splits = _mini_problem()
    batch = make_agent_batch(splits)
    theta0, psi0, _ = init_admm_state(4, spec.num_parameters, 42, 100.0)

    def run(gp_dtype):
        step = make_admm_step(spec, None, rho=100.0, L=100.0, noise_std=0.1,
                              compute_cond=False, psd_fallback=True,
                              gp_dtype=gp_dtype)
        theta, psi = jnp.asarray(theta0), jnp.asarray(psi0)
        zs = []
        for _ in range(3):
            out = step(theta, psi, batch)
            theta, psi = out.theta, out.psi
            zs.append(np.asarray(out.z))
        return np.stack(zs), np.asarray(theta), np.asarray(psi)

    z64, th64, ps64 = run("float64")
    zmx, thmx, psmx = run("mixed")
    np.testing.assert_array_equal(zmx, z64)
    np.testing.assert_array_equal(thmx, th64)
    diff = psmx - ps64
    flipped = np.nonzero(diff)
    assert len(flipped[0]) <= 2, (
        f"{len(flipped[0])}/{diff.size} psi elements differ - more than "
        f"isolated boundary flips: {diff[flipped]}")
    if len(flipped[0]):
        np.testing.assert_allclose(np.abs(diff[flipped]), 1e-4, rtol=1e-9,
                                   err_msg="psi mismatch is not a single "
                                           "4-dp rounding quantum")


@pytest.mark.slow
def test_streamed_mixed_matches_central_float64():
    from dqgp.driver import init_admm_state
    from dqgp.parallel import make_admm_step, make_agent_batch

    spec, X, Y, splits = _mini_problem()
    batch = make_agent_batch(splits)
    theta0, psi0, _ = init_admm_state(4, spec.num_parameters, 42, 100.0)
    outs = {}
    for label, kw in (("central64", dict(grad_method="central", gp_dtype="float64")),
                      ("streamedmx", dict(grad_method="streamed", gp_dtype="mixed"))):
        step = make_admm_step(spec, None, rho=100.0, L=100.0, noise_std=0.1,
                              compute_cond=False, psd_fallback=False, **kw)
        outs[label] = step(jnp.asarray(theta0), jnp.asarray(psi0), batch)
    np.testing.assert_array_equal(np.asarray(outs["streamedmx"].theta),
                                  np.asarray(outs["central64"].theta))


def test_cv_mixed_matches_float64():
    from dqgp.models.gp.cv import k_fold_cross_validation_consensus

    spec, X, Y, _ = _mini_problem()
    theta = jnp.asarray(np.random.RandomState(7).uniform(0, np.pi,
                                                         spec.num_parameters))
    a = k_fold_cross_validation_consensus(spec, X, Y, theta, 0.1, k_folds=3,
                                          random_seed=42, cv_dtype="float64")
    b = k_fold_cross_validation_consensus(spec, X, Y, theta, 0.1, k_folds=3,
                                          random_seed=42, cv_dtype="mixed")
    # mixed builds fold Grams in f32 and runs the predictive-variance
    # triangular solve in f32 -> ~1e-4 NLPD noise, far below anything
    # selection-relevant (iteration-to-iteration CV-NLPD moves are
    # O(0.01-10), and z rounds to 4dp); bench.py's parity gate bounds the
    # same deviation at 0.05
    assert abs(a["mean_nlpd"] - b["mean_nlpd"]) < 1e-3
    assert abs(a["mean_r2"] - b["mean_r2"]) < 1e-3


@pytest.mark.slow
def test_cv_mixed_rescores_flagged_folds_in_float64():
    """Fold systems beyond the f32 factorization's reach (cond >~ 1e7 via
    duplicated rows + tiny noise) must NOT score +inf under cv_dtype='mixed'
    when f64 would succeed — they are re-scored through the float64 path so
    model selection matches the reference's f64 CV."""
    from dqgp.models.gp.cv import (
        _cv_fold_scores,
        k_fold_cross_validation_consensus,
        kfold_pad_indices,
    )

    spec, X, Y, _ = _mini_problem()
    X_dup = np.concatenate([X, X])
    Y_dup = np.concatenate([Y, Y])
    theta = jnp.asarray(np.random.RandomState(7).uniform(0, np.pi,
                                                         spec.num_parameters))
    kw = dict(k_folds=3, random_seed=42, jitter=1e-10)
    # guard against vacuity: the raw mixed fold pass must actually flag
    # (else this test would pass without exercising the rescore branch)
    idx = kfold_pad_indices(len(X_dup), 3, 42)
    raw_nlpds, _, _ = _cv_fold_scores(
        spec, jnp.asarray(X_dup), jnp.asarray(Y_dup), theta, *idx,
        noise_std=1e-5, jitter=1e-10, cv_dtype="mixed")
    assert not np.all(np.isfinite(np.asarray(raw_nlpds)))
    a = k_fold_cross_validation_consensus(spec, X_dup, Y_dup, theta, 1e-5,
                                          cv_dtype="float64", **kw)
    b = k_fold_cross_validation_consensus(spec, X_dup, Y_dup, theta, 1e-5,
                                          cv_dtype="mixed", **kw)
    assert np.isfinite(a["mean_nlpd"])
    assert np.isfinite(b["mean_nlpd"])
    # a's flagged folds and b's re-score both run f64, but through different
    # compiled programs (a: plain float64 rescore; b: rescue=True full
    # fallback chain) whose fusion orders differ -> f64-roundoff-level
    # disagreement, not exact equality
    np.testing.assert_allclose(b["mean_nlpd"], a["mean_nlpd"], rtol=1e-6)


@pytest.mark.slow
def test_2d_mesh_mixed_matches_float64():
    """Mixed solver through the agents x data 2-D mesh path."""
    n_dev = len(jax.devices())
    if n_dev < 4:
        pytest.skip("needs 4 virtual devices")
    from dqgp.driver import init_admm_state
    from dqgp.parallel import (
        agents_data_mesh, make_admm_step_2d, make_agent_batch,
        shard_batch_to_mesh_2d,
    )

    spec, X, Y, splits = _mini_problem()
    splits2 = splits[:2]
    mesh = agents_data_mesh(2, 2)
    batch = make_agent_batch(splits2)
    theta0, psi0, _ = init_admm_state(2, spec.num_parameters, 42, 100.0)

    def run(gp_dtype):
        b, th, ps = shard_batch_to_mesh_2d(batch, theta0, psi0, mesh)
        step = make_admm_step_2d(spec, mesh, rho=100.0, L=100.0, noise_std=0.1,
                                 compute_cond=False, gp_dtype=gp_dtype)
        out = step(th, ps, b)
        return np.asarray(out.theta)

    np.testing.assert_array_equal(run("mixed"), run("float64"))


def test_mixed_flag_mode_nans_instead_of_rescue():
    C = _spd(48, cond=1e10, seed=2)
    y = jnp.asarray(np.random.RandomState(3).randn(48))
    res = jax.jit(lambda c, b: solve_psd_mixed(c, b, on_fail="flag"))(C, y)
    assert not bool(res.chol_ok)
    assert not np.any(np.isfinite(np.asarray(res.C_inv_y)))


@pytest.mark.slow
def test_driver_retries_flagged_mixed_iteration():
    """An (effectively) singular agent system defeats the f32 refinement;
    the driver must transparently redo the iteration in float64 and produce
    the float64 run's exact trajectory."""
    from dqgp.driver import train, TrainConfig

    spec, X, Y, splits = _mini_problem()
    # duplicate every row within each agent shard -> rank-deficient Grams;
    # tiny noise keeps C from being regularized back to f32 reach
    splits_dup = [(np.concatenate([Xi, Xi]), np.concatenate([Yi, Yi]))
                  for Xi, Yi in splits]
    X_dup = np.concatenate([s[0] for s in splits_dup])
    Y_dup = np.concatenate([s[1] for s in splits_dup])
    base = dict(rho=100.0, L=100.0, max_iter=2, cv_folds=0, seed=42,
                noise_std=1e-6, verbose=False, run_cv=False,
                compute_cond=False)
    r_mixed = train(spec, splits_dup, X_dup, Y_dup,
                    TrainConfig(gp_dtype="mixed", **base))
    r_f64 = train(spec, splits_dup, X_dup, Y_dup,
                  TrainConfig(gp_dtype="float64", **base))
    assert np.all(np.isfinite(r_mixed.z))
    np.testing.assert_array_equal(r_mixed.z, r_f64.z)
    np.testing.assert_array_equal(np.asarray(r_mixed.theta),
                                  np.asarray(r_f64.theta))
    # numeric provenance (VERDICT r3 weak #8): a flagged-then-rescued
    # iteration must be tagged, so its log-det components carry their
    # accuracy class (exact f64 here, not ~N*eps_f32 mixed)
    solvers = [row["solver"] for row in r_mixed.nll_history]
    assert "float64-rescue" in solvers
    assert all(s in ("mixed", "float64-rescue") for s in solvers)
    assert all(row["solver"] == "float64" for row in r_f64.nll_history)


@pytest.mark.slow
def test_chained_driver_retries_flagged_mixed_iteration():
    """Same as above but with chained dispatch: a flagged row poisons the
    rest of its chunk (NaN theta/psi propagate through the scan), so the
    driver must truncate the chunk at the flagged row, redo it in float64
    from the pre-row state, and resume chunking from the corrected state."""
    from dqgp.driver import train, TrainConfig

    spec, X, Y, splits = _mini_problem()
    splits_dup = [(np.concatenate([Xi, Xi]), np.concatenate([Yi, Yi]))
                  for Xi, Yi in splits]
    X_dup = np.concatenate([s[0] for s in splits_dup])
    Y_dup = np.concatenate([s[1] for s in splits_dup])
    base = dict(rho=100.0, L=100.0, max_iter=3, cv_folds=0, seed=42,
                noise_std=1e-6, verbose=False, run_cv=False,
                compute_cond=False)
    r_mixed = train(spec, splits_dup, X_dup, Y_dup,
                    TrainConfig(gp_dtype="mixed", chain_iters=2, **base))
    r_f64 = train(spec, splits_dup, X_dup, Y_dup,
                  TrainConfig(gp_dtype="float64", **base))
    assert r_mixed.iterations == r_f64.iterations == 3
    assert np.all(np.isfinite(r_mixed.z))
    np.testing.assert_array_equal(r_mixed.z, r_f64.z)
    np.testing.assert_array_equal(np.asarray(r_mixed.theta),
                                  np.asarray(r_f64.theta))
    np.testing.assert_array_equal(np.asarray(r_mixed.psi),
                                  np.asarray(r_f64.psi))
    # provenance survives chunk truncation: the rescued mid-chunk row is
    # tagged, rows solved by the mixed step keep their own tag
    solvers = [row["solver"] for row in r_mixed.nll_history]
    assert "float64-rescue" in solvers
    assert all(s in ("mixed", "float64-rescue") for s in solvers)


@pytest.mark.slow
def test_history_rows_tagged_with_resolved_solver():
    """Un-flagged runs: every nll row carries the resolved gp_dtype and every
    cv row the resolved cv_dtype (auto -> float64 on the CPU test backend)."""
    from dqgp.driver import train, TrainConfig

    spec, X, Y, splits = _mini_problem()
    res = train(spec, splits, X, Y,
                TrainConfig(rho=100.0, L=100.0, max_iter=2, cv_folds=2,
                            seed=42, noise_std=0.1, verbose=False,
                            compute_cond=False))
    assert [row["solver"] for row in res.nll_history] == ["float64"] * 2
    assert [row["solver"] for row in res.cv_history] == ["float64"] * 2


def test_flag_solvers_ignore_caller_fallback():
    """The solver string owns the failure semantics: a caller passing
    fallback=True (a plain keyword that would override a functools.partial
    binding) must NOT re-enable the in-program rescue of a '-flag' solver —
    under vmap the rescue branch would execute on every call."""
    from dqgp.ops.linalg import get_psd_solver

    n = 16
    rng = np.random.RandomState(4)
    A = rng.randn(n, n)
    y = jnp.asarray(rng.randn(n))
    for dt in (jnp.float64, jnp.float32):
        C = jnp.asarray((A + A.T) / 2, dt)  # indefinite: Cholesky fails
        for name in ("direct-flag", "mixed-flag"):
            solve = get_psd_solver(name)
            res = jax.jit(lambda c, b: solve(c, b, fallback=True))(C, y.astype(dt))
            assert not bool(res.chol_ok), (name, dt)
            assert not np.any(np.isfinite(np.asarray(res.C_inv_y))), (name, dt)


def test_mixed_flag_f32_input_keeps_flag_contract():
    """solve_psd_mixed's non-f64 early return must preserve on_fail='flag'
    (reached when DQGP_X64=0 downgrades a mixed caller's dtype to f32 while
    the solver string stays 'mixed-flag')."""
    n = 12
    rng = np.random.RandomState(7)
    A = rng.randn(n, n)
    C = jnp.asarray((A + A.T) / 2, jnp.float32)  # indefinite
    y = jnp.asarray(rng.randn(n), jnp.float32)
    res = jax.jit(
        lambda c, b: solve_psd_mixed(c, b, fallback=True, on_fail="flag")
    )(C, y)
    assert not bool(res.chol_ok)
    assert not np.any(np.isfinite(np.asarray(res.C_inv_y)))


def test_masked_nll_core_flag_solver_flags_failure():
    """masked_nll_core(solver='direct-flag') with the default fallback=True
    must surface a failed factorization as NaN/chol_ok=False, not rescue it
    in-program (the caller-keyword-overrides-partial trap)."""
    from dqgp.models.gp.posterior import masked_nll_core

    n = 16
    rng = np.random.RandomState(9)
    A = rng.randn(n, n)
    K = jnp.asarray((A + A.T) / 2, jnp.float64) - 50.0 * jnp.eye(n)  # very indefinite
    y = jnp.asarray(rng.randn(n))
    mask = jnp.ones((n,), jnp.float64)
    res, bracket = jax.jit(
        lambda k, b, m: masked_nll_core(k, b, m, 0.1, compute_cond=False,
                                        fallback=True, solver="direct-flag")
    )(K, y, mask)
    assert not bool(res.chol_ok)
    assert not np.isfinite(float(res.nll))
