"""Marginal-likelihood noise fitting (models/gp/noise.py) + the CLI's
--fit-noise / --predictive-noise knobs (additive; parity defaults off).

Round-4 motivation: the SRTM validation misses at the reference config were
noise misspecification (fixed --noise-std 0.1 on normalized real data whose
residual scale is ~0.5) plus latent-only predictive variance — see
docs/PERFORMANCE.md's calibration section.
"""

import numpy as np
import pytest

from dqgp.models.circuits import build_circuit
from dqgp.models.kernels import QuantumKernelSpec
from dqgp.models.gp import fit_noise_std


def _spec(qubits=2, d=1, layers=1):
    return QuantumKernelSpec(
        circuit=build_circuit("hubregtsen", qubits, d, layers),
        kernel_type="projected", outer_kernel="matern",
    )


def test_fit_recovers_generating_noise():
    """Data sampled from the quantum-GP prior with known sigma: the MLL
    optimum at the GENERATING parameters must land near sigma (the estimator
    is consistent; at N=300 its stderr is ~sigma/sqrt(2N) ~ 3%)."""
    from dqgp.data import generate_quantum_gp_data

    spec = _spec()
    sigma = 0.3
    X, Y, theta_star = generate_quantum_gp_data(
        num_samples=300, input_dim=1, spec=spec, noise_std=sigma,
        data_seed=11)
    fit = fit_noise_std(spec, X, Y, theta_star, current_noise_std=0.1)
    assert abs(fit.noise_std - sigma) / sigma < 0.25, fit.noise_std
    # the optimum must be at least as likely as the misspecified input
    assert fit.nmll <= fit.nmll_at_input


def test_fit_detects_gross_misspecification():
    """Y with much larger noise than the default 0.1: the fit must move up
    and improve the marginal likelihood decisively."""
    from dqgp.data import generate_quantum_gp_data

    spec = _spec()
    X, Y, theta_star = generate_quantum_gp_data(
        num_samples=200, input_dim=1, spec=spec, noise_std=0.8,
        data_seed=12)
    fit = fit_noise_std(spec, X, Y, theta_star, current_noise_std=0.1)
    assert fit.noise_std > 0.4
    assert fit.nmll < fit.nmll_at_input - 10.0  # decisive, not marginal


def test_fit_accepts_precomputed_gram():
    from dqgp.data import generate_quantum_gp_data
    from dqgp.models.kernels.quantum_kernel import gram

    import jax.numpy as jnp

    spec = _spec()
    X, Y, theta_star = generate_quantum_gp_data(
        num_samples=80, input_dim=1, spec=spec, noise_std=0.2, data_seed=13)
    # same precision as the internal build (f64 on the CPU test backend)
    K = np.asarray(gram(spec, jnp.asarray(X, jnp.float64),
                        jnp.asarray(theta_star, jnp.float64),
                        dtype=jnp.float64))
    a = fit_noise_std(spec, X, Y, theta_star)
    b = fit_noise_std(spec, X, Y, theta_star, K=K)
    # jit fusion reorders the internal build's f64 ops vs this eager K —
    # entries agree to roundoff, the fitted sigma to ~1e-8
    np.testing.assert_allclose(a.noise_std, b.noise_std, rtol=1e-6)


@pytest.mark.slow
def test_cli_fit_noise_and_predictive_noise(tmp_path):
    """End-to-end: --fit-noise replaces the misspecified constant and
    --predictive-noise scores observed-Y variance; summary records both.
    Data generated with sigma=0.5 but the CLI told 0.1 — coverage must
    improve over the misspecified parity run."""
    from dqgp.cli import main

    common = [
        "--input-dim", "1", "--n-dataset", "120", "--encoding", "hubregtsen",
        "--kernel-type", "projected", "--num-qubits", "2", "--num-layers", "1",
        "--outer-kernel", "matern", "--n-agents", "2", "--max-iter", "2",
        "--cv-folds", "3", "--data-seed", "21", "--no-plot", "--no-cond",
        "--quiet", "--noise-std", "0.1", "--generating-noise-std", "0.5",
    ]
    base = main(common)
    fitted = main(common + ["--fit-noise", "--predictive-noise"])
    assert fitted["noise_fit"] is not None
    assert fitted["eval_noise_std"] == pytest.approx(
        fitted["noise_fit"]["fitted_noise_std"])
    assert fitted["noise_fit"]["fitted_noise_std"] > 0.25  # moved off 0.1
    # observed-Y scoring with the fitted sigma must calibrate better
    assert (fitted["test_metrics"]["within_2sigma"]
            >= base["test_metrics"]["within_2sigma"])
    assert fitted["test_metrics"]["nlpd"] < base["test_metrics"]["nlpd"]
    assert base["noise_fit"] is None
    assert base["eval_noise_std"] == pytest.approx(0.1)


@pytest.mark.slow
def test_cli_fit_noise_subsample_cap(tmp_path):
    """Past --fit-noise-max-samples the exact dense-Gram fit runs on a
    seeded subsample (forced cheaply here by shrinking the cap); the fitted
    sigma must still move off the misspecified constant. Also exercises the
    CG-posterior predict with the fitted sigma via --predict-cg-threshold."""
    from dqgp.cli import main

    s = main([
        "--input-dim", "1", "--n-dataset", "150", "--encoding", "hubregtsen",
        "--kernel-type", "projected", "--num-qubits", "2", "--num-layers", "1",
        "--outer-kernel", "matern", "--n-agents", "2", "--max-iter", "2",
        "--cv-folds", "3", "--data-seed", "22", "--no-plot", "--no-cond",
        "--quiet", "--noise-std", "0.1", "--generating-noise-std", "0.5",
        "--fit-noise", "--predictive-noise", "--predict-cg-threshold", "64",
        "--fit-noise-max-samples", "64",
    ])
    assert s["noise_fit"] is not None
    assert s["noise_fit"]["fit_samples"] == 64  # genuinely subsampled
    assert s["noise_fit"]["fitted_noise_std"] > 0.25
