"""Property-based tests (hypothesis) for the torus-manifold algebra.

The example-based tests in test_manifold.py pin reference quirks; these
pin the mathematical invariants that must hold for EVERY input — wrap
idempotence/range, distance metric axioms on the quotient, exp/log
consistency, circular-mean shift equivariance, and the psum-reducibility
identity that the distributed consensus step relies on
(circular_mean == circular_mean_from_sums of per-shard partial sums).
"""

import pytest
import numpy as np
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from dqgp import manifold as M

angles = st.floats(min_value=-50.0, max_value=50.0,
                   allow_nan=False, allow_infinity=False)


def vecs(n=4):
    return st.lists(angles, min_size=n, max_size=n).map(
        lambda v: jnp.asarray(np.array(v, np.float64)))


@settings(max_examples=200, deadline=None)
@given(vecs())
def test_wrap_idempotent_and_in_range(x):
    """wrap lands in [0, PERIOD] (CLOSED at PERIOD: np.mod/jnp.mod of a
    tiny negative rounds to exactly PERIOD — the reference's np.mod has the
    identical edge) and is idempotent on the quotient: re-wrapping may map
    the PERIOD boundary to 0, which is the same torus point."""
    w = M.wrap(x)
    wn = np.asarray(w)
    assert np.all((wn >= 0) & (wn <= M.PERIOD))
    assert float(M.distance(M.wrap(w), w)) < 1e-12


@settings(max_examples=200, deadline=None)
@given(vecs(), vecs())
def test_distance_metric_axioms(x, y):
    d_xy = float(M.distance(x, y))
    d_yx = float(M.distance(y, x))
    assert d_xy >= 0
    # symmetry on the quotient
    np.testing.assert_allclose(d_xy, d_yx, atol=1e-9)
    # identity of indiscernibles up to the period
    assert float(M.distance(x, x)) < 1e-9
    # period invariance: shifting either argument by the period is free
    np.testing.assert_allclose(
        float(M.distance(x + M.PERIOD, y)), d_xy, atol=1e-9)
    # per-component distance bounded by half the period (2-norm overall)
    assert d_xy <= np.sqrt(x.shape[0]) * M.PERIOD / 2 + 1e-9


@settings(max_examples=200, deadline=None)
@given(vecs(), vecs())
def test_exp_of_signed_log_recovers_target(x, y):
    """exp_map(x, signed_arc(x, y)) == y on the torus (the SIGNED log is the
    true inverse; the reference's unsigned log_map is pinned elsewhere)."""
    z = M.exp_map(x, M.signed_arc(x, y))
    assert float(M.distance(z, y)) < 1e-9


@settings(max_examples=200, deadline=None)
@given(vecs(), st.floats(min_value=-3.0, max_value=3.0,
                         allow_nan=False, allow_infinity=False))
def test_circular_mean_shift_equivariance(x, s):
    """Rotating every sample by s rotates the circular mean by s."""
    X = jnp.stack([x, x + 0.1, x - 0.2])
    m0 = M.circular_mean(X)
    m1 = M.circular_mean(X + s)
    assert float(M.distance(m1, M.wrap(m0 + s))) < 1e-7


@settings(max_examples=100, deadline=None)
@given(st.lists(st.lists(angles, min_size=3, max_size=3),
                min_size=2, max_size=8))
def test_circular_mean_is_psum_reducible(rows):
    """The distributed consensus identity: the circular mean equals the mean
    from psum-style partial (cos, sin) sums over arbitrary row shards."""
    X = jnp.asarray(np.array(rows, np.float64))
    want = np.asarray(M.circular_mean(X))
    w = 2.0 * np.pi / M.PERIOD
    cos_sum = jnp.sum(jnp.cos(w * X), axis=0)
    sin_sum = jnp.sum(jnp.sin(w * X), axis=0)
    got = np.asarray(M.circular_mean_from_sums(cos_sum, sin_sum))
    np.testing.assert_allclose(got, want, atol=1e-9)


@settings(max_examples=200, deadline=None)
@given(vecs(), vecs(), vecs())
def test_admm_psi_update_wraps_like_reference(z, theta, psi):
    """psi' = psi + rho * log_map(z, theta) with the reference's UNSIGNED
    wrapped difference in [0, period) — psi' - psi must be rho * that."""
    rho = 100.0
    psi2 = M.admm_update_psi(psi, theta, z, rho)
    diff = np.asarray(psi2 - psi) / rho
    assert np.all((diff >= -1e-12) & (diff < M.PERIOD + 1e-9))
    np.testing.assert_allclose(
        diff, np.asarray(M.wrap(theta - z)), atol=1e-9)


# ---------------------------------------------------------------------------
# Statevector unitarity properties (every encoding, random angles)
# ---------------------------------------------------------------------------


@settings(max_examples=25, deadline=None)
@given(st.integers(min_value=0, max_value=2**31 - 1))
@pytest.mark.slow
def test_all_encodings_preserve_norm(seed):
    """Every gate in the IR is unitary, so |psi(x, theta)|_2 == 1 for every
    encoding family, input, and parameter draw — the invariant behind
    fidelity-Gram diag == 1 and projected features in [-1, 1]."""
    from dqgp.models.circuits import ENCODING_TYPES, build_circuit
    from dqgp.ops.statevector import angle_matrix, state_from_angles

    rng = np.random.RandomState(seed % (2**31 - 1))
    enc = ENCODING_TYPES[seed % len(ENCODING_TYPES)]
    n = 2 + seed % 3          # 2..4 qubits
    circ = build_circuit(enc, n, 2, 1 + seed % 2)
    X = jnp.asarray(rng.uniform(-0.9, 0.9, (5, 2)), jnp.float32)
    theta = jnp.asarray(rng.uniform(0, np.pi, circ.num_parameters), jnp.float32)
    psi = state_from_angles(circ, angle_matrix(circ, X, theta))
    norms = np.asarray(jnp.sum(jnp.abs(psi) ** 2, axis=-1))
    np.testing.assert_allclose(norms, 1.0, atol=5e-6)
