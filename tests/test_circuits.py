"""Encoding-circuit library invariants (SURVEY.md §2.5)."""

import numpy as np
import jax.numpy as jnp
import pytest

from dqgp.models.circuits import ENCODING_TYPES, build_circuit
from dqgp.ops import statevector as sv


@pytest.mark.parametrize("enc", ENCODING_TYPES)
@pytest.mark.parametrize("n,d,layers", [(2, 1, 1), (3, 2, 2), (4, 3, 1)])
def test_build_and_run_all_encodings(enc, n, d, layers):
    c = build_circuit(enc, n, d, layers)
    assert c.num_qubits == n and c.num_features == d
    assert c.num_parameters > 0  # every family must be trainable for ADMM
    rng = np.random.RandomState(0)
    X = rng.uniform(-0.9, 0.9, (4, d))
    theta = rng.uniform(0, np.pi, (c.num_parameters,))
    psi = np.asarray(sv.batched_states(c, jnp.asarray(X), jnp.asarray(theta)))
    # normalized states, no NaNs
    assert np.all(np.isfinite(psi.view(np.float32)))
    np.testing.assert_allclose(np.sum(np.abs(psi) ** 2, axis=1), 1.0, atol=1e-5)


def test_hubregtsen_parameter_count_pinned_by_reference_example():
    # main.py:2020-2021: --kernel-params takes 6 values for the 3-qubit,
    # 1-layer hubregtsen BASELINE config #1.
    c = build_circuit("hubregtsen", 3, 2, 1)
    assert c.num_parameters == 6


def test_chebyshev_is_the_only_clipping_family():
    for enc in ENCODING_TYPES:
        c = build_circuit(enc, 3, 2, 2)
        assert c.requires_clipping == (enc == "chebyshev")


@pytest.mark.slow
def test_parameters_affect_state():
    for enc in ENCODING_TYPES:
        c = build_circuit(enc, 3, 2, 2)
        rng = np.random.RandomState(1)
        X = jnp.asarray(rng.uniform(-0.9, 0.9, (2, 2)))
        t0 = jnp.asarray(rng.uniform(0, np.pi, (c.num_parameters,)))
        t1 = t0.at[0].add(0.3)
        s0 = np.asarray(sv.batched_states(c, X, t0))
        s1 = np.asarray(sv.batched_states(c, X, t1))
        assert not np.allclose(s0, s1), enc


def test_random_circuit_deterministic_in_seed():
    a = build_circuit("random", 3, 2, 2, seed=0)
    b = build_circuit("random", 3, 2, 2, seed=0)
    assert a.gates == b.gates
    c = build_circuit("random", 3, 2, 2, seed=1)
    assert a.gates != c.gates


def test_features_reach_the_state():
    for enc in ENCODING_TYPES:
        c = build_circuit(enc, 3, 2, 2)
        rng = np.random.RandomState(2)
        theta = jnp.asarray(rng.uniform(0, np.pi, (c.num_parameters,)))
        x0 = jnp.asarray([[0.1, -0.4]])
        x1 = jnp.asarray([[0.6, 0.2]])
        s0 = np.asarray(sv.batched_states(c, x0, theta))
        s1 = np.asarray(sv.batched_states(c, x1, theta))
        assert not np.allclose(s0, s1), enc


def test_parameter_count_formulas():
    """Pin the P(n, d, L) formula table from docs/PARITY.md — the contract
    theta* recovery and every Gram fixture depend on."""
    ring = lambda n: 1 if n == 2 else n
    formulas = {
        "chebyshev": lambda n, L: n + L * (2 * n + ring(n)),
        "yz_cx": lambda n, L: 2 * n * L,
        "hubregtsen": lambda n, L: L * (n + ring(n)),
        "kyriienko": lambda n, L: 2 * n * L,
        "multi_control": lambda n, L: L * (ring(n) + n),
        "layered": lambda n, L: 3 * n * L,
        "highdim": lambda n, L: n * L,
    }
    for enc, f in formulas.items():
        for (n, d, L) in [(2, 1, 1), (3, 2, 1), (4, 2, 3), (5, 3, 4), (6, 2, 3)]:
            c = build_circuit(enc, n, d, L)
            assert c.num_parameters == f(n, L), (enc, n, d, L, c.num_parameters)
    # random: seed-dependent within [nL, 2nL]; seed-0 values pinned
    for (n, d, L), expect in [((3, 2, 1), 4), ((4, 2, 3), 18), ((5, 3, 4), 29)]:
        c = build_circuit("random", n, d, L)
        assert n * L <= c.num_parameters <= 2 * n * L
        assert c.num_parameters == expect, (n, d, L, c.num_parameters)
