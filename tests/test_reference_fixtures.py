"""Golden-Gram fixture loader: drop-in verification against the pip reference.

squlearn 0.9.1 is unavailable in this offline environment, so the encoding
circuits in ``dqgp/models/circuits/library.py`` are re-derivations
(SURVEY.md §7 hard-part #1). When Gram matrices recorded from the actual
reference become available, drop them into ``fixtures/`` as ``.npz`` files
and this test consumes them with no code changes.

Fixture contract — one ``.npz`` per case with arrays/scalars:

* ``X``         (N, d) float  — inputs exactly as fed to squlearn
* ``theta``     (P,) float    — circuit parameters (wrapped or not; they are
                                 used verbatim)
* ``K``         (N, N) float  — ``q_kernel.evaluate(X, X)`` from the reference
* ``encoding``  str           — one of the 8 family names
* ``num_qubits`` / ``num_features`` / ``num_layers``  int
* ``kernel_type`` str         — 'fidelity' | 'projected'
* ``measurement`` str         — e.g. 'XYZ' (projected only; optional)
* ``outer_kernel`` str        — e.g. 'gaussian' (projected only; optional)
* ``rtol`` / ``atol`` float   — optional tolerance overrides

Recording script for a machine with the reference installed:

    k = create_quantum_kernel(...); k.assign_parameters(theta)
    np.savez("fixtures/<name>.npz", X=X, theta=theta, K=k.evaluate(X, X),
             encoding="chebyshev", num_qubits=4, num_features=2,
             num_layers=3, kernel_type="projected", measurement="XYZ",
             outer_kernel="gaussian")
"""

import glob
import os

import numpy as np
import pytest

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "fixtures")
FIXTURES = sorted(glob.glob(os.path.join(FIXTURE_DIR, "*.npz")))


def _scalar(z, key, default=None):
    if key not in getattr(z, "files", []):
        return default
    v = z[key]
    return v.item() if getattr(v, "shape", None) == () else v


@pytest.mark.skipif(not FIXTURES, reason="no reference Gram fixtures recorded "
                                         "(fixtures/*.npz absent)")
@pytest.mark.parametrize("path", FIXTURES, ids=[os.path.basename(p) for p in FIXTURES])
def test_gram_matches_reference_fixture(path):
    from dqgp.models.kernels import create_quantum_kernel

    z = np.load(path, allow_pickle=False)
    kernel = create_quantum_kernel(
        num_qubits=int(_scalar(z, "num_qubits")),
        num_features=int(_scalar(z, "num_features")),
        num_layers=int(_scalar(z, "num_layers")),
        encoding_type=str(_scalar(z, "encoding")),
        kernel_type=str(_scalar(z, "kernel_type", "fidelity")),
        measurement=str(_scalar(z, "measurement", "XYZ")),
        outer_kernel=str(_scalar(z, "outer_kernel", "gaussian")),
    )
    theta = np.asarray(z["theta"], np.float64)
    assert kernel.num_parameters == theta.shape[0], (
        f"parameter-count mismatch: builder {kernel.num_parameters} vs "
        f"fixture {theta.shape[0]} — gate sequence diverges from squlearn"
    )
    kernel.assign_parameters(theta)
    K = kernel.evaluate(np.asarray(z["X"], np.float64))
    rtol = float(_scalar(z, "rtol", 1e-4))
    atol = float(_scalar(z, "atol", 1e-5))
    np.testing.assert_allclose(K, np.asarray(z["K"], np.float64),
                               rtol=rtol, atol=atol)

    # Second, much sharper check through the f64 pipeline (complex128
    # statevectors — the same precision squlearn/qiskit-aer computed the
    # recorded Gram at): if the gate sequences truly match, agreement is
    # ~1e-12; anything beyond ~1e-7 means a real semantic divergence that
    # the f32 production tolerance above could mask.
    import jax.numpy as jnp
    from dqgp.models.kernels.quantum_kernel import gram

    K64 = np.asarray(gram(kernel.spec, jnp.asarray(z["X"], jnp.float64),
                          jnp.asarray(theta, jnp.float64),
                          dtype=jnp.float64))
    f64_rtol = float(_scalar(z, "f64_rtol", 1e-7))
    np.testing.assert_allclose(K64, np.asarray(z["K"], np.float64),
                               rtol=f64_rtol, atol=f64_rtol)
