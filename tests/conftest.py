"""Test env: an 8-device virtual CPU mesh before jax initializes.

Mirrors SURVEY.md §4's implication: distributed logic is tested on a CPU mesh
(``--xla_force_host_platform_device_count``), so no accelerator is needed.
An explicit ``JAX_PLATFORMS`` wins, so the card's tests run with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_chip_smoke.py``.
"""

import os
import sys

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none. Decided
    here, at run time, never at import or collection."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU (JAX default platform is {devs[0].platform!r})")
    return devs[0]
