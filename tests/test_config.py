"""Runtime-config knobs (dqgp.config + package-init env handling).

Env-driven behavior is tested in subprocesses so each case sees a fresh
import with its own environment.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, **env):
    e = dict(os.environ)
    e.update(env)
    e["PYTHONPATH"] = REPO + os.pathsep + e.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", code], env=e,
                          capture_output=True, text=True, timeout=300)


def test_compile_cache_knob():
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and the package sets
    no other."""
    r = _run(
        "import dqgp, jax;"
        "print(jax.config.jax_compilation_cache_dir)",
        JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR="/tmp/dqgp_cache_test_knob",
    )
    assert r.returncode == 0, r.stderr[-500:]
    assert r.stdout.strip().splitlines()[-1] == "/tmp/dqgp_cache_test_knob"


def test_compile_cache_off_by_default():
    """Without JAX_COMPILATION_CACHE_DIR the cache sits at a fixed path in
    the checkout (the path is part of the cache key)."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-c",
         "import dqgp, jax;"
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, timeout=300, cwd="/")
    assert r.returncode == 0, r.stderr[-500:]
    assert r.stdout.strip().splitlines()[-1] == os.path.join(REPO, ".jax_cache")


def test_config_has_no_kernel_knobs():
    """One engine: the config module exposes the precision policy only — no
    Pallas/fusion switches, and no DQGP_* knob for them is read anywhere."""
    import dqgp.config as config

    public = {k for k in vars(config) if not k.startswith("_")}
    assert public - {"annotations"} == {"resolve_dtype_mode",
                                         "resolve_gram_dtype"}
    pkg = os.path.join(REPO, "dqgp")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f)).read()
                for knob in ("DQGP_USE_PALLAS", "DQGP_PALLAS_MIN_QUBITS",
                             "DQGP_FUSION", "DQGP_COMPILE_CACHE"):
                    assert knob not in src, (f, knob)


def test_x64_knob_off():
    r = _run(
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import dqgp;"
        "print(jax.config.jax_enable_x64)",
        JAX_PLATFORMS="cpu", DQGP_X64="0",
    )
    assert r.returncode == 0, r.stderr[-500:]
    assert r.stdout.strip().splitlines()[-1] == "False"


def test_jax_platforms_env_honored_without_manual_pin():
    """Importing dqgp alone must land on the CPU backend when
    JAX_PLATFORMS=cpu: the package never repins the platform."""
    r = _run(
        "import dqgp; import jax;"
        "print(jax.default_backend())",
        JAX_PLATFORMS="cpu",
    )
    assert r.returncode == 0, r.stderr[-500:]
    assert r.stdout.strip().splitlines()[-1] == "cpu"


def test_x64_off_rejects_explicit_float64_requests():
    """With DQGP_X64=0, an explicit float64 request must raise rather than
    silently return float32-grade values under an f64 label — both on the
    QuantumKernel facade and the dataset generator."""
    code = "\n".join([
        "import jax",
        "jax.config.update('jax_platforms','cpu')",
        "import dqgp",
        "from dqgp.models.circuits import build_circuit",
        "from dqgp.models.kernels import QuantumKernelSpec",
        "from dqgp.models.kernels.quantum_kernel import QuantumKernel",
        "from dqgp.data import generate_quantum_gp_data",
        "spec = QuantumKernelSpec(circuit=build_circuit('hubregtsen', 2, 1, 1),",
        "                         kernel_type='projected', outer_kernel='gaussian')",
        "def expect_raise(fn):",
        "    try:",
        "        fn()",
        "    except ValueError as e:",
        "        assert 'x64' in str(e), e",
        "    else:",
        "        raise AssertionError('no ValueError')",
        "expect_raise(lambda: QuantumKernel(spec, dtype='float64'))",
        "expect_raise(lambda: generate_quantum_gp_data(",
        "    num_samples=4, input_dim=1, spec=spec, gram_dtype='float64'))",
        "# auto must quietly resolve to f32 (no raise) when x64 is off",
        "QuantumKernel(spec, dtype='auto')",
        "print('GUARDS_OK')",
    ])
    r = _run(code, JAX_PLATFORMS="cpu", DQGP_X64="0")
    assert r.returncode == 0, r.stderr[-1000:]
    assert r.stdout.strip().splitlines()[-1] == "GUARDS_OK"


def test_resolve_dtype_mode_passthrough():
    from dqgp.config import resolve_dtype_mode

    for m in ("float64", "float32", "mixed"):
        assert resolve_dtype_mode(m) == m
    # auto = direct f64 on every backend
    assert resolve_dtype_mode("auto") == "float64"
