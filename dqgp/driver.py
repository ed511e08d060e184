"""ADMM training orchestrator — twin of the reference's ``main()`` loop
(main.py:2403-2784) on top of the jitted mesh step.

Host responsibilities only: convergence bookkeeping, CV-based model selection
with patience, ground-truth tracking, metrics history, checkpointing. All
device work (consensus z-update, 2P+1 shifted Grams, NLL gradients, theta/psi
updates, per-iteration CV) is compiled XLA.

Stopping rules (main.py:2767-2784): consensus ``all(||z - theta_i||_2 < tol)``
(Euclidean norm — a reference quirk, NOT the Riemannian distance), CV patience
exhaustion, or max_iter; on the latter two the best-CV z is restored.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import manifold as M
from .models.gp.cv import k_fold_cross_validation_consensus
from .models.kernels.quantum_kernel import QuantumKernelSpec
from .parallel.consensus import (
    STEP_GRAM_DTYPE,
    agents_mesh,
    make_admm_step,
    make_agent_batch,
    shard_batch_to_mesh,
)


@dataclasses.dataclass
class TrainConfig:
    rho: float = 100.0
    L: float = 100.0
    noise_std: float = 0.1
    max_iter: int = 100
    tolerance: float = 1e-6
    shift_value: float = float(np.pi / 8)
    cv_folds: int = 5
    cv_patience: int = 50
    seed: int = 42
    parity_round: bool = True       # 4-decimal quantization (reference quirk)
    compute_cond: bool = True       # per-iteration condition numbers (eigvalsh)
    cond_mode: str = "auto"         # where the (reporting-only) condition
                                    # numbers compute: "device" fuses them
                                    # into the step program (f32-built Gram);
                                    # "host" rebuilds each agent's noise-free
                                    # Gram in full f64 (complex128 states) on
                                    # the CPU backend and takes an exact f64
                                    # eigvalsh — zero accelerator time and
                                    # the reference's np.linalg.cond f64
                                    # semantics. "auto" = host on accelerator
                                    # backends, device on CPU.
    gp_dtype: str = "auto"          # GP linalg dtype: "auto" = float64;
                                    # "mixed" = f64-grade via f32 factor +
                                    # f64 refinement; "float32" for raw speed
    cv_dtype: str = "auto"          # CV fold dtype, same modes as gp_dtype
    psd_fallback: bool = True       # compile the eigh-pinv fallback branch
    grad_method: str = "central"    # "central" (parity) | "streamed" (parity,
                                    # O(N^2) memory) | "autodiff" (exact)
    run_cv: bool = True             # per-iteration k-fold CV model selection
    cv_max_samples: Optional[int] = None  # subsample X_train for CV beyond
                                    # this size (the dense fold Grams are
                                    # O(n^2); scale-out runs cap the CV set)
    chain_iters: int = 1            # >1: run this many ADMM iterations per
                                    # device dispatch (lax.scan over the
                                    # fused step+CV body), amortizing the
                                    # per-iteration dispatch and fetch.
                                    # Trajectory and stopping iteration are
                                    # identical — rows replay through the
                                    # same host bookkeeping in order and
                                    # speculative iterations past a stop
                                    # are discarded.
    n_mesh_devices: Optional[int] = None  # None = all local devices
    data_mesh_cols: Optional[int] = None  # >1: agents x data 2-D mesh — each
                                    # agent's Gram panels row-shard over this
                                    # many devices (scale-out training)
    solve_2d: str = "replicated"    # 2-D mesh solve: "replicated" (each data
                                    # column solves the full N x N system) or
                                    # "distributed" (row-sharded blocked
                                    # Cholesky + bracket, O(N^2/cols) memory
                                    # per device — for agents whose N^2 no
                                    # longer fits one chip; central/streamed
                                    # grads, f32/f64 only, cond via host)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 10
    verbose: bool = True
    verbose_agents: bool = False    # reference-style per-agent NLL/cond report


@dataclasses.dataclass
class TrainResult:
    z: np.ndarray
    z_best_cv: Optional[np.ndarray]
    cv_best: float
    theta: np.ndarray
    psi: np.ndarray
    iterations: int
    converged_by: str
    nll_history: List[Dict]
    cv_history: List[Dict]
    error_history: List[float]
    z_best_gt: Optional[np.ndarray]
    error_best: float
    total_time: float


def init_admm_state(n_agents: int, num_parameters: int, seed: int, rho: float,
                    parity_round: bool = True):
    """theta, psi ~ U(0,1) rounded 4dp; z = circular mean (main.py:2403-2461).

    Uses numpy's legacy global RNG exactly as the reference does after
    ``np.random.seed(args.seed)`` so fixed seeds reproduce its initial state.
    """
    np.random.seed(seed)
    theta = np.round(np.random.rand(n_agents, num_parameters), 4)
    psi = np.round(np.random.rand(n_agents, num_parameters), 4)
    z = M.np_circular_mean(theta + psi / rho)
    if parity_round:
        z = np.round(z, 4)
    return theta, psi, z


def save_checkpoint(path: str, iteration: int, theta, psi, z, cv_best, z_best_cv,
                    patience_counter: int, extra: Optional[Dict] = None):
    """Checkpoint/resume — a capability the reference lacks (SURVEY.md §5.4)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(
        path,
        iteration=iteration,
        theta=np.asarray(theta),
        psi=np.asarray(psi),
        z=np.asarray(z),
        cv_best=cv_best,
        z_best_cv=(np.asarray(z_best_cv) if z_best_cv is not None else np.zeros(0)),
        patience_counter=patience_counter,
        extra=json.dumps(extra or {}),
    )


def load_checkpoint(path: str):
    d = np.load(path, allow_pickle=False)
    z_best_cv = d["z_best_cv"] if d["z_best_cv"].size else None
    return {
        "iteration": int(d["iteration"]),
        "theta": d["theta"],
        "psi": d["psi"],
        "z": d["z"],
        "cv_best": float(d["cv_best"]),
        "z_best_cv": z_best_cv,
        "patience_counter": int(d["patience_counter"]),
        "extra": json.loads(str(d["extra"])),
    }


def host_cpu_device():
    """The CPU device the host condition-number backfill runs on. A process
    whose ``JAX_PLATFORMS`` leaves out ``cpu`` (e.g. ``cuda`` alone) has
    none: say how to fix it instead of failing inside jax."""
    try:
        return jax.devices("cpu")[0]
    except RuntimeError as e:
        raise RuntimeError(
            "cond_mode='host' computes condition numbers on the CPU backend, "
            "which this process cannot reach (JAX_PLATFORMS="
            f"{os.environ.get('JAX_PLATFORMS', '')!r}). Leave JAX_PLATFORMS "
            "unset or include cpu (e.g. 'cuda,cpu'), or train with "
            "cond_mode='device' or compute_cond=False.") from e


def host_cpu_agent_arrays(
    agent_data_splits: Sequence[Tuple[np.ndarray, np.ndarray]],
) -> list:
    """Per-agent X arrays as f64 on the host CPU device, for reuse across
    repeated ``host_condition_numbers`` calls (the per-iteration verbose
    path would otherwise re-upload every agent's X each call)."""
    cpu = host_cpu_device()
    return [
        jax.device_put(jnp.asarray(np.asarray(X_i), jnp.float64), cpu)
        for X_i, _ in agent_data_splits
    ]


def host_condition_numbers(
    spec: QuantumKernelSpec,
    agent_data_splits: Sequence[Tuple[np.ndarray, np.ndarray]],
    z_rows: np.ndarray,
    chunk: int = 16,
    xas_cpu: Optional[list] = None,
) -> np.ndarray:
    """Per-agent condition numbers of the noise-free Gram, on the host CPU.

    The reference reports ``np.linalg.cond(C)`` of each agent's noise-free
    Gram every iteration (agent_riemannian.py:411) — a pure reporting
    quantity that needs an f64 Cholesky + explicit inverse in-program, so
    the driver's "host" cond mode rebuilds K(X_i, z) here — through the complex128
    statevector pipeline (``gram(..., dtype=float64)``) — and takes an f64
    eigvalsh on the CPU backend, for every recorded iteration at once.
    Unlike the device path there is no shard padding: each agent's true
    n_i x n_i Gram is conditioned, as the reference does. Because the Gram
    entries themselves carry f64 accuracy here (the reference simulates in
    double-precision qiskit-aer and calls ``np.linalg.cond`` on the result,
    agent_riemannian.py:411), this path fully resolves the reference's
    1e12/1e15 condition buckets — unlike the in-program "device" estimator,
    whose f32-built Gram caps meaningful readings at ~1e7-1e8.

    z_rows: (T, P) consensus/parameter rows. Returns (T, A) float64.
    """
    Z_np = np.asarray(z_rows, np.float64).reshape(-1, z_rows.shape[-1])
    T = Z_np.shape[0]
    out = np.empty((T, len(agent_data_splits)), np.float64)
    cpu = host_cpu_device()
    # Chunk the iteration axis: the vmapped program materializes a
    # (chunk, n_i, n_i) f64 Gram stack per agent — unchunked, a long run on
    # large shards would allocate gigabytes host-side for a reporting
    # quantity. The last chunk pads to CHUNK so the jit compiles once (per
    # chunk size: the per-iteration verbose path passes chunk=1 so a single
    # row does not pay 16 rows of eigvalsh work).
    CHUNK = max(1, int(chunk))
    T_pad = ((T + CHUNK - 1) // CHUNK) * CHUNK
    Z_pad = np.zeros((T_pad, Z_np.shape[1]), np.float64)
    Z_pad[:T] = Z_np
    with jax.default_device(cpu):
        Xas = (xas_cpu if xas_cpu is not None
               else host_cpu_agent_arrays(agent_data_splits))
        for s in range(0, T_pad, CHUNK):
            Zc = jax.device_put(jnp.asarray(Z_pad[s:s + CHUNK]), cpu)
            hi = min(s + CHUNK, T)  # T_pad - T < CHUNK: always > s
            for a, Xa in enumerate(Xas):
                out[s:hi, a] = np.asarray(
                    _host_cond_batch(spec, Zc, Xa))[: hi - s]
    return out


@partial(jax.jit, static_argnums=0)
def _host_cond_batch(spec, Zb, Xa):
    """vmapped f64 cond of K(Xa, z) over parameter rows Zb — module-level so
    the jit cache persists across calls (keyed on spec + shapes; the CPU
    compile of this program is ~10 s and must not be re-paid per call)."""
    from .models.kernels.quantum_kernel import gram

    def one(z):
        # wrap exactly as the device step does (_agent_local wraps z before
        # building K): with parity rounding a component can be 3.1416 > pi,
        # and circuit angles are affine in theta, not pi-periodic — the
        # unwrapped row would condition a materially different Gram.
        # dtype=float64 runs the complex128 statevector pipeline: Gram
        # entries at the reference's double-precision qiskit-aer accuracy,
        # so the eigvalsh below reproduces np.linalg.cond's f64 semantics.
        K = gram(spec, Xa, M.wrap(z), dtype=jnp.float64)
        w = jnp.abs(jnp.linalg.eigvalsh(K))
        tiny = jnp.finfo(jnp.float64).tiny
        return jnp.max(w) / jnp.maximum(jnp.min(w), tiny)

    return jax.vmap(one)(Zb)


_cond_floor_warned = False


def _warn_device_cond_floor(cond_mode: str, gram_dtype) -> None:
    """With cond_mode="device" the estimator is exact but the Gram it sees
    was BUILT in ``gram_dtype``. An f32-built Gram carries representation
    error ~eps_f32*lambda_max, which floors resolvable cond at ~1e7-1e8, so
    values reported into the reference's 1e12/1e15 buckets would be floors,
    not measurements. Say so once per process."""
    global _cond_floor_warned
    if (cond_mode != "device" or jnp.finfo(gram_dtype).bits >= 64
            or _cond_floor_warned):
        return
    _cond_floor_warned = True
    warnings.warn(
        f"cond_mode='device' conditions a Gram built in "
        f"{jnp.dtype(gram_dtype).name}: condition numbers beyond ~1e7-1e8 "
        f"saturate (representation error). Reported values are lower "
        f"bounds; use cond_mode='host' for exact f64 buckets.",
        stacklevel=3)


def train(
    spec: QuantumKernelSpec,
    agent_data_splits: Sequence[Tuple[np.ndarray, np.ndarray]],
    X_train: np.ndarray,
    Y_train: np.ndarray,
    cfg: TrainConfig,
    ground_truth_params: Optional[np.ndarray] = None,
    resume_from: Optional[str] = None,
) -> TrainResult:
    """Run the distributed Riemannian-ADMM optimization to convergence."""
    n_agents = len(agent_data_splits)
    P = spec.num_parameters
    log = print if cfg.verbose else (lambda *a, **k: None)

    from .config import resolve_dtype_mode

    cfg = dataclasses.replace(
        cfg,
        gp_dtype=resolve_dtype_mode(cfg.gp_dtype),
        cv_dtype=resolve_dtype_mode(cfg.cv_dtype),
    )

    # Where do the (reporting-only) per-iteration condition numbers compute?
    # "host" drops them from the device program entirely (the f64 Cholesky +
    # explicit inverse they need is the single most expensive thing in the
    # fused step) and backfills exact f64 eigvalsh
    # values computed on the CPU backend after training.
    cond_mode = cfg.cond_mode
    if cond_mode not in ("auto", "device", "host"):
        raise ValueError(
            f"cond_mode must be 'auto', 'device', or 'host', got {cond_mode!r}"
        )
    if cond_mode == "auto":
        cond_mode = "device" if jax.default_backend() == "cpu" else "host"
    if not cfg.compute_cond:
        cond_mode = "off"
    _warn_device_cond_floor(cond_mode, STEP_GRAM_DTYPE)
    if cond_mode == "host":
        host_cpu_device()  # fail before training, not after it
    step_cond = cond_mode == "device"
    cond_pending: List[Tuple[int, np.ndarray]] = []  # (history idx, z_row)
    xas_cpu_cache: List[list] = []  # lazy one-element cache (verbose path)

    # --- mesh + data residency -------------------------------------------
    devs = jax.devices()
    n_dev = cfg.n_mesh_devices or len(devs)
    n_dev = max(1, min(n_dev, len(devs)))
    mesh2d = None
    if cfg.data_mesh_cols and cfg.data_mesh_cols > 1:
        # agents x data 2-D mesh (parallel/training2d.py): rows split the
        # agent axis, columns row-shard each agent's Gram panels.
        from .parallel import agents_data_mesh

        cols = cfg.data_mesh_cols
        if cols > n_dev:
            raise ValueError(
                f"data_mesh_cols={cols} exceeds the available device budget "
                f"({n_dev}; n_mesh_devices caps it)"
            )
        rows = max(1, n_dev // cols)
        while rows > 1 and n_agents % rows != 0:
            rows -= 1
        # honor the n_mesh_devices cap: hand the mesh exactly rows*cols devices
        mesh2d = agents_data_mesh(rows, cols, devices=devs[: rows * cols])
        mesh = None
    else:
        if cfg.solve_2d != "replicated":
            # mirrors the other config-coercion log lines: the row-sharded
            # solve only exists on the agents x data 2-D mesh — without
            # data_mesh_cols > 1 the 1-D/single-device path runs instead
            log(f"solve_2d={cfg.solve_2d!r} ignored: no 2-D mesh "
                f"(data_mesh_cols={cfg.data_mesh_cols}); the 1-D agents-axis "
                f"path is used")
        n_dev = min(n_dev, n_agents)
        while n_agents % n_dev != 0:  # agent axis must divide evenly
            n_dev -= 1
        mesh = agents_mesh(n_dev) if n_dev > 1 else None

    pad_to = None
    if mesh2d is not None:
        # per-agent padded row count must divide by the data axis
        n_max = max(x.shape[0] for x, _ in agent_data_splits)
        cols = cfg.data_mesh_cols
        pad_to = ((n_max + cols - 1) // cols) * cols
    batch = make_agent_batch(agent_data_splits, pad_to=pad_to)
    if mesh2d is not None:
        from .parallel import make_admm_step_2d

        if cfg.solve_2d == "distributed" and cfg.gp_dtype == "mixed":
            # the distributed solve does not carry the f64 refinement loop;
            # f32 is its native precision.
            log("solve_2d=distributed: gp_dtype mixed -> float32 "
                "(the row-sharded solve does not distribute f64 refinement)")
            cfg = dataclasses.replace(cfg, gp_dtype="float32")
        if cfg.solve_2d == "distributed" and step_cond:
            # in-step cond needs the full spectrum; route through the host
            # backfill instead (independent of the step program)
            step_cond = False
            cond_mode = "host" if cfg.compute_cond else "off"
        if cfg.solve_2d == "distributed" and cfg.psd_fallback:
            # the row-sharded Cholesky has no in-program eigh-pinv rescue
            # branch; a non-PSD factorization surfaces as NaN NLL and the
            # driver re-runs that iteration's agent updates through the
            # replicated float64 step (the same host-coordinated rescue the
            # mixed solver uses) — mirroring the reference's always-rescued
            # Cholesky->LU->pinv chain (agent_riemannian.py:414-428)
            log("solve_2d=distributed: psd_fallback routes through the "
                "driver's float64 re-run (no sharded eigh-pinv branch)")
        step = make_admm_step_2d(
            spec, mesh2d,
            rho=cfg.rho, L=cfg.L, noise_std=cfg.noise_std,
            shift_value=cfg.shift_value, parity_round=cfg.parity_round,
            compute_cond=step_cond,
            gp_dtype=cfg.gp_dtype, psd_fallback=cfg.psd_fallback,
            grad_method=cfg.grad_method, solve=cfg.solve_2d,
        )
    else:
        step = make_admm_step(
            spec, mesh,
            rho=cfg.rho, L=cfg.L, noise_std=cfg.noise_std,
            shift_value=cfg.shift_value, parity_round=cfg.parity_round,
            compute_cond=step_cond,
            gp_dtype=cfg.gp_dtype, psd_fallback=cfg.psd_fallback,
            grad_method=cfg.grad_method,
        )

    # --- single-fetch host view --------------------------------------------
    # Every host fetch is a device sync; rather than fetching z, per-agent
    # scalars and consensus norms separately, everything the host loop reads
    # per iteration is packed into ONE float64 vector on device:
    #   [z (P) | ||z-theta_i|| (A) | nll (A) | cond (A) | logdet (A) |
    #    quad (A) | const (A) | cv nlpd/r2/rmse (3k, fused-CV only)]
    def _pack(out, scores=None, with_state=False):
        f64 = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        norms = jnp.linalg.norm(
            out.z[None, :].astype(f64) - out.theta.astype(f64), axis=1
        )  # Euclidean consensus norms (reference quirk), now device-side
        parts = [out.z, norms, out.nll, out.condition_number,
                 out.log_det_term, out.quadratic_term, out.constant_term]
        if scores is not None:
            parts.extend(scores)
        if with_state:
            # chained rows carry theta/psi so mid-chunk bookkeeping (early
            # stop, checkpoints, mixed-solver f64 re-runs) needs no extra
            # host fetches
            parts.extend([out.theta, out.psi])
        return jnp.concatenate([jnp.ravel(p).astype(f64) for p in parts])

    def _unpack(h):
        z = h[:P]
        sec = h[P:P + 6 * n_agents].reshape(6, n_agents)
        scores = h[P + 6 * n_agents:]
        return z, sec, (scores.reshape(3, -1) if scores.size else None)

    def _unpack_row(h):
        """Chained-mode rows: _unpack payload + theta/psi (A, P) at the tail."""
        state = h[h.size - 2 * n_agents * P:]
        th = state[: n_agents * P].reshape(n_agents, P)
        ps = state[n_agents * P:].reshape(n_agents, P)
        z, sec, scores = _unpack(h[: h.size - 2 * n_agents * P])
        return z, sec, scores, th, ps

    # gp_dtype="mixed" flags agents whose f32-factorized solve could not be
    # refined to f64 accuracy (cond beyond ~1e7) as NaN instead of paying the
    # direct branch inside vmap (where lax.cond lowers to select and BOTH
    # branches would execute every iteration). The driver re-runs such an
    # iteration through a float64 step, compiled on first use.
    # solve_2d="distributed" shares the rescue: its row-sharded Cholesky has
    # no in-program fallback, so a non-PSD agent system surfaces as NaN NLL
    # and gets the same f64 re-run (on the 2-D mesh the f64 step uses the
    # replicated solve — the distributed panel algorithm never runs in f64).
    rescue_on_nan = cfg.gp_dtype == "mixed" or (
        mesh2d is not None and cfg.solve_2d == "distributed")
    _step64 = []

    def get_step64():
        if not _step64:
            kw = dict(rho=cfg.rho, L=cfg.L, noise_std=cfg.noise_std,
                      shift_value=cfg.shift_value,
                      parity_round=cfg.parity_round,
                      compute_cond=step_cond,
                      gp_dtype="float64", psd_fallback=cfg.psd_fallback)
            if mesh2d is not None:
                from .parallel import make_admm_step_2d as _mk2d

                base64 = _mk2d(spec, mesh2d, grad_method=cfg.grad_method, **kw)
            else:
                base64 = make_admm_step(
                    spec, mesh, grad_method=cfg.grad_method, **kw)

            @jax.jit
            def step64_packed(theta, psi, batch):
                out = base64(theta, psi, batch)
                return out, _pack(out)

            _step64.append(step64_packed)
        return _step64[0]

    # --- state ------------------------------------------------------------
    if resume_from:
        ck = load_checkpoint(resume_from)
        theta, psi, z = ck["theta"], ck["psi"], ck["z"]
        start_iter = ck["iteration"]
        cv_best, z_best_cv = ck["cv_best"], ck["z_best_cv"]
        patience_counter = ck["patience_counter"]
        log(f"Resumed from {resume_from} at iteration {start_iter}")
    else:
        theta, psi, z = init_admm_state(n_agents, P, cfg.seed, cfg.rho, cfg.parity_round)
        start_iter = 0
        cv_best, z_best_cv, patience_counter = float("inf"), None, 0

    theta = jnp.asarray(theta, jnp.float64)
    psi = jnp.asarray(psi, jnp.float64)
    if mesh2d is not None:
        from .parallel import shard_batch_to_mesh_2d

        batch, theta, psi = shard_batch_to_mesh_2d(batch, theta, psi, mesh2d)
    elif mesh is not None:
        batch, theta, psi = shard_batch_to_mesh(batch, theta, psi, mesh)

    # --- fuse per-iteration CV into the step program -----------------------
    # The reference runs 5 complete GP fits per iteration in separate
    # processes (main.py:2645-2716); here the fold scores compute inside the
    # SAME jitted executable as the ADMM step — one program per training
    # iteration (dispatch overhead and the accelerator runtime's
    # secondary-program slow path both disappear; fold shapes are
    # deterministic in (n, k), so this compiles once).
    step_with_cv = None
    X_cv, Y_cv = X_train, Y_train
    if cfg.run_cv:
        from .models.gp.cv import (
            aggregate_cv_scores,
            cv_fold_scores_impl,
            kfold_pad_indices_np,
        )

        if cfg.cv_max_samples and len(X_train) > cfg.cv_max_samples:
            # scale-out: the dense fold Grams are O(n^2) — model-select on a
            # seeded subsample (documented divergence; the reference's CV
            # cannot run at these sizes at all)
            sel = np.random.RandomState(cfg.seed).choice(
                len(X_train), cfg.cv_max_samples, replace=False)
            X_cv, Y_cv = X_train[sel], Y_train[sel]
            log(f"CV model selection on a {cfg.cv_max_samples}-sample subset "
                f"of {len(X_train)} training rows")

        base_step = step
        Xtr_j = jnp.asarray(X_cv)
        Ytr_j = jnp.asarray(Y_cv)

        # Fold indices/masks travel as ONE int32 buffer per upload; shapes are
        # static per (n, k_folds), so probe once and reshape inside jit.
        # An infeasible fold config (k > n) disables fusion here and
        # surfaces per-iteration through the un-fused CV path's penalty
        # handling, like the reference's failed folds (main.py:2705-2716).
        try:
            _pi0 = kfold_pad_indices_np(len(X_cv), cfg.cv_folds, 0)
        except ValueError as e:
            log(f"fold construction infeasible ({e}); CV runs un-fused")
            _pi0 = None
        _kf = _tm = _vm = _o1 = _o2 = _o3 = 0
        if _pi0 is not None:
            _kf, _tm = _pi0[0].shape
            _vm = _pi0[2].shape[1]
            _o1 = _kf * _tm
            _o2, _o3 = 2 * _o1, 2 * _o1 + _kf * _vm

        def pack_idx_np(seed):
            return np.concatenate([
                a.ravel()
                for a in kfold_pad_indices_np(len(X_cv), cfg.cv_folds, seed)
            ])

        def _unflatten_idx(xs):
            return (xs[:_o1].reshape(_kf, _tm), xs[_o1:_o2].reshape(_kf, _tm),
                    xs[_o2:_o3].reshape(_kf, _vm), xs[_o3:].reshape(_kf, _vm))

        if _pi0 is not None:
            @jax.jit
            def step_with_cv(theta, psi, batch, X_tr, Y_tr, idx_packed):
                out = base_step(theta, psi, batch)
                scores = cv_fold_scores_impl(
                    spec, X_tr, Y_tr, out.z, *_unflatten_idx(idx_packed),
                    noise_std=float(cfg.noise_std), cv_dtype=cfg.cv_dtype,
                )
                return out, _pack(out, scores)

    @jax.jit
    def step_packed(theta, psi, batch):
        out = step(theta, psi, batch)
        return out, _pack(out)

    nll_history: List[Dict] = []
    cv_history: List[Dict] = []
    error_history: List[float] = []
    z_best_gt, error_best = None, float("inf")
    converged_by = "max_iter"
    z_prev = np.asarray(z, np.float64)

    def place_state(theta_np, psi_np):
        """Host numpy theta/psi -> device arrays with the step's sharding."""
        from jax.sharding import NamedSharding, PartitionSpec

        th = jnp.asarray(theta_np, jnp.float64)
        ps = jnp.asarray(psi_np, jnp.float64)
        m = mesh2d if mesh2d is not None else mesh
        if m is not None:
            s1 = NamedSharding(m, PartitionSpec("agents"))
            th, ps = jax.device_put(th, s1), jax.device_put(ps, s1)
        return th, ps

    def record_iteration(it, z_row, sec, fold_scores, it_time, get_state,
                         solver=None):
        """All host bookkeeping for one completed iteration (identical for
        per-iteration and chained dispatch); returns the stop reason
        ('consensus' | 'cv_patience' | 'max_iter') or None.

        ``solver`` tags the numeric provenance of this row's NLL values
        (VERDICT r3 weak #8: mixed-mode log-det components are ~N*eps_f32
        relative while looking like exact f64 in the JSON): the resolved
        gp_dtype by default, 'float64-rescue' when the mixed solver flagged
        the iteration and the driver re-ran the agent updates through the
        direct f64 step (the reference's components are always exact f64,
        agent_riemannian.py:442-460)."""
        nonlocal cv_best, z_best_cv, patience_counter, z_prev
        nonlocal z_best_gt, error_best

        theta_z_norms, nll, conds, lds, quads, consts = sec
        if cond_mode == "host":
            if cfg.verbose and cfg.verbose_agents:
                # debug path: compute this row's conds synchronously so the
                # per-agent report below can print them live. chunk=1: a
                # single row must not pad to (and pay for) a 16-row batch,
                # and the CPU-resident agent arrays upload once, not per
                # iteration.
                if not xas_cpu_cache:
                    xas_cpu_cache.append(
                        host_cpu_agent_arrays(agent_data_splits))
                conds = host_condition_numbers(
                    spec, agent_data_splits, np.asarray(z_row)[None, :],
                    chunk=1, xas_cpu=xas_cpu_cache[0])[0]
            else:
                # copy: z_row may be a view into a packed fetch buffer
                # (chained mode: the whole chunk) — a view would pin every
                # fetched buffer in memory until the end-of-run backfill
                cond_pending.append((len(nll_history),
                                     np.array(z_row, copy=True)))
        valid = nll[np.isfinite(nll)]
        nll_history.append({
            "iteration": it,
            "solver": solver if solver is not None else cfg.gp_dtype,
            # wall seconds attributed to this iteration (chained dispatch:
            # chunk wall / chain_iters; the first chunk includes compile).
            # Feeds the post-training timing report and bench's chained
            # ms/iter metric.
            "iter_time": float(it_time),
            "agent_losses": nll.tolist(),
            "condition_numbers": conds.tolist(),
            "nll_components": [
                {
                    "log_det_term": float(lds[i]),
                    "quadratic_term": float(quads[i]),
                    "constant_term": float(consts[i]),
                    "total": float(nll[i]),
                }
                for i in range(n_agents)
            ],
            "total_nll": float(valid.sum()) if valid.size else float("inf"),
            "avg_nll": float(valid.mean()) if valid.size else float("inf"),
            "min_nll": float(valid.min()) if valid.size else float("inf"),
            "max_nll": float(valid.max()) if valid.size else float("inf"),
        })

        # --- per-iteration CV model selection (main.py:2645-2716) ---------
        if cfg.run_cv:
            try:
                cv_dtype_iter = cfg.cv_dtype
                cv_rescue = False
                if (fold_scores is not None
                        and not np.all(np.isfinite(fold_scores[0]))):
                    # the vmapped fold program flags failed factorizations
                    # as NaN instead of compiling an in-program rescue
                    # (mixed: cond beyond the f32 refinement's ~1e7 reach;
                    # direct: no eigh-pinv branch under vmap). The
                    # reference's f64 CV would have rescued/succeeded —
                    # re-score in float64 with the full fallback chain
                    # rather than letting the inf penalty skew selection
                    log("  CV fold solve flagged fold(s); re-scoring this "
                        "iteration's CV in float64")
                    fold_scores = None
                    # the fused program already ran the f64 direct-flag
                    # solver and flagged — re-running it would flag again
                    # deterministically; jump straight to the rescue chain
                    cv_rescue = cv_dtype_iter == "float64"
                    cv_dtype_iter = "float64"
                if fold_scores is not None:
                    cv = aggregate_cv_scores(*fold_scores, cfg.cv_folds)
                    cv_solver = cfg.cv_dtype
                else:
                    cv = k_fold_cross_validation_consensus(
                        spec, X_cv, Y_cv, z_row, cfg.noise_std,
                        k_folds=cfg.cv_folds,
                        random_seed=cfg.seed + it,  # per-iter seed (main.py:2665)
                        cv_dtype=cv_dtype_iter,
                        rescue=cv_rescue,
                    )
                    cv_solver = ("float64-rescue" if cv_rescue
                                 else cv_dtype_iter)
                cv_score = cv["mean_nlpd"]
                if cv_score < cv_best:
                    cv_best = cv_score
                    z_best_cv = z_row.copy()
                    patience_counter = 0
                else:
                    patience_counter += 1
                cv_history.append({
                    "iteration": it,
                    "solver": cv_solver,
                    "consensus_cv_score": cv_score,
                    "cv_score_std": cv["std_nlpd"],
                    "cv_r2": cv["mean_r2"],
                    "valid_folds": cv["valid_folds"],
                    "total_folds": cv["total_folds"],
                    "consensus_params": z_row.copy(),
                })
            except Exception as e:  # fold machinery failure -> patience tick
                log(f"  CV evaluation failed: {e}")
                patience_counter += 1
                cv_history.append({
                    "iteration": it,
                    "solver": "failed",
                    "consensus_cv_score": float("inf"),
                    "cv_score_std": float("inf"),
                    "cv_r2": -float("inf"),
                    "valid_folds": 0,
                    "total_folds": cfg.cv_folds,
                    "consensus_params": z_row.copy(),
                })

        # --- convergence metrics (main.py:2718-2726) ----------------------
        # theta_z_norms (Euclidean — reference quirk) came packed from the
        # device; theta itself stays device-resident between iterations.
        max_norm = float(theta_z_norms.max())
        z_change = float(np.linalg.norm(z_row - z_prev))
        z_prev = np.asarray(z_row, np.float64)

        if ground_truth_params is not None:
            param_error = M.np_distance(z_row, ground_truth_params)
            error_history.append(float(np.round(param_error, 4)))
            if param_error < error_best:
                error_best = param_error
                z_best_gt = z_row.copy()

        cvs = cv_history[-1]["consensus_cv_score"] if cv_history else float("nan")
        log(
            f"iter {it:4d}  nll_sum={nll_history[-1]['total_nll']:.4f}  "
            f"cv_nlpd={cvs:.4f}  max||z-th||={max_norm:.6f}  "
            f"dz={z_change:.6f}  {it_time:.3f}s"
        )
        if cfg.verbose and cfg.verbose_agents:
            # per-agent NLL components and condition-number buckets
            # (main.py:2557-2643 reporting)
            for i in range(n_agents):
                c = conds[i]
                if not cfg.compute_cond:
                    status = "n/a"  # cond estimation disabled
                elif not np.isfinite(c):
                    # the iterative estimator returns inf for singular /
                    # indefinite systems — the loudest "Poor" there is
                    status = "Poor"
                else:
                    status = "Good" if c < 1e12 else ("Moderate" if c < 1e15 else "Poor")
                log(f"    Agent {i+1}: NLL={nll[i]:.6f} "
                    f"[LogDet={lds[i]:.4f}, Quad={quads[i]:.4f}, "
                    f"Const={consts[i]:.4f}]  cond={c:.2e} ({status})")

        if cfg.checkpoint_dir and it % cfg.checkpoint_every == 0:
            th_np, ps_np = get_state()
            save_checkpoint(
                os.path.join(cfg.checkpoint_dir, f"ckpt_{it:05d}.npz"),
                it, th_np, ps_np, z_row, cv_best, z_best_cv,
                patience_counter,
            )

        # --- stopping (main.py:2767-2784) ---------------------------------
        if np.all(theta_z_norms < cfg.tolerance):
            return "consensus"
        if cfg.run_cv and patience_counter >= cfg.cv_patience:
            return "cv_patience"
        if it >= cfg.max_iter:
            return "max_iter"
        return None

    # --- chained dispatch: chain_iters iterations per device program -------
    chain_k = max(1, int(cfg.chain_iters))
    chained_step = None
    if chain_k > 1:
        if cfg.run_cv and step_with_cv is not None:
            # Fold indices/masks for the whole chunk travel as ONE int32
            # buffer.
            def pack_chunk_indices(start_it):
                flat = [pack_idx_np(cfg.seed + start_it + 1 + j)
                        for j in range(chain_k)]
                return jnp.asarray(np.stack(flat))  # (chain_k, total) int32

            @jax.jit
            def chained_step(theta, psi, batch, X_tr, Y_tr, idx_packed):
                def body(carry, xs):
                    th, ps = carry
                    out = step(th, ps, batch)
                    scores = cv_fold_scores_impl(
                        spec, X_tr, Y_tr, out.z, *_unflatten_idx(xs),
                        noise_std=float(cfg.noise_std), cv_dtype=cfg.cv_dtype,
                    )
                    return (out.theta, out.psi), _pack(out, scores,
                                                       with_state=True)
                (th_f, ps_f), rows = jax.lax.scan(
                    body, (theta, psi), idx_packed)
                return th_f, ps_f, rows
        elif not cfg.run_cv:
            @jax.jit
            def chained_step(theta, psi, batch):
                def body(carry, _):
                    th, ps = carry
                    out = step(th, ps, batch)
                    return (out.theta, out.psi), _pack(out, with_state=True)
                (th_f, ps_f), rows = jax.lax.scan(
                    body, (theta, psi), None, length=chain_k)
                return th_f, ps_f, rows

    it = start_iter
    t0 = time.time()
    idx_cache = None  # (start_iter, uploaded idx buffer) for the next chunk
    while True:
        # ==== chained mode: one dispatch + ONE fetch per chain_k iterations
        if chained_step is not None:
            chunk_start = time.time()
            try:
                if cfg.run_cv:
                    t_idx = time.time()
                    if idx_cache is not None and idx_cache[0] == it:
                        idx_packed = idx_cache[1]  # pre-uploaded last chunk
                    else:
                        idx_packed = pack_chunk_indices(it)  # ONE upload
                    t_up = time.time()
                    th_n, ps_n, rows_dev = chained_step(theta, psi, batch,
                                                        Xtr_j, Ytr_j,
                                                        idx_packed)
                    # Speculatively pack + upload the NEXT chunk's fold
                    # indices now, while the device executes this chunk —
                    # the host work and the transfer hide
                    # behind the fetch below (wasted only on a mid-chunk
                    # stop, which ends the loop anyway).
                    idx_cache = (it + chain_k,
                                 pack_chunk_indices(it + chain_k))
                else:
                    t_idx = t_up = time.time()
                    th_n, ps_n, rows_dev = chained_step(theta, psi, batch)
                t_disp = time.time()
                rows = np.asarray(rows_dev)  # the chunk's single host fetch
                if os.environ.get("DQGP_TIMING"):
                    t_f = time.time()
                    log(f"  [chunk] idx={t_idx - chunk_start:.3f}s "
                        f"upload={t_up - t_idx:.3f}s "
                        f"dispatch={t_disp - t_up:.3f}s "
                        f"fetch={t_f - t_disp:.3f}s")
            except Exception as e:
                log(f"  chained dispatch failed ({e}); falling back to "
                    f"per-iteration dispatch")
                chained_step = None
                continue

            stop = None
            redo64 = False
            t_row = (time.time() - chunk_start) / chain_k
            for j in range(chain_k):
                z_row, sec, fold_scores, th_row, ps_row = _unpack_row(rows[j])
                if rescue_on_nan and not np.all(np.isfinite(sec[1])):
                    # A flagged agent poisons every later row in the chunk
                    # (NaN theta/psi propagate); re-run THIS iteration's
                    # agent updates in f64 from the pre-row state, then
                    # restart chunking from the corrected state. z and the
                    # fused CV scores of this row are valid regardless (the
                    # z-update reads only last iteration's theta/psi).
                    redo64 = True
                    if j == 0:
                        th_prev = np.asarray(theta, np.float64)
                        ps_prev = np.asarray(psi, np.float64)
                    else:
                        _, _, _, th_prev, ps_prev = _unpack_row(rows[j - 1])
                    log("  non-finite agent NLL (mixed flag / distributed "
                        "solve); re-running this iteration's agent updates "
                        "in float64")
                    th_d, ps_d = place_state(th_prev, ps_prev)
                    out64, packed64 = get_step64()(th_d, ps_d, batch)
                    z_row, sec, _ = _unpack(np.asarray(packed64))
                    th_n, ps_n = out64.theta, out64.psi
                    th_row = np.asarray(out64.theta, np.float64)
                    ps_row = np.asarray(out64.psi, np.float64)
                it += 1
                z = z_row
                stop = record_iteration(it, z_row, sec, fold_scores, t_row,
                                        lambda: (np.asarray(th_row),
                                                 np.asarray(ps_row)),
                                        solver=("float64-rescue" if redo64
                                                else None))
                if stop is not None or redo64:
                    break
            if stop is not None:
                # mid-chunk stop: discard speculative rows; final state is
                # this row's (host) theta/psi
                theta, psi = np.asarray(th_row), np.asarray(ps_row)
                converged_by = stop
                if stop in ("cv_patience", "max_iter") and z_best_cv is not None:
                    z = z_best_cv.copy()
                break
            theta, psi = th_n, ps_n
            continue

        # ==== per-iteration mode ==========================================
        it += 1
        it_start = time.time()

        if step_with_cv is not None:
            try:
                # seed+iter (main.py:2665); ONE packed index upload
                idx = jnp.asarray(pack_idx_np(cfg.seed + it))
                out, packed = step_with_cv(theta, psi, batch,
                                           Xtr_j, Ytr_j, idx)
                # ONE host fetch per training iteration (see _pack above);
                # inside the try because async runtime failures (e.g. OOM
                # executing the compiled fused program) surface at the
                # blocking fetch, not at dispatch
                host = np.asarray(packed)
            except Exception as e:
                # disable fusion permanently — re-attempting would re-trace
                # (and re-fail) a minutes-long compile every iteration
                log(f"  fused step+CV failed ({e}); disabling fusion, "
                    f"separate CV from here on")
                step_with_cv = None
                host = None
        if step_with_cv is None:
            out, packed = step_packed(theta, psi, batch)
            host = np.asarray(packed)
        z, sec, fold_scores = _unpack(host)
        rescued = False
        if rescue_on_nan and not np.all(np.isfinite(sec[1])):
            # The consensus z-update only reads LAST iteration's theta/psi,
            # so z (and any fused CV scores on it) is valid even when an
            # agent's mixed solve was flagged — only the agent-side outputs
            # need the f64 re-run.
            log("  non-finite agent NLL (mixed flag / distributed solve); "
                "re-running this iteration's agent updates in float64")
            out, packed64 = get_step64()(theta, psi, batch)
            z, sec, _ = _unpack(np.asarray(packed64))  # keeps fused CV scores
            rescued = True
        theta, psi = out.theta, out.psi

        stop = record_iteration(
            it, z, sec, fold_scores, time.time() - it_start,
            lambda: (np.asarray(theta), np.asarray(psi)),
            solver=("float64-rescue" if rescued else None))
        if stop is not None:
            converged_by = stop
            if stop in ("cv_patience", "max_iter") and z_best_cv is not None:
                z = z_best_cv.copy()
            break

    total_time = time.time() - t0
    log(f"ADMM done ({converged_by}) after {it} iterations in {total_time:.2f}s "
        f"({total_time / max(it - start_iter, 1):.3f}s/iter)")

    if cond_pending:
        # host cond mode: one batched CPU-backend pass over every recorded
        # iteration, then backfill the history rows (reporting-only values;
        # nothing in the training control flow reads them)
        t_cond = time.time()
        rows = np.stack([z for _, z in cond_pending])
        conds_all = host_condition_numbers(spec, agent_data_splits, rows)
        for (hist_idx, _), crow in zip(cond_pending, conds_all):
            nll_history[hist_idx]["condition_numbers"] = crow.tolist()
        log(f"condition numbers (host, exact f64) for {len(cond_pending)} "
            f"iterations in {time.time() - t_cond:.2f}s")

    return TrainResult(
        z=np.asarray(z),
        z_best_cv=(np.asarray(z_best_cv) if z_best_cv is not None else None),
        cv_best=cv_best,
        theta=np.asarray(theta),
        psi=np.asarray(psi),
        iterations=it,
        converged_by=converged_by,
        nll_history=nll_history,
        cv_history=cv_history,
        error_history=error_history,
        z_best_gt=(np.asarray(z_best_gt) if z_best_gt is not None else None),
        error_best=error_best,
        total_time=total_time,
    )
