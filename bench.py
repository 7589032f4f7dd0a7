"""Benchmark: batched CILQR throughput (full 30-step scenario solves / sec).

Workload: scenario_two_straight (3 obstacles, N=30, nx=4, nu=2,
max_iter=100, line search, status machine) in float32 with perturbed
initial states.

- BENCH_MODE=mpc (default on the GPU): batched receding-horizon episodes at
  the yaml's full length (120 ticks x 8192 episodes per run,
  src/motion_planning.cpp:180-270 + max_simulation_time), with the
  reference's use_last_solution shifted-u warm start between ticks
  (src/cilqr_solver.cpp:163-180; BENCH_WARM=0 disables). Metric
  "cilqr_mpc_solves_per_sec".
- BENCH_MODE=cold: 16384 independent cold solves per run. Metric
  "cilqr_solves_per_sec".

BENCH_IMPL=kernel|xla picks the engine: the fused Triton kernel
(ilqr_tpu/ops/pallas/cilqr_kernel.py) or the XLA engine
(ilqr_tpu/solvers/cilqr.py under vmap). Default: kernel on the GPU, xla on
the CPU. BENCH_BATCH, BENCH_TICKS and BENCH_ITERS override the sizes.

Prints ONE JSON line on stdout: the metric, its value, the engine, and the
device as JAX reports it, plus the card's name and power limit. Exits
non-zero when no GPU is found, unless JAX_PLATFORMS=cpu asked for the CPU.
"""

import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "configs", "scenario_two_straight.yaml")
COLD_BATCH, MPC_BATCH, MPC_TICKS = 16384, 8192, 120


def _problem(batch: int, dtype=jnp.float32, warm: bool = False):
    from ilqr_tpu.config import GlobalConfig
    from ilqr_tpu.sim.scenario import build_scenario_setup, perturbed_initial_states
    from ilqr_tpu.types import CILQRConfig, CILQRWeights

    gc = GlobalConfig.from_file(CONFIG)
    st = build_scenario_setup(gc)
    cfg = CILQRConfig.from_global_config(gc, use_last_solution=warm)
    w = CILQRWeights.from_global_config(gc, dtype=dtype)
    x0_b = jnp.asarray(perturbed_initial_states(st.ego_x0, batch, seed=0),
                       dtype)
    return gc, st, cfg, w, x0_b


def build_mpc(batch: int, ticks: int, engine: str, dtype=jnp.float32):
    """Batched receding-horizon episodes: batch*ticks full solves per run.
    Returns run() -> (iters, final ego x per episode). The XLA engine's
    program is compiled here; the kernel's compiles on the first run."""
    from ilqr_tpu.ops.pallas.cilqr_kernel import tuned_options, WARM_CAP

    warm = os.environ.get("BENCH_WARM", "1") == "1"
    gc, st, cfg, w, x0_b = _problem(batch, dtype, warm)
    scenario = st.device_scenario(tick=0, dtype=dtype)
    obs_full = jnp.asarray(st.obs_preds_array(), dtype)
    need = ticks + cfg.N + 1
    if obs_full.shape[1] < need:
        pad = jnp.broadcast_to(obs_full[:, -1:],
                               (obs_full.shape[0], need - obs_full.shape[1], 3))
        obs_full = jnp.concatenate([obs_full, pad], axis=1)
    ref_b = jnp.stack([scenario.ref_line] * batch)
    rv_b = jnp.stack([jnp.asarray(scenario.ref_velo, dtype)] * batch)
    rb_b = jnp.stack([scenario.road_borders] * batch)
    obs_b = jnp.stack([obs_full] * batch)
    args = (x0_b, ref_b, rv_b, obs_b, rb_b)
    n_dev = len(jax.devices())

    if engine == "xla":
        from functools import partial

        from jax.sharding import PartitionSpec as P

        from ilqr_tpu.parallel import make_mesh, shard_batch
        from ilqr_tpu.sim.mpc import run_mpc_scan

        ep = jax.vmap(lambda x0, rl, rv, ob, rb: run_mpc_scan(
            cfg, w, x0, rl, rv, ob, rb, ticks))
        if n_dev > 1:
            mesh = make_mesh(n_dev)
            ep = partial(jax.shard_map, mesh=mesh, in_specs=(P("data"),) * 5,
                         out_specs=P("data"), check_vma=False)(ep)
            args = tuple(shard_batch(mesh, a) for a in args)
        episode = jax.jit(ep).lower(*args).compile()

        def run():
            ego, _, stats = episode(*args)
            return stats.iters, ego[:, -1, 0]
        return run

    opts = tuned_options(gc)
    kw = dict(opts, straggler_cap_warm=WARM_CAP)
    if n_dev > 1:
        from ilqr_tpu.parallel import make_mesh, run_mpc_chunked_sharded

        mesh = make_mesh(n_dev)

        def run():
            ego, _, stats = run_mpc_chunked_sharded(
                mesh, cfg, w, *args, ticks=ticks, chunk=10, **kw)
            return stats.iters, ego[-1, :, 0]
    elif ticks > 20:
        # reference-length episodes: one compiled 10-tick chunk program
        # dispatched repeatedly with device-resident carries
        from ilqr_tpu.sim.mpc import run_mpc_kernel_chunked

        def run():
            ego, _, stats = run_mpc_kernel_chunked(
                cfg, w, *args, ticks=ticks, chunk=10, **kw)
            return stats.iters, ego[-1, :, 0]
    else:
        from ilqr_tpu.sim.mpc import run_mpc_kernel_scan

        def run():
            ego, _, stats = run_mpc_kernel_scan(cfg, w, *args, ticks=ticks,
                                                **kw)
            return stats.iters, ego[-1, :, 0]
    return run


def build(batch: int, engine: str, dtype=jnp.float32):
    """Independent cold solves. Returns run() -> (iters, converged frac).
    The XLA engine's program is compiled here; the kernel's compiles on the
    first run."""
    from ilqr_tpu.ops.pallas.cilqr_kernel import tuned_options
    from ilqr_tpu.parallel import make_mesh, shard_batch
    from ilqr_tpu.parallel.sharding import replicate

    gc, st, cfg, w, x0_b = _problem(batch, dtype)
    scenario = st.device_scenario(tick=0, dtype=dtype)
    scen_b = jax.tree.map(lambda a: jnp.stack([a] * batch), scenario)
    n_dev = len(jax.devices())
    if n_dev > 1:
        from ilqr_tpu.parallel import sharded_kernel_solve_fn, sharded_solve_fn

        mesh = make_mesh(n_dev)
        fn = (sharded_kernel_solve_fn(mesh, cfg, **tuned_options(gc))
              if engine == "kernel" else sharded_solve_fn(mesh, cfg))
        args = (replicate(mesh, w), shard_batch(mesh, x0_b),
                shard_batch(mesh, scen_b))

        def run():
            _, _, stats, summary = fn(*args)
            return stats.iters, summary["converged_frac"]
        return run
    if engine == "kernel":
        from ilqr_tpu.ops.pallas.cilqr_kernel import cilqr_solve_pallas

        opts = tuned_options(gc)

        def run():
            _, _, stats = cilqr_solve_pallas(cfg, w, x0_b, scen_b, **opts)
            return stats.iters, jnp.mean(stats.converged.astype(jnp.float32))
        return run
    from ilqr_tpu.solvers.cilqr import solve

    vsolve = jax.jit(jax.vmap(lambda w, x, s: solve(cfg, w, x, s)[2],
                              in_axes=(None, 0, 0))
                     ).lower(w, x0_b, scen_b).compile()

    def run():
        stats = vsolve(w, x0_b, scen_b)
        return stats.iters, jnp.mean(stats.converged.astype(jnp.float32))
    return run


def time_run(run, iters: int):
    """(median seconds per run, last output); the first call compiles and
    is not timed."""
    out = jax.block_until_ready(run())
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run())
        samples.append(time.perf_counter() - t0)
    return float(np.median(samples)), out


def main():
    from ilqr_tpu import runtime

    platform = runtime.setup()
    engine = os.environ.get("BENCH_IMPL", runtime.engine_for(platform))
    mode = os.environ.get("BENCH_MODE", "mpc" if platform == "gpu" else "cold")
    small = platform == "cpu"  # a CPU run is a smoke test of the path
    default_batch = 64 if small else (COLD_BATCH if mode == "cold" else MPC_BATCH)
    batch = int(os.environ.get("BENCH_BATCH", default_batch))
    ticks = int(os.environ.get("BENCH_TICKS", MPC_TICKS))
    iters = int(os.environ.get("BENCH_ITERS", "5"))
    if mode == "mpc":
        run = build_mpc(batch, ticks, engine)
        solves_per_run = batch * ticks
        metric = "cilqr_mpc_solves_per_sec"
    else:
        run = build(batch, engine)
        solves_per_run = batch
        metric = "cilqr_solves_per_sec"
    dt, out = time_run(run, iters)
    aux = float(jnp.mean(out[1]))
    result = {
        "metric": metric,
        "value": solves_per_run / dt,
        "unit": "solves/s",
        "engine": engine,
        "mode": mode,
        "batch": batch,
        "device": runtime.device_info(),
    }
    if platform == "gpu":
        result["gpu"] = runtime.gpu_name_and_power_limit()
    print(json.dumps(result))
    name = "final_ego_x_mean" if mode == "mpc" else "converged"
    print(f"# median_step={dt * 1e3:.1f}ms "
          f"mean_iters={float(jnp.mean(out[0])):.2f} {name}={aux:.4f}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
