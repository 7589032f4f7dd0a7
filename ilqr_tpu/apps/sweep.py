"""Batched scenario sweep driver (the framework's "training job").

Runs thousands of scenario variants (initial-state perturbations x noisy
obstacle routings) through the batched CILQR solver, sharded over every
visible device, with psum'd convergence stats, periodic structured logging,
and optional orbax checkpointing of the sweep cursor -- the batched
equivalent of running the reference binary thousands of times. Runs on the
GPU; JAX_PLATFORMS=cpu asks for the CPU.

Usage:
    python -m ilqr_tpu.apps.sweep -c configs/scenario_two_straight.yaml \
        [--variants 100] [--batch 1024] [--ticks 20] [--engine kernel|xla] \
        [--checkpoint-dir /tmp/sweep_ckpt] [--multihost]
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

import numpy as np

log = logging.getLogger("ilqr_tpu.sweep")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="batched CILQR scenario sweep")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--batch", type=int, default=8192,
                        help="scenarios per solver step")
    parser.add_argument("--steps", type=int, default=4,
                        help="number of batched solve steps")
    parser.add_argument("--engine", choices=("kernel", "xla", "auto"),
                        default="auto",
                        help="auto = the fused kernel on the GPU, the XLA "
                        "engine on the CPU")
    parser.add_argument("--window", type=int, default=384,
                        help="kernel engine: per-scenario refline window")
    parser.add_argument("--proj-rows", type=int, default=-1,
                        help="kernel engine: per-step projection search "
                        "bound; -1 derives 1.1x the yaml's target "
                        "velocity (cilqr_kernel.derive_proj_rows), 0 "
                        "disables")
    parser.add_argument("--straggler-cap", default="8,16,32",
                        help="kernel engine: straggler-compaction iteration "
                        "cap or comma-separated multi-phase schedule "
                        "(0 disables; results identical either way)")
    parser.add_argument("--noise-seed", type=int, default=0)
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--multihost", action="store_true",
                        help="call jax.distributed.initialize() first with "
                        "the three options below")
    parser.add_argument("--coordinator", default=None,
                        help="multihost: coordinator address host:port")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s] [%(levelname)s] %(message)s")

    if args.multihost:
        from ilqr_tpu.parallel.mesh import initialize_distributed
        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id)

    from ilqr_tpu import runtime

    platform = runtime.setup()

    import jax
    import jax.numpy as jnp
    from ilqr_tpu.config import GlobalConfig
    from ilqr_tpu.parallel import make_mesh, shard_batch, sharded_solve_fn
    from ilqr_tpu.parallel.sharding import aggregate_stats, replicate
    from ilqr_tpu.sim.scenario import build_scenario_setup, perturbed_initial_states
    from ilqr_tpu.types import CILQRConfig, CILQRWeights

    cap_s = str(args.straggler_cap)
    straggler_cap = (tuple(int(c) for c in cap_s.split(",") if c)
                     if "," in cap_s else int(cap_s))

    if args.engine == "auto":
        args.engine = runtime.engine_for(platform)

    gc = GlobalConfig.from_file(args.config)
    st = build_scenario_setup(gc)
    kernel_kw = {}
    if args.engine == "kernel":
        from ilqr_tpu.ops.pallas.cilqr_kernel import tuned_options

        kernel_kw = tuned_options(gc)
        kernel_kw.update(window=args.window, straggler_cap=straggler_cap)
        if args.proj_rows >= 0:
            kernel_kw["proj_rows_per_step"] = args.proj_rows
    cfg = CILQRConfig.from_global_config(gc)
    w = CILQRWeights.from_global_config(gc, dtype=jnp.float32)
    scenario = st.device_scenario(tick=0, dtype=jnp.float32)
    n_dev = len(jax.devices())
    B = args.batch - args.batch % max(n_dev, 1) or n_dev
    log.info("platform=%s devices=%d engine=%s batch=%d steps=%d", platform,
             n_dev, args.engine, B, args.steps)

    use_mesh = n_dev > 1
    if use_mesh:
        from ilqr_tpu.parallel import sharded_kernel_solve_fn

        mesh = make_mesh(n_dev)
        if args.engine == "kernel":
            # fused kernel per shard: the perf path scales with the mesh
            solve_fn = sharded_kernel_solve_fn(mesh, cfg, **kernel_kw)
        else:
            solve_fn = sharded_solve_fn(mesh, cfg)
        w_d = replicate(mesh, w)
    elif args.engine == "kernel":
        # solve + stat aggregation in ONE jitted program: no eager op (and
        # no device round trip) per statistic
        from ilqr_tpu.ops.pallas.cilqr_kernel import cilqr_solve_pallas

        @jax.jit
        def solve_agg(w_, x0_b, scen_b):
            _, _, stats = cilqr_solve_pallas(cfg, w_, x0_b, scen_b,
                                             **kernel_kw)
            return aggregate_stats(stats)
    else:
        from ilqr_tpu.solvers.cilqr import solve

        @jax.jit
        def solve_agg(w_, x0_b, scen_b):
            _, _, stats, _ = jax.vmap(
                solve, in_axes=(None, None, 0, 0, None))(
                    cfg, w_, x0_b, scen_b, None)
            return aggregate_stats(stats)

    start_step = 0
    if args.checkpoint_dir:
        import os
        from ilqr_tpu.utils.checkpoint import restore_state, save_state
        cursor_path = os.path.join(args.checkpoint_dir, "cursor")
        if os.path.exists(cursor_path):
            start_step = int(np.asarray(restore_state(cursor_path)["step"]))
            log.info("resuming from step %d", start_step)

    totals = {"solves": 0, "converged": 0.0, "iters": 0.0, "wall": 0.0}
    # the scenario tensors are identical across steps (variation is in the
    # initial states): stack them once
    scen_b = jax.tree.map(lambda a: jnp.stack([a] * B), scenario)
    if use_mesh:
        scen_d = shard_batch(mesh, scen_b)
    for step in range(start_step, args.steps):
        x0_b = jnp.asarray(
            perturbed_initial_states(st.ego_x0, B, seed=1000 + step),
            jnp.float32)
        t0 = time.perf_counter()
        if use_mesh:
            _, _, stats, summary = solve_fn(w_d, shard_batch(mesh, x0_b),
                                            scen_d)
            summary = jax.device_get(summary)
        else:
            # one bulk device_get rather than a transfer per statistic
            summary = jax.device_get(solve_agg(w, x0_b, scen_b))
        dt = time.perf_counter() - t0
        totals["solves"] += B
        totals["converged"] += float(summary["converged"])
        totals["iters"] += float(summary["total_iters"])
        totals["wall"] += dt
        log.info(
            "step %d: %d solves in %.3f s (%.0f/s) converged %.1f%% mean_iters %.1f",
            step, B, dt, B / dt, 100 * float(summary["converged_frac"]),
            float(summary["mean_iters"]))
        if args.checkpoint_dir:
            save_state(cursor_path, {"step": step + 1})

    result = {
        "total_solves": totals["solves"],
        "solves_per_sec": totals["solves"] / max(totals["wall"], 1e-9),
        "converged_frac": totals["converged"] / max(totals["solves"], 1),
        "mean_iters": totals["iters"] / max(totals["solves"], 1),
        "engine": args.engine,
        "device": runtime.device_info(),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
