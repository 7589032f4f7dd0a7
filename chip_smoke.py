"""End-to-end check that the planner runs on one NVIDIA GPU.

Run from the checkout root:  python chip_smoke.py
In one process on one card, at the shipped workload's full width
(scenario_two_straight: N=30, 3 obstacles, nx=4, nu=2, max_iter 100):

1. device check: the card's name and power limit;
2. compile of each engine (the fused Triton kernel and the XLA engine) at
   the cold-benchmark shape, with ``memory_analysis()``, and of every other
   program below; compiles overlap in threads;
3. correctness gates (tools/validate_kernel.py) on all four scenarios at
   batch 1024;
4. bench.py's two shapes on both engines (cold 16384, MPC 8192 x 120),
   timed one at a time, and the warm-episode gate: each engine's mean final
   ego x over the first 64 episodes against float64 XLA episodes of the
   same rows;
5. apps/motion_planning for one 120-tick float64 episode;
6. apps/sweep for 2 steps;
7. the episode scan form (``unroll=False``) against the unrolled episode.

``--four``: instead, only the 4-card phase: the sharded solve paths over a
4-card mesh against the single-card result on the same rows.

Exits non-zero, printing no result, when JAX finds no GPU or any phase
fails. The last line of stdout is one JSON object with the device.
"""

import argparse
import functools
import io
import json
import os
import sys
import time
from contextlib import redirect_stdout

T0 = time.perf_counter()
GATE_BATCH = 1024  # the f64 anchors' batch
EPISODE_ROWS = 64
FOUR_BATCH, FOUR_EPISODES, FOUR_TICKS = 4096, 1024, 10


def log(*args):
    print(f"[{time.perf_counter() - T0:7.1f}s]", *args, flush=True)


def timed(run, iters: int):
    """Median seconds of ``iters`` runs (compiled and warmed up before)."""
    import jax
    import numpy as np

    samples, out = [], None
    for _ in range(iters):
        t = time.perf_counter()
        out = jax.block_until_ready(run())
        samples.append(time.perf_counter() - t)
    return float(np.median(samples)), out


def parallel(**thunks):
    """Run the thunks in threads (their compiles overlap) and return their
    results by name; any exception propagates."""
    from concurrent.futures import ThreadPoolExecutor

    import jax

    def call(item):
        name, f = item
        t = time.perf_counter()
        out = jax.block_until_ready(f())
        log(f"  ready: {name} ({time.perf_counter() - t:.1f}s)")
        return name, out

    with ThreadPoolExecutor(max_workers=8) as ex:
        return dict(ex.map(call, thunks.items()))


def cold_compiler():
    """compile_one(engine): compiles the cold-bench shape for an engine,
    prints ``memory_analysis()``, checks one run, and returns the run."""
    import functools

    import jax
    import jax.numpy as jnp

    import bench
    from ilqr_tpu.ops.pallas.cilqr_kernel import cilqr_solve_pallas, tuned_options
    from ilqr_tpu.solvers.cilqr import solve

    gc, st, cfg, w, x0_b = bench._problem(bench.COLD_BATCH)
    scen = st.device_scenario(tick=0, dtype=jnp.float32)
    scen_b = jax.tree.map(lambda a: jnp.stack([a] * bench.COLD_BATCH), scen)
    fns = {
        "kernel": functools.partial(cilqr_solve_pallas, cfg,
                                    **tuned_options(gc)),
        "xla": jax.vmap(lambda w, x, s: solve(cfg, w, x, s)[:3],
                        in_axes=(None, 0, 0)),
    }

    def compile_one(name):
        t = time.perf_counter()
        compiled = jax.jit(fns[name]).lower(w, x0_b, scen_b).compile()
        log(f"compile {name} cold {bench.COLD_BATCH}: "
            f"{time.perf_counter() - t:.1f}s {compiled.memory_analysis()}")
        u, x, stats = jax.block_until_ready(compiled(w, x0_b, scen_b))
        assert x.shape == (bench.COLD_BATCH, cfg.N + 1, 4)
        assert bool(jnp.isfinite(x).all()), name
        return lambda: (lambda st: (
            st.iters, jnp.mean(st.converged.astype(jnp.float32))))(
            compiled(w, x0_b, scen_b)[2])

    return compile_one


def phase_compile_and_gates():
    """Compiles every benchmark program and runs the correctness gates,
    overlapping compiles in threads. Returns the benchmark runs."""
    import jax.numpy as jnp

    import bench
    from tools import validate_kernel as vk

    compile_one = cold_compiler()
    thunks = {
        "cold_kernel": lambda: compile_one("kernel"),
        "cold_xla": lambda: compile_one("xla"),
        "mpc_xla": lambda: bench.build_mpc(bench.MPC_BATCH, bench.MPC_TICKS,
                                           "xla"),
        # the float64 reference episodes of the warm-episode gate
        "episode_f64": lambda: bench.build_mpc(
            EPISODE_ROWS, bench.MPC_TICKS, "xla", jnp.float64)()[1],
    }

    def mpc_kernel():
        run = bench.build_mpc(bench.MPC_BATCH, bench.MPC_TICKS, "kernel")
        run()  # compiles the chunk programs
        return run
    thunks["mpc_kernel"] = mpc_kernel
    for name in vk.SCENARIOS:
        thunks[f"{name}/xla_f64"] = functools.partial(
            vk.solve_xla, name, GATE_BATCH, jnp.float64)
        thunks[f"{name}/xla_f32"] = functools.partial(
            vk.solve_xla, name, GATE_BATCH, jnp.float32)
        thunks[f"{name}/kernel_f32"] = functools.partial(
            vk.solve_kernel, name, GATE_BATCH)
    done = parallel(**thunks)
    ok = True
    for name in vk.SCENARIOS:
        ref = done[f"{name}/xla_f32"]
        ok = vk.gate_xla_f64(name, GATE_BATCH, done[f"{name}/xla_f64"]) and ok
        ok = vk.gate_f32(name, GATE_BATCH, "kernel",
                         done[f"{name}/kernel_f32"], ref) and ok
        ok = vk.gate_f32(name, GATE_BATCH, "xla", ref, ref) and ok
    assert ok, "a correctness gate failed"
    return done


def phase_bench(done):
    """Both engines at both benchmark shapes, timed one after another on
    the idle card; the warm-episode gate on the MPC runs' first rows."""
    import jax.numpy as jnp
    import numpy as np

    import bench

    ref = float(np.mean(np.asarray(done["episode_f64"])))
    results = {}
    for mode, engine, iters in (("cold", "kernel", 3), ("cold", "xla", 1),
                                ("mpc", "kernel", 1), ("mpc", "xla", 1)):
        dt, out = timed(done[f"{mode}_{engine}"], iters)
        batch = bench.COLD_BATCH if mode == "cold" else bench.MPC_BATCH
        solves = batch * (1 if mode == "cold" else bench.MPC_TICKS)
        results[(mode, engine)] = solves / dt
        log(f"bench {mode} {engine} batch {batch}: median {dt:.4f}s "
            f"({iters} runs), {solves / dt:.1f} solves/s, mean_iters "
            f"{float(jnp.mean(out[0])):.3f}, "
            f"{'final_ego_x_mean' if mode == 'mpc' else 'converged'} "
            f"{float(jnp.mean(out[1])):.4f}")
        if mode == "mpc":
            got = float(np.mean(np.asarray(out[1])[:EPISODE_ROWS]))
            ok = abs(got - ref) <= 0.05
            log(f"{'PASS' if ok else 'FAIL'} episode {engine}_f32: mean "
                f"final ego x {got:.4f} vs f64 xla {ref:.4f} over the first "
                f"{EPISODE_ROWS} rows (gap {abs(got - ref):.4f}, limit 0.05)")
            assert ok, f"warm-episode gate failed for {engine}"
    for mode in ("cold", "mpc"):
        k, x = results[(mode, "kernel")], results[(mode, "xla")]
        log(f"{mode}: kernel {k:.1f} / xla {x:.1f} solves/s = {k / x:.2f}x")
    faster = all(results[(m, "kernel")] > results[(m, "xla")]
                 for m in ("cold", "mpc"))
    log(f"engine kept on the GPU: {'kernel' if faster else 'xla'}")
    assert faster, "the fused kernel is not faster end to end on this card"


def phase_apps():
    from ilqr_tpu.apps import motion_planning, sweep

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = os.path.join(here, "configs", "scenario_two_straight.yaml")
    t = time.perf_counter()
    assert motion_planning.main(["-c", cfg, "--no-viz", "--ticks", "120"]) == 0
    log(f"motion_planning 120 ticks float64: {time.perf_counter() - t:.1f}s")
    buf = io.StringIO()
    t = time.perf_counter()
    with redirect_stdout(buf):
        assert sweep.main(["-c", cfg, "--steps", "2"]) == 0
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert result["total_solves"] > 0 and result["engine"] == "kernel"
    log(f"sweep 2 steps: {time.perf_counter() - t:.1f}s {result}")


def phase_scan_form():
    """Whether the scan form of the episode driver (unroll=False) matches
    the unrolled one on the card: input for removing one of the forms."""
    import jax.numpy as jnp
    import numpy as np

    import bench
    from ilqr_tpu.ops.pallas.cilqr_kernel import tuned_options
    from ilqr_tpu.sim.mpc import run_mpc_kernel_scan

    rows, ticks = 256, 3
    gc, st, cfg, w, x0_b = bench._problem(rows, warm=True)
    scen = st.device_scenario(tick=0, dtype=jnp.float32)
    obs = jnp.stack([jnp.asarray(st.obs_preds_array(), jnp.float32)] * rows)
    args = (cfg, w, x0_b, jnp.stack([scen.ref_line] * rows),
            jnp.stack([jnp.asarray(scen.ref_velo, jnp.float32)] * rows), obs,
            jnp.stack([scen.road_borders] * rows))
    opts = tuned_options(gc)
    a = run_mpc_kernel_scan(*args, ticks=ticks, **opts)
    b = run_mpc_kernel_scan(*args, ticks=ticks, unroll=False, **opts)
    same = all(np.array_equal(np.asarray(p), np.asarray(q))
               for p, q in zip(a[:2], b[:2]))
    log(f"unroll=False episode equals the unrolled one bitwise: {same}")


def phase_four():
    """Sharded paths over a 4-card mesh vs the single-card result."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from ilqr_tpu.ops.pallas.cilqr_kernel import (WARM_CAP, cilqr_solve_pallas,
                                                  tuned_options)
    from ilqr_tpu.parallel import (make_mesh, run_mpc_chunked_sharded,
                                   shard_batch, sharded_kernel_solve_fn,
                                   sharded_solve_fn)
    from ilqr_tpu.parallel.sharding import aggregate_stats, replicate
    from ilqr_tpu.sim.mpc import run_mpc_kernel_chunked
    from ilqr_tpu.solvers.cilqr import solve
    from tools import validate_kernel

    assert len(jax.devices()) == 4, "the 4-card phase needs 4 cards"
    mesh = make_mesh(4)
    one = jax.devices()[:1]
    B = FOUR_BATCH
    gc, st, cfg, w, x0_b = bench._problem(B)
    scen = st.device_scenario(tick=0, dtype=jnp.float32)
    scen_b = jax.tree.map(lambda a: jnp.stack([a] * B), scen)
    opts = tuned_options(gc)
    sharded = (replicate(mesh, w), shard_batch(mesh, x0_b),
               shard_batch(mesh, scen_b))
    single = jax.device_put((w, x0_b, scen_b), one[0])

    E, ticks = FOUR_EPISODES, FOUR_TICKS
    _, st_w, cfg_w, w_e, x0_e = bench._problem(E, warm=True)
    obs = jnp.asarray(st_w.obs_preds_array(), jnp.float32)
    pad = max(ticks + cfg_w.N + 1 - obs.shape[1], 0)
    obs = jnp.concatenate(
        [obs, jnp.broadcast_to(obs[:, -1:], (obs.shape[0], pad, 3))], 1)
    ep_args = (x0_e, jnp.stack([scen.ref_line] * E),
               jnp.stack([jnp.asarray(scen.ref_velo, jnp.float32)] * E),
               jnp.stack([obs] * E), jnp.stack([scen.road_borders] * E))
    ep_kw = dict(opts, straggler_cap_warm=WARM_CAP, ticks=ticks, chunk=5)
    vsolve = jax.jit(jax.vmap(solve, in_axes=(None, None, 0, 0, None)),
                     static_argnums=0)
    out = parallel(
        kernel4=lambda: sharded_kernel_solve_fn(mesh, cfg, **opts)(*sharded),
        kernel1=lambda: cilqr_solve_pallas(cfg, *single, **opts),
        xla4=lambda: sharded_solve_fn(mesh, cfg)(*sharded),
        xla1=lambda: vsolve(cfg, *single, None),
        episodes4=lambda: run_mpc_chunked_sharded(mesh, cfg_w, w_e, *ep_args,
                                                  **ep_kw),
        episodes1=lambda: run_mpc_kernel_chunked(
            cfg_w, w_e, *jax.device_put(ep_args, one[0]), **ep_kw))

    def same_summary(summary, stats):
        ref = aggregate_stats(stats)
        for key in ("num_solves", "converged", "lamb_overflow", "total_iters"):
            assert float(summary[key]) == float(ref[key]), key

    def equal(pairs):
        return all(np.array_equal(np.asarray(p), np.asarray(q))
                   for p, q in pairs)

    u4, x4, s4, sum4 = out["kernel4"]
    u1, x1, s1 = out["kernel1"]
    assert equal(((u4, u1), (x4, x1), (s4.iters, s1.iters),
                  (s4.status, s1.status))), \
        "sharded kernel differs from the single-card kernel"
    same_summary(sum4, s1)
    log(f"4-card kernel solve: bitwise equal to one card over {B} rows; "
        f"psum'd stats equal the single-card aggregate")

    u4, x4, s4, sum4 = out["xla4"]
    u1, x1, s1, _ = out["xla1"]
    bitwise = equal(((u4, u1), (x4, x1), (s4.status, s1.status)))
    same_summary(sum4, s4)
    res4 = validate_kernel._host(x4, s4)
    res1 = validate_kernel._host(x1, s1)
    both = res4["conv"] & res1["conv"]
    pos = float(np.percentile(np.abs(res4["x"][both] - res1["x"][both]), 90)) \
        if both.any() else 0.0
    conv_gap = abs(float(np.mean(res4["conv"])) - float(np.mean(res1["conv"])))
    log(f"4-card XLA solve: bitwise={bitwise} conv gap {conv_gap:.4f} "
        f"pos p90 {pos:.2e} m; psum'd stats equal the host aggregate")
    assert bitwise or (conv_gap <= 0.03 and pos < 5e-2)

    assert equal(zip(out["episodes4"][:2], out["episodes1"][:2])) and equal(
        ((out["episodes4"][2].iters, out["episodes1"][2].iters),)), \
        "sharded episodes differ from the single-card episodes"
    log(f"4-card chunked episodes: {E} x {ticks} ticks bitwise equal to one "
        f"card")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card phase")
    args = ap.parse_args()

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from ilqr_tpu import runtime

    if runtime.cpu_requested():
        sys.exit("chip_smoke.py needs a GPU; JAX_PLATFORMS=cpu was set")
    platform = runtime.setup(x64=True)
    log(runtime.gpu_name_and_power_limit())
    info = runtime.device_info()
    log(f"platform={platform} {info}")
    assert info["platform"] == "gpu"

    if args.four:
        phase_four()
    else:
        t = time.perf_counter()
        done = phase_compile_and_gates()
        log(f"compiles and gates done in {time.perf_counter() - t:.1f}s")
        for phase in (functools.partial(phase_bench, done), phase_apps,
                      phase_scan_form):
            t = time.perf_counter()
            phase()
            log(f"phase done in {time.perf_counter() - t:.1f}s")
    print(json.dumps({"ok": True, "device": runtime.device_info()}))


if __name__ == "__main__":
    main()
