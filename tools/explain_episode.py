"""Explain the 120-tick episode's ego-advance profile in exact arithmetic.

The MPC benchmark (bench.py, BENCH_MODE=mpc) reports
final_ego_x mean = 52.70 m after 120 ticks (12 s) on scenario_two_straight
-- an average 0.44 m/tick vs the 0.797 m/tick of the first verified 20
ticks. This tool shows the deceleration is reference behavior (obstacle
interaction), not drift: it runs the float64 host-loop episode (run_mpc,
the driver proven equal to tests/oracle_cilqr.py semantics) for the
nominal ego start plus a few bench-batch perturbed rows and prints the
ego speed/position against the slow agents' positions.

Scenario physics (configs/scenario_two_straight.yaml == reference
config/scenario_two_straight.yaml): ego starts at x=0 at 8 m/s; agent 1
is a 3.0 m/s lead car in the ego lane at x=30; the left lane carries a
2.5 m/s car at x=15 and a 5 m/s car at x=35. Reference episode loop:
src/motion_planning.cpp:180-270.

Usage (CPU):
  env JAX_PLATFORMS=cpu python tools/explain_episode.py \
      [--ticks 120] [--rows 2]
"""

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=120)
    ap.add_argument("--rows", type=int, default=2,
                    help="extra perturbed bench rows to run")
    ap.add_argument("--warm", action="store_true", default=True)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from ilqr_tpu.config import GlobalConfig
    from ilqr_tpu.sim.mpc import run_mpc
    from ilqr_tpu.sim.scenario import (build_scenario_setup,
                                       perturbed_initial_states)
    from ilqr_tpu.solvers.cilqr import solve
    from ilqr_tpu.types import CILQRConfig, CILQRWeights

    gc = GlobalConfig.from_file(
        os.path.join(REPO, "configs", "scenario_two_straight.yaml"))
    st = build_scenario_setup(gc)
    cfg = dataclasses.replace(CILQRConfig.from_global_config(gc),
                              use_last_solution=args.warm)
    w = CILQRWeights.from_global_config(gc, dtype=jnp.float64)
    obs = st.obs_preds_array()  # (M, T, 3)

    def report(tag, ego_hist):
        x, y, v = ego_hist[:, 0], ego_hist[:, 1], ego_hist[:, 2]
        # gap to the ego-lane lead car (agent 0 = yaml row 2: x0=30, 3 m/s)
        lead_x = obs[0, :len(x), 0]
        gap = lead_x - x
        print(f"[{tag}] final x={x[-1]:.2f} m; v: start {v[0]:.2f} "
              f"t=2s {v[20]:.2f} t=4s {v[40]:.2f} t=8s {v[80]:.2f} "
              f"end {v[-1]:.2f} m/s", flush=True)
        print(f"[{tag}] lead-car gap: start {gap[0]:.1f} m, min "
              f"{gap.min():.1f} m at t={gap.argmin()/10:.1f}s, end "
              f"{gap[-1]:.1f} m; ego lane-y: max |y|={np.abs(y).max():.2f} m "
              f"(lane change would be ~3.6)", flush=True)
        print(f"[{tag}] ego v vs lead v at end: {v[-1]:.2f} vs 3.00 -> "
              f"{'following the 3 m/s lead' if abs(v[-1] - 3.0) < 0.8 else 'not lead-limited'}",
              flush=True)

    t0 = time.perf_counter()
    out = run_mpc(cfg, w, st, dtype=jnp.float64, ticks=args.ticks)
    print(f"nominal f64 episode: {time.perf_counter()-t0:.0f}s", flush=True)
    report("nominal", out["ego"])

    if args.rows:
        x0s = perturbed_initial_states(st.ego_x0, 8192, seed=0)
        solver_fn = jax.jit(solve, static_argnums=0)
        for r in range(args.rows):
            ego = jnp.asarray(x0s[r], jnp.float64)
            carry = None
            hist = [np.asarray(ego)]
            for t in range(args.ticks):
                scen = st.device_scenario(tick=t, horizon=cfg.N,
                                          dtype=jnp.float64)
                u, x, stats, carry = solver_fn(cfg, w, ego, scen, carry)
                ego = x[1]
                hist.append(np.asarray(ego))
            report(f"bench row {r}", np.stack(hist))


if __name__ == "__main__":
    main()
