"""Why do ~30% of bench rows not converge?

Reproduces the bench workload (scenario_two_straight, perturbed initial
states, float32) on CPU with the XLA solver, breaks the outcome down by
final status, characterises the non-converged subpopulation (how far the
perturbed start is from the reference line / road, initial speed), and —
the key question — runs the reference-semantics float64 oracle
(tests/oracle_cilqr.py = literal src/cilqr_solver.cpp:85-153 semantics)
on a sample of non-converged rows to establish whether the C++ reference
would converge on the same problems.

Usage: env JAX_PLATFORMS=cpu \
           python tools/analyze_tail.py [--batch 2048] [--oracle-sample 32]

Findings are summarised in NOTES.md.
"""

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STATUS_NAMES = {0: "RUNNING", 1: "CONVERGED", 2: "BACKWARD_PASS_FAIL",
                3: "FORWARD_PASS_FAIL", 4: "FORWARD_PASS_SMALL_STEP"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--oracle-sample", type=int, default=32)
    ap.add_argument("--scenario", default="scenario_two_straight")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from ilqr_tpu.config import GlobalConfig
    from ilqr_tpu.sim.scenario import build_scenario_setup, perturbed_initial_states
    from ilqr_tpu.solvers.cilqr import solve
    from ilqr_tpu.types import CILQRConfig, CILQRWeights
    from tests.oracle_cilqr import OracleCILQR

    gc = GlobalConfig.from_file(
        os.path.join(REPO, "configs", args.scenario + ".yaml"))
    st = build_scenario_setup(gc)
    cfg = CILQRConfig.from_global_config(gc, line_search_width=4)
    w = CILQRWeights.from_global_config(gc, dtype=jnp.float32)
    scenario = st.device_scenario(tick=0, dtype=jnp.float32)
    B = args.batch
    x0_b = perturbed_initial_states(st.ego_x0, B, seed=0)  # same as bench.py
    scen_b = jax.tree.map(lambda a: jnp.stack([a] * B), scenario)

    f = jax.jit(jax.vmap(solve, in_axes=(None, None, 0, 0, None)),
                static_argnums=0)
    u, x, stats, _ = f(cfg, w, jnp.asarray(x0_b, jnp.float32), scen_b, None)
    status = np.asarray(stats.status)
    conv = np.asarray(stats.converged)
    iters = np.asarray(stats.iters)
    lo = np.asarray(stats.lamb_overflow)

    print(f"batch={B} scenario={args.scenario} f32 XLA solver "
          f"(line_search_width=4)")
    print(f"converged={conv.mean():.4f} lamb_overflow={lo.mean():.4f} "
          f"iters p50/p90/max={np.percentile(iters, 50):.0f}/"
          f"{np.percentile(iters, 90):.0f}/{iters.max()}")
    print("final-status histogram:")
    for s in sorted(set(status.tolist())):
        m = status == s
        print(f"  {STATUS_NAMES[s]:<24} {m.mean():6.4f}  "
              f"(iters p50={np.percentile(iters[m], 50):.0f}, "
              f"conv={conv[m].mean():.3f}, overflow={lo[m].mean():.3f})")

    # -- characterise the tail vs the converged set -------------------------
    bad = ~conv
    ref0 = st.center_lines[0].as_array()  # (P, 4) x,y,yaw,(s)
    d = np.hypot(ref0[None, :, 0] - x0_b[:, 0:1],
                 ref0[None, :, 1] - x0_b[:, 1:2]).min(axis=1)
    rb = np.asarray(st.road_borders, float)
    off_road = (x0_b[:, 1] > rb.max()) | (x0_b[:, 1] < rb.min())
    print("\nperturbation character (converged vs not):")
    for nm, v in [("dist_to_refline", d), ("y", x0_b[:, 1]),
                  ("v", x0_b[:, 2]), ("yaw", x0_b[:, 3])]:
        print(f"  {nm:<16} conv mean={v[conv].mean():8.3f} "
              f"sd={v[conv].std():6.3f} | tail mean={v[bad].mean():8.3f} "
              f"sd={v[bad].std():6.3f}")
    print(f"  off-road starts: overall={off_road.mean():.4f} "
          f"tail={off_road[bad].mean():.4f} conv={off_road[conv].mean():.4f}")

    # -- does the *reference* converge on the tail rows? --------------------
    k = min(args.oracle_sample, int(bad.sum()))
    idx = np.flatnonzero(bad)[:k]
    obs = st.obs_preds_array()[:, 0:cfg.N + 1]
    agree, o_conv, o_overflow = 0, 0, 0
    for i in idx:
        o = OracleCILQR(gc, st.num_obstacles)
        o.solve(x0_b[i], ref0, gc["vehicle/target_velocity"], obs,
                st.road_borders)
        if o.status == o.CONVERGED:
            o_conv += 1
        else:
            agree += 1
            if o.iters < o.max_iter:
                o_overflow += 1  # stopped on lamb > max_lamb, not max_iter
    print(f"\noracle (f64 reference semantics) on {k} non-converged rows:")
    print(f"  also non-converged: {agree}/{k}  (lamb-overflow exits: "
          f"{o_overflow}, max-iter exits: {agree - o_overflow})")
    print(f"  converged under oracle: {o_conv}/{k} "
          f"(f32-vs-f64 threshold flips)")

    # and on a converged sample, as a control
    kc = min(args.oracle_sample, int(conv.sum()))
    idxc = np.flatnonzero(conv)[:kc]
    c_agree = 0
    for i in idxc:
        o = OracleCILQR(gc, st.num_obstacles)
        o.solve(x0_b[i], ref0, gc["vehicle/target_velocity"], obs,
                st.road_borders)
        c_agree += int(o.status == o.CONVERGED)
    print(f"  control: oracle converges on {c_agree}/{kc} of rows the f32 "
          f"solver converged on")


if __name__ == "__main__":
    main()
