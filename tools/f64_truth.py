"""Float64 exact-semantics convergence anchors for the shipped scenarios.

Runs the float64 reference-semantics solver (exactly equal to
tests/oracle_cilqr.py per tests/test_cilqr.py) on the standard validation
batch (seed-0 perturbed initial states) for each scenario on CPU, and
writes the convergence statistics to tools/f64_anchors.json.

Why: on-device validation (tools/validate_kernel.py) compares the fused
kernel against the f32 XLA solver, but on the oscillator-heavy
scenario_three_bend any f32 compilation drifts from the exact reference
behavior. Gating the convergence fraction and the per-row exits against
the exact-arithmetic anchor instead of against a drifting f32 comparator
makes the criterion implementation-independent.
Reference status machine: src/cilqr_solver.cpp:110-142.

Usage (CPU):
  env JAX_PLATFORMS=cpu python tools/f64_truth.py \
      [--batch 1024] [--scenario NAME ...]
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ANCHORS = os.path.join(REPO, "tools", "f64_anchors.json")

SCENARIOS = [
    "scenario_two_straight",
    "scenario_two_borrow",
    "scenario_three_straight",
    "scenario_three_bend",
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--scenario", action="append", default=None)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from ilqr_tpu.config import GlobalConfig
    from ilqr_tpu.sim.scenario import (build_scenario_setup,
                                       perturbed_initial_states)
    from ilqr_tpu.solvers.cilqr import solve
    from ilqr_tpu.types import CILQRConfig, CILQRWeights

    out = {}
    if os.path.exists(ANCHORS):
        with open(ANCHORS) as f:
            out = json.load(f)

    f = jax.jit(jax.vmap(solve, in_axes=(None, None, 0, 0, None)),
                static_argnums=0)
    for name in (args.scenario or SCENARIOS):
        gc = GlobalConfig.from_file(
            os.path.join(REPO, "configs", name + ".yaml"))
        st = build_scenario_setup(gc)
        cfg = dataclasses.replace(
            CILQRConfig.from_global_config(gc), use_last_solution=False,
            line_search_width=4)  # bit-identical to the reference's serial
        # walk on CPU (f32 and f64)
        w = CILQRWeights.from_global_config(gc, dtype=jnp.float64)
        scenario = st.device_scenario(tick=0, dtype=jnp.float64)
        x0_b = jnp.asarray(
            perturbed_initial_states(st.ego_x0, args.batch, seed=0),
            jnp.float64)
        scen_b = jax.tree.map(lambda a: jnp.stack([a] * args.batch), scenario)
        t0 = time.perf_counter()
        _, _, stats, _ = f(cfg, w, x0_b, scen_b, None)
        it = np.asarray(stats.iters)
        conv = np.asarray(stats.converged)
        stat = np.asarray(stats.status)
        out[name] = {
            "batch": args.batch,
            "seed": 0,
            "conv": round(float(conv.mean()), 6),
            "mean_iters": round(float(it.mean()), 4),
            "status_hist": {str(s): int((stat == s).sum())
                            for s in np.unique(stat)},
            # Per-row exit statuses (reference status machine:
            # src/cilqr_solver.cpp:110-142), in batch-row order, so
            # validate_kernel.py can compute the full-batch per-row
            # f64-agreement fraction for both the kernel and the f32 XLA
            # comparator. ~1 KiB per scenario as a
            # compact digit string (statuses are single digits 0-3).
            "status_rows": "".join(str(int(s)) for s in stat),
        }
        print(f"{name}: conv={out[name]['conv']:.3f} "
              f"mean_iters={out[name]['mean_iters']:.2f} "
              f"({time.perf_counter()-t0:.0f}s)", flush=True)

    with open(ANCHORS, "w") as fp:
        json.dump(out, fp, indent=1, sort_keys=True)
    print(f"wrote {ANCHORS}")


if __name__ == "__main__":
    main()
