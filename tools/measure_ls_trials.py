"""Measure the line-search trial-count distribution on the bench workload.

The fused kernel's line search is an early-exit while loop that runs until
EVERY scenario of the kernel's block is done; a single scenario that
exhausts all n_alphas=20 trials forces the whole block through 20 trial
(rollout+projection+cost) passes. This tool instruments the numpy oracle
(exact reference semantics, tests/oracle_cilqr.py) on the bench workload
(scenario_two_straight + perturbed_initial_states) to get:

  - per-(solve, iteration) trial counts,
  - the simulated lockstep tile-max trial count per iteration (what the
    kernel actually pays) vs the per-lane sum (what a perfectly
    divergence-free machine would pay).

This decides whether a chunked (breadth-first) line search pays: it caps the
per-iteration trial cost at ceil(20/width) sweeps instead of block-max
serial trials.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

from oracle_cilqr import OracleCILQR  # noqa: E402

from ilqr_tpu.config import GlobalConfig  # noqa: E402
from ilqr_tpu.sim.scenario import build_scenario_setup, perturbed_initial_states  # noqa: E402


def main():
    n_solves = int(os.environ.get("N_SOLVES", "96"))
    here = os.path.dirname(os.path.abspath(__file__))
    gc = GlobalConfig.from_file(
        os.path.join(here, "..", "configs", "scenario_two_straight.yaml"))
    st = build_scenario_setup(gc)
    x0s = perturbed_initial_states(st.ego_x0, n_solves, seed=0)
    scen = st.device_scenario(tick=0, dtype=np.float64)
    ref = np.asarray(scen.ref_line)
    rv = np.asarray(scen.ref_velo)
    rb = np.asarray(scen.road_borders)
    obs = np.asarray(scen.obs_preds)

    per_lane = []  # list of per-iteration trial-count lists
    for i in range(n_solves):
        o = OracleCILQR(gc, st.num_obstacles)
        counts = []
        orig_iter = o.iter_step

        def counting_iter(u, x, lamb, *a, _o=o, _counts=counts, _f=orig_iter):
            # count trials by wrapping forward
            n = [0]
            fwd = _o.forward

            def cf(*fa):
                n[0] += 1
                return fwd(*fa)

            _o.forward = cf
            out = _f(u, x, lamb, *a)
            _o.forward = fwd
            _counts.append(n[0])
            return out

        o.iter_step = counting_iter
        o.solve(np.asarray(x0s[i], np.float64), ref, rv, obs, rb)
        per_lane.append(counts)

    flat = np.concatenate([np.asarray(c) for c in per_lane])
    print(f"solves={n_solves} total_iters={flat.size} "
          f"mean_iters={flat.size / n_solves:.1f}")
    hist = np.bincount(flat, minlength=21)
    print("trial-count histogram (count: iterations):")
    for t in range(1, 21):
        if hist[t]:
            print(f"  {t:2d}: {hist[t]:5d}  ({100 * hist[t] / flat.size:.1f}%)")
    print(f"per-lane mean trials/iter = {flat.mean():.2f}")

    # simulate lockstep tiles of L lanes: column-wise max over active lanes
    rng = np.random.default_rng(0)
    for L in (8, 32, 128):
        tile_tot, lane_tot, reps = 0, 0, 0
        for _ in range(64):
            idx = rng.choice(n_solves, size=L, replace=L > n_solves)
            lanes = [per_lane[j] for j in idx]
            depth = max(len(c) for c in lanes)
            for it in range(depth):
                col = [c[it] for c in lanes if len(c) > it]
                tile_tot += max(col)
                lane_tot += sum(col)
            reps += 1
        print(f"tile L={L:3d}: lockstep trials/solve = "
              f"{tile_tot / (reps):.0f} per-tile-run; "
              f"divergence waste = {tile_tot * L / lane_tot:.2f}x "
              f"(tile-max sum {tile_tot} vs mean lane sum {lane_tot / L:.0f})")
    # what the packed-8 chunked line search would pay instead: per lockstep
    # iteration, chunks = ceil(tile-max / 8); rollout chains = chunks,
    # projection-units = 8 * chunks
    for L in (128,):
        rollouts, projs, base_r, base_p = 0, 0, 0, 0
        reps = 0
        for _ in range(64):
            idx = rng.choice(n_solves, size=L, replace=L > n_solves)
            lanes = [per_lane[j] for j in idx]
            depth = max(len(c) for c in lanes)
            for it in range(depth):
                m = max(c[it] for c in lanes if len(c) > it)
                chunks = -(-m // 8)
                rollouts += chunks
                projs += 8 * chunks
                base_r += m
                base_p += m
            reps += 1
        print(f"packed-8 vs current (L={L}): rollout chains {rollouts} vs "
              f"{base_r} ({base_r / rollouts:.2f}x fewer), projection-units "
              f"{projs} vs {base_p} ({projs / base_p:.2f}x more)")


if __name__ == "__main__":
    main()
