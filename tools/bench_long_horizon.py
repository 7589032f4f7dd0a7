"""Long-horizon scaling benchmark: sequential vs parallel-in-time Riccati.

The reference's horizon is N=30; this framework's long-horizon story
(SURVEY.md section 5, "Long-context / sequence parallelism") is the
``riccati_impl="pscan"`` solver mode -- the backward pass becomes a
``lax.associative_scan`` with O(log N) depth instead of an O(N) sequential
chain. This tool measures one full CILQR solve (batch B) at several horizon
lengths with both implementations on the current backend.

Usage: python tools/bench_long_horizon.py [--batch 64] [--horizons 32,128,512]
Prints one line per (impl, N) with the median per-solve wall time.
"""

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build_problem(N: int, batch: int):
    """Synthetic straight-road scenario long enough for any horizon."""
    from ilqr_tpu.config import GlobalConfig
    from ilqr_tpu.types import CILQRConfig, CILQRWeights, Scenario

    gc = GlobalConfig.from_file(
        os.path.join(REPO, "configs", "scenario_two_straight.yaml"))
    cfg = dataclasses.replace(
        CILQRConfig.from_global_config(gc, max_iter=20),
        N=N, num_obstacles=1, use_last_solution=False)
    w = CILQRWeights.from_global_config(gc, dtype=jnp.float32)

    ref_velo = 8.0
    length_m = ref_velo * N * 0.1 + 40.0
    P = int(length_m / 0.1)
    s = np.arange(P) * 0.1
    ref = np.stack([s, np.zeros(P), np.zeros(P), s], axis=-1)
    # one slow lead agent ahead, driving straight
    T = N + 1
    obs = np.zeros((1, T, 3))
    obs[0, :, 0] = 30.0 + 4.0 * np.arange(T) * 0.1
    scenario = Scenario(
        ref_line=jnp.asarray(ref, jnp.float32),
        ref_velo=jnp.asarray(ref_velo, jnp.float32),
        obs_preds=jnp.asarray(obs, jnp.float32),
        road_borders=jnp.asarray([4.5, -1.5], jnp.float32),
    )
    rng = np.random.default_rng(0)
    x0 = np.asarray([0.0, 1.5, 8.0, 0.0])
    x0_b = jnp.asarray(
        x0[None, :] + rng.normal(size=(batch, 4)) * [0.5, 0.3, 0.5, 0.02],
        jnp.float32)
    scen_b = jax.tree.map(lambda a: jnp.stack([a] * batch), scenario)
    return cfg, w, x0_b, scen_b


def main():
    from ilqr_tpu.solvers.cilqr import solve

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--horizons", default="32,128,512")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    print(f"backend={jax.default_backend()}", flush=True)
    for N in [int(n) for n in args.horizons.split(",")]:
        cfg0, w, x0_b, scen_b = build_problem(N, args.batch)
        row = {}
        for impl in ("scan", "pscan"):
            cfg = dataclasses.replace(cfg0, riccati_impl=impl)
            f = jax.jit(jax.vmap(solve, in_axes=(None, None, 0, 0, None)),
                        static_argnums=0)
            out = f(cfg, w, x0_b, scen_b, None)
            jax.block_until_ready(out)
            ts = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                out = f(cfg, w, x0_b, scen_b, None)
                jax.block_until_ready(out)
                ts.append(time.perf_counter() - t0)
            it = float(np.mean(np.asarray(out[2].iters)))
            row[impl] = (float(np.median(ts)), it)
            print(f"N={N:4d} impl={impl:5s} median_solve_batch="
                  f"{row[impl][0]*1e3:8.1f}ms mean_iters={it:.1f}", flush=True)
        print(f"N={N:4d} speedup(pscan/scan)="
              f"{row['scan'][0] / row['pscan'][0]:.2f}x", flush=True)


if __name__ == "__main__":
    main()
