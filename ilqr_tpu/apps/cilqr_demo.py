"""Demo-2 CILQR motion-planning CLI (one-shot solve + animation replay).

The framework's equivalent of running the reference's pedagogical planner
``python scripts/2-cilqr-motionplanning.py`` (reference
scripts/2-cilqr-motionplanning.py:453-503): build the shipped demo scenario
(straight 1000-point reference line, two constant-velocity obstacles),
solve once with the demo-variant solver semantics
(ilqr_tpu.solvers.cilqr_demo), then replay the solved trajectory frame by
frame and finish with the every-second-step footprint summary plot.

Usage:
    python -m ilqr_tpu.apps.cilqr_demo [--save out.gif] [--no-viz] [--f32]
        [--max-iter 50] [--batch B]

``--batch B`` solves B perturbed copies of the demo problem in one vmapped
device call (the batched reading of the same workload) and replays the
first.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

log = logging.getLogger("ilqr_tpu.cilqr_demo")

DEMO_LENGTH = 4.5  # vehicle footprint (reference scripts/utils/kinematic.py)
DEMO_WIDTH = 2.0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="pedagogical CILQR planner (demo-2 semantics)")
    parser.add_argument("--max-iter", type=int, default=50)
    parser.add_argument("--batch", type=int, default=0,
                        help="solve B perturbed copies in one vmapped call")
    parser.add_argument("--save", default=None, help="save animation (gif/mp4)")
    parser.add_argument("--no-viz", action="store_true")
    parser.add_argument("--f32", action="store_true",
                        help="solve in float32 (default float64)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s] [%(levelname)s] %(message)s")

    import jax
    import jax.numpy as jnp
    from ilqr_tpu.solvers import cilqr_demo as demo
    from ilqr_tpu.utils.timing import TicToc

    dtype = jnp.float32 if args.f32 else jnp.float64
    p, x0, ref, ref_velo, obs_attrs, obs_preds = demo.demo_scenario(dtype)

    timer = TicToc()
    timer.tic()
    if args.batch:
        # batched form: perturb the start state laterally/longitudinally
        key = jax.random.PRNGKey(0)
        dx = 0.5 * jax.random.normal(key, (args.batch, 2), dtype)
        x0_b = jnp.broadcast_to(x0, (args.batch, 4)).at[:, :2].add(dx)
        mi = args.max_iter
        vsolve = jax.jit(jax.vmap(
            lambda p_, x0_, ref_, rv_, oa_, op_: demo.solve(
                p_, x0_, ref_, rv_, oa_, op_, mi),
            in_axes=(None, 0, None, None, None, None)))
        res = vsolve(p, x0_b, ref, ref_velo, obs_attrs, obs_preds)
        jax.block_until_ready(res.u)
        log.info("batch of %d demo solves in %.2f s (incl. jit compile); "
                 "converged %.1f%%, mean iters %.1f", args.batch, timer.toc(),
                 100 * float(jnp.mean(res.converged.astype(jnp.float32))),
                 float(jnp.mean(res.iters.astype(jnp.float32))))
        u, x = np.asarray(res.u[0]), np.asarray(res.x[0])
    else:
        res = jax.jit(demo.solve, static_argnums=6)(
            p, x0, ref, ref_velo, obs_attrs, obs_preds, args.max_iter)
        jax.block_until_ready(res.u)
        # reference prints the solve wall time (:470-477)
        log.info("----CILQR Solution Time: %.3f seconds----", timer.toc())
        log.info("iters=%d converged=%s J=%.4f", int(res.iters),
                 bool(res.converged), float(res.J))
        u, x = np.asarray(res.u), np.asarray(res.x)

    if not args.no_viz:
        from ilqr_tpu.viz.render import animate_demo_replay
        animate_demo_replay(u, x, np.asarray(obs_preds),
                            length=DEMO_LENGTH, width=DEMO_WIDTH,
                            acc_max=float(p.acc_max), out_path=args.save,
                            show=args.save is None)
        if args.save:
            log.info("animation saved to %s", args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
