"""Closed-loop motion-planning app (CLI).

The framework's equivalent of the reference executable
``motion_planning -c <yaml>`` (src/motion_planning.cpp:29-276): load a
scenario config, build lane geometry + agent routings, run the
receding-horizon CILQR loop, and render each tick. Solves on the GPU in float64 by default (``--f32`` for
float32); JAX_PLATFORMS=cpu asks for the CPU.

Usage:
    python -m ilqr_tpu.apps.motion_planning -c configs/scenario_two_straight.yaml
    ... [--ticks N] [--noise] [--seed S] [--save out.gif] [--no-viz] [--f32]
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

log = logging.getLogger("ilqr_tpu.motion_planning")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="CILQR motion planning demo")
    parser.add_argument("-c", "--config", required=True, help="scenario yaml path")
    parser.add_argument("--ticks", type=int, default=None,
                        help="simulation ticks (default: max_simulation_time/dt)")
    parser.add_argument("--noise", action="store_true",
                        help="enable agent position noise (reference behavior)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--save", default=None, help="save animation (gif/mp4)")
    parser.add_argument("--no-viz", action="store_true", help="run headless, no rendering")
    parser.add_argument("--live", action="store_true",
                        help="redraw each tick inside the MPC loop (the "
                        "reference's in-loop rendering, "
                        "src/motion_planning.cpp:182-269)")
    parser.add_argument("--f32", action="store_true", help="solve in float32 (default float64)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s] [%(levelname)s] %(message)s")

    from ilqr_tpu import runtime

    platform = runtime.setup(x64=not args.f32)

    import jax.numpy as jnp
    from ilqr_tpu.config import GlobalConfig
    from ilqr_tpu.sim.mpc import run_mpc
    from ilqr_tpu.sim.scenario import build_scenario_setup
    from ilqr_tpu.types import CILQRConfig, CILQRWeights
    from ilqr_tpu.utils.timing import TicToc

    dtype = jnp.float32 if args.f32 else jnp.float64
    log.info("config path: %s (platform %s, %s)", args.config, platform,
             jnp.dtype(dtype).name)
    gc = GlobalConfig.from_file(args.config)
    setup = build_scenario_setup(gc, noise=args.noise, seed=args.seed)
    cfg = CILQRConfig.from_global_config(gc)
    w = CILQRWeights.from_global_config(gc, dtype=dtype)

    timer = TicToc()

    live_ctx = None
    if args.live and not args.no_viz:
        # reference redraws and plt.pause(dt)s inside the loop
        # (src/motion_planning.cpp:182-269)
        from ilqr_tpu.viz.render import (
            _plt, _steering_wheel_sprite, make_car_sprite, render_frame)
        plt = _plt()
        fig, ax = plt.subplots(figsize=(10, 5))
        sprites = {
            "ego": make_car_sprite((0.2, 0.75, 0.8)),
            "agent": make_car_sprite((0.9, 0.9, 0.9)),
            "wheel": _steering_wheel_sprite(),
        }
        live_ctx = (plt, ax, sprites, float(gc["delta_t"]))

    def on_tick(t, u, x, stats):
        log.info(
            "tick %3d: iters=%3d status=%d converged=%s cost=%.3f",
            t, int(stats.iters), int(stats.status), bool(stats.converged),
            float(stats.final_cost),
        )
        if live_ctx is not None:
            plt, ax, sprites, dt = live_ctx
            render_frame(ax, setup, x[1], x, u[0], t, sprites=sprites)
            plt.pause(dt)

    timer.tic()
    history = run_mpc(cfg, w, setup, dtype=dtype, ticks=args.ticks, on_tick=on_tick)
    log.info("episode done: %d ticks in %.2f s (incl. jit compile)",
             len(history["u"]), timer.toc())

    ego = history["ego"]
    log.info("ego travelled %.1f m, final v=%.2f m/s",
             float(np.hypot(ego[-1, 0] - ego[0, 0], ego[-1, 1] - ego[0, 1])),
             float(ego[-1, 2]))

    if not args.no_viz:
        from ilqr_tpu.viz.render import animate_episode
        fig = animate_episode(setup, history, out_path=args.save,
                              show=args.save is None)
        if args.save:
            log.info("animation saved to %s", args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
