"""Receding-horizon MPC drivers.

Reference loop: src/motion_planning.cpp:180-270 -- each tick solves CILQR on
the obstacle-prediction window starting at that tick and applies the second
planned state (``new_x.row(1)``, :197) as the next ego state.

Five drivers:
- :func:`run_mpc` -- host loop, one jitted solve per tick. Flexible
  (visualization hooks, per-tick logging); used by the parity suite and the
  demo app.
- :func:`run_mpc_scan` -- the whole episode as a single ``lax.scan`` with
  the solver carry (warm start + ALM duals) threaded through the scan carry.
  No host round-trip per tick, so "solves/sec" benchmarks are honest and
  episodes batch under ``vmap`` (SURVEY.md section 7 "Warm start & MPC
  statefulness").
- :func:`run_mpc_kernel` -- host loop over the fused kernel (batched
  scenarios, warm start + ALM duals carried host-side).
- :func:`run_mpc_kernel_scan` -- whole episode on the fused kernel in one
  compiled program (straight-line chained ticks), independent of per-tick
  dispatch latency.
- :func:`run_mpc_kernel_chunked` -- reference-length episodes as repeated
  dispatches of one compiled chunk program; the benchmark path.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ilqr_tpu.solvers.cilqr import solve
from ilqr_tpu.types import CILQRCarry, CILQRConfig, CILQRWeights, Scenario


def _kernel_kw(w_back, ls_chunk, proj_dot, block):
    """Kernel options a driver forwards; None keeps the kernel's default."""
    kw = dict(ls_chunk=ls_chunk, proj_dot=proj_dot)
    if w_back is not None:
        kw["w_back"] = w_back
    if block is not None:
        kw["block"] = block
    return kw


def run_mpc(cfg: CILQRConfig, w: CILQRWeights, setup, dtype=jnp.float64,
            ticks: Optional[int] = None,
            on_tick: Optional[Callable] = None):
    """Host-driven episode. Returns dict of stacked histories."""
    ticks = ticks if ticks is not None else setup.num_ticks
    solver_fn = jax.jit(solve, static_argnums=0)
    ego = jnp.asarray(setup.ego_x0, dtype=dtype)
    carry = None
    ego_hist, u_hist, x_hist, stats_hist = [np.asarray(ego)], [], [], []
    for t in range(ticks):
        scenario = setup.device_scenario(tick=t, horizon=cfg.N, dtype=dtype)
        u, x, stats, carry = solver_fn(cfg, w, ego, scenario, carry)
        ego = x[1]
        ego_hist.append(np.asarray(ego))
        u_hist.append(np.asarray(u))
        x_hist.append(np.asarray(x))
        stats_hist.append(jax.tree.map(np.asarray, stats))
        if on_tick is not None:
            on_tick(t, np.asarray(u), np.asarray(x), stats_hist[-1])
    return {
        "ego": np.stack(ego_hist),
        "u": np.stack(u_hist),
        "x": np.stack(x_hist),
        "stats": stats_hist,
    }


def run_mpc_scan(cfg: CILQRConfig, w: CILQRWeights, x0, ref_line, ref_velo,
                 obs_preds_full, road_borders, ticks: int):
    """Whole-episode jitted scan.

    Args:
      x0: (4,) ego start; obs_preds_full: (M, T, 3) full routing lines with
      T >= ticks + N + 1; other args as in Scenario.

    Returns (ego_traj (ticks+1, 4), u_hist (ticks, N, 2), stats pytree with
    leading ``ticks`` axis).
    """
    x0 = jnp.asarray(x0)
    dtype = x0.dtype
    carry0 = CILQRCarry.init(cfg, w, dtype)

    def tick_step(carry, t):
        ego, sc = carry
        window = lax.dynamic_slice_in_dim(obs_preds_full, t, cfg.N + 1, axis=1)
        scenario = Scenario(
            ref_line=ref_line,
            ref_velo=ref_velo,
            obs_preds=window,
            road_borders=road_borders,
        )
        u, x, stats, sc = solve(cfg, w, ego, scenario, sc)
        new_ego = x[1]
        return (new_ego, sc), (new_ego, u, stats)

    (_, _), (egos, us, stats) = lax.scan(
        tick_step, (x0, carry0), jnp.arange(ticks)
    )
    ego_traj = jnp.concatenate([x0[None], egos], axis=0)
    return ego_traj, us, stats


def run_mpc_kernel(cfg: CILQRConfig, w: CILQRWeights, x0_b, ref_line_b,
                   ref_velo_b, obs_full_b, road_borders_b, ticks: int,
                   window: int = 512, interpret: bool = False,
                   straggler_cap: int = 0, proj_rows_per_step: int = 0,
                   w_back: Optional[int] = None, ls_chunk: int = 0,
                   proj_dot: bool = False, block: Optional[int] = None):
    """Batched receding-horizon episodes on the fused Pallas kernel.

    x0_b (B, 4); ref_line_b (B, P, 4); obs_full_b (B, M, T, 3) with
    T >= ticks + N + 1; warm start (the reference's shifted-previous-u,
    src/cilqr_solver.cpp:163-180) is applied when cfg.use_last_solution,
    and in ALM mode the dual state (mu, rho) persists across ticks exactly
    like the reference's members (:88-102), so ALM + use_last_solution
    (the reference's warm-start scenario with its alm penalty family,
    config/scenario_three_straight.yaml:14,24) runs end-to-end on the
    kernel.

    Returns (ego (ticks+1, B, 4), u_hist (ticks, B, N, 2), stats pytree
    with leading ticks axis).
    """
    from ilqr_tpu.ops.pallas.cilqr_kernel import cilqr_solve_pallas

    kb = _kernel_kw(w_back, ls_chunk, proj_dot, block)
    alm = cfg.solve_type == "alm"
    ego = jnp.asarray(x0_b, jnp.float32)
    u_prev = None
    alm_mu = alm_rho = None
    egos, us, stats_hist = [ego], [], []
    for t in range(ticks):
        scenario = Scenario(
            ref_line=ref_line_b,
            ref_velo=ref_velo_b,
            obs_preds=obs_full_b[:, :, t: t + cfg.N + 1],
            road_borders=road_borders_b,
        )
        u_init = None
        if cfg.use_last_solution and u_prev is not None:
            u_init = jnp.concatenate([u_prev[:, 1:], u_prev[:, -1:]], axis=1)
        if alm:
            # duals persist across ticks only under use_last_solution
            # (reference reset policy, src/cilqr_solver.cpp:88-93)
            mu_in = alm_mu if cfg.use_last_solution else None
            rho_in = alm_rho if cfg.use_last_solution else None
            u, x, st, (alm_mu, alm_rho) = cilqr_solve_pallas(
                cfg, w, ego, scenario, window=window, interpret=interpret,
                u_init=u_init, straggler_cap=straggler_cap,
                proj_rows_per_step=proj_rows_per_step,
                alm_mu0=mu_in, alm_rho0=rho_in, return_alm=True, **kb)
        else:
            u, x, st = cilqr_solve_pallas(
                cfg, w, ego, scenario, window=window, interpret=interpret,
                u_init=u_init, straggler_cap=straggler_cap,
                proj_rows_per_step=proj_rows_per_step, **kb)
        ego = x[:, 1]
        u_prev = u
        egos.append(ego)
        us.append(u)
        stats_hist.append(st)
    stats = jax.tree.map(lambda *xs: jnp.stack(xs), *stats_hist)
    return jnp.stack(egos), jnp.stack(us), stats


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "ticks", "window", "interpret", "straggler_cap",
                     "proj_rows_per_step", "unroll", "with_carry",
                     "straggler_cap_warm", "cold_first_tick", "w_back",
                     "ls_chunk", "proj_dot", "block"),
)
def run_mpc_kernel_scan(cfg: CILQRConfig, w: CILQRWeights, x0_b, ref_line_b,
                        ref_velo_b, obs_full_b, road_borders_b, ticks: int,
                        window: int = 512, interpret: bool = False,
                        straggler_cap: int = 0, proj_rows_per_step: int = 0,
                        unroll: bool = True,
                        t0=0, carry_in=None, with_carry: bool = False,
                        straggler_cap_warm=None, cold_first_tick: bool = True,
                        w_back: Optional[int] = None, ls_chunk: int = 0,
                        proj_dot: bool = False, block: Optional[int] = None):
    """Whole-episode batched MPC with the fused kernel in ONE compiled
    program: a ``lax.scan`` over ticks whose body is the Pallas solve.

    The host loop of :func:`run_mpc_kernel` pays a dispatch round trip and
    an obstacle-window regather per tick (the reference's per-tick loop,
    src/motion_planning.cpp:180-270, pays the same in wall clock); here the
    obstacle window advance (``lax.dynamic_slice`` along the prediction
    axis), the shifted-previous-u warm start (src/cilqr_solver.cpp:163-180)
    and the ALM dual carry (:88-102) all live in the scan carry, so an
    episode is a single device program -- same results as the host-loop
    driver, tick for tick (tests/test_pallas_kernel.py).

    ``t0`` (traced) offsets the obstacle-prediction window: tick k of this
    call uses predictions starting at row ``t0 + k``. ``carry_in`` seeds
    the cross-tick solver state ``(u_prev (B, N, 2), alm_mu (B, N, C0),
    alm_rho (B,))`` -- pass the previous chunk's carry to split an episode
    into chunks (:func:`run_mpc_kernel_chunked`); None = episode start
    (zero u_prev == the reference's cold init, cold ALM duals).
    ``with_carry`` additionally returns the final carry.

    ``straggler_cap_warm``: straggler schedule for warm ticks. Warm-started
    solves converge in about half the iterations of cold ones, so
    compacting earlier pays; only the
    episode's first tick (cold unless ``cold_first_tick`` is False --
    chunk continuations pass False) keeps ``straggler_cap``. None = one
    schedule everywhere. Requires ``unroll`` (per-tick static knobs need
    the straight-line tick chain).

    Args as :func:`run_mpc_kernel`. Returns (ego (ticks+1, B, 4),
    u_hist (ticks, B, N, 2), stats pytree with leading ticks axis
    [, carry_out]).
    """
    from ilqr_tpu.ops.pallas.cilqr_kernel import cilqr_solve_pallas

    kb = _kernel_kw(w_back, ls_chunk, proj_dot, block)
    alm = cfg.solve_type == "alm"
    carry_duals = alm and cfg.use_last_solution
    x0_b = jnp.asarray(x0_b, jnp.float32)
    B, N = x0_b.shape[0], cfg.N
    C0 = 8 + 2 * cfg.num_obstacles

    def tick_step(carry, t, cap=straggler_cap):
        ego, u_prev, mu, rho = carry
        scenario = Scenario(
            ref_line=ref_line_b,
            ref_velo=ref_velo_b,
            obs_preds=lax.dynamic_slice_in_dim(obs_full_b, t, N + 1, axis=2),
            road_borders=road_borders_b,
        )
        # shifted warm start; at t=0 u_prev is zeros and shift(0) == 0 ==
        # the cold init, so no first-tick branch is needed
        u_init = (jnp.concatenate([u_prev[:, 1:], u_prev[:, -1:]], axis=1)
                  if cfg.use_last_solution else None)
        if alm:
            u, x, st, (mu, rho) = cilqr_solve_pallas(
                cfg, w, ego, scenario, window=window, interpret=interpret,
                u_init=u_init, straggler_cap=cap,
                proj_rows_per_step=proj_rows_per_step,
                alm_mu0=mu if carry_duals else None,
                alm_rho0=rho if carry_duals else None, return_alm=True,
                **kb)
        else:
            u, x, st = cilqr_solve_pallas(
                cfg, w, ego, scenario, window=window, interpret=interpret,
                u_init=u_init, straggler_cap=cap,
                proj_rows_per_step=proj_rows_per_step, **kb)
        new_ego = x[:, 1]
        return (new_ego, u, mu, rho), (new_ego, u, st)

    if carry_in is None:
        mu0 = jnp.zeros((B, N, C0), jnp.float32)
        rho0 = jnp.broadcast_to(jnp.asarray(w.alm_rho_init, jnp.float32), (B,))
        u_prev0 = jnp.zeros((B, N, 2), jnp.float32)
    else:
        u_prev0, mu0, rho0 = carry_in
    carry0 = (x0_b, u_prev0, mu0, rho0)
    # ``unroll``: emit the ticks as straight-line calls instead of a
    # lax.scan loop -- still ONE compiled program with no per-tick
    # dispatch. The straight-line chain is an explicit Python loop (not
    # scan unroll=n) so warm ticks can use their own static straggler
    # schedule; unroll=False (one schedule) is the scan form.
    if unroll:
        t0 = jnp.asarray(t0, jnp.int32)
        warm_cap = (straggler_cap if straggler_cap_warm is None
                    else straggler_cap_warm)
        carry = carry0
        egos_l, us_l, st_l = [], [], []
        for k in range(ticks):
            cap_k = (straggler_cap if (k == 0 and cold_first_tick)
                     else warm_cap)
            carry, (e_k, u_k, s_k) = tick_step(carry, t0 + k, cap=cap_k)
            egos_l.append(e_k)
            us_l.append(u_k)
            st_l.append(s_k)
        carry_f = carry
        egos = jnp.stack(egos_l)
        us = jnp.stack(us_l)
        stats = jax.tree.map(lambda *xs: jnp.stack(xs), *st_l)
    else:
        assert straggler_cap_warm is None, \
            "per-tick schedules require unroll=True"
        carry_f, (egos, us, stats) = lax.scan(
            tick_step, carry0, t0 + jnp.arange(ticks), unroll=1)
    ego_traj = jnp.concatenate([x0_b[None], egos], axis=0)
    if with_carry:
        return ego_traj, us, stats, (carry_f[1], carry_f[2], carry_f[3])
    return ego_traj, us, stats


def run_mpc_kernel_chunked(cfg: CILQRConfig, w: CILQRWeights, x0_b,
                           ref_line_b, ref_velo_b, obs_full_b,
                           road_borders_b, ticks: int, chunk: int = 10,
                           window: int = 512, interpret: bool = False,
                           straggler_cap: int = 0,
                           proj_rows_per_step: int = 0,
                           straggler_cap_warm=None,
                           w_back: Optional[int] = None, ls_chunk: int = 0,
                           proj_dot: bool = False,
                           block: Optional[int] = None):
    """Reference-length episodes (120-150 ticks, max_simulation_time in the
    shipped yamls / src/motion_planning.cpp:180) on the fused-kernel path.

    A 120-tick straight-line program would hold hundreds of kernel calls
    (one 10-tick chunk is ~40 already) and take long to compile. This
    driver splits the episode into fixed-size chunks of ``chunk`` ticks:
    ONE compiled chunk program
    (identical shape every call -- the tick offset ``t0`` is a traced
    scalar) is dispatched ceil(ticks/chunk) times, with the cross-tick
    carry (ego, shifted-u warm start, ALM duals) staying device-resident
    between calls. Host cost is one dispatch per chunk instead of per
    tick; results are tick-for-tick identical to :func:`run_mpc_kernel`
    (tested bitwise in tests/test_pallas_kernel.py::
    test_kernel_episode_chunked_matches_scan).

    ``ticks`` must be a multiple of ``chunk`` (pad the episode or pick a
    divisor; the shipped scenarios' 120/150 ticks both divide by 10).
    Returns (ego (ticks+1, B, 4), u_hist (ticks, B, N, 2), stats pytree
    with leading ticks axis).
    """
    assert ticks % chunk == 0, "ticks must be a multiple of chunk"
    x0_b = jnp.asarray(x0_b, jnp.float32)
    ego = x0_b
    B, N = x0_b.shape[0], cfg.N
    C0 = 8 + 2 * cfg.num_obstacles
    # explicit episode-start carry (not None) so every chunk -- including
    # the first -- hits the same compiled program
    carry = (jnp.zeros((B, N, 2), jnp.float32),
             jnp.zeros((B, N, C0), jnp.float32),
             jnp.broadcast_to(jnp.asarray(w.alm_rho_init, jnp.float32), (B,)))
    egos, us, stats_hist = [], [], []
    for c in range(ticks // chunk):
        # chunk continuations (c > 0) start on a warm tick: cold_first_tick
        # only for the true episode start, so at most 2 compiled chunk
        # programs exist when straggler_cap_warm differs
        ego_c, us_c, stats_c, carry = run_mpc_kernel_scan(
            cfg, w, ego, ref_line_b, ref_velo_b, obs_full_b, road_borders_b,
            ticks=chunk, window=window, interpret=interpret,
            straggler_cap=straggler_cap,
            proj_rows_per_step=proj_rows_per_step,
            t0=jnp.asarray(c * chunk, jnp.int32), carry_in=carry,
            with_carry=True, straggler_cap_warm=straggler_cap_warm,
            cold_first_tick=(c == 0 or straggler_cap_warm is None),
            w_back=w_back, ls_chunk=ls_chunk, proj_dot=proj_dot, block=block)
        ego = ego_c[-1]
        egos.append(ego_c[1:])
        us.append(us_c)
        stats_hist.append(stats_c)
    ego_traj = jnp.concatenate([x0_b[None]] + egos, axis=0)
    u_hist = jnp.concatenate(us, axis=0)
    stats = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0),
                         *stats_hist)
    return ego_traj, u_hist, stats
