"""Batch sharding + collective stat aggregation.

The "distributed" column of SURVEY.md section 2:
- the scenario batch is row-partitioned over the mesh's ``data`` axis
  (embarrassingly parallel -- zero cross-device traffic during solves);
- convergence / throughput statistics are reduced with ``psum`` inside the
  same compiled program, so the (tiny) collective overlaps with the tail of
  solve compute instead of forcing a host sync.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ilqr_tpu.parallel.mesh import DATA_AXIS
from ilqr_tpu.solvers.cilqr import solve
from ilqr_tpu.types import CILQRConfig, CILQRWeights, SolveStats


def shard_batch(mesh: Mesh, tree, axis_name: str = DATA_AXIS):
    """Place a batched pytree with its leading axis split over the mesh."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.device_put(tree, sharding)


def replicate(mesh: Mesh, tree):
    return jax.device_put(tree, NamedSharding(mesh, P()))


def shard_batch_multihost(mesh: Mesh, local_tree, axis_name: str = DATA_AXIS):
    """Assemble a *global* batched pytree from per-process local rows.

    Each process passes its own shard (leading axis = local rows); the
    result is a global array row-partitioned over ``axis_name`` across all
    processes -- the multi-host feeding path (single-process
    :func:`shard_batch` only places process-local data).
    """
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.tree.map(
        lambda a: jax.make_array_from_process_local_data(sharding, a),
        local_tree,
    )


def aggregate_stats(stats: SolveStats, axis_name: Optional[str] = None):
    """Global scalar summary of a batch of SolveStats.

    Inside shard_map, pass ``axis_name`` to psum across devices; outside,
    plain reductions over the batch axis.
    """
    n = stats.iters.shape[0] if stats.iters.ndim else 1
    local = {
        "num_solves": jnp.asarray(n, jnp.float32),
        "converged": jnp.sum(stats.converged.astype(jnp.float32)),
        "lamb_overflow": jnp.sum(stats.lamb_overflow.astype(jnp.float32)),
        "total_iters": jnp.sum(stats.iters.astype(jnp.float32)),
        "total_cost": jnp.sum(stats.final_cost.astype(jnp.float32)),
    }
    if axis_name is not None:
        local = {k: lax.psum(v, axis_name) for k, v in local.items()}
    denom = jnp.maximum(local["num_solves"], 1.0)
    local["converged_frac"] = local["converged"] / denom
    local["mean_iters"] = local["total_iters"] / denom
    local["mean_cost"] = local["total_cost"] / denom
    return local


def sharded_kernel_solve_fn(mesh: Mesh, cfg: CILQRConfig, *,
                            axis_name: str = DATA_AXIS,
                            with_stats_psum: bool = True,
                            with_alm_io: bool = False, **kernel_kw):
    """Mesh-sharded batched solve on the *fused kernel* path.

    Same contract as :func:`sharded_solve_fn` --
    ``fn(w, x0_batch, scenario_batch) -> (u, x, stats, summary)`` with the
    batch row-partitioned over ``axis_name`` -- but each shard runs
    :func:`ilqr_tpu.ops.pallas.cilqr_kernel.cilqr_solve_pallas` on its local
    rows instead of the XLA-composed solver. The workload is
    embarrassingly parallel, so the kernel composes with ``shard_map`` with
    zero cross-device traffic in the hot path: batch padding to block
    multiples and the straggler-compaction argsort both stay shard-local;
    only the O(bytes) stats summary is psum'd. Kernel options
    (``kernel_kw``: window, straggler_cap, proj_rows_per_step, ls_chunk,
    proj_dot, block, interpret, ...) pass through unchanged; per-shard
    semantics are exactly the single-device kernel's.

    ``with_alm_io`` (ALM configs): the returned fn takes two extra
    row-partitioned args ``(alm_mu0 (B, N, C), alm_rho0 (B,))`` and returns
    a fifth element ``(alm_mu, alm_rho)`` -- the warm-start dual carry for
    MPC sweeps, shard-local like the solves themselves.
    """
    from ilqr_tpu.ops.pallas.cilqr_kernel import cilqr_solve_pallas

    kw = kernel_kw

    if with_alm_io:
        assert cfg.solve_type == "alm", "with_alm_io requires an ALM config"

        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(), P(axis_name), P(axis_name), P(axis_name),
                      P(axis_name)),
            out_specs=(P(axis_name), P(axis_name), P(axis_name), P(),
                       (P(axis_name), P(axis_name))),
            check_vma=False,
        )
        def _sharded_alm(w, x0_b, scen_b, alm_mu0, alm_rho0):
            u, x, stats, duals = cilqr_solve_pallas(
                cfg, w, x0_b, scen_b, alm_mu0=alm_mu0, alm_rho0=alm_rho0,
                return_alm=True, **kw)
            summary = aggregate_stats(
                stats, axis_name if with_stats_psum else None)
            return u, x, stats, summary, duals

        return jax.jit(_sharded_alm)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis_name), P(axis_name)),
        out_specs=(P(axis_name), P(axis_name), P(axis_name), P()),
        check_vma=False,
    )
    def _sharded(w, x0_b, scen_b):
        u, x, stats = cilqr_solve_pallas(cfg, w, x0_b, scen_b, **kw)
        summary = aggregate_stats(stats, axis_name if with_stats_psum else None)
        return u, x, stats, summary

    return jax.jit(_sharded)


def run_mpc_chunked_sharded(mesh: Mesh, cfg: CILQRConfig, w, x0_b,
                            ref_line_b, ref_velo_b, obs_full_b,
                            road_borders_b, *, ticks: int, chunk: int = 10,
                            straggler_cap_warm=None,
                            axis_name: str = DATA_AXIS, **kernel_kw):
    """Reference-length MPC episodes, batch row-partitioned over the mesh.

    The mesh analogue of :func:`ilqr_tpu.sim.mpc.run_mpc_kernel_chunked`
    (same contract and tick-for-tick results, tests/test_sharding.py): ONE
    compiled, shard_mapped chunk program -- ``chunk`` straight-line ticks
    of the fused kernel per shard, traced tick offset -- is dispatched
    ceil(ticks/chunk) times with the cross-tick carry (ego, shifted-u warm
    start, ALM duals) staying device-resident and row-partitioned between
    calls. Episodes are embarrassingly parallel, so the hot path has zero
    cross-device traffic; scaling is linear in mesh size like
    :func:`sharded_kernel_solve_fn`. ``kernel_kw`` are the kernel options
    of :func:`ilqr_tpu.sim.mpc.run_mpc_kernel_scan`.
    """
    from ilqr_tpu.sim.mpc import run_mpc_kernel_scan

    assert ticks % chunk == 0, "ticks must be a multiple of chunk"
    x0_b = jnp.asarray(x0_b, jnp.float32)
    B, N = x0_b.shape[0], cfg.N
    C0 = 8 + 2 * cfg.num_obstacles

    def make_chunk_fn(cold_first_tick: bool):
        episode = partial(
            run_mpc_kernel_scan, cfg, ticks=chunk,
            straggler_cap_warm=straggler_cap_warm, with_carry=True,
            cold_first_tick=cold_first_tick, **kernel_kw)

        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(), P(axis_name), P(axis_name), P(axis_name),
                      P(axis_name), P(axis_name), P(),
                      (P(axis_name), P(axis_name), P(axis_name))),
            out_specs=(P(None, axis_name), P(None, axis_name),
                       P(None, axis_name),
                       (P(axis_name), P(axis_name), P(axis_name))),
            check_vma=False,
        )
        def _chunk(w_, ego, rl, rv, ob, rb, t0, carry):
            return episode(w_, ego, rl, rv, ob, rb, t0=t0, carry_in=carry)

        return jax.jit(_chunk)

    # at most 2 compiled chunk programs (cold-start chunk 0 + warm
    # continuations), exactly like the single-device chunked driver
    fn_first = make_chunk_fn(True)
    fn_rest = (fn_first if straggler_cap_warm is None
               else make_chunk_fn(False))

    w_d = replicate(mesh, w)
    args_d = tuple(shard_batch(mesh, a, axis_name) for a in
                   (ref_line_b, ref_velo_b, obs_full_b, road_borders_b))
    ego = shard_batch(mesh, x0_b, axis_name)
    carry = shard_batch(
        mesh,
        (jnp.zeros((B, N, 2), jnp.float32),
         jnp.zeros((B, N, C0), jnp.float32),
         jnp.broadcast_to(jnp.asarray(w.alm_rho_init, jnp.float32), (B,))),
        axis_name)
    egos, us, stats_hist = [], [], []
    for c in range(ticks // chunk):
        fn = fn_first if c == 0 else fn_rest
        ego_c, us_c, stats_c, carry = fn(
            w_d, ego, *args_d, jnp.asarray(c * chunk, jnp.int32), carry)
        ego = ego_c[-1]
        egos.append(ego_c[1:])
        us.append(us_c)
        stats_hist.append(stats_c)
    ego_traj = jnp.concatenate([jnp.asarray(x0_b)[None]] + egos, axis=0)
    u_hist = jnp.concatenate(us, axis=0)
    stats = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0),
                         *stats_hist)
    return ego_traj, u_hist, stats


def sharded_solve_fn(mesh: Mesh, cfg: CILQRConfig, axis_name: str = DATA_AXIS,
                     with_stats_psum: bool = True):
    """Build a jitted, mesh-sharded batched solve.

    Returns ``fn(w, x0_batch, scenario_batch) -> (u, x, stats, summary)``
    where the batch leading axis is row-partitioned over ``axis_name`` and
    ``summary`` is the psum'd global stat dict (replicated on all devices).

    Uses ``shard_map`` so the per-shard program is exactly the single-chip
    vmapped solver -- XLA can't accidentally introduce resharding
    collectives into the hot loop.
    """
    vsolve = jax.vmap(solve, in_axes=(None, None, 0, 0, None))

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis_name), P(axis_name)),
        out_specs=(P(axis_name), P(axis_name), P(axis_name), P()),
        check_vma=False,
    )
    def _sharded(w, x0_b, scen_b):
        u, x, stats, _ = vsolve(cfg, w, x0_b, scen_b, None)
        summary = aggregate_stats(stats, axis_name if with_stats_psum else None)
        return u, x, stats, summary

    return jax.jit(_sharded)
