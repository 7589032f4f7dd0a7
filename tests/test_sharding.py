"""Multi-device sharding on the 8-device virtual CPU mesh."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ilqr_tpu.config import GlobalConfig
from ilqr_tpu.parallel import make_mesh, shard_batch, sharded_solve_fn
from ilqr_tpu.parallel.sharding import replicate
from ilqr_tpu.sim.scenario import build_scenario_setup, perturbed_initial_states
from ilqr_tpu.solvers.cilqr import solve
from ilqr_tpu.types import CILQRConfig, CILQRWeights

from tests.conftest import CONFIG_DIR


@pytest.fixture(scope="module")
def problem():
    gc = GlobalConfig.from_file(os.path.join(CONFIG_DIR, "scenario_two_straight.yaml"))
    st = build_scenario_setup(gc)
    cfg = CILQRConfig.from_global_config(gc, max_iter=20)
    w = CILQRWeights.from_global_config(gc, dtype=jnp.float64)
    scenario = st.device_scenario(tick=0, dtype=jnp.float64)
    B = 16
    x0_b = jnp.asarray(perturbed_initial_states(st.ego_x0, B, seed=3))
    scen_b = jax.tree.map(lambda a: jnp.stack([a] * B), scenario)
    return cfg, w, x0_b, scen_b


def test_eight_virtual_devices_present():
    assert len(jax.devices()) == 8


def test_sharded_solve_matches_single_device(problem):
    cfg, w, x0_b, scen_b = problem
    mesh = make_mesh(8)
    fn = sharded_solve_fn(mesh, cfg)
    u_sh, x_sh, stats_sh, summary = fn(
        replicate(mesh, w), shard_batch(mesh, x0_b), shard_batch(mesh, scen_b)
    )
    # single-device reference
    vsolve = jax.jit(jax.vmap(solve, in_axes=(None, None, 0, 0, None)),
                     static_argnums=0)
    u_ref, x_ref, stats_ref, _ = vsolve(cfg, w, x0_b, scen_b, None)
    np.testing.assert_allclose(np.asarray(u_sh), np.asarray(u_ref), atol=1e-10)
    np.testing.assert_allclose(np.asarray(x_sh), np.asarray(x_ref), atol=1e-10)
    np.testing.assert_array_equal(np.asarray(stats_sh.iters), np.asarray(stats_ref.iters))
    # psum'd summary equals host-side aggregate
    assert float(summary["num_solves"]) == x0_b.shape[0]
    np.testing.assert_allclose(
        float(summary["total_iters"]), float(jnp.sum(stats_ref.iters)), atol=1e-5
    )
    np.testing.assert_allclose(
        float(summary["converged_frac"]),
        float(jnp.mean(stats_ref.converged.astype(jnp.float32))),
        atol=1e-6,
    )


def test_sharded_kernel_matches_single_device_kernel():
    """The fused Pallas kernel composed with shard_map over the 8-device
    mesh must equal the single-device kernel call bitwise: per-shard padding
    and compaction are shard-local, so sharding only re-tiles the batch."""
    import dataclasses

    from ilqr_tpu.ops.pallas.cilqr_kernel import cilqr_solve_pallas
    from ilqr_tpu.parallel import sharded_kernel_solve_fn

    gc = GlobalConfig.from_file(
        os.path.join(CONFIG_DIR, "scenario_two_straight.yaml"))
    st = build_scenario_setup(gc)
    cfg = dataclasses.replace(CILQRConfig.from_global_config(gc, max_iter=8),
                              N=6)
    w = CILQRWeights.from_global_config(gc, dtype=jnp.float32)
    scenario = st.device_scenario(tick=0, horizon=cfg.N, dtype=jnp.float32)
    B = 16
    x0_b = jnp.asarray(perturbed_initial_states(st.ego_x0, B, seed=0),
                       jnp.float32)
    scen_b = jax.tree.map(lambda a: jnp.stack([a] * B), scenario)

    mesh = make_mesh(8)
    fn = sharded_kernel_solve_fn(mesh, cfg, window=64, straggler_cap=3,
                                 interpret=True, block=2)
    u_sh, x_sh, st_sh, summary = fn(
        replicate(mesh, w), shard_batch(mesh, x0_b), shard_batch(mesh, scen_b))

    u_1, x_1, st_1 = cilqr_solve_pallas(cfg, w, x0_b, scen_b, window=64,
                                        straggler_cap=3, interpret=True,
                                        block=8)
    np.testing.assert_array_equal(np.asarray(u_sh), np.asarray(u_1))
    np.testing.assert_array_equal(np.asarray(x_sh), np.asarray(x_1))
    np.testing.assert_array_equal(np.asarray(st_sh.iters),
                                  np.asarray(st_1.iters))
    np.testing.assert_array_equal(np.asarray(st_sh.status),
                                  np.asarray(st_1.status))
    # psum'd summary equals the host-side aggregate of the full batch
    assert float(summary["num_solves"]) == B
    np.testing.assert_allclose(
        float(summary["total_iters"]), float(jnp.sum(st_1.iters)), atol=1e-5)
    # outputs stay row-partitioned (no gather happened)
    assert len(u_sh.addressable_shards) == 8
    assert u_sh.addressable_shards[0].data.shape[0] == B // 8


def test_sharded_kernel_alm_io_matches_single_device():
    """ALM dual I/O through the sharded kernel: duals stay row-partitioned
    and equal the single-device kernel's bitwise."""
    import dataclasses

    from ilqr_tpu.ops.pallas.cilqr_kernel import cilqr_solve_pallas
    from ilqr_tpu.parallel import sharded_kernel_solve_fn

    gc = GlobalConfig.from_file(
        os.path.join(CONFIG_DIR, "scenario_two_straight.yaml"))
    st = build_scenario_setup(gc)
    cfg = dataclasses.replace(CILQRConfig.from_global_config(gc, max_iter=8),
                              N=6, solve_type="alm")
    w = CILQRWeights.from_global_config(gc, dtype=jnp.float32)
    scenario = st.device_scenario(tick=0, horizon=cfg.N, dtype=jnp.float32)
    B = 16
    x0_b = jnp.asarray(perturbed_initial_states(st.ego_x0, B, seed=0),
                       jnp.float32)
    scen_b = jax.tree.map(lambda a: jnp.stack([a] * B), scenario)
    C0 = 8 + 2 * cfg.num_obstacles
    mu0 = jnp.zeros((B, cfg.N, C0), jnp.float32)
    rho0 = jnp.full((B,), float(w.alm_rho_init), jnp.float32)

    mesh = make_mesh(8)
    fn = sharded_kernel_solve_fn(mesh, cfg, window=64, interpret=True,
                                 block=2, with_alm_io=True)
    u_sh, x_sh, st_sh, summary, (mu_sh, rho_sh) = fn(
        replicate(mesh, w), shard_batch(mesh, x0_b),
        shard_batch(mesh, scen_b), shard_batch(mesh, mu0),
        shard_batch(mesh, rho0))
    u_1, x_1, st_1, (mu_1, rho_1) = cilqr_solve_pallas(
        cfg, w, x0_b, scen_b, window=64, interpret=True, block=8,
        alm_mu0=mu0, alm_rho0=rho0, return_alm=True)
    np.testing.assert_array_equal(np.asarray(u_sh), np.asarray(u_1))
    np.testing.assert_array_equal(np.asarray(mu_sh), np.asarray(mu_1))
    np.testing.assert_array_equal(np.asarray(rho_sh), np.asarray(rho_1))
    assert len(mu_sh.addressable_shards) == 8


def test_output_shardings_stay_row_partitioned(problem):
    cfg, w, x0_b, scen_b = problem
    mesh = make_mesh(8)
    fn = sharded_solve_fn(mesh, cfg)
    u_sh, _, _, _ = fn(replicate(mesh, w), shard_batch(mesh, x0_b),
                       shard_batch(mesh, scen_b))
    # each device holds B/8 rows: no gather happened
    shards = u_sh.addressable_shards
    assert len(shards) == 8
    assert shards[0].data.shape[0] == x0_b.shape[0] // 8


def test_sharded_chunked_episode_matches_single_device():
    """run_mpc_chunked_sharded over the 8-device mesh equals the
    single-device chunked driver tick-for-tick bitwise (warm start + ALM
    duals carried across chunk boundaries, batch row-partitioned)."""
    import dataclasses

    from ilqr_tpu.parallel import run_mpc_chunked_sharded
    from ilqr_tpu.sim.mpc import run_mpc_kernel_chunked

    gc = GlobalConfig.from_file(
        os.path.join(CONFIG_DIR, "scenario_two_straight.yaml"))
    st = build_scenario_setup(gc)
    cfg = dataclasses.replace(CILQRConfig.from_global_config(gc, max_iter=6),
                              N=6, solve_type="alm", use_last_solution=True)
    w = CILQRWeights.from_global_config(gc, dtype=jnp.float32)
    scenario = st.device_scenario(tick=0, horizon=cfg.N, dtype=jnp.float32)
    B, ticks, chunk = 16, 4, 2
    x0_b = jnp.asarray(perturbed_initial_states(st.ego_x0, B, seed=0),
                       jnp.float32)
    obs_full = jnp.asarray(st.obs_preds_array(), jnp.float32)
    args = (jnp.stack([scenario.ref_line] * B),
            jnp.stack([jnp.asarray(scenario.ref_velo, jnp.float32)] * B),
            jnp.stack([obs_full[:, :ticks + cfg.N + 1]] * B),
            jnp.stack([scenario.road_borders] * B))
    kw = dict(ticks=ticks, chunk=chunk, window=64, interpret=True,
              block=2, straggler_cap=2, straggler_cap_warm=3)

    mesh = make_mesh(8)
    ego_s, us_s, st_s = run_mpc_chunked_sharded(
        mesh, cfg, w, x0_b, *args, **kw)
    ego_1, us_1, st_1 = run_mpc_kernel_chunked(cfg, w, x0_b, *args, **kw)
    np.testing.assert_array_equal(np.asarray(ego_s), np.asarray(ego_1))
    np.testing.assert_array_equal(np.asarray(us_s), np.asarray(us_1))
    np.testing.assert_array_equal(np.asarray(st_s.iters),
                                  np.asarray(st_1.iters))
    np.testing.assert_array_equal(np.asarray(st_s.status),
                                  np.asarray(st_1.status))
