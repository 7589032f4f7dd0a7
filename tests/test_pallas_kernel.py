"""Fused Triton CILQR kernel vs the XLA solver (Pallas interpreter on CPU).

Full-size interpreter runs are slow on CPU, so the parity checks run the
same kernel code at a reduced horizon (N=6) and a small block (8 scenarios
per program); the kernel is shape-polymorphic over N and the block, and the
full-size behavior on the card is checked by chip_smoke.py.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ilqr_tpu.config import GlobalConfig
from ilqr_tpu.ops.pallas.cilqr_kernel import cilqr_solve_pallas
from ilqr_tpu.sim.scenario import build_scenario_setup, perturbed_initial_states
from ilqr_tpu.solvers.cilqr import solve
from ilqr_tpu.types import CILQRConfig, CILQRWeights

from tests.conftest import CONFIG_DIR

# interpreter + a small block keep the CPU cost of each test low
KI = dict(interpret=True, block=8)


@pytest.fixture(scope="module")
def small_problem():
    gc = GlobalConfig.from_file(os.path.join(CONFIG_DIR, "scenario_two_straight.yaml"))
    st = build_scenario_setup(gc)
    cfg = dataclasses.replace(CILQRConfig.from_global_config(gc, max_iter=8), N=6)
    w = CILQRWeights.from_global_config(gc, dtype=jnp.float32)
    scenario = st.device_scenario(tick=0, horizon=cfg.N, dtype=jnp.float32)
    B = 8
    x0_b = jnp.asarray(perturbed_initial_states(st.ego_x0, B, seed=0), jnp.float32)
    scen_b = jax.tree.map(lambda a: jnp.stack([a] * B), scenario)
    return cfg, w, x0_b, scen_b


def test_kernel_matches_xla_solver(small_problem):
    cfg, w, x0_b, scen_b = small_problem
    u_k, x_k, stats_k = cilqr_solve_pallas(cfg, w, x0_b, scen_b, window=256,
                                           **KI)
    f = jax.jit(jax.vmap(solve, in_axes=(None, None, 0, 0, None)),
                static_argnums=0)
    u_r, x_r, stats_r, _ = f(cfg, w, x0_b, scen_b, None)
    np.testing.assert_array_equal(np.asarray(stats_k.iters), np.asarray(stats_r.iters))
    np.testing.assert_array_equal(np.asarray(stats_k.status), np.asarray(stats_r.status))
    np.testing.assert_allclose(np.asarray(u_k), np.asarray(u_r), atol=1e-4)
    np.testing.assert_allclose(np.asarray(x_k), np.asarray(x_r), atol=1e-4)
    np.testing.assert_allclose(np.asarray(stats_k.final_cost),
                               np.asarray(stats_r.final_cost), rtol=1e-4)


def test_kernel_matches_xla_gravity_center_many_obstacles():
    """two_borrow: gravity-center dynamics branch + 4 obstacles."""
    gc = GlobalConfig.from_file(os.path.join(CONFIG_DIR, "scenario_two_borrow.yaml"))
    st = build_scenario_setup(gc)
    cfg = dataclasses.replace(CILQRConfig.from_global_config(gc, max_iter=6), N=6)
    assert cfg.reference_point == "gravity_center"
    w = CILQRWeights.from_global_config(gc, dtype=jnp.float32)
    scenario = st.device_scenario(tick=0, horizon=cfg.N, dtype=jnp.float32)
    B = 4
    x0_b = jnp.asarray(perturbed_initial_states(st.ego_x0, B, seed=1), jnp.float32)
    scen_b = jax.tree.map(lambda a: jnp.stack([a] * B), scenario)
    u_k, x_k, stats_k = cilqr_solve_pallas(cfg, w, x0_b, scen_b, window=256,
                                           **KI)
    f = jax.jit(jax.vmap(solve, in_axes=(None, None, 0, 0, None)),
                static_argnums=0)
    u_r, x_r, stats_r, _ = f(cfg, w, x0_b, scen_b, None)
    np.testing.assert_array_equal(np.asarray(stats_k.iters), np.asarray(stats_r.iters))
    np.testing.assert_allclose(np.asarray(x_k), np.asarray(x_r), atol=1e-3)


@pytest.mark.parametrize("name,max_iter,B", [
    ("scenario_three_straight", 6, 4),  # 8 obstacles (densest constraint set)
    ("scenario_three_bend", 6, 4),      # curved (S-bend) reference spline
])
def test_kernel_matches_xla_remaining_scenarios(name, max_iter, B):
    """Kernel parity on the two scenario shapes the fixtures above miss:
    M=8 obstacle slabs and a curved reference-line window."""
    gc = GlobalConfig.from_file(os.path.join(CONFIG_DIR, name + ".yaml"))
    st = build_scenario_setup(gc)
    cfg = dataclasses.replace(
        CILQRConfig.from_global_config(gc, max_iter=max_iter),
        N=6, use_last_solution=False)
    w = CILQRWeights.from_global_config(gc, dtype=jnp.float32)
    scenario = st.device_scenario(tick=0, horizon=cfg.N, dtype=jnp.float32)
    x0_b = jnp.asarray(perturbed_initial_states(st.ego_x0, B, seed=2),
                       jnp.float32)
    scen_b = jax.tree.map(lambda a: jnp.stack([a] * B), scenario)
    u_k, x_k, stats_k = cilqr_solve_pallas(cfg, w, x0_b, scen_b, window=256,
                                           **KI)
    f = jax.jit(jax.vmap(solve, in_axes=(None, None, 0, 0, None)),
                static_argnums=0)
    u_r, x_r, stats_r, _ = f(cfg, w, x0_b, scen_b, None)
    np.testing.assert_array_equal(np.asarray(stats_k.iters),
                                  np.asarray(stats_r.iters))
    np.testing.assert_array_equal(np.asarray(stats_k.status),
                                  np.asarray(stats_r.status))
    np.testing.assert_allclose(np.asarray(x_k), np.asarray(x_r), atol=1e-3)


def test_kernel_alm_mode_matches_xla(small_problem):
    cfg, w, x0_b, scen_b = small_problem
    cfg_alm = dataclasses.replace(cfg, solve_type="alm")
    u_k, x_k, stats_k = cilqr_solve_pallas(cfg_alm, w, x0_b, scen_b,
                                           window=256, **KI)
    f = jax.jit(jax.vmap(solve, in_axes=(None, None, 0, 0, None)),
                static_argnums=0)
    u_r, x_r, stats_r, _ = f(cfg_alm, w, x0_b, scen_b, None)
    np.testing.assert_array_equal(np.asarray(stats_k.iters),
                                  np.asarray(stats_r.iters))
    np.testing.assert_array_equal(np.asarray(stats_k.status),
                                  np.asarray(stats_r.status))
    np.testing.assert_allclose(np.asarray(u_k), np.asarray(u_r), atol=1e-4)
    np.testing.assert_allclose(np.asarray(x_k), np.asarray(x_r), atol=1e-4)


def test_kernel_alm_warm_start_matches_xla(small_problem):
    """ALM + use_last_solution on the kernel: the dual state (mu, rho)
    rides the ALM I/O slab across solves exactly like the reference
    persists it between ticks (src/cilqr_solver.cpp:88-102)."""
    cfg, w, x0_b, scen_b = small_problem
    cfg_ws = dataclasses.replace(cfg, solve_type="alm",
                                 use_last_solution=True)
    # first (cold) solve, capturing the final duals
    u1, _, _, (mu1, rho1) = cilqr_solve_pallas(
        cfg_ws, w, x0_b, scen_b, window=256, **KI,
        return_alm=True)
    shifted = jnp.concatenate([u1[:, 1:], u1[:, -1:]], axis=1)
    u2, x2, st2 = cilqr_solve_pallas(
        cfg_ws, w, x0_b, scen_b, window=256, **KI,
        u_init=shifted, alm_mu0=mu1, alm_rho0=rho1)
    # XLA path with the equivalent carry
    from ilqr_tpu.types import CILQRCarry
    f = jax.jit(jax.vmap(solve, in_axes=(None, None, 0, 0, 0)),
                static_argnums=0)
    B = x0_b.shape[0]
    carry = CILQRCarry(
        last_u=u1,
        is_first=jnp.zeros((B,), bool),
        alm_rho=jnp.asarray(rho1, jnp.float32),
        alm_mu=jnp.asarray(mu1, jnp.float32),
    )
    u_r, x_r, st_r, _ = f(cfg_ws, w, x0_b, scen_b, carry)
    np.testing.assert_array_equal(np.asarray(st2.iters), np.asarray(st_r.iters))
    np.testing.assert_array_equal(np.asarray(st2.status),
                                  np.asarray(st_r.status))
    np.testing.assert_allclose(np.asarray(u2), np.asarray(u_r), atol=1e-4)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x_r), atol=1e-4)


def test_kernel_alm_carry_matches_xla_carry(small_problem):
    """The duals the kernel returns equal the XLA solve's carry."""
    cfg, w, x0_b, scen_b = small_problem
    cfg_alm = dataclasses.replace(cfg, solve_type="alm")
    _, _, _, (mu_k, rho_k) = cilqr_solve_pallas(
        cfg_alm, w, x0_b, scen_b, window=256, **KI,
        return_alm=True)
    f = jax.jit(jax.vmap(solve, in_axes=(None, None, 0, 0, None)),
                static_argnums=0)
    _, _, _, carry = f(cfg_alm, w, x0_b, scen_b, None)
    np.testing.assert_allclose(np.asarray(rho_k), np.asarray(carry.alm_rho),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(mu_k), np.asarray(carry.alm_mu),
                               atol=1e-5)


def test_kernel_warm_start_matches_xla(small_problem):
    """u_init threads through as the initial trajectory (the reference's
    shifted-previous-solution warm start is applied by the caller)."""
    cfg, w, x0_b, scen_b = small_problem
    cfg_ws = dataclasses.replace(cfg, use_last_solution=True)
    # first (cold) solve
    u1, _, _ = cilqr_solve_pallas(cfg_ws, w, x0_b, scen_b, window=256,
                                  **KI)
    shifted = jnp.concatenate([u1[:, 1:], u1[:, -1:]], axis=1)
    u2, x2, st2 = cilqr_solve_pallas(cfg_ws, w, x0_b, scen_b, window=256,
                                     **KI, u_init=shifted)
    # XLA path with an explicit carry reproducing the same warm start
    from ilqr_tpu.types import CILQRCarry
    f = jax.jit(jax.vmap(solve, in_axes=(None, None, 0, 0, 0)),
                static_argnums=0)
    B = x0_b.shape[0]
    carry = CILQRCarry(
        last_u=u1,
        is_first=jnp.zeros((B,), bool),
        alm_rho=jnp.zeros((B,), jnp.float32),
        alm_mu=jnp.zeros((B, cfg.N, cfg.num_constraints), jnp.float32),
    )
    u_r, x_r, st_r, _ = f(cfg_ws, w, x0_b, scen_b, carry)
    np.testing.assert_array_equal(np.asarray(st2.iters), np.asarray(st_r.iters))
    np.testing.assert_allclose(np.asarray(u2), np.asarray(u_r), atol=1e-4)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x_r), atol=1e-4)


def test_kernel_mpc_driver(small_problem):
    from ilqr_tpu.sim.mpc import run_mpc_kernel

    cfg, w, x0_b, scen_b = small_problem
    B = x0_b.shape[0]
    T = cfg.N + 1 + 3
    obs_full = jnp.concatenate(
        [scen_b.obs_preds,
         jnp.broadcast_to(scen_b.obs_preds[:, :, -1:],
                          (B, scen_b.obs_preds.shape[1], 3, 3))], axis=2)
    ego, us, stats = run_mpc_kernel(
        cfg, w, x0_b, scen_b.ref_line, scen_b.ref_velo, obs_full,
        scen_b.road_borders, ticks=3, window=256, **KI)
    assert ego.shape == (4, B, 4)
    assert us.shape == (3, B, cfg.N, 2)
    # vehicles advance each tick
    assert np.all(np.asarray(ego[-1, :, 0]) > np.asarray(ego[0, :, 0]))


def test_kernel_mpc_alm_warm_start_matches_scan():
    """ALM + use_last_solution MPC (scenario_three_straight's warm-start
    config with the ALM penalty family the reference gates behind the same
    yaml, /root/reference/config/scenario_three_straight.yaml:14,24)
    end-to-end on the kernel driver vs the XLA whole-episode scan: same
    per-tick iteration counts and trajectories."""
    from ilqr_tpu.sim.mpc import run_mpc_kernel, run_mpc_scan

    gc = GlobalConfig.from_file(
        os.path.join(CONFIG_DIR, "scenario_three_straight.yaml"))
    st = build_scenario_setup(gc)
    cfg = dataclasses.replace(CILQRConfig.from_global_config(gc, max_iter=6),
                              N=6, solve_type="alm")
    assert cfg.use_last_solution
    w = CILQRWeights.from_global_config(gc, dtype=jnp.float32)
    scenario = st.device_scenario(tick=0, dtype=jnp.float32)
    B, ticks = 2, 3
    x0_b = jnp.asarray(perturbed_initial_states(st.ego_x0, B, seed=3),
                       jnp.float32)
    obs_full = jnp.asarray(st.obs_preds_array(), jnp.float32)
    scen_b = jax.tree.map(lambda a: jnp.stack([a] * B),
                          scenario)
    obs_full_b = jnp.stack([obs_full] * B)
    ego_k, us_k, st_k = run_mpc_kernel(
        cfg, w, x0_b, scen_b.ref_line, scen_b.ref_velo, obs_full_b,
        scen_b.road_borders, ticks=ticks, window=256, **KI)
    scan_b = jax.vmap(
        lambda x0, rl, rv, ob, rb: run_mpc_scan(cfg, w, x0, rl, rv, ob, rb,
                                                ticks),
        in_axes=(0, 0, 0, 0, 0))
    ego_r, us_r, st_r = scan_b(x0_b, scen_b.ref_line, scen_b.ref_velo,
                               obs_full_b, scen_b.road_borders)
    # scan returns (B, ticks, ...); kernel driver (ticks, B, ...)
    np.testing.assert_array_equal(np.asarray(st_k.iters),
                                  np.asarray(st_r.iters).T)
    np.testing.assert_allclose(np.asarray(ego_k),
                               np.moveaxis(np.asarray(ego_r), 0, 1),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(us_k),
                               np.moveaxis(np.asarray(us_r), 0, 1),
                               atol=1e-4)


def test_kernel_episode_scan_matches_host_loop(small_problem):
    """Whole-episode-in-one-program driver (lax.scan over ticks with the
    kernel inside) == the host-loop kernel driver, tick for tick."""
    from ilqr_tpu.sim.mpc import run_mpc_kernel, run_mpc_kernel_scan

    cfg, w, x0_b, scen_b = small_problem
    B = x0_b.shape[0]
    ticks = 3
    obs_full = jnp.concatenate(
        [scen_b.obs_preds,
         jnp.broadcast_to(scen_b.obs_preds[:, :, -1:],
                          (B, scen_b.obs_preds.shape[1], ticks, 3))], axis=2)
    ego_h, us_h, st_h = run_mpc_kernel(
        cfg, w, x0_b, scen_b.ref_line, scen_b.ref_velo, obs_full,
        scen_b.road_borders, ticks=ticks, window=256, **KI)
    ego_s, us_s, st_s = run_mpc_kernel_scan(
        cfg, w, x0_b, scen_b.ref_line, scen_b.ref_velo, obs_full,
        scen_b.road_borders, ticks=ticks, window=256, **KI)
    np.testing.assert_array_equal(np.asarray(ego_h), np.asarray(ego_s))
    np.testing.assert_array_equal(np.asarray(us_h), np.asarray(us_s))
    np.testing.assert_array_equal(np.asarray(st_h.iters),
                                  np.asarray(st_s.iters))
    np.testing.assert_array_equal(np.asarray(st_h.status),
                                  np.asarray(st_s.status))


def test_kernel_episode_scan_alm_warm_start():
    """Scan driver under ALM + use_last_solution: duals and warm start
    ride the scan carry; must equal the host loop."""
    from ilqr_tpu.sim.mpc import run_mpc_kernel, run_mpc_kernel_scan

    gc = GlobalConfig.from_file(
        os.path.join(CONFIG_DIR, "scenario_three_straight.yaml"))
    st = build_scenario_setup(gc)
    cfg = dataclasses.replace(CILQRConfig.from_global_config(gc, max_iter=6),
                              N=6, solve_type="alm")
    assert cfg.use_last_solution
    w = CILQRWeights.from_global_config(gc, dtype=jnp.float32)
    scenario = st.device_scenario(tick=0, dtype=jnp.float32)
    B, ticks = 2, 3
    x0_b = jnp.asarray(perturbed_initial_states(st.ego_x0, B, seed=3),
                       jnp.float32)
    scen_b = jax.tree.map(lambda a: jnp.stack([a] * B), scenario)
    obs_full_b = jnp.stack([jnp.asarray(st.obs_preds_array(),
                                        jnp.float32)] * B)
    ego_h, us_h, st_h = run_mpc_kernel(
        cfg, w, x0_b, scen_b.ref_line, scen_b.ref_velo, obs_full_b,
        scen_b.road_borders, ticks=ticks, window=256, **KI)
    ego_s, us_s, st_s = run_mpc_kernel_scan(
        cfg, w, x0_b, scen_b.ref_line, scen_b.ref_velo, obs_full_b,
        scen_b.road_borders, ticks=ticks, window=256, **KI)
    np.testing.assert_array_equal(np.asarray(ego_h), np.asarray(ego_s))
    np.testing.assert_array_equal(np.asarray(us_h), np.asarray(us_s))
    np.testing.assert_array_equal(np.asarray(st_h.iters),
                                  np.asarray(st_s.iters))


def test_kernel_pads_batch_to_lane_multiple(small_problem):
    cfg, w, x0_b, scen_b = small_problem
    # B=8 is far from a multiple of the block (one scenario per lane):
    # outputs must still be (8, ...)
    u_k, x_k, stats_k = cilqr_solve_pallas(cfg, w, x0_b, scen_b, window=256,
                                           interpret=True, block=32)
    assert u_k.shape == (8, cfg.N, 2)
    assert x_k.shape == (8, cfg.N + 1, 4)
    assert stats_k.iters.shape == (8,)


def test_kernel_straggler_compaction_bitwise_exact(small_problem):
    """Two-phase straggler compaction (capped pass + sorted resume) must be
    bitwise identical to the single-pass kernel: the resume carry is exact
    (trajectory = deterministic rollout of the carried controls)."""
    cfg, w, x0_b, scen_b = small_problem
    u1, x1, st1 = cilqr_solve_pallas(cfg, w, x0_b, scen_b, window=256,
                                     **KI)
    # cap below max_iter (8) so phase 2 genuinely resumes mid-solve
    u2, x2, st2 = cilqr_solve_pallas(cfg, w, x0_b, scen_b, window=256,
                                     **KI, straggler_cap=3)
    np.testing.assert_array_equal(np.asarray(u1), np.asarray(u2))
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))
    np.testing.assert_array_equal(np.asarray(st1.iters), np.asarray(st2.iters))
    np.testing.assert_array_equal(np.asarray(st1.status), np.asarray(st2.status))
    np.testing.assert_array_equal(np.asarray(st1.final_cost),
                                  np.asarray(st2.final_cost))
    np.testing.assert_array_equal(np.asarray(st1.final_lamb),
                                  np.asarray(st2.final_lamb))


def test_kernel_straggler_compaction_alm_bitwise_exact(small_problem):
    """ALM + straggler compaction: the dual slabs ride the ALM I/O slab
    through the sorted resume, so capped + resume == single pass bitwise."""
    cfg, w, x0_b, scen_b = small_problem
    cfg_alm = dataclasses.replace(cfg, solve_type="alm")
    u1, x1, st1, (mu1, rho1) = cilqr_solve_pallas(
        cfg_alm, w, x0_b, scen_b, window=256, **KI,
        return_alm=True)
    u2, x2, st2, (mu2, rho2) = cilqr_solve_pallas(
        cfg_alm, w, x0_b, scen_b, window=256, **KI,
        straggler_cap=3, return_alm=True)
    np.testing.assert_array_equal(np.asarray(u1), np.asarray(u2))
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))
    np.testing.assert_array_equal(np.asarray(st1.iters), np.asarray(st2.iters))
    np.testing.assert_array_equal(np.asarray(st1.status),
                                  np.asarray(st2.status))
    np.testing.assert_array_equal(np.asarray(mu1), np.asarray(mu2))
    np.testing.assert_array_equal(np.asarray(rho1), np.asarray(rho2))


def test_kernel_straggler_multiphase_bitwise_exact(small_problem):
    cfg, w, x0_b, scen_b = small_problem
    u1, x1, st1 = cilqr_solve_pallas(cfg, w, x0_b, scen_b, window=256,
                                     **KI)
    u3, x3, st3 = cilqr_solve_pallas(cfg, w, x0_b, scen_b, window=256,
                                     **KI, straggler_cap=(2, 5))
    np.testing.assert_array_equal(np.asarray(u1), np.asarray(u3))
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(x3))
    np.testing.assert_array_equal(np.asarray(st1.iters), np.asarray(st3.iters))
    np.testing.assert_array_equal(np.asarray(st1.status), np.asarray(st3.status))


@pytest.mark.parametrize("chunk", [8, 3])
def test_kernel_chunked_line_search_bitwise_exact(small_problem, chunk):
    """Chunked packed-alpha line search (ls_chunk) vs the serial early-exit
    loop: one packed (chunk, 128) rollout chain per chunk, but projection/
    cost/accept logic replay the serial code per alpha on extracted
    sublanes, and alphas are exact powers of two -- results must be
    bitwise identical. chunk=8 exercises the dummy trailing alphas of the
    last chunk (20 alphas pad to 24); chunk=3 an uneven width."""
    cfg, w, x0_b, scen_b = small_problem
    u1, x1, st1 = cilqr_solve_pallas(cfg, w, x0_b, scen_b, window=256,
                                     **KI, ls_chunk=0)
    u2, x2, st2 = cilqr_solve_pallas(cfg, w, x0_b, scen_b, window=256,
                                     **KI, ls_chunk=chunk)
    np.testing.assert_array_equal(np.asarray(u1), np.asarray(u2))
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))
    np.testing.assert_array_equal(np.asarray(st1.iters), np.asarray(st2.iters))
    np.testing.assert_array_equal(np.asarray(st1.status), np.asarray(st2.status))
    np.testing.assert_array_equal(np.asarray(st1.final_cost),
                                  np.asarray(st2.final_cost))


def test_kernel_chunked_line_search_alm_compaction_bitwise(small_problem):
    """ls_chunk composes with ALM duals + straggler compaction (the
    production configuration) bitwise."""
    cfg, w, x0_b, scen_b = small_problem
    cfg_alm = dataclasses.replace(cfg, solve_type="alm")
    u1, x1, st1, (mu1, rho1) = cilqr_solve_pallas(
        cfg_alm, w, x0_b, scen_b, window=256, **KI,
        straggler_cap=3, return_alm=True, ls_chunk=0)
    u2, x2, st2, (mu2, rho2) = cilqr_solve_pallas(
        cfg_alm, w, x0_b, scen_b, window=256, **KI,
        straggler_cap=3, return_alm=True, ls_chunk=8)
    np.testing.assert_array_equal(np.asarray(u1), np.asarray(u2))
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))
    np.testing.assert_array_equal(np.asarray(st1.iters), np.asarray(st2.iters))
    np.testing.assert_array_equal(np.asarray(st1.status),
                                  np.asarray(st2.status))
    np.testing.assert_array_equal(np.asarray(mu1), np.asarray(mu2))
    np.testing.assert_array_equal(np.asarray(rho1), np.asarray(rho2))


def test_kernel_proj_dot_statistical(small_problem):
    """Dot-form nearest-point scoring (proj_dot) vs the squared-distance
    default: identical exact-arithmetic argmin, different f32 rounding,
    so the criterion is solution agreement (the validate_kernel
    criteria at test scale), not bitwise equality. On this small problem
    no window near-tie flips, so statuses should agree exactly and
    trajectories to f32 path tolerance."""
    cfg, w, x0_b, scen_b = small_problem
    u1, x1, st1 = cilqr_solve_pallas(cfg, w, x0_b, scen_b, window=256,
                                     **KI, proj_dot=False)
    u2, x2, st2 = cilqr_solve_pallas(cfg, w, x0_b, scen_b, window=256,
                                     **KI, proj_dot=True)
    np.testing.assert_array_equal(np.asarray(st1.status),
                                  np.asarray(st2.status))
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2), atol=1e-3)
    np.testing.assert_allclose(np.asarray(st1.final_cost),
                               np.asarray(st2.final_cost), rtol=1e-3)


def test_kernel_proj_dot_translation_invariance(small_problem):
    """proj_dot must stay sound for reference lines far from the origin
    : the raw dot form's f32 score error grows
    as |coords|^2 * eps, which at ~1e4 m coordinates is meters^2 -- the
    argmin would pick rows meters away. The centered form keeps the error
    at window scale, so on a uniformly translated scenario proj_dot must
    agree with the squared-distance form exactly as it does at the
    origin (statuses/iters equal on this near-tie-free problem)."""
    cfg, w, x0_b, scen_b = small_problem
    shift = np.array([12345.0, -6789.0], np.float32)

    def translate(a, cols):
        a = np.asarray(a).copy()
        a[..., 0] += shift[0]
        a[..., 1] += shift[1]
        return jnp.asarray(a)

    scen_t = scen_b.replace(
        ref_line=translate(scen_b.ref_line, 2),
        obs_preds=translate(scen_b.obs_preds, 2))
    x0_t = translate(x0_b, 2)

    u1, x1, st1 = cilqr_solve_pallas(cfg, w, x0_t, scen_t, window=256,
                                     **KI, proj_dot=False)
    u2, x2, st2 = cilqr_solve_pallas(cfg, w, x0_t, scen_t, window=256,
                                     **KI, proj_dot=True)
    np.testing.assert_array_equal(np.asarray(st1.status),
                                  np.asarray(st2.status))
    np.testing.assert_array_equal(np.asarray(st1.iters),
                                  np.asarray(st2.iters))
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2), atol=1e-2)


def test_kernel_projection_bound_generous_is_exact(small_problem):
    """A generous per-step search bound never binds, so results must be
    bitwise identical to the full-window scan."""
    cfg, w, x0_b, scen_b = small_problem
    u1, x1, st1 = cilqr_solve_pallas(cfg, w, x0_b, scen_b, window=256,
                                     **KI)
    u2, x2, st2 = cilqr_solve_pallas(cfg, w, x0_b, scen_b, window=256,
                                     **KI, proj_rows_per_step=23)
    np.testing.assert_array_equal(np.asarray(u1), np.asarray(u2))
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))
    np.testing.assert_array_equal(np.asarray(st1.iters), np.asarray(st2.iters))
    np.testing.assert_array_equal(np.asarray(st1.status), np.asarray(st2.status))


def test_kernel_episode_chunked_matches_scan():
    """Chunked episode driver (the reference-length-episode path): splitting
    an episode into fixed-size chunks with a device-resident carry must be
    bitwise identical to the single-program scan driver. Covers the
    carry-richest case: ALM duals + shifted-u warm start crossing a chunk
    boundary, plus the traced t0 obstacle-window offset."""
    from ilqr_tpu.sim.mpc import run_mpc_kernel_chunked, run_mpc_kernel_scan

    gc = GlobalConfig.from_file(
        os.path.join(CONFIG_DIR, "scenario_three_straight.yaml"))
    st = build_scenario_setup(gc)
    cfg = dataclasses.replace(CILQRConfig.from_global_config(gc, max_iter=6),
                              N=6, solve_type="alm")
    assert cfg.use_last_solution
    w = CILQRWeights.from_global_config(gc, dtype=jnp.float32)
    scenario = st.device_scenario(tick=0, dtype=jnp.float32)
    B, ticks = 2, 4
    x0_b = jnp.asarray(perturbed_initial_states(st.ego_x0, B, seed=3),
                       jnp.float32)
    scen_b = jax.tree.map(lambda a: jnp.stack([a] * B), scenario)
    obs_full_b = jnp.stack([jnp.asarray(st.obs_preds_array(),
                                        jnp.float32)] * B)
    args = (cfg, w, x0_b, scen_b.ref_line, scen_b.ref_velo, obs_full_b,
            scen_b.road_borders)
    ego_s, us_s, st_s = run_mpc_kernel_scan(
        *args, ticks=ticks, window=256, **KI)
    ego_c, us_c, st_c = run_mpc_kernel_chunked(
        *args, ticks=ticks, chunk=2, window=256, **KI)
    np.testing.assert_array_equal(np.asarray(ego_s), np.asarray(ego_c))
    np.testing.assert_array_equal(np.asarray(us_s), np.asarray(us_c))
    np.testing.assert_array_equal(np.asarray(st_s.iters),
                                  np.asarray(st_c.iters))
    np.testing.assert_array_equal(np.asarray(st_s.status),
                                  np.asarray(st_c.status))


def test_kernel_episode_warm_tick_schedule_bitwise():
    """Per-tick straggler schedules (straggler_cap_warm for ticks >= 1)
    must not change results: compaction is bitwise-exact at any cap, so
    only wall time may differ. Covers the scan driver and the chunked
    driver's cold-first-chunk split."""
    from ilqr_tpu.sim.mpc import run_mpc_kernel_chunked, run_mpc_kernel_scan

    gc = GlobalConfig.from_file(
        os.path.join(CONFIG_DIR, "scenario_three_straight.yaml"))
    st = build_scenario_setup(gc)
    cfg = dataclasses.replace(CILQRConfig.from_global_config(gc, max_iter=6),
                              N=6, solve_type="alm")
    w = CILQRWeights.from_global_config(gc, dtype=jnp.float32)
    scenario = st.device_scenario(tick=0, dtype=jnp.float32)
    B, ticks = 2, 4
    x0_b = jnp.asarray(perturbed_initial_states(st.ego_x0, B, seed=3),
                       jnp.float32)
    scen_b = jax.tree.map(lambda a: jnp.stack([a] * B), scenario)
    obs_full_b = jnp.stack([jnp.asarray(st.obs_preds_array(),
                                        jnp.float32)] * B)
    args = (cfg, w, x0_b, scen_b.ref_line, scen_b.ref_velo, obs_full_b,
            scen_b.road_borders)
    ego_u, us_u, st_u = run_mpc_kernel_scan(
        *args, ticks=ticks, window=256, **KI, straggler_cap=3)
    ego_w, us_w, st_w = run_mpc_kernel_scan(
        *args, ticks=ticks, window=256, **KI, straggler_cap=3,
        straggler_cap_warm=2)
    np.testing.assert_array_equal(np.asarray(ego_u), np.asarray(ego_w))
    np.testing.assert_array_equal(np.asarray(us_u), np.asarray(us_w))
    np.testing.assert_array_equal(np.asarray(st_u.iters),
                                  np.asarray(st_w.iters))
    ego_c, us_c, st_c = run_mpc_kernel_chunked(
        *args, ticks=ticks, chunk=2, window=256, **KI,
        straggler_cap=3, straggler_cap_warm=2)
    np.testing.assert_array_equal(np.asarray(ego_u), np.asarray(ego_c))
    np.testing.assert_array_equal(np.asarray(us_u), np.asarray(us_c))
    np.testing.assert_array_equal(np.asarray(st_u.iters),
                                  np.asarray(st_c.iters))


@pytest.mark.parametrize("B,block,padded", [(8, 32, 32), (33, 32, 64),
                                            (16384, 32, 16384), (5, 8, 8)])
def test_padded_batch_rounds_up_to_block(B, block, padded):
    """The kernel runs the batch padded to a multiple of its block, and
    the block is a power of two (the Triton route's tensor sizes)."""
    from ilqr_tpu.ops.pallas.cilqr_kernel import padded_batch

    assert padded_batch(B, block) == padded


def test_padded_batch_rejects_non_power_of_two_block():
    from ilqr_tpu.ops.pallas.cilqr_kernel import padded_batch

    with pytest.raises(AssertionError):
        padded_batch(8, 24)
