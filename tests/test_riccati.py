"""Riccati passes: sequential scan semantics + parallel-in-time equivalence."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ilqr_tpu.ops.riccati import backward_pass, forward_pass
from ilqr_tpu.ops.riccati_pscan import parallel_lqr_backward


def _random_lq(rng, N=16, nx=4, nu=2):
    A = jnp.asarray(np.eye(nx) + 0.05 * rng.normal(size=(N, nx, nx)))
    B = jnp.asarray(0.1 * rng.normal(size=(N, nx, nu)))
    l_x = jnp.asarray(rng.normal(size=(N + 1, nx)))
    l_u = jnp.asarray(rng.normal(size=(N, nu)))
    M = rng.normal(size=(N + 1, nx, nx))
    l_xx = jnp.asarray(M @ np.transpose(M, (0, 2, 1)) + 0.5 * np.eye(nx))
    Mu = rng.normal(size=(N, nu, nu))
    l_uu = jnp.asarray(Mu @ np.transpose(Mu, (0, 2, 1)) + 0.5 * np.eye(nu))
    return A, B, l_x, l_u, l_xx, l_uu


def test_backward_pass_solves_lqr_optimality(rng):
    """d from the backward pass zeroes the gradient of the LQ objective."""
    A, B, l_x, l_u, l_xx, l_uu = _random_lq(rng, N=10)
    res = backward_pass(A, B, l_x, l_u, l_xx, l_uu, jnp.float64(0.0))
    assert not bool(res.fail)
    # on an LQ problem, one Newton step from u=0 is optimal: the open-loop
    # sequence obtained by rolling d through the gains must satisfy the
    # Pontryagin stationarity condition. Verify via the value recursion:
    # at each step Quu d + Qu = 0 by construction -- recompute and check.
    V_x, V_xx = l_x[-1], l_xx[-1]
    for i in range(A.shape[0] - 1, -1, -1):
        Qu = l_u[i] + B[i].T @ V_x
        Quu = l_uu[i] + B[i].T @ V_xx @ B[i]
        Qux = B[i].T @ V_xx @ A[i]
        np.testing.assert_allclose(
            np.asarray(Quu @ res.d[i] + Qu), 0.0, atol=1e-9)
        np.testing.assert_allclose(
            np.asarray(Quu @ res.K[i] + Qux), 0.0, atol=1e-9)
        Qx = l_x[i] + A[i].T @ V_x
        Qxx = l_xx[i] + A[i].T @ V_xx @ A[i]
        V_x = Qx - Qux.T @ np.linalg.solve(np.asarray(Quu), np.asarray(Qu))
        V_xx = Qxx - Qux.T @ np.linalg.solve(np.asarray(Quu), np.asarray(Qux))


def test_backward_pass_flags_indefinite_quu(rng):
    A, B, l_x, l_u, l_xx, l_uu = _random_lq(rng, N=6)
    l_uu = l_uu.at[3].set(jnp.asarray([[-1.0, 0.0], [0.0, -1.0]]))
    res = backward_pass(A, B, l_x, l_u, l_xx, l_uu, jnp.float64(0.0))
    assert bool(res.fail)


@pytest.mark.parametrize("N", [4, 16, 64, 256])
def test_parallel_backward_matches_sequential(rng, N):
    A, B, l_x, l_u, l_xx, l_uu = _random_lq(rng, N=N)
    seq = backward_pass(A, B, l_x, l_u, l_xx, l_uu, jnp.float64(0.0))
    par = parallel_lqr_backward(A, B, l_x, l_u, l_xx, l_uu)
    np.testing.assert_allclose(np.asarray(par.d), np.asarray(seq.d),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(par.K), np.asarray(seq.K),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(float(par.dV1), float(seq.dV1), rtol=1e-8)
    np.testing.assert_allclose(float(par.dV2), float(seq.dV2), rtol=1e-8)


def test_parallel_backward_on_bicycle_jacobians(rng):
    """Real model Jacobians from a rollout, not just random matrices."""
    from ilqr_tpu.models.bicycle import kinematic_jacobians, rollout

    N = 40
    x0 = jnp.asarray([0.0, 0.0, 6.0, 0.05])
    u = jnp.asarray(rng.normal(size=(N, 2)) * np.array([0.5, 0.05]))
    x = rollout(x0, u, 0.1, 2.8, "gravity_center")
    A, B = kinematic_jacobians(x[:-1], u, 0.1, 2.8, "gravity_center")
    l_x = jnp.asarray(rng.normal(size=(N + 1, 4)))
    l_u = jnp.asarray(rng.normal(size=(N, 2)))
    l_xx = jnp.broadcast_to(jnp.diag(jnp.asarray([2.0, 2.0, 2.0, 40.0])), (N + 1, 4, 4))
    l_uu = jnp.broadcast_to(jnp.diag(jnp.asarray([1.0, 40.0])), (N, 2, 2))
    seq = backward_pass(A, B, l_x, l_u, l_xx, l_uu, jnp.float64(0.0))
    par = parallel_lqr_backward(A, B, l_x, l_u, l_xx, l_uu)
    np.testing.assert_allclose(np.asarray(par.d), np.asarray(seq.d),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(np.asarray(par.K), np.asarray(seq.K),
                               rtol=1e-7, atol=1e-8)


def test_forward_pass_alpha_zero_reproduces_trajectory(rng):
    from ilqr_tpu.models.bicycle import rollout

    N = 12
    x0 = jnp.asarray([0.0, 0.0, 5.0, 0.0])
    u = jnp.asarray(rng.normal(size=(N, 2)) * 0.1)
    x = rollout(x0, u, 0.1, 2.8, "gravity_center")
    d = jnp.asarray(rng.normal(size=(N, 2)))
    K = jnp.asarray(rng.normal(size=(N, 2, 4)))
    nu, nx = forward_pass(u, x, d, K, jnp.float64(0.0), 0.1, 2.8, "gravity_center")
    np.testing.assert_allclose(np.asarray(nu), np.asarray(u), atol=1e-12)
    np.testing.assert_allclose(np.asarray(nx), np.asarray(x), atol=1e-12)


def test_parallel_backward_flags_indefinite_quu(rng):
    A, B, l_x, l_u, l_xx, l_uu = _random_lq(rng, N=6)
    good = parallel_lqr_backward(A, B, l_x, l_u, l_xx, l_uu)
    assert not bool(good.fail)
    l_uu = l_uu.at[3].set(jnp.asarray([[-1.0, 0.0], [0.0, -1.0]]))
    res = parallel_lqr_backward(A, B, l_x, l_u, l_xx, l_uu)
    assert bool(res.fail)


def test_cilqr_pscan_mode_matches_scan_at_zero_lamb():
    """Full CILQR solve with riccati_impl="pscan" vs "scan": identical
    iteration paths when lambda stays 0 (no regularization ever applied, so
    the two backward passes are numerically-equal formulations)."""
    import dataclasses
    import os

    from ilqr_tpu.config import GlobalConfig
    from ilqr_tpu.sim.scenario import build_scenario_setup
    from ilqr_tpu.solvers.cilqr import solve
    from ilqr_tpu.types import CILQRConfig, CILQRWeights
    from tests.conftest import CONFIG_DIR

    gc = GlobalConfig.from_file(
        os.path.join(CONFIG_DIR, "scenario_two_straight.yaml"))
    st = build_scenario_setup(gc)
    w = CILQRWeights.from_global_config(gc, dtype=jnp.float64)
    w = w.replace(init_lamb=jnp.float64(0.0))
    scenario = st.device_scenario(tick=0, horizon=12, dtype=jnp.float64)
    x0 = jnp.asarray(st.ego_x0, jnp.float64)
    outs = {}
    for impl in ("scan", "pscan"):
        cfg = dataclasses.replace(
            CILQRConfig.from_global_config(gc, max_iter=20),
            N=12, use_last_solution=False, riccati_impl=impl)
        u, x, stats, _ = jax.jit(solve, static_argnums=0)(
            cfg, w, x0, scenario, None)
        outs[impl] = (np.asarray(u), np.asarray(x), int(stats.iters),
                      int(stats.status))
    assert outs["scan"][2] == outs["pscan"][2]
    assert outs["scan"][3] == outs["pscan"][3]
    np.testing.assert_allclose(outs["pscan"][0], outs["scan"][0],
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(outs["pscan"][1], outs["scan"][1],
                               rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("name", [
    "scenario_two_straight",
    "scenario_three_bend",
])
def test_cilqr_pscan_mode_converges_on_shipped_scenarios(name):
    """pscan as a *solver mode* at the shipped lambda schedule (init_lamb >
    0, so the two backward passes genuinely differ: pscan regularizes gains
    only, ops/riccati_pscan.py). The long-horizon mode is only usable if it
    still converges on real scenarios to a solution of the same quality --
    this pins that, not just the lamb=0 algebraic equality above."""
    import dataclasses
    import os

    from ilqr_tpu.config import GlobalConfig
    from ilqr_tpu.sim.scenario import build_scenario_setup
    from ilqr_tpu.solvers.cilqr import solve
    from ilqr_tpu.types import CILQRConfig, CILQRWeights
    from tests.conftest import CONFIG_DIR

    from ilqr_tpu.sim.scenario import perturbed_initial_states

    gc = GlobalConfig.from_file(os.path.join(CONFIG_DIR, name + ".yaml"))
    st = build_scenario_setup(gc)
    w = CILQRWeights.from_global_config(gc, dtype=jnp.float64)
    scenario = st.device_scenario(tick=0, dtype=jnp.float64)
    B = 48
    x0_b = jnp.asarray(perturbed_initial_states(st.ego_x0, B, seed=0),
                       jnp.float64)
    scen_b = jax.tree.map(lambda a: jnp.stack([a] * B), scenario)
    outs = {}
    for impl in ("scan", "pscan"):
        cfg = dataclasses.replace(
            CILQRConfig.from_global_config(gc),
            use_last_solution=False, riccati_impl=impl)
        f = jax.jit(jax.vmap(solve, in_axes=(None, None, 0, 0, None)),
                    static_argnums=0)
        u, x, stats, _ = f(cfg, w, x0_b, scen_b, None)
        outs[impl] = (np.asarray(x), np.asarray(stats.converged),
                      np.asarray(stats.final_cost))
    conv_s, conv_p = outs["scan"][1], outs["pscan"][1]
    # a single cold tick-0 solve often exits via lambda overflow even under
    # exact reference semantics (the known oscillator tail, NOTES.md), so
    # the scenario-level
    # criterion is statistical: pscan's convergence rate and solution
    # quality must match the sequential mode's on a perturbed batch.
    assert conv_s.mean() > 0.4, "reference mode degenerate (sanity)"
    assert abs(conv_p.mean() - conv_s.mean()) <= 0.15, (
        f"pscan convergence rate {conv_p.mean():.2f} far from scan "
        f"{conv_s.mean():.2f}")
    both = conv_s & conv_p
    assert both.any()
    cost_rel = np.abs(outs["pscan"][2][both] - outs["scan"][2][both]) / \
        np.abs(outs["scan"][2][both])
    assert float(np.median(cost_rel)) < 1e-2
    pos = np.abs(outs["pscan"][0][both] - outs["scan"][0][both])
    assert float(np.median(pos)) < 0.05
