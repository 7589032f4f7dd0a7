"""Total cost and derivative/Hessian assembly, vectorized over the horizon.

The reference computes these with a per-step loop over k = 1..N and a nested
loop over constraints (src/cilqr_solver.cpp:199-287 and :463-690). Here the
whole (horizon x constraint) grid is evaluated at once:

  - constraint values        c      (N, C)        C = 8 + 2*M
  - gradient directions      g_u    (N, 4, 2),  g_x (N, 4 + 2*M, 4)
  - penalty coefficients     value/gamma/eta  (N, C)
  - l_x / l_xx assembly      two einsums (rank-1 Hessian sums)

Constraint column order matches the reference's ALM dual layout
(src/cilqr_solver.cpp:622-676):
  0 acc_up, 1 acc_lo, 2 stl_up, 3 stl_lo,
  4 velo_up, 5 velo_lo, 6 pos_up, 7 pos_lo,
  8+2j obs_j_front, 9+2j obs_j_rear.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from ilqr_tpu.ops import constraints as C
from ilqr_tpu.ops.projection import nearest_ref_points
from ilqr_tpu.types import CILQRConfig, CILQRWeights

# f32 means f32: a GPU would otherwise run these contractions in TF32
_HIGHEST = lax.Precision.HIGHEST


class CostDerivatives(NamedTuple):
    l_x: jnp.ndarray  # (N+1, 4)
    l_u: jnp.ndarray  # (N, 2)
    l_xx: jnp.ndarray  # (N+1, 4, 4)
    l_uu: jnp.ndarray  # (N, 2, 2)
    alm_mu_next: jnp.ndarray  # (N, C)


def _ref_states(x, ref_line, ref_velo, method: str = "exact"):
    """Nearest ref rows + the (N+1, 4) tracking target [rx, ry, v_ref, ryaw]
    (reference src/cilqr_solver.cpp:205-209)."""
    ref_pts = nearest_ref_points(x[:, :2], ref_line, method)[:, :3]  # (N+1, 3)
    ref_states = jnp.stack(
        [
            ref_pts[:, 0],
            ref_pts[:, 1],
            jnp.broadcast_to(jnp.asarray(ref_velo, x.dtype), (x.shape[0],)),
            ref_pts[:, 2],
        ],
        axis=-1,
    )
    return ref_pts, ref_states


def _constraint_values(cfg: CILQRConfig, w: CILQRWeights, u, x, ref_pts,
                       obs_preds, road_borders):
    """(c_u (N,4), c_x (N,4), c_obs (N,2M), cur_d stuff) at steps k=1..N."""
    xk = x[1:]  # (N, 4)
    rk = ref_pts[1:]  # (N, 3)
    c_u = jnp.stack(
        [
            C.upper_bound_constr(u[:, 0], w.acc_max),
            C.lower_bound_constr(u[:, 0], w.acc_min),
            C.upper_bound_constr(u[:, 1], w.stl_lim),
            C.lower_bound_constr(u[:, 1], -w.stl_lim),
        ],
        axis=-1,
    )
    cur_d, _ = C.lateral_offset(xk, rk)
    c_x = jnp.stack(
        [
            C.upper_bound_constr(xk[:, 2], w.velo_max),
            C.lower_bound_constr(xk[:, 2], w.velo_min),
            C.upper_bound_constr(cur_d, road_borders[0] - w.width / 2),
            C.lower_bound_constr(cur_d, road_borders[1] + w.width / 2),
        ],
        axis=-1,
    )
    if cfg.num_obstacles > 0:
        obs_k = obs_preds[:, 1:, :]  # (M, N, 3)
        front, rear = C.obstacle_avoidance_constr(
            xk[None, :, :], obs_k, w.wheelbase, w.width, w.length, w.d_safe,
            cfg.reference_point,
        )  # each (M, N)
        # interleave -> (N, 2M): col 2j front_j, 2j+1 rear_j
        c_obs = jnp.stack([front, rear], axis=-1)  # (M, N, 2)
        c_obs = jnp.moveaxis(c_obs, 0, 1).reshape(cfg.N, 2 * cfg.num_obstacles)
    else:
        c_obs = jnp.zeros((cfg.N, 0), dtype=x.dtype)
    return c_u, c_x, c_obs


def _penalty_coeffs(cfg: CILQRConfig, w: CILQRWeights, c_all, alm_rho, alm_mu):
    """(value, gamma, eta) each (N, C) for the active penalty family."""
    M = cfg.num_obstacles
    if cfg.solve_type == "alm":
        return C.alm_coeffs(c_all, alm_rho, alm_mu)
    q1 = jnp.concatenate(
        [
            jnp.broadcast_to(w.state_exp_q1, (8,)),
            jnp.broadcast_to(w.obstacle_exp_q1, (2 * M,)),
        ]
    )
    q2 = jnp.concatenate(
        [
            jnp.broadcast_to(w.state_exp_q2, (8,)),
            jnp.broadcast_to(w.obstacle_exp_q2, (2 * M,)),
        ]
    )
    return C.exp_barrier_coeffs(c_all, q1, q2, w.exp_clip)


def total_cost(cfg: CILQRConfig, w: CILQRWeights, u, x, scenario,
               alm_rho=None, alm_mu=None):
    """J = quadratic tracking + control energy + penalty terms
    (reference src/cilqr_solver.cpp:199-287)."""
    ref_pts, ref_states = _ref_states(x, scenario.ref_line, scenario.ref_velo,
                                      cfg.projection)
    dxs = x - ref_states
    j_prime = jnp.sum(dxs * dxs * w.state_weight_diag) + jnp.sum(
        u * u * w.ctrl_weight_diag
    )
    c_u, c_x, c_obs = _constraint_values(
        cfg, w, u, x, ref_pts, scenario.obs_preds, scenario.road_borders
    )
    c_all = jnp.concatenate([c_u, c_x, c_obs], axis=-1)
    value, _, _ = _penalty_coeffs(cfg, w, c_all, alm_rho, alm_mu)
    return j_prime + jnp.sum(value)


def cost_derivatives(cfg: CILQRConfig, w: CILQRWeights, u, x, scenario,
                     alm_rho=None, alm_mu=None) -> CostDerivatives:
    """l_x, l_u, l_xx, l_uu (+ ALM dual precompute)."""
    _, der = cost_and_derivatives(cfg, w, u, x, scenario, alm_rho, alm_mu)
    return der


def cost_and_derivatives(cfg: CILQRConfig, w: CILQRWeights, u, x, scenario,
                         alm_rho=None, alm_mu=None):
    """(J, CostDerivatives) in one pass, fully vectorized
    (reference src/cilqr_solver.cpp:199-287 and :463-690).

    The solver iteration needs both the cost and its derivatives of the
    *same* trajectory (src/cilqr_solver.cpp:342-344); computing them
    together shares the nearest-point projection, constraint values and
    penalty coefficients -- the dominant non-scan work per iteration.
    """
    N, M = cfg.N, cfg.num_obstacles
    dtype = x.dtype
    ref_pts, ref_states = _ref_states(x, scenario.ref_line, scenario.ref_velo,
                                      cfg.projection)
    xk = x[1:]
    rk = ref_pts[1:]

    # prime-objective terms (src/cilqr_solver.cpp:491-494)
    l_u_prime = 2.0 * u * w.ctrl_weight_diag
    l_x_prime = 2.0 * (x - ref_states) * w.state_weight_diag
    l_uu_prime = jnp.broadcast_to(2.0 * jnp.diag(w.ctrl_weight_diag), (N, 2, 2))
    l_xx_prime = jnp.broadcast_to(2.0 * jnp.diag(w.state_weight_diag), (N + 1, 4, 4))

    # constraint values
    c_u, c_x, c_obs = _constraint_values(
        cfg, w, u, x, ref_pts, scenario.obs_preds, scenario.road_borders
    )
    c_all = jnp.concatenate([c_u, c_x, c_obs], axis=-1)

    # gradient directions
    g_u = jnp.broadcast_to(
        jnp.asarray(
            [[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]], dtype=dtype
        ),
        (N, 4, 2),
    )
    g_pos_up = C.lateral_offset_grad(xk, rk)  # (N, 4)
    vel_grad = jnp.asarray([0.0, 0.0, 1.0, 0.0], dtype=dtype)
    g_x_bounds = jnp.stack(
        [
            jnp.broadcast_to(vel_grad, (N, 4)),
            jnp.broadcast_to(-vel_grad, (N, 4)),
            g_pos_up,
            -g_pos_up,
        ],
        axis=1,
    )  # (N, 4, 4)
    if M > 0:
        obs_k = scenario.obs_preds[:, 1:, :]
        gf, gr = C.obstacle_avoidance_constr_grads(
            xk[None, :, :], obs_k, w.wheelbase, w.width, w.length, w.d_safe,
            cfg.reference_point,
        )  # each (M, N, 4)
        g_obs = jnp.stack([gf, gr], axis=-2)  # (M, N, 2, 4)
        g_obs = jnp.moveaxis(g_obs, 0, 1).reshape(N, 2 * M, 4)
        g_x = jnp.concatenate([g_x_bounds, g_obs], axis=1)  # (N, 4+2M, 4)
    else:
        g_x = g_x_bounds

    value, gamma, eta = _penalty_coeffs(cfg, w, c_all, alm_rho, alm_mu)
    gamma_u, gamma_x = gamma[:, :4], gamma[:, 4:]
    eta_u, eta_x = eta[:, :4], eta[:, 4:]

    l_u_barrier = jnp.einsum("nc,nci->ni", gamma_u, g_u,
                           precision=_HIGHEST)
    l_uu_barrier = jnp.einsum("nc,nci,ncj->nij", eta_u, g_u, g_u,
                           precision=_HIGHEST)
    l_x_barrier_k = jnp.einsum("nc,nci->ni", gamma_x, g_x,
                           precision=_HIGHEST)
    l_xx_barrier_k = jnp.einsum("nc,nci,ncj->nij", eta_x, g_x, g_x,
                           precision=_HIGHEST)

    # barrier terms live at steps 1..N; step 0 carries only the prime term
    l_x = l_x_prime.at[1:].add(l_x_barrier_k)
    l_xx = l_xx_prime + jnp.concatenate(
        [jnp.zeros((1, 4, 4), dtype=dtype), l_xx_barrier_k], axis=0
    )
    l_u = l_u_prime + l_u_barrier
    l_uu = l_uu_prime + l_uu_barrier

    if cfg.solve_type == "alm":
        mu_next = C.alm_mu_next(c_all, alm_rho, alm_mu, w.max_mu)
    else:
        mu_next = jnp.zeros((N, cfg.num_constraints), dtype=dtype)

    dxs = x - ref_states
    j_prime = jnp.sum(dxs * dxs * w.state_weight_diag) + jnp.sum(
        u * u * w.ctrl_weight_diag
    )
    J = j_prime + jnp.sum(value)
    return J, CostDerivatives(l_x, l_u, l_xx, l_uu, mu_next)
