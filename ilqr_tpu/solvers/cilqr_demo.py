"""Barrier-only CILQR variant with the *Python demo's* semantics.

The reference ships two deliberately different CILQR implementations
(SURVEY.md section 2): the C++ solver (covered by
``ilqr_tpu.solvers.cilqr``) and the pedagogical numpy planner in
scripts/2-cilqr-motionplanning.py. This module covers the latter's distinct
behaviors:

- regularization on the *model*: gains use Q_uu + B^T(lambda I)B and
  Q_ux + B^T(lambda I)A, while the value recursion keeps the unregularized
  terms (scripts/2-cilqr-motionplanning.py:310-320);
- fixed line-search schedule alpha in {1, .5, .25, .125, .0625} with the
  monotonic acceptance rule new_J < J (:354-362);
- simple ellipse inflation a = len/2 + d_safe + r (scripts/utils/
  kinematic.py:108-112 -- no 6x major-axis quirk), per-obstacle attributes;
- reference yaw target fixed at 0 and no road-border constraints (:96-100);
- the k = 0 state row receives barrier derivative terms even though the
  cost sums k = 1..N (:181 vs :109 -- a reference quirk, replicated);
- J carried across iterations, tolerance |dJ| < tol, lambda decay/amplify
  on success/failure (:364-393).

Everything is batched-first pure JAX: scan backward/forward passes, masked
line search, ``vmap``/``pjit`` over scenarios.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ilqr_tpu.models.bicycle import (
    GRAVITY_CENTER,
    front_rear_center_jacobians,
    front_rear_centers,
    kinematic_jacobians,
    rollout,
)
from ilqr_tpu.types import pytree_dataclass
from ilqr_tpu.ops.constraints import (
    ellipsoid_safety_margin,
    ellipsoid_safety_margin_grad,
    exp_barrier_coeffs,
)


@pytree_dataclass
class DemoCILQRParams:
    """Tunables of the demo planner (defaults = the script's constants,
    scripts/2-cilqr-motionplanning.py:44-80)."""

    dt: Any = 0.1
    wheelbase: Any = 3.6
    width: Any = 2.0
    state_weight: Any = None  # (4,) diag
    ctrl_weight: Any = None  # (2,) diag
    exp_q1: Any = 5.5
    exp_q2: Any = 5.75
    init_lamb: Any = 20.0
    lamb_decay: Any = 0.7
    lamb_amplify: Any = 2.0
    max_lamb: Any = 10000.0
    tol: Any = 1e-3
    velo_max: Any = 10.0
    velo_min: Any = 0.0
    acc_max: Any = 2.0
    acc_min: Any = -2.0
    stl_lim: Any = 1.57

    @classmethod
    def default(cls, dtype=jnp.float64):
        return cls(
            state_weight=jnp.asarray([1.0, 1.0, 0.5, 0.0], dtype),
            ctrl_weight=jnp.asarray([1.0, 1.0], dtype),
        )


ALPHAS = (1.0, 0.5, 0.25, 0.125, 0.0625)


def _ellipse_ab(obs_attr, ego_radius):
    """a = len/2 + d_safe + r, b = width/2 + d_safe + r (simple inflation)."""
    width, length, d_safe = obs_attr[..., 0], obs_attr[..., 1], obs_attr[..., 2]
    return length * 0.5 + d_safe + ego_radius, width * 0.5 + d_safe + ego_radius


def _nearest_waypoints(pos, ref_waypoints):
    """Global argmin over the (P, 2) waypoint list
    (scripts/utils/kinematic.py:69-75)."""
    d2 = jnp.sum((pos[:, None, :] - ref_waypoints[None, :, :]) ** 2, axis=-1)
    idx = jnp.argmin(d2, axis=-1)
    return ref_waypoints[idx]


def _obs_margins(p: DemoCILQRParams, x, obs_attrs, obs_preds_k):
    """front/rear margins of state rows x (..., 4) against per-obstacle
    predicted states obs_preds_k (M, ..., 4)."""
    front, rear = front_rear_centers(x, p.wheelbase, GRAVITY_CENTER)
    a, b = _ellipse_ab(obs_attrs, 0.5 * p.width)  # (M,)
    obs3 = jnp.concatenate(
        [obs_preds_k[..., :2], obs_preds_k[..., 3:4]], axis=-1)
    shape = obs3.shape[:-1]
    ab = (a.reshape((-1,) + (1,) * (len(shape) - 1)),
          b.reshape((-1,) + (1,) * (len(shape) - 1)))
    cf = ellipsoid_safety_margin(front[None], obs3, ab)
    cr = ellipsoid_safety_margin(rear[None], obs3, ab)
    return cf, cr


def total_cost(p: DemoCILQRParams, u, x, ref_waypoints, ref_velo, obs_attrs,
               obs_preds):
    """scripts/2-cilqr-motionplanning.py:91-156. u (N,2), x (N+1,4),
    ref_waypoints (P,2), obs_attrs (M,3), obs_preds (M, N+1, 4)."""
    ref_xy = _nearest_waypoints(x[:, :2], ref_waypoints)
    ref_states = jnp.concatenate(
        [ref_xy,
         jnp.full((x.shape[0], 1), ref_velo, x.dtype),
         jnp.zeros((x.shape[0], 1), x.dtype)], axis=-1)
    dxs = x - ref_states
    J = jnp.sum(dxs * dxs * p.state_weight) + jnp.sum(u * u * p.ctrl_weight)

    q1, q2 = p.exp_q1, p.exp_q2
    bar = lambda c: q1 * jnp.exp(q2 * c)
    # bound constraints at k = 1..N (controls align with u[k-1])
    J = J + jnp.sum(bar(u[:, 0] - p.acc_max) + bar(p.acc_min - u[:, 0])
                    + bar(u[:, 1] - p.stl_lim) + bar(-p.stl_lim - u[:, 1]))
    v = x[1:, 2]
    J = J + jnp.sum(bar(v - p.velo_max) + bar(p.velo_min - v))
    cf, cr = _obs_margins(p, x[1:], obs_attrs, obs_preds[:, 1:])
    J = J + jnp.sum(bar(cf) + bar(cr))
    return J


def cost_derivatives(p: DemoCILQRParams, u, x, ref_waypoints, ref_velo,
                     obs_attrs, obs_preds):
    """scripts/2-cilqr-motionplanning.py:159-278 -- note the k = 0 state row
    *does* receive barrier terms here (unlike the cost)."""
    N = u.shape[0]
    dtype = x.dtype
    ref_xy = _nearest_waypoints(x[:, :2], ref_waypoints)
    ref_states = jnp.concatenate(
        [ref_xy, jnp.full((N + 1, 1), ref_velo, dtype),
         jnp.zeros((N + 1, 1), dtype)], axis=-1)
    l_u = 2.0 * u * p.ctrl_weight
    l_x = 2.0 * (x - ref_states) * p.state_weight
    l_uu = jnp.broadcast_to(2.0 * jnp.diag(p.ctrl_weight), (N, 2, 2))
    l_xx = jnp.broadcast_to(2.0 * jnp.diag(p.state_weight), (N + 1, 4, 4))

    # control bounds (gradients +-e0 / +-e1)
    _, g_au, h_au = exp_barrier_coeffs(u[:, 0] - p.acc_max, p.exp_q1, p.exp_q2)
    _, g_al, h_al = exp_barrier_coeffs(p.acc_min - u[:, 0], p.exp_q1, p.exp_q2)
    _, g_su, h_su = exp_barrier_coeffs(u[:, 1] - p.stl_lim, p.exp_q1, p.exp_q2)
    _, g_sl, h_sl = exp_barrier_coeffs(-p.stl_lim - u[:, 1], p.exp_q1, p.exp_q2)
    l_u = l_u + jnp.stack([g_au - g_al, g_su - g_sl], axis=-1)
    l_uu = l_uu + jnp.stack(
        [jnp.stack([h_au + h_al, jnp.zeros_like(h_au)], axis=-1),
         jnp.stack([jnp.zeros_like(h_au), h_su + h_sl], axis=-1)], axis=-2)

    # velocity bounds over ALL k = 0..N (the demo's k=0 quirk)
    _, g_vu, h_vu = exp_barrier_coeffs(x[:, 2] - p.velo_max, p.exp_q1, p.exp_q2)
    _, g_vl, h_vl = exp_barrier_coeffs(p.velo_min - x[:, 2], p.exp_q1, p.exp_q2)
    l_x = l_x.at[:, 2].add(g_vu - g_vl)
    l_xx = l_xx.at[:, 2, 2].add(h_vu + h_vl)

    # obstacles over ALL k = 0..N
    front, rear = front_rear_centers(x, p.wheelbase, GRAVITY_CENTER)
    jf, jr = front_rear_center_jacobians(x[:, 3], p.wheelbase, GRAVITY_CENTER)
    a, b = _ellipse_ab(obs_attrs, 0.5 * p.width)
    obs3 = jnp.concatenate([obs_preds[..., :2], obs_preds[..., 3:4]], axis=-1)
    ab = (a[:, None], b[:, None])
    for pnt, jac in ((front, jf), (rear, jr)):
        c = ellipsoid_safety_margin(pnt[None], obs3, ab)  # (M, N+1)
        gp = ellipsoid_safety_margin_grad(pnt[None], obs3, ab)  # (M, N+1, 2)
        g4 = jnp.einsum("ksc,mkc->mks", jac, gp)  # (M, N+1, 4)
        _, gam, eta = exp_barrier_coeffs(c, p.exp_q1, p.exp_q2)
        l_x = l_x + jnp.einsum("mk,mks->ks", gam, g4)
        l_xx = l_xx + jnp.einsum("mk,mks,mkt->kst", eta, g4, g4)
    return l_x, l_u, l_xx, l_uu


class DemoSolveResult(NamedTuple):
    u: Any
    x: Any
    J: Any
    iters: Any
    converged: Any


def backward_pass(p: DemoCILQRParams, u, x, lamb, ref_waypoints, ref_velo,
                  obs_attrs, obs_preds):
    """Riccati recursion of the demo solver
    (scripts/2-cilqr-motionplanning.py:281-325). Returns (d, K).

    Module-level (not nested in solve) so tests can teacher-force single
    iterations along the reference's own solve path
    (tests/test_reference_oracle.py)."""
    N = u.shape[-2]
    dtype = u.dtype
    l_x, l_u, l_xx, l_uu = cost_derivatives(
        p, u, x, ref_waypoints, ref_velo, obs_attrs, obs_preds)
    A, B = kinematic_jacobians(x[:-1], u, p.dt, p.wheelbase, GRAVITY_CENTER)

    def step(carry, inp):
        V_x, V_xx, dV = carry
        A_i, B_i, lx_i, lu_i, lxx_i, luu_i = inp
        Q_x = lx_i + A_i.T @ V_x
        Q_u = lu_i + B_i.T @ V_x
        Q_xx = lxx_i + A_i.T @ V_xx @ A_i
        Q_uu = luu_i + B_i.T @ V_xx @ B_i
        Q_ux = B_i.T @ V_xx @ A_i
        # model-space regularization (:310-312)
        Bt_reg = B_i.T * lamb
        Q_ux_r = Q_ux + Bt_reg @ A_i
        Q_uu_r = Q_uu + Bt_reg @ B_i
        det = Q_uu_r[0, 0] * Q_uu_r[1, 1] - Q_uu_r[0, 1] * Q_uu_r[1, 0]
        inv = jnp.asarray([[Q_uu_r[1, 1], -Q_uu_r[0, 1]],
                           [-Q_uu_r[1, 0], Q_uu_r[0, 0]]]) / det
        d_i = -(inv @ Q_u)
        K_i = -(inv @ Q_ux_r)
        # value recursion with the UNregularized terms (:319-320)
        V_x_n = Q_x + K_i.T @ Q_uu @ d_i + K_i.T @ Q_u + Q_ux.T @ d_i
        V_xx_n = Q_xx + K_i.T @ Q_uu @ K_i + K_i.T @ Q_ux + Q_ux.T @ K_i
        dV_n = dV + 0.5 * d_i @ (Q_uu @ d_i) + d_i @ Q_u
        return (V_x_n, V_xx_n, dV_n), (d_i, K_i)

    init = (l_x[N], l_xx[N], jnp.zeros((), dtype))
    (_, _, dV), (d, K) = lax.scan(
        step, init, (A, B, l_x[:N], l_u, l_xx[:N], l_uu), reverse=True)
    return d, K


def forward_pass(p: DemoCILQRParams, u, x, d, K, alpha):
    """Line-search rollout (scripts/2-cilqr-motionplanning.py:328-343;
    get_bounded_ctrl is a no-op stub there, scripts/utils/constraint.py:68)."""
    from ilqr_tpu.models.bicycle import kinematic_propagate

    def step(cur, inp):
        u_i, x_i, d_i, K_i = inp
        nu = u_i + alpha * d_i + K_i @ (cur - x_i)
        nxt = kinematic_propagate(cur, nu, p.dt, p.wheelbase, GRAVITY_CENTER)
        return nxt, (nu, nxt)

    _, (nu, nx_tail) = lax.scan(step, x[0], (u, x[:-1], d, K))
    return nu, jnp.concatenate([x[0][None], nx_tail], axis=0)


def iter_step(p: DemoCILQRParams, u, x, J, lamb, ref_waypoints, ref_velo,
              obs_attrs, obs_preds):
    """One solver iteration: backward + fixed-alpha line search accepting
    the first J-improving trial (scripts/2-cilqr-motionplanning.py:346-362).
    Returns (new_u, new_x, new_J, effective)."""
    dtype = u.dtype
    d, K = backward_pass(p, u, x, lamb, ref_waypoints, ref_velo, obs_attrs,
                         obs_preds)

    def trial(cr, alpha):
        hit, bu, bx, bj = cr
        nu, nx = forward_pass(p, u, x, d, K, alpha)
        nJ = total_cost(p, nu, nx, ref_waypoints, ref_velo, obs_attrs,
                        obs_preds)
        take = (~hit) & (nJ < J)
        return ((hit | take, jnp.where(take, nu, bu),
                 jnp.where(take, nx, bx), jnp.where(take, nJ, bj)), None)

    alphas = jnp.asarray(ALPHAS, dtype)
    (eff, nu, nx, nJ), _ = lax.scan(trial, (jnp.asarray(False), u, x, J),
                                    alphas)
    return nu, nx, nJ, eff


def solve(p: DemoCILQRParams, x0, ref_waypoints, ref_velo, obs_attrs,
          obs_preds, max_iter: int = 50):
    """scripts/2-cilqr-motionplanning.py:364-393, batched-first."""
    x0 = jnp.asarray(x0)
    dtype = x0.dtype
    N = obs_preds.shape[-2] - 1
    u0 = jnp.zeros((N, 2), dtype)
    x_init = rollout(x0, u0, p.dt, p.wheelbase, GRAVITY_CENTER)
    J0 = total_cost(p, u0, x_init, ref_waypoints, ref_velo, obs_attrs, obs_preds)

    def body(carry):
        u, x, J, lamb, it, done, conv = carry
        nu, nx, nJ, eff = iter_step(p, u, x, J, lamb, ref_waypoints,
                                    ref_velo, obs_attrs, obs_preds)
        conv_now = eff & (jnp.abs(nJ - J) < p.tol)
        u2 = jnp.where(eff, nu, u)
        x2 = jnp.where(eff, nx, x)
        J2 = jnp.where(eff, nJ, J)
        lamb2 = jnp.where(eff, lamb * p.lamb_decay, lamb * p.lamb_amplify)
        overflow = (~eff) & (lamb2 > p.max_lamb)
        return (u2, x2, J2, lamb2, it + 1, done | conv_now | overflow,
                conv | conv_now)

    def cond(carry):
        _, _, _, _, it, done, _ = carry
        return (~done) & (it < max_iter)

    init = (u0, x_init, J0, jnp.asarray(p.init_lamb, dtype),
            jnp.asarray(0, jnp.int32), jnp.asarray(False), jnp.asarray(False))
    u, x, J, _, it, _, conv = lax.while_loop(cond, body, init)
    return DemoSolveResult(u, x, J, it, conv)


def demo_scenario(dtype=jnp.float64):
    """The shipped demo problem (scripts/2-cilqr-motionplanning.py:453-468):
    straight 1000-point reference, two constant-velocity obstacles."""
    from ilqr_tpu.models.bicycle import const_velo_prediction

    N = 60
    p = DemoCILQRParams.default(dtype)
    x0 = jnp.asarray([0.0, 0.0, 5.0, 0.0], dtype)
    ref = jnp.stack([jnp.linspace(0.0, 50.0, 1000),
                     jnp.zeros(1000)], axis=-1).astype(dtype)
    obs_attrs = jnp.asarray([[2.0, 4.5, 1.5], [2.0, 4.5, 1.5]], dtype)
    o1 = const_velo_prediction(jnp.asarray([6.5, -0.2, 3.0, 0.0], dtype),
                               N, p.dt, p.wheelbase)
    o2 = const_velo_prediction(jnp.asarray([20.0, 4.0, 2.0, 0.0], dtype),
                               N, p.dt, p.wheelbase)
    obs_preds = jnp.stack([o1, o2], axis=0)
    return p, x0, ref, jnp.asarray(6.0, dtype), obs_attrs, obs_preds
