"""Constraint geometry + penalty kernels (barrier / augmented Lagrangian).

Everything here is elementwise/broadcast math over arbitrary leading batch
axes -- the building blocks the cost assembly vectorizes over
(batch, horizon, constraint).

Parity notes (all against the reference C++):
- ellipsoid scales keep the 6x d_safe major-axis inflation quirk
  (src/utils.cpp:387-393):  a = 0.5*length + 6*d_safe + r,
  b = 0.5*width + d_safe + r;
- safety margin c = 1 - ((x'/a)^2 + (y'/b)^2) in the obstacle frame
  (src/utils.cpp:395-407); c > 0 means violation;
- exponential barrier b(c) = q1*exp(q2*c), b' = q2*b*c',
  b'' = q2^2*b*c'c'^T (src/cilqr_solver.cpp:692-699);
- ALM item rho/2*max(c + mu/rho, 0)^2 (include/cilqr_solver.hpp:81-83) with
  the reference's Gauss-Newton-flavoured Hessian b'' = b' c'^T
  (src/cilqr_solver.cpp:701-713) and dual precompute
  mu_next = clip(mu + rho*c, 0, max_mu) (src/cilqr_solver.cpp:622-637).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ilqr_tpu.models.bicycle import front_rear_centers, front_rear_center_jacobians

# exp-barrier exponent clamp: inactive for float64 parity runs, keeps float32
# finite for deeply violated constraints (SURVEY.md "Hard parts").
EXP_CLIP_F32 = 60.0
EXP_CLIP_F64 = 700.0


def default_exp_clip(dtype) -> float:
    return EXP_CLIP_F64 if jnp.dtype(dtype) == jnp.float64 else EXP_CLIP_F32


# ---------------------------------------------------------------------------
# bound constraints (reference src/cilqr_solver.cpp:316-324)
# ---------------------------------------------------------------------------

def upper_bound_constr(var, bound):
    """c = var - bound (c > 0 => violated)."""
    return var - bound


def lower_bound_constr(var, bound):
    """c = bound - var (c > 0 => violated)."""
    return bound - var


# ---------------------------------------------------------------------------
# ellipsoid obstacle geometry
# ---------------------------------------------------------------------------

def ellipsoid_scales(width, length, d_safe, ego_pnt_radius=0.0):
    """(a, b) semi-axes of the inflated obstacle ellipse."""
    a = 0.5 * length + 6.0 * d_safe + ego_pnt_radius
    b = 0.5 * width + d_safe + ego_pnt_radius
    return a, b


def ellipsoid_safety_margin(pnt, obs_state, ab):
    """c = 1 - ((R(theta) (p - center)) scaled)^2 ; pnt (..., 2),
    obs_state (..., 3) = [cx, cy, theta], ab = (a, b)."""
    a, b = ab
    diff = pnt - obs_state[..., :2]
    theta = obs_state[..., 2]
    ct, st = jnp.cos(theta), jnp.sin(theta)
    # rotate by -theta into the obstacle frame (src/utils.cpp:400-402)
    xs = ct * diff[..., 0] + st * diff[..., 1]
    ys = -st * diff[..., 0] + ct * diff[..., 1]
    return 1.0 - (xs**2 / a**2 + ys**2 / b**2)


def ellipsoid_safety_margin_grad(pnt, obs_state, ab):
    """dc/dp as (..., 2) (reference src/utils.cpp:409-439)."""
    a, b = ab
    diff = pnt - obs_state[..., :2]
    theta = obs_state[..., 2]
    ct, st = jnp.cos(theta), jnp.sin(theta)
    xs = ct * diff[..., 0] + st * diff[..., 1]
    ys = -st * diff[..., 0] + ct * diff[..., 1]
    gxs = -2.0 * xs / a**2
    gys = -2.0 * ys / b**2
    # chain through the (-theta) rotation: dc/dp = R(theta)^T @ [gxs, gys]
    gx = ct * gxs - st * gys
    gy = st * gxs + ct * gys
    return jnp.stack([gx, gy], axis=-1)


def obstacle_avoidance_constr(ego_state, obs_state, wheelbase, width, length,
                              d_safe, ref_point: str):
    """(front_margin, rear_margin) for one obstacle
    (reference src/cilqr_solver.cpp:326-335)."""
    front, rear = front_rear_centers(ego_state, wheelbase, ref_point)
    ab = ellipsoid_scales(width, length, d_safe, 0.5 * width)
    return (
        ellipsoid_safety_margin(front, obs_state, ab),
        ellipsoid_safety_margin(rear, obs_state, ab),
    )


def obstacle_avoidance_constr_grads(ego_state, obs_state, wheelbase, width,
                                    length, d_safe, ref_point: str):
    """d(front_margin)/dx, d(rear_margin)/dx as (..., 4)
    (reference src/cilqr_solver.cpp:715-739)."""
    front, rear = front_rear_centers(ego_state, wheelbase, ref_point)
    ab = ellipsoid_scales(width, length, d_safe, 0.5 * width)
    g_front_pnt = ellipsoid_safety_margin_grad(front, obs_state, ab)
    g_rear_pnt = ellipsoid_safety_margin_grad(rear, obs_state, ab)
    jf, jr = front_rear_center_jacobians(ego_state[..., 3], wheelbase, ref_point)
    # (..., 4, 2) @ (..., 2) -> (..., 4)
    g_front = jnp.einsum("...sc,...c->...s", jf, g_front_pnt,
                         precision=lax.Precision.HIGHEST)
    g_rear = jnp.einsum("...sc,...c->...s", jr, g_rear_pnt,
                         precision=lax.Precision.HIGHEST)
    return g_front, g_rear


# ---------------------------------------------------------------------------
# penalty scalars: value / gradient-coefficient / Hessian-coefficient
#
# Both penalty families have gradient gamma(c) * c' and Hessian
# eta(c) * c' c'^T for scalar coefficient functions gamma, eta -- the cost
# assembly exploits this shared structure with one einsum.
# ---------------------------------------------------------------------------

def exp_barrier(c, q1, q2, exp_clip=None):
    """b = q1 * exp(q2 * c), exponent clamped for low-precision dtypes."""
    e = q2 * c
    if exp_clip is not None:
        e = jnp.minimum(e, exp_clip)
    return q1 * jnp.exp(e)


def exp_barrier_coeffs(c, q1, q2, exp_clip=None):
    """(value, gamma, eta): b, q2*b, q2^2*b."""
    b = exp_barrier(c, q1, q2, exp_clip)
    return b, q2 * b, q2 * q2 * b


def alm_item(c, rho, mu):
    """rho/2 * max(c + mu/rho, 0)^2."""
    act = jnp.maximum(c + mu / rho, 0.0)
    return 0.5 * rho * act**2


def alm_coeffs(c, rho, mu):
    """(value, gamma, eta) with gamma = eta = rho*(c + mu/rho) when active
    (the reference's rank-1 Hessian b'' = b' c'^T, src/cilqr_solver.cpp:707-709)."""
    shifted = c + mu / rho
    active = shifted > 0
    value = jnp.where(active, 0.5 * rho * shifted**2, 0.0)
    gamma = jnp.where(active, rho * shifted, 0.0)
    return value, gamma, gamma


def alm_mu_next(c, rho, mu, max_mu):
    """Dual precompute mu_next = clip(mu + rho*c, 0, max_mu)."""
    return jnp.clip(mu + rho * c, 0.0, max_mu)


# ---------------------------------------------------------------------------
# signed lateral offset to the reference line
# ---------------------------------------------------------------------------

def lateral_offset(x_k, ref_pt):
    """Signed lateral distance of state (..., 4) w.r.t. nearest ref point
    (..., 3) = [rx, ry, ryaw]. Positive = left of the line.

    Matches src/cilqr_solver.cpp:507-509 including sign(0) = +1.
    """
    dx = x_k[..., 0] - ref_pt[..., 0]
    dy = x_k[..., 1] - ref_pt[..., 1]
    ryaw = ref_pt[..., 2]
    d_sign = dy * jnp.cos(ryaw) - dx * jnp.sin(ryaw)
    sgn = jnp.where(d_sign < 0, -1.0, 1.0).astype(x_k.dtype)
    return sgn * jnp.hypot(dx, dy), d_sign


def lateral_offset_grad(x_k, ref_pt):
    """d(cur_d)/dx for the *upper* road-border constraint as (..., 4)
    (reference src/cilqr_solver.cpp:527-533); the lower constraint uses the
    negation. Zero-distance rows are guarded to 0 gradient (the reference
    would divide by zero there)."""
    dx = x_k[..., 0] - ref_pt[..., 0]
    dy = x_k[..., 1] - ref_pt[..., 1]
    h = jnp.hypot(dx, dy)
    safe = jnp.where(h > 0, h, 1.0)
    gx = jnp.where(h > 0, dx / safe, 0.0)
    gy = jnp.where(h > 0, dy / safe, 0.0)
    _, d_sign = lateral_offset(x_k, ref_pt)
    flip = jnp.where(d_sign < 0, -1.0, 1.0).astype(x_k.dtype)
    z = jnp.zeros_like(gx)
    return jnp.stack([flip * gx, flip * gy, z, z], axis=-1)
