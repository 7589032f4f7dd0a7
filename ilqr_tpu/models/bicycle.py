"""Kinematic bicycle model: dynamics + analytic Jacobians.

State x = [px, py, v, yaw], control u = [acc, steer]. Two reference-point
variants with exactly the reference's discretization:

- gravity center (slip angle beta = atan(tan(steer)/2)), reference
  src/utils.cpp:274-279;
- rear axle (tan form), reference src/utils.cpp:269-273.

All functions are shape-polymorphic over leading axes (write once, ``vmap``
for batch; horizon handled by broadcasting) and dtype-preserving so the same
code runs float64 parity and float32 batches on any device. The Jacobian layout
matches reference src/utils.cpp:295-309:
  df_dx[k][r, c] = d next_state[r] / d state[c],  df_du similarly.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

GRAVITY_CENTER = "gravity_center"
REAR_CENTER = "rear_center"


def kinematic_propagate(x, u, dt, wheelbase, ref_point: str = GRAVITY_CENTER):
    """One step of the discrete bicycle model. x: (..., 4), u: (..., 2)."""
    px, py, v, yaw = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    acc, stl = u[..., 0], u[..., 1]
    if ref_point == REAR_CENTER:
        nx = px + v * jnp.cos(yaw) * dt
        ny = py + v * jnp.sin(yaw) * dt
        nv = v + acc * dt
        nyaw = yaw + v * jnp.tan(stl) * dt / wheelbase
    else:
        beta = jnp.arctan(jnp.tan(stl) / 2.0)
        nx = px + v * jnp.cos(beta + yaw) * dt
        ny = py + v * jnp.sin(beta + yaw) * dt
        nv = v + acc * dt
        nyaw = yaw + 2.0 * v * jnp.sin(beta) * dt / wheelbase
    return jnp.stack([nx, ny, nv, nyaw], axis=-1)


def kinematic_jacobians(x, u, dt, wheelbase, ref_point: str = GRAVITY_CENTER):
    """Analytic (A, B) = (df/dx, df/du) along a trajectory.

    x: (..., N, 4) states at steps 0..N-1 (pass ``x[:-1]`` of an (N+1)-state
    trajectory), u: (..., N, 2). Returns A: (..., N, 4, 4), B: (..., N, 4, 2).
    Matches reference src/utils.cpp:285-342.
    """
    v = x[..., 2]
    yaw = x[..., 3]
    stl = u[..., 1]
    dtype = x.dtype
    zeros = jnp.zeros_like(v)
    ones = jnp.ones_like(v)
    if ref_point == REAR_CENTER:
        a02 = jnp.cos(yaw) * dt
        a03 = -v * jnp.sin(yaw) * dt
        a12 = jnp.sin(yaw) * dt
        a13 = v * jnp.cos(yaw) * dt
        a32 = jnp.tan(stl) * dt / wheelbase
        b01 = zeros
        b11 = zeros
        b31 = (v * dt / wheelbase) / (jnp.cos(stl) ** 2)
    else:
        # REFERENCE QUIRK, mirrored deliberately: the Jacobian's slip angle
        # is atan(tan(stl / 2)) -- src/utils.cpp:292 `(u.col(1) / 2)
        # .array().tan().atan()` and scripts/utils/kinematic.py:20 -- while
        # the dynamics use the standard atan(tan(stl) / 2)
        # (src/utils.cpp:265). The derivative factor below, however, IS the
        # exact d/dstl of the dynamics' beta (src/utils.cpp:293), so the
        # reference Jacobian is internally inconsistent at O(stl^3); we
        # reproduce it exactly (caught by tests/test_reference_oracle.py
        # executing the reference's own numpy implementation).
        beta = jnp.arctan(jnp.tan(stl / 2.0))
        # d beta / d steer (reference src/utils.cpp:292-293)
        t2 = jnp.tan(stl) ** 2
        beta_over_stl = 0.5 * (1.0 + t2) / (1.0 + 0.25 * t2)
        a02 = jnp.cos(beta + yaw) * dt
        a03 = -v * jnp.sin(beta + yaw) * dt
        a12 = jnp.sin(beta + yaw) * dt
        a13 = v * jnp.cos(beta + yaw) * dt
        a32 = 2.0 * jnp.sin(beta) * dt / wheelbase
        b01 = -v * jnp.sin(beta + yaw) * dt * beta_over_stl
        b11 = v * jnp.cos(beta + yaw) * dt * beta_over_stl
        b31 = (2.0 * v * dt / wheelbase) * jnp.cos(beta) * beta_over_stl

    A = jnp.stack(
        [
            jnp.stack([ones, zeros, a02, a03], axis=-1),
            jnp.stack([zeros, ones, a12, a13], axis=-1),
            jnp.stack([zeros, zeros, ones, zeros], axis=-1),
            jnp.stack([zeros, zeros, a32, ones], axis=-1),
        ],
        axis=-2,
    ).astype(dtype)
    bdt = jnp.full_like(v, dt)
    B = jnp.stack(
        [
            jnp.stack([zeros, b01], axis=-1),
            jnp.stack([zeros, b11], axis=-1),
            jnp.stack([bdt, zeros], axis=-1),
            jnp.stack([zeros, b31], axis=-1),
        ],
        axis=-2,
    ).astype(dtype)
    return A, B


def rollout(x0, u_seq, dt, wheelbase, ref_point: str = GRAVITY_CENTER):
    """Roll a control sequence forward: x0 (4,), u_seq (N, 2) -> (N+1, 4).

    Sequential by nature; expressed as lax.scan so it fuses under jit and
    batches under vmap (reference loop: src/cilqr_solver.cpp:169-178).
    """

    def step(cur_x, u):
        nxt = kinematic_propagate(cur_x, u, dt, wheelbase, ref_point)
        return nxt, nxt

    _, xs = lax.scan(step, x0, u_seq)
    return jnp.concatenate([x0[None], xs], axis=0)


def const_velo_prediction(x0, steps: int, dt, wheelbase,
                          ref_point: str = GRAVITY_CENTER):
    """Zero-control rollout (reference src/cilqr_solver.cpp:182-197)."""
    u = jnp.zeros((steps, 2), dtype=jnp.asarray(x0).dtype)
    return rollout(jnp.asarray(x0), u, dt, wheelbase, ref_point)


def front_rear_centers(state, wheelbase, ref_point: str = GRAVITY_CENTER):
    """Front/rear disc centers of the ego footprint. state (..., 4).

    Gravity center: +-wheelbase/2 along yaw; rear center: rear = position,
    front = +wheelbase (reference src/utils.cpp:344-361).
    """
    pos = state[..., :2]
    yaw = state[..., 3]
    whba = wheelbase * jnp.stack([jnp.cos(yaw), jnp.sin(yaw)], axis=-1)
    if ref_point == REAR_CENTER:
        return pos + whba, pos
    return pos + 0.5 * whba, pos - 0.5 * whba


def front_rear_center_jacobians(yaw, wheelbase, ref_point: str = GRAVITY_CENTER):
    """d(front)/d(state), d(rear)/d(state) as (..., 4, 2) arrays.

    Layout matches reference src/utils.cpp:363-385: rows index the state
    [x, y, v, yaw], columns index the point coordinate [px, py] (i.e. the
    transpose of the usual Jacobian, as the reference chains it
    ``point_over_state @ margin_over_point`` in src/cilqr_solver.cpp:733-736).
    """
    yaw = jnp.asarray(yaw)
    z = jnp.zeros_like(yaw)
    o = jnp.ones_like(yaw)
    if ref_point == REAR_CENTER:
        f3x = -wheelbase * jnp.sin(yaw)
        f3y = wheelbase * jnp.cos(yaw)
        r3x = z
        r3y = z
    else:
        half = 0.5 * wheelbase
        f3x = -half * jnp.sin(yaw)
        f3y = half * jnp.cos(yaw)
        r3x = half * jnp.sin(yaw)
        r3y = -half * jnp.cos(yaw)
    front = jnp.stack(
        [
            jnp.stack([o, z], axis=-1),
            jnp.stack([z, o], axis=-1),
            jnp.stack([z, z], axis=-1),
            jnp.stack([f3x, f3y], axis=-1),
        ],
        axis=-2,
    )
    rear = jnp.stack(
        [
            jnp.stack([o, z], axis=-1),
            jnp.stack([z, o], axis=-1),
            jnp.stack([z, z], axis=-1),
            jnp.stack([r3x, r3y], axis=-1),
        ],
        axis=-2,
    )
    return front, rear
