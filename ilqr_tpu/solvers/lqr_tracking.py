"""LQR path tracking with the kinematic bicycle (capability of reference
demo 1).

Reference: scripts/1-lqr-pathtracking.py -- 5-state error dynamics
[e, de, th_e, dth_e, dv] with DARE re-solved every tick (:163-226),
feedforward steering from path curvature, steering low-pass filter,
speed profile with stop/reverse handling (:311-337), and the rear-axle
bicycle update in tan form (:134-140).

Batched-first: the controller tick is pure; the whole simulation is a bounded
``lax.scan`` with a goal mask (no data-dependent trip count inside jit) and
vmaps over batches of (course x gains x start states).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ilqr_tpu.ops.dare import solve_dare
from ilqr_tpu.utils.splines import calc_spline_course

DT = 0.1


class TrackerParams(NamedTuple):
    Q: jnp.ndarray  # (5, 5)
    R: jnp.ndarray  # (2, 2)
    wheelbase: jnp.ndarray
    max_steer: jnp.ndarray
    max_acc: jnp.ndarray
    dt: jnp.ndarray


def default_params(dtype=jnp.float64) -> TrackerParams:
    return TrackerParams(
        Q=jnp.eye(5, dtype=dtype),
        R=jnp.eye(2, dtype=dtype),
        wheelbase=jnp.asarray(2.5, dtype),
        max_steer=jnp.asarray(np.deg2rad(40.0), dtype),
        max_acc=jnp.asarray(5.0, dtype),
        dt=jnp.asarray(DT, dtype),
    )


def pi_2_pi(angle):
    return (angle + jnp.pi) % (2 * jnp.pi) - jnp.pi


def calc_speed_profile(cyaw: np.ndarray, target_speed: float) -> np.ndarray:
    """Direction-switch aware speed profile with slow-down tail
    (reference scripts/1-lqr-pathtracking.py:311-337). Host-side (static
    per course)."""
    n = len(cyaw)
    sp = np.full(n, target_speed, dtype=np.float64)
    direction = 1.0
    for i in range(n - 1):
        dyaw = abs(cyaw[i + 1] - cyaw[i])
        switch = (np.pi / 4.0 <= dyaw) and (dyaw < np.pi / 2.0)
        if switch:
            direction *= -1
        sp[i] = -target_speed if direction != 1.0 else target_speed
        if switch:
            sp[i] = 0.0
    for i in range(50):
        sp[-i] = target_speed / (60 - i)
        if sp[-i] <= 1.0 / 3.6:
            sp[-i] = 1.0 / 3.6
    return sp


def nearest_index(state, cx, cy, cyaw):
    """Global argmin + signed lateral error
    (reference scripts/1-lqr-pathtracking.py:229-245)."""
    dx = state[0] - cx
    dy = state[1] - cy
    d2 = dx * dx + dy * dy
    ind = jnp.argmin(d2)
    mind = jnp.sqrt(d2[ind])
    angle = pi_2_pi(cyaw[ind] - jnp.arctan2(cy[ind] - state[1], cx[ind] - state[0]))
    return ind, jnp.where(angle < 0, -mind, mind)


def control_step(p: TrackerParams, state, course, pe, pth_e):
    """One controller tick: error-state LQR via DARE + curvature feedforward
    (reference scripts/1-lqr-pathtracking.py:163-226).

    state = [x, y, yaw, v]; course = (cx, cy, cyaw, ck, sp) arrays.
    Returns (delta, accel, ind, e, th_e).
    """
    cx, cy, cyaw, ck, sp = course
    dtype = state.dtype
    ind, e = nearest_index(state, cx, cy, cyaw)
    tv = sp[ind]
    k = ck[ind]
    v = state[3]
    th_e = pi_2_pi(state[2] - cyaw[ind])

    A = jnp.zeros((5, 5), dtype).at[0, 0].set(1.0).at[0, 1].set(p.dt)
    A = A.at[1, 2].set(v).at[2, 2].set(1.0).at[2, 3].set(p.dt).at[4, 4].set(1.0)
    B = jnp.zeros((5, 2), dtype).at[3, 0].set(v / p.wheelbase).at[4, 1].set(p.dt)

    P = solve_dare(A, B, p.Q, p.R)
    BtP = B.T @ P
    K = jnp.linalg.solve(p.R + BtP @ B, BtP @ A)

    xvec = jnp.stack([e, (e - pe) / p.dt, th_e, (th_e - pth_e) / p.dt, v - tv])
    ustar = -(K @ xvec)
    ff = jnp.arctan2(p.wheelbase * k, jnp.ones((), dtype))
    fb = pi_2_pi(ustar[0])
    delta = ff + fb
    accel = ustar[1]
    return delta, accel, ind, e, th_e


def vehicle_update(p: TrackerParams, state, accel, delta):
    """Rear-axle bicycle, tan form (reference scripts/1-lqr-pathtracking.py:134-140)."""
    x, y, yaw, v = state
    return jnp.stack([
        x + v * jnp.cos(yaw) * p.dt,
        y + v * jnp.sin(yaw) * p.dt,
        yaw + v / p.wheelbase * jnp.tan(delta) * p.dt,
        v + accel * p.dt,
    ])


def simulate(p: TrackerParams, course, goal, x0=None, max_ticks: int = 5000,
             goal_dis: float = 0.3):
    """Whole tracking episode as one jitted scan with a goal mask
    (reference loop: scripts/1-lqr-pathtracking.py:248-308).

    Returns (states (T+1, 4), controls (T, 2), reached (T,) goal mask).
    """
    cx = course[0]
    dtype = cx.dtype
    if x0 is None:
        x0 = jnp.zeros(4, dtype)
    goal = jnp.asarray(goal, dtype)

    def tick(carry, _):
        state, pe, pth_e, last_dl, done = carry
        dl, acc, ind, e, th_e = control_step(p, state, course, pe, pth_e)
        dl = jnp.clip(dl, -p.max_steer, p.max_steer)
        acc = jnp.clip(acc, -p.max_acc, p.max_acc)
        steering = dl * 0.75 + last_dl * 0.25  # low-pass (:269-271)
        new_state = vehicle_update(p, state, acc, steering)
        reached = jnp.hypot(new_state[0] - goal[0], new_state[1] - goal[1]) <= goal_dis
        done_n = done | reached
        # freeze after goal: keep last state
        out_state = jnp.where(done, state, new_state)
        return (
            (out_state, jnp.where(done, pe, e), jnp.where(done, pth_e, th_e),
             jnp.where(done, last_dl, steering), done_n),
            (out_state, jnp.stack([acc, steering]), done_n),
        )

    init = (x0, jnp.zeros((), dtype), jnp.zeros((), dtype), jnp.zeros((), dtype),
            jnp.asarray(False))
    _, (states, controls, reached) = lax.scan(tick, init, None, length=max_ticks)
    states = jnp.concatenate([x0[None], states], axis=0)
    return states, controls, reached


def make_demo_course(dtype=jnp.float64):
    """The demo-1 course (reference scripts/1-lqr-pathtracking.py:341-347)."""
    ax = [0.0, 15.0, 31.25, 25.0, 18.75, 7.5, -2.5]
    ay = [0.0, -7.5, -12.25, 16.25, 7.5, 12.5, -5.0]
    cx, cy, cyaw, ck, s = calc_spline_course(ax, ay, ds=0.1)
    sp = calc_speed_profile(cyaw, 20.0 / 3.6)
    course = tuple(jnp.asarray(a, dtype) for a in (cx, cy, cyaw, ck, sp))
    goal = (ax[-1], ay[-1])
    return course, goal
