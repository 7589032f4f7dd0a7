"""Linear LQR closed-loop regulator (capability of reference demo 0).

Reference: scripts/0-lqr-demo.py -- DARE via fixed-point iteration
(:5-20), gain K* = (R + B^T P B)^{-1} B^T P A (:59), then open- vs
closed-loop rollouts of an unstable LTI system (:31-70).

Batched-first: rollouts are ``lax.scan``; everything vmaps over a batch of
(A, B, Q, R, x0) problems, so sweeping controller tunings is one compiled
program.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ilqr_tpu.ops.dare import lqr_gain, solve_dare


class LQRRollout(NamedTuple):
    x: jnp.ndarray  # (N, nx) state trajectory
    u: jnp.ndarray  # (N, nu) controls (zero for open loop)
    u_norm: jnp.ndarray  # (N,) control norms


def open_loop_rollout(A, x0, steps: int) -> LQRRollout:
    """x_{k+1} = A x_k (reference scripts/0-lqr-demo.py:31-35)."""
    A = jnp.asarray(A)
    x0 = jnp.asarray(x0)

    def step(x, _):
        return A @ x, x

    _, xs = lax.scan(step, x0, None, length=steps)
    u = jnp.zeros((steps, A.shape[0]), xs.dtype)
    return LQRRollout(xs, u, jnp.zeros((steps,), xs.dtype))


def closed_loop_rollout(A, B, K, x0, steps: int) -> LQRRollout:
    """u_k = -K x_k;  x_{k+1} = A x_k + B u_k
    (reference scripts/0-lqr-demo.py:67-70)."""
    A, B, K, x0 = map(jnp.asarray, (A, B, K, x0))

    def step(x, _):
        u = -(K @ x)
        return A @ x + B @ u, (x, u)

    _, (xs, us) = lax.scan(step, x0, None, length=steps)
    return LQRRollout(xs, us, jnp.linalg.norm(us, axis=-1))


def lqr_demo(A, B, Q, R, x0, steps: int = 50):
    """Full demo-0 computation: (P*, K*, open-loop, closed-loop)."""
    P = solve_dare(A, B, Q, R)
    K = lqr_gain(A, B, Q, R, P)
    return P, K, open_loop_rollout(A, x0, steps), closed_loop_rollout(A, B, K, x0, steps)


# batched variants: sweep many (x0 | system) instances in one program
lqr_demo_batch_x0 = jax.vmap(lqr_demo, in_axes=(None, None, None, None, 0, None))
