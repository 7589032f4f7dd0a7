"""Riccati backward recursion + forward rollout (the solver hot loops).

Reference semantics: src/cilqr_solver.cpp:383-461. Shape:
- backward pass is a ``lax.scan`` over the reversed horizon carrying
  (V_x, V_xx, dV1, dV2, fail); under ``vmap`` every small matmul becomes a
  batched (B, 4, 4)-style product, at HIGHEST precision;
- the PD check on Q_uu (Eigen LLT failure, src/cilqr_solver.cpp:415-420)
  becomes branch-free data: for a 2x2 matrix PD <=> Quu[0,0] > 0 and
  det(Quu) > 0; failures latch a flag instead of early-returning, and the
  caller discards the pass (masked lockstep, SURVEY.md section 7);
- Q_uu is inverted in closed form (2x2 adjugate) -- no factorization needed.

``l_ux`` is identically zero in the reference (zeroed in the ctor at
src/cilqr_solver.cpp:79-80 and never written), so Q_ux has no cost term.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from ilqr_tpu.models.bicycle import kinematic_propagate

# f32 means f32: a GPU would otherwise run these small products in TF32
_mm = partial(jnp.matmul, precision=lax.Precision.HIGHEST)


class BackwardResult(NamedTuple):
    d: jnp.ndarray  # (N, 2) feedforward
    K: jnp.ndarray  # (N, 2, 4) feedback gains
    dV1: jnp.ndarray  # scalar: sum 0.5 d^T Quu d
    dV2: jnp.ndarray  # scalar: sum d^T Qu
    fail: jnp.ndarray  # bool: any non-PD Quu along the horizon


def backward_pass(A, B, l_x, l_u, l_xx, l_uu, lamb) -> BackwardResult:
    """A (N,4,4), B (N,4,2), l_x (N+1,4), l_u (N,2), l_xx (N+1,4,4),
    l_uu (N,2,2), lamb scalar (Levenberg regularizer on Q_uu,
    src/cilqr_solver.cpp:407-410)."""
    dtype = A.dtype
    N = A.shape[0]
    eye2 = jnp.eye(2, dtype=dtype)

    def step(carry, inp):
        V_x, V_xx, dV1, dV2, fail = carry
        A_i, B_i, lx_i, lu_i, lxx_i, luu_i = inp
        Q_x = lx_i + _mm(A_i.T, V_x)
        Q_u = lu_i + _mm(B_i.T, V_x)
        BtV = _mm(B_i.T, V_xx)  # (2, 4)
        Q_xx = lxx_i + _mm(_mm(A_i.T, V_xx), A_i)
        Q_uu = luu_i + _mm(BtV, B_i) + lamb * eye2
        Q_ux = _mm(BtV, A_i)  # (2, 4); l_ux == 0 in the reference

        det = Q_uu[0, 0] * Q_uu[1, 1] - Q_uu[0, 1] * Q_uu[1, 0]
        pd = (Q_uu[0, 0] > 0) & (det > 0)
        det_safe = jnp.where(pd, det, jnp.ones((), dtype))
        Q_uu_inv = (
            jnp.asarray(
                [[Q_uu[1, 1], -Q_uu[0, 1]], [-Q_uu[1, 0], Q_uu[0, 0]]]
            )
            / det_safe
        )

        d_i = -_mm(Q_uu_inv, Q_u)
        K_i = -_mm(Q_uu_inv, Q_ux)

        KtQuu = _mm(K_i.T, Q_uu)
        V_x_n = Q_x + _mm(KtQuu, d_i) + _mm(K_i.T, Q_u) + _mm(Q_ux.T, d_i)
        V_xx_n = Q_xx + _mm(KtQuu, K_i) + _mm(K_i.T, Q_ux) + _mm(Q_ux.T, K_i)
        dV1_n = dV1 + 0.5 * _mm(d_i, _mm(Q_uu, d_i))
        dV2_n = dV2 + _mm(d_i, Q_u)
        fail_n = fail | ~pd
        return (V_x_n, V_xx_n, dV1_n, dV2_n, fail_n), (d_i, K_i)

    init = (
        l_x[N],
        l_xx[N],
        jnp.zeros((), dtype),
        jnp.zeros((), dtype),
        jnp.asarray(False),
    )
    xs = (A, B, l_x[:N], l_u, l_xx[:N], l_uu)
    (V_x, V_xx, dV1, dV2, fail), (d_rev, K_rev) = lax.scan(
        step, init, xs, reverse=True
    )
    return BackwardResult(d_rev, K_rev, dV1, dV2, fail)


def forward_pass(u, x, d, K, alpha, dt, wheelbase, ref_point: str):
    """Closed-loop rollout with gains:  u' = u + K (x' - x) + alpha d
    (reference src/cilqr_solver.cpp:442-461; no control clamping)."""

    def step(new_x_i, inp):
        u_i, x_i, d_i, K_i = inp
        new_u_i = u_i + _mm(K_i, new_x_i - x_i) + alpha * d_i
        new_x_next = kinematic_propagate(new_x_i, new_u_i, dt, wheelbase, ref_point)
        return new_x_next, (new_u_i, new_x_next)

    _, (new_u, new_x_tail) = lax.scan(step, x[0], (u, x[:-1], d, K))
    new_x = jnp.concatenate([x[0][None], new_x_tail], axis=0)
    return new_u, new_x
