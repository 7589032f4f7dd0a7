"""Parallel-in-time Riccati backward pass via ``lax.associative_scan``.

STATUS: EXPERIMENTAL. It has never measured faster than the sequential
scan at batch >= 8, where the batch axis already fills the device; at
batch 1 with long horizons it has not been measured on a GPU yet
(tools/bench_long_horizon.py). Use riccati_impl="scan" (the default); this
module remains as the validated design study for parallel-in-time
scaling.

The sequential backward recursion (ops/riccati.py) has O(N) depth -- fine at
the reference's N=30, but the wrong scaling story for long horizons. This
module reformulates the LQ value recursion as an associative composition of
linear-fractional maps, giving O(log N) depth: the framework's analog of
sequence parallelism (SURVEY.md section 5 "Long-context", cf. PAPERS.md
"Parallel and Proximal Constrained Linear-Quadratic Methods").

Formulation: augment the state with a homogeneous coordinate
x~ = [dx; 1] so the affine cost terms (l_x, l_u) fold into one (nx+1)-dim
quadratic; the Riccati map then is

    V_k = F_k(V_{k+1}),   F(V) = Q + A^T V (I + S V)^{-1} A,
    S = B R^{-1} B^T,

and maps of this three-parameter form (A, S-like C, Q-like J) are closed
under composition (Sarkka & Garcia-Fernandez-style combination):

    (A1,C1,J1) o (A2,C2,J2) = (A2 Z A1,
                               A2 Z C1 A2^T + C2,
                               A1^T Y J2 A1 + J1),
    Z = (I + C1 J2)^{-1},  Y = (I + J2 C1)^{-1}.

A suffix ``associative_scan`` yields every V_k at once; gains d_k / K_k then
follow in one vectorized sweep. Exactly equivalent (up to fp association)
to the sequential pass with lambda = 0 -- the regularized-lambda path stays
sequential because the reference applies lambda to the gains but not the
value recursion (src/cilqr_solver.cpp:407-432).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax


class ParallelBackwardResult(NamedTuple):
    d: jnp.ndarray  # (N, nu)
    K: jnp.ndarray  # (N, nu, nx)
    dV1: jnp.ndarray
    dV2: jnp.ndarray
    fail: jnp.ndarray  # bool: any non-PD Quu along the horizon


def _combine(e1, e2):
    """Compose value maps: combined(V) = f_{e2}(f_{e1}(V)).

    Elements are ordered terminal-first in the scanned array, so in the
    left-fold the first operand e1 is the terminal-side (inner) map and e2
    the step being prepended (outer). With f(V) = J + A^T V (I + C V)^{-1} A:

      inner value W = f1(V); outer sees W through its own (A2, C2, J2):
      J = J2 + A2^T J1 (I + C2 J1)^{-1} A2          (V-independent part)
      A = A1 (I + C2 J1)^{-1} A2                    (propagated sensitivity)
      C = C1 + A1 (I + C2 J1)^{-1} C2 A1^T          (accumulated control term)
    """
    A1, C1, J1 = e1
    A2, C2, J2 = e2
    n = A1.shape[-1]
    I = jnp.eye(n, dtype=A1.dtype)
    Z = jnp.linalg.solve(I + jnp.matmul(C2, J1), jnp.broadcast_to(I, C1.shape))
    Y = jnp.linalg.solve(I + jnp.matmul(J1, C2), jnp.broadcast_to(I, C1.shape))
    A = jnp.matmul(A1, jnp.matmul(Z, A2))
    C = C1 + jnp.matmul(A1, jnp.matmul(Z, jnp.matmul(C2, jnp.swapaxes(A1, -1, -2))))
    J = J2 + jnp.matmul(jnp.swapaxes(A2, -1, -2), jnp.matmul(Y, jnp.matmul(J1, A2)))
    return (A, C, J)


def parallel_lqr_backward(A, B, l_x, l_u, l_xx, l_uu,
                          lamb=None) -> ParallelBackwardResult:
    """Drop-in for ops.riccati.backward_pass(..., lamb=0) with O(log N) depth.

    A (N,nx,nx), B (N,nx,nu), l_x (N+1,nx), l_u (N,nu), l_xx (N+1,nx,nx),
    l_uu (N,nu,nu).

    ``lamb`` (optional scalar) applies the Levenberg regularizer to the
    *gain* stage only (Quu + lamb I when solving for d/K and in dV1/dV2).
    Unlike the sequential reference recursion (src/cilqr_solver.cpp:407-432),
    the parallel value sweep composes *unregularized* optimal value maps, so
    with lamb > 0 results differ from ops.riccati.backward_pass; they are
    exactly equal at lamb == 0 (tests/test_riccati.py). This is the
    long-horizon mode's trade: O(log N) depth for a lambda schedule that
    steers the gains rather than the value function.
    """
    N, nx = A.shape[0], A.shape[-1]
    nu = B.shape[-1]
    dtype = A.dtype
    na = nx + 1

    # augmented per-step quantities
    A_aug = jnp.zeros((N, na, na), dtype)
    A_aug = A_aug.at[:, :nx, :nx].set(A)
    A_aug = A_aug.at[:, nx, nx].set(1.0)
    B_aug = jnp.zeros((N, na, nu), dtype).at[:, :nx, :].set(B)
    # quadratic cost in homogeneous coordinates:
    #   x~^T Q~ x~ reproduces  dx^T l_xx dx + 2 l_x . dx  up to a constant,
    # matching the reference's convention (no 1/2 factors).
    Q_aug = jnp.zeros((N, na, na), dtype)
    Q_aug = Q_aug.at[:, :nx, :nx].set(l_xx[:N])
    Q_aug = Q_aug.at[:, :nx, nx].set(l_x[:N])
    Q_aug = Q_aug.at[:, nx, :nx].set(l_x[:N])
    # fold l_u into the S term: with cost u^T R u + 2 l_u . u the optimal-u
    # completion shifts u; equivalently augment B with an affine column by
    # treating r_k = l_u via the standard substitution u = v - R^{-1} l_u:
    # dynamics gain A_aug[:, :, nx] += -B R^{-1} l_u, and the completed cost
    # adds  -l_u^T R^{-1} l_u (a constant, dropped).
    Rinv_lu = jnp.linalg.solve(l_uu, l_u[..., None])[..., 0]  # (N, nu)
    A_aug = A_aug.at[:, :nx, nx].add(-jnp.einsum("kij,kj->ki", B, Rinv_lu))
    S_aug = jnp.einsum("kij,kjl,kml->kim", B_aug,
                       jnp.linalg.inv(l_uu), B_aug)

    V_term = jnp.zeros((na, na), dtype)
    V_term = V_term.at[:nx, :nx].set(l_xx[N])
    V_term = V_term.at[:nx, nx].set(l_x[N])
    V_term = V_term.at[nx, :nx].set(l_x[N])

    # elements ordered terminal-first: e[0] = terminal, e[i] = step N-i
    zeros = jnp.zeros((1, na, na), dtype)
    elems = (
        jnp.concatenate([zeros, A_aug[::-1]], axis=0),
        jnp.concatenate([zeros, S_aug[::-1]], axis=0),
        jnp.concatenate([V_term[None], Q_aug[::-1]], axis=0),
    )
    _, _, J_all = lax.associative_scan(_combine, elems)
    # J_all[i] = V at step N-i ; V_next[k] = V_{k+1} = J_all[N-1-k]
    V_next = J_all[:N][::-1]  # (N, na, na): V_{k+1} for k = 0..N-1

    Vxx_n = V_next[:, :nx, :nx]
    Vx_n = V_next[:, :nx, nx]

    # vectorized gains (reference Q-term assembly, src/cilqr_solver.cpp:400-424)
    Qu = l_u + jnp.einsum("kij,ki->kj", B, Vx_n)
    Quu = l_uu + jnp.einsum("kij,kil,klm->kjm", B, Vxx_n, B)
    if lamb is not None:
        Quu = Quu + lamb * jnp.eye(nu, dtype=dtype)
    Qux = jnp.einsum("kij,kil,klm->kjm", B, Vxx_n, A)
    # non-PD detection matching the sequential pass's LLT check
    # (src/cilqr_solver.cpp:415-420): cholesky yields NaN on non-PD blocks
    fail = jnp.any(jnp.isnan(jnp.linalg.cholesky(Quu)))
    sol = jnp.linalg.solve(Quu, jnp.concatenate([Qu[..., None], Qux], axis=-1))
    d = -sol[..., 0]
    K = -sol[..., 1:]
    dV1 = 0.5 * jnp.einsum("ki,kij,kj->", d, Quu, d)
    dV2 = jnp.einsum("ki,ki->", d, Qu)
    return ParallelBackwardResult(d, K, dV1, dV2, fail)
