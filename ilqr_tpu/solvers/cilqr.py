"""Constrained iLQR solver (CILQR) -- the framework core.

Reference behaviour being matched: ``CILQRSolver::solve``
(src/cilqr_solver.cpp:85-153) with both constraint modes (exponential
barrier / augmented Lagrangian), the lambda schedule, the backtracking line
search with the reference's acceptance rule, warm starting, and the
``LQRSolveStatus`` state machine -- including its quirks:

- a CONVERGED line-search trial returns the new trajectory but the solve
  loop does *not* adopt it (``iter_effective_flag`` stays false,
  src/cilqr_solver.cpp:352-361 + :113-116), so the pre-iteration trajectory
  is what the caller gets;
- ALM dual updates fire only on line-search exhaustion
  (src/cilqr_solver.cpp:377-379), not on backward-pass failure (which
  early-returns at :345-347);
- the lambda schedule only reacts to {BACKWARD,FORWARD}_PASS_FAIL and
  RUNNING; SMALL_STEP and CONVERGED leave lambda unchanged
  (src/cilqr_solver.cpp:118-125);
- barrier-mode "reuse derivatives after a failed iteration"
  (src/cilqr_solver.cpp:469-474) is a cache of values that are bit-identical
  on an unchanged trajectory, so recomputing (as we do, branch-free) is
  semantically equivalent.

Shape: the whole solve is one pure function of pytrees built from
``lax.while_loop``/``lax.scan``; per-scenario control-flow divergence is
handled by JAX's batched-while masking under ``vmap``, and batches shard
over a device mesh in ``ilqr_tpu.parallel``.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ilqr_tpu.config import GlobalConfig
from ilqr_tpu.models.bicycle import kinematic_jacobians, rollout
from ilqr_tpu.ops.cost import cost_and_derivatives, total_cost
from ilqr_tpu.ops.riccati import backward_pass, forward_pass
from ilqr_tpu.ops.riccati_pscan import parallel_lqr_backward
from ilqr_tpu.types import (
    CILQRCarry,
    CILQRConfig,
    CILQRWeights,
    Scenario,
    SolveStats,
    SolveStatus,
)
from ilqr_tpu.utils.refline import ReferenceLine, RoutingLine, stack_routing_lines

__all__ = [
    "CILQRConfig",
    "CILQRWeights",
    "CILQRCarry",
    "CILQRSolver",
    "SolveStatus",
    "solve",
    "solve_batch",
]


# ---------------------------------------------------------------------------
# initial trajectory
# ---------------------------------------------------------------------------

def _init_traj(cfg: CILQRConfig, w: CILQRWeights, x0, carry: CILQRCarry):
    """Zero-control rollout, or the one-step-shifted previous solution when
    warm starting (reference src/cilqr_solver.cpp:155-180)."""
    zeros_u = jnp.zeros((cfg.N, cfg.nu), dtype=x0.dtype)
    if cfg.use_last_solution:
        shifted = jnp.concatenate([carry.last_u[1:], carry.last_u[-1:]], axis=0)
        u0 = jnp.where(carry.is_first, zeros_u, shifted)
    else:
        u0 = zeros_u
    x = rollout(x0, u0, w.dt, w.wheelbase, cfg.reference_point)
    return u0, x


# ---------------------------------------------------------------------------
# line search
# ---------------------------------------------------------------------------

class _LineSearchResult(NamedTuple):
    accepted: Any
    converged: Any
    small_step: Any
    new_u: Any
    new_x: Any
    new_J: Any


def _alpha_schedule(cfg: CILQRConfig):
    """alpha = 1, 0.5, ... while alpha > min_alpha
    (reference src/cilqr_solver.cpp:354): 20 trials at the default 1e-6."""
    alphas = []
    a = 1.0
    while a > cfg.min_alpha:
        alphas.append(a)
        a *= 0.5
    return tuple(alphas)


def _line_search(cfg: CILQRConfig, w: CILQRWeights, u, x, d, K, ori_cost,
                 dV1, dV2, scenario: Scenario, alm_rho, alm_mu) -> _LineSearchResult:
    """Backtracking line search (reference src/cilqr_solver.cpp:354-372),
    evaluated *breadth-first*: every alpha's rollout + cost runs in one
    widened batch and the first acceptable trial (in the reference's
    descending-alpha order) is selected.

    Identical results to the sequential walk -- each trial is a pure
    function of (u, x, d, K, alpha) and the reference stops at the first
    hit -- but the sequential depth drops from (#alphas x N) propagation
    steps to N, which is what the lockstep batch actually pays.
    """
    dtype = x.dtype
    schedule = _alpha_schedule(cfg)
    W = max(1, min(cfg.line_search_width, len(schedule)))
    n_chunks = -(-len(schedule) // W)
    # pad the schedule to a multiple of W; padded slots are masked out
    padded = schedule + (schedule[-1],) * (n_chunks * W - len(schedule))
    alphas_all = jnp.asarray(padded, dtype).reshape(n_chunks, W)
    valid_all = (
        jnp.arange(n_chunks * W) < len(schedule)
    ).reshape(n_chunks, W)

    def trials(alphas):
        def one(alpha):
            nu, nx = forward_pass(u, x, d, K, alpha, w.dt, w.wheelbase,
                                  cfg.reference_point)
            nJ = total_cost(cfg, w, nu, nx, scenario, alm_rho, alm_mu)
            return nu, nx, nJ

        return jax.vmap(one)(alphas)

    def cond(c):
        chunk, done, *_ = c
        return (~done) & (chunk < n_chunks)

    def body(c):
        chunk, done, acc_f, conv_f, small_f, bu, bx, bj = c
        alphas = alphas_all[chunk]  # (W,)
        valid = valid_all[chunk]
        nu_all, nx_all, nJ_all = trials(alphas)
        decay = ori_cost - nJ_all  # (W,)
        is_first = (chunk == 0) & (jnp.arange(W) == 0)
        # the convergence check precedes the acceptance check at alpha == 1
        # (src/cilqr_solver.cpp:358-365)
        conv_slot = is_first & (jnp.abs(decay) < w.convergence_threshold)
        approx = -(alphas * alphas * dV1 + alphas * dV2)
        # reference divides unguarded; replicate accept-at-inf, avoid NaN
        ratio = jnp.where(approx != 0, decay / approx,
                          jnp.asarray(jnp.inf, dtype))
        acc_slot = (decay > 0) & ((approx < 0) | (ratio > w.accept_step_threshold))
        hit = valid & (conv_slot | acc_slot)
        any_hit = jnp.any(hit)
        j = jnp.argmax(hit)  # first hit in descending-alpha order
        conv_now = any_hit & conv_slot[j]
        acc_now = any_hit & ~conv_now
        small_now = acc_now & ~is_first[j]
        bu = jnp.where(acc_now, nu_all[j], bu)
        bx = jnp.where(acc_now, nx_all[j], bx)
        bj = jnp.where(acc_now, nJ_all[j], bj)
        return (chunk + 1, done | any_hit, acc_f | acc_now, conv_f | conv_now,
                small_f | small_now, bu, bx, bj)

    init = (
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
        jnp.asarray(False),
        jnp.asarray(False),
        jnp.asarray(False),
        u,
        x,
        jnp.asarray(ori_cost, dtype),
    )
    (_, _, acc, conv, small, bu, bx, bj) = lax.while_loop(cond, body, init)
    return _LineSearchResult(acc, conv, small, bu, bx, bj)


# ---------------------------------------------------------------------------
# one solver iteration + the solve loop
# ---------------------------------------------------------------------------

class _IterState(NamedTuple):
    u: Any
    x: Any
    lamb: Any
    status: Any
    itr: Any
    done: Any
    converged: Any
    lamb_overflow: Any
    alm_rho: Any
    alm_mu: Any


def _solve_loop(cfg: CILQRConfig, w: CILQRWeights, u0, x_init,
                scenario: Scenario, alm_rho0, alm_mu0):
    dtype = x_init.dtype

    def cond(s: _IterState):
        return (~s.done) & (s.itr < cfg.max_iter)

    def body(s: _IterState) -> _IterState:
        # one pass computes the iteration's cost (== ori_cost of
        # src/cilqr_solver.cpp:342, same trajectory) and its derivatives
        ori_cost, der = cost_and_derivatives(cfg, w, s.u, s.x, scenario,
                                             s.alm_rho, s.alm_mu)
        A, B = kinematic_jacobians(s.x[:-1], s.u, w.dt, w.wheelbase,
                                   cfg.reference_point)
        if cfg.riccati_impl == "pscan":
            bw = parallel_lqr_backward(A, B, der.l_x, der.l_u, der.l_xx,
                                       der.l_uu, lamb=s.lamb)
        else:
            bw = backward_pass(A, B, der.l_x, der.l_u, der.l_xx, der.l_uu,
                               s.lamb)
        ls = _line_search(cfg, w, s.u, s.x, bw.d, bw.K, ori_cost, bw.dV1,
                          bw.dV2, scenario, s.alm_rho, s.alm_mu)

        bp_fail = bw.fail
        accepted = (~bp_fail) & ls.accepted
        converged_now = (~bp_fail) & ls.converged
        exhausted = (~bp_fail) & ~ls.accepted & ~ls.converged

        u = jnp.where(accepted, ls.new_u, s.u)
        x = jnp.where(accepted, ls.new_x, s.x)

        status = jnp.where(
            bp_fail,
            SolveStatus.BACKWARD_PASS_FAIL,
            jnp.where(
                converged_now,
                SolveStatus.CONVERGED,
                jnp.where(
                    exhausted,
                    SolveStatus.FORWARD_PASS_FAIL,
                    jnp.where(
                        ls.small_step,
                        SolveStatus.FORWARD_PASS_SMALL_STEP,
                        SolveStatus.RUNNING,
                    ),
                ),
            ),
        ).astype(jnp.int32)

        if cfg.solve_type == "alm":
            alm_mu = jnp.where(exhausted, der.alm_mu_next, s.alm_mu)
            alm_rho = jnp.where(
                exhausted,
                jnp.minimum((1.0 + w.alm_gamma) * s.alm_rho, w.max_rho),
                s.alm_rho,
            )
        else:
            alm_mu, alm_rho = s.alm_mu, s.alm_rho

        is_fail = (status == SolveStatus.BACKWARD_PASS_FAIL) | (
            status == SolveStatus.FORWARD_PASS_FAIL
        )
        lamb = jnp.where(
            is_fail,
            jnp.maximum(w.lamb_amplify, s.lamb * w.lamb_amplify),
            jnp.where(status == SolveStatus.RUNNING, s.lamb * w.lamb_decay,
                      s.lamb),
        )
        lamb_overflow = lamb > w.max_lamb
        done = lamb_overflow | converged_now
        return _IterState(
            u, x, lamb, status, s.itr + 1, done,
            s.converged | converged_now, s.lamb_overflow | lamb_overflow,
            alm_rho, alm_mu,
        )

    init = _IterState(
        u=u0,
        x=x_init,
        lamb=jnp.asarray(w.init_lamb, dtype),
        status=jnp.asarray(SolveStatus.RUNNING, jnp.int32),
        itr=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
        lamb_overflow=jnp.asarray(False),
        alm_rho=jnp.asarray(alm_rho0, dtype),
        alm_mu=alm_mu0,
    )
    return lax.while_loop(cond, body, init)


def solve(cfg: CILQRConfig, w: CILQRWeights, x0, scenario: Scenario,
          carry: Optional[CILQRCarry] = None):
    """One full CILQR solve. Pure; jit/vmap/shard_map-able.

    Args:
      cfg: static hyperparameters.
      w: traced solver scalars.
      x0: (4,) initial ego state.
      scenario: device scenario data; ``scenario.obs_preds`` must be the
        (M, N+1, 3) prediction window starting at the current tick.
      carry: warm-start + ALM state from the previous solve (or None).

    Returns: (u (N,2), x (N+1,4), SolveStats, CILQRCarry).
    """
    x0 = jnp.asarray(x0)
    dtype = x0.dtype
    if carry is None:
        carry = CILQRCarry.init(cfg, w, dtype)

    # ALM state reset policy (reference src/cilqr_solver.cpp:88-93)
    if cfg.solve_type == "alm" and cfg.use_last_solution:
        alm_rho0 = jnp.where(carry.is_first, w.alm_rho_init, carry.alm_rho)
        alm_mu0 = jnp.where(carry.is_first, jnp.zeros_like(carry.alm_mu),
                            carry.alm_mu)
    else:
        alm_rho0 = jnp.asarray(w.alm_rho_init, dtype)
        alm_mu0 = jnp.zeros((cfg.N, cfg.num_constraints), dtype=dtype)

    u0, x_init = _init_traj(cfg, w, x0, carry)
    final = _solve_loop(cfg, w, u0, x_init, scenario, alm_rho0, alm_mu0)

    final_cost = total_cost(cfg, w, final.u, final.x, scenario, final.alm_rho,
                            final.alm_mu)
    stats = SolveStats(
        iters=final.itr,
        status=final.status,
        converged=final.converged,
        lamb_overflow=final.lamb_overflow,
        final_cost=final_cost,
        final_lamb=final.lamb,
    )
    new_carry = CILQRCarry(
        last_u=final.u,
        is_first=jnp.asarray(False),
        alm_rho=final.alm_rho,
        alm_mu=final.alm_mu,
    )
    return final.u, final.x, stats, new_carry


def solve_batch(cfg: CILQRConfig, w: CILQRWeights, x0, scenario: Scenario,
                carry: Optional[CILQRCarry] = None,
                weights_batched: bool = False):
    """vmap of :func:`solve` over a leading batch axis of x0 / scenario /
    carry (and optionally the weights, for yaml-param sweeps)."""
    w_axis = 0 if weights_batched else None
    fn = jax.vmap(solve, in_axes=(None, w_axis, 0, 0, 0 if carry is not None else None))
    return fn(cfg, w, x0, scenario, carry)


# ---------------------------------------------------------------------------
# host-facing wrapper mirroring the reference's OO API
# ---------------------------------------------------------------------------

class CILQRSolver:
    """Drop-in-style wrapper mirroring ``CILQRSolver`` from the reference
    (include/cilqr_solver.hpp:31-41): construct from a config, call
    ``solve(x0, ref_line, ref_velo, obs_preds, road_borders)`` repeatedly;
    warm start and ALM duals are carried across calls internally.
    """

    def __init__(self, config: GlobalConfig, dtype=jnp.float64,
                 num_obstacles: Optional[int] = None, **cfg_overrides):
        self.gc = config
        self.dtype = jnp.dtype(dtype)
        self.cfg = CILQRConfig.from_global_config(config, num_obstacles,
                                                  **cfg_overrides)
        self.weights = CILQRWeights.from_global_config(config, self.dtype)
        self.carry = CILQRCarry.init(self.cfg, self.weights, self.dtype)
        self._jitted = jax.jit(solve, static_argnums=0)

    def reset(self):
        self.carry = CILQRCarry.init(self.cfg, self.weights, self.dtype)

    def solve(self, x0, ref_line, ref_velo, obs_preds, road_borders):
        """Hosts arrays / ReferenceLine / RoutingLine in, numpy out."""
        scenario = self.make_scenario(ref_line, ref_velo, obs_preds,
                                      road_borders)
        x0 = jnp.asarray(np.asarray(x0), dtype=self.dtype)
        u, x, stats, self.carry = self._jitted(self.cfg, self.weights, x0,
                                               scenario, self.carry)
        self.last_stats = jax.tree.map(np.asarray, stats)
        return np.asarray(u), np.asarray(x)

    def make_scenario(self, ref_line, ref_velo, obs_preds, road_borders) -> Scenario:
        if isinstance(ref_line, ReferenceLine):
            ref_arr = ref_line.as_array(dtype=self.dtype)
        else:
            ref_arr = np.asarray(ref_line, dtype=self.dtype)
        if isinstance(obs_preds, (list, tuple)):
            window = np.stack(
                [
                    (rl.as_array(self.dtype)[: self.cfg.N + 1]
                     if isinstance(rl, RoutingLine) else
                     np.asarray(rl, dtype=self.dtype)[: self.cfg.N + 1])
                    for rl in obs_preds
                ],
                axis=0,
            ) if len(obs_preds) else np.zeros((0, self.cfg.N + 1, 3), self.dtype)
        else:
            window = np.asarray(obs_preds, dtype=self.dtype)[:, : self.cfg.N + 1]
        return Scenario(
            ref_line=jnp.asarray(ref_arr),
            ref_velo=jnp.asarray(ref_velo, dtype=self.dtype),
            obs_preds=jnp.asarray(window),
            road_borders=jnp.asarray(np.asarray(road_borders), dtype=self.dtype),
        )
