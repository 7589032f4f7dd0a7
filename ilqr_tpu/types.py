"""Core parameter / state pytrees for the CILQR solver.

Design stance (SURVEY.md section 7): one pure-functional solver core; all
state (trajectory, lambda, ALM duals, status, warm-start carry) is an
explicit pytree, so a batch of scenarios is just these structures with a
leading axis (``vmap``), and checkpoint/resume is a free side effect of the
state being data.

Two kinds of parameters:
- ``CILQRConfig``: *static* hyperparameters (shapes, modes) -- hashable,
  baked into the compiled program;
- ``CILQRWeights``: *traced* scalars -- can carry a batch axis, so sweeps
  over yaml params (weights, bounds, barrier gains) are one compiled
  program, not a recompile per config.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ilqr_tpu.config import GlobalConfig


def pytree_dataclass(cls):
    """Frozen dataclass registered as a pytree whose fields are all data
    leaves, with a ``replace(**changes)`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(
        cls, data_fields=[f.name for f in dataclasses.fields(cls)],
        meta_fields=[])


class SolveStatus:
    """Reference enum LQRSolveStatus (include/cilqr_solver.hpp:23-29)."""

    RUNNING = 0
    CONVERGED = 1
    BACKWARD_PASS_FAIL = 2
    FORWARD_PASS_FAIL = 3
    FORWARD_PASS_SMALL_STEP = 4


@dataclasses.dataclass(frozen=True)
class CILQRConfig:
    """Static solver hyperparameters (hashable; passed as static to jit)."""

    N: int = 30
    nx: int = 4
    nu: int = 2
    num_obstacles: int = 0
    solve_type: str = "barrier"  # "barrier" | "alm"
    reference_point: str = "gravity_center"  # | "rear_center"
    use_last_solution: bool = False
    max_iter: int = 100
    # line search: alpha = 1, 0.5, ... while alpha > min_alpha
    # (reference src/cilqr_solver.cpp:354) -> at most 20 trials
    min_alpha: float = 1e-6
    # nearest-point strategy: "exact" global argmin | "hier" coarse->fine
    # (perf path; identical on smooth lane lines -- see ops/projection.py)
    projection: str = "exact"
    # line-search breadth: how many alphas are evaluated per lockstep round
    # (1 = the reference's sequential walk; results identical for any width)
    line_search_width: int = 4
    # backward-pass implementation: "scan" = sequential O(N)-depth Riccati
    # (exact reference semantics); "pscan" = EXPERIMENTAL parallel-in-time
    # lax.associative_scan -- never measured faster at batch >= 8 (lambda
    # regularizes gains only -- see ops/riccati_pscan.py). Keep "scan".
    riccati_impl: str = "scan"

    @property
    def num_constraints(self) -> int:
        return 8 + 2 * self.num_obstacles

    @classmethod
    def from_global_config(cls, gc: GlobalConfig, num_obstacles: int | None = None,
                           **overrides: Any) -> "CILQRConfig":
        kw = dict(
            N=int(gc["lqr/N"]),
            nx=int(gc["lqr/nx"]),
            nu=int(gc["lqr/nu"]),
            num_obstacles=(gc.num_obstacles if num_obstacles is None else num_obstacles),
            solve_type=gc.solve_type,
            reference_point=gc["vehicle/reference_point"],
            use_last_solution=bool(gc["lqr/use_last_solution"]),
            max_iter=int(gc["iteration/max_iter"]),
        )
        kw.update(overrides)
        return cls(**kw)


@pytree_dataclass
class CILQRWeights:
    """Traced solver scalars (a pytree; vmap-able for yaml-param sweeps).

    Field-for-field image of the ~30 config keys the reference solver ctor
    reads (src/cilqr_solver.cpp:17-83).
    """

    dt: Any
    w_pos: Any
    w_vel: Any
    w_yaw: Any
    w_acc: Any
    w_stl: Any
    obstacle_exp_q1: Any
    obstacle_exp_q2: Any
    state_exp_q1: Any
    state_exp_q2: Any
    alm_rho_init: Any
    alm_gamma: Any
    max_rho: Any
    max_mu: Any
    init_lamb: Any
    lamb_decay: Any
    lamb_amplify: Any
    max_lamb: Any
    convergence_threshold: Any
    accept_step_threshold: Any
    wheelbase: Any
    width: Any
    length: Any
    velo_max: Any
    velo_min: Any
    yaw_lim: Any
    acc_max: Any
    acc_min: Any
    stl_lim: Any
    d_safe: Any
    # float32 overflow guard for q1*exp(q2*c); inactive at float64
    exp_clip: Any

    @property
    def state_weight_diag(self):
        return jnp.stack([self.w_pos, self.w_pos, self.w_vel, self.w_yaw])

    @property
    def ctrl_weight_diag(self):
        return jnp.stack([self.w_acc, self.w_stl])

    @classmethod
    def from_global_config(cls, gc: GlobalConfig, dtype=jnp.float32,
                           **overrides: Any) -> "CILQRWeights":
        from ilqr_tpu.ops.constraints import default_exp_clip

        def g(key):
            return jnp.asarray(gc[key], dtype=dtype)

        kw = dict(
            dt=g("delta_t"),
            w_pos=g("lqr/w_pos"),
            w_vel=g("lqr/w_vel"),
            w_yaw=g("lqr/w_yaw"),
            w_acc=g("lqr/w_acc"),
            w_stl=g("lqr/w_stl"),
            obstacle_exp_q1=g("lqr/obstacle_exp_q1"),
            obstacle_exp_q2=g("lqr/obstacle_exp_q2"),
            state_exp_q1=g("lqr/state_exp_q1"),
            state_exp_q2=g("lqr/state_exp_q2"),
            alm_rho_init=g("lqr/alm_rho_init"),
            alm_gamma=g("lqr/alm_gamma"),
            max_rho=g("lqr/max_rho"),
            max_mu=g("lqr/max_mu"),
            init_lamb=g("iteration/init_lamb"),
            lamb_decay=g("iteration/lamb_decay"),
            lamb_amplify=g("iteration/lamb_amplify"),
            max_lamb=g("iteration/max_lamb"),
            convergence_threshold=g("iteration/convergence_threshold"),
            accept_step_threshold=g("iteration/accept_step_threshold"),
            wheelbase=g("vehicle/wheelbase"),
            width=g("vehicle/width"),
            length=g("vehicle/length"),
            velo_max=g("vehicle/velo_max"),
            velo_min=g("vehicle/velo_min"),
            yaw_lim=g("vehicle/yaw_lim"),
            acc_max=g("vehicle/acc_max"),
            acc_min=g("vehicle/acc_min"),
            stl_lim=g("vehicle/stl_lim"),
            d_safe=g("vehicle/d_safe"),
            exp_clip=jnp.asarray(default_exp_clip(dtype), dtype=dtype),
        )
        kw.update(overrides)
        return cls(**kw)


@pytree_dataclass
class Scenario:
    """Per-scenario device data (pad-and-stack for batching).

    ref_line: (P, 4) [x, y, yaw, s] dense offset lane line (padded rows at
        PAD_COORD); obs_preds: (M, T, 3) agent routing lines; road_borders:
        (2,) [upper, lower] lateral border offsets (reference
        src/motion_planning.cpp:101-103); ref_velo: target speed.
    """

    ref_line: Any
    ref_velo: Any
    obs_preds: Any
    road_borders: Any


@pytree_dataclass
class CILQRCarry:
    """Cross-solve MPC state: warm start + ALM duals
    (reference src/cilqr_solver.cpp:88-102, 144)."""

    last_u: Any  # (N, 2)
    is_first: Any  # bool scalar
    alm_rho: Any  # scalar
    alm_mu: Any  # (N, 8 + 2*M)

    @classmethod
    def init(cls, cfg: CILQRConfig, w: CILQRWeights, dtype=None):
        dtype = dtype or jnp.result_type(w.dt)
        return cls(
            last_u=jnp.zeros((cfg.N, cfg.nu), dtype=dtype),
            is_first=jnp.asarray(True),
            alm_rho=jnp.asarray(w.alm_rho_init, dtype=dtype),
            alm_mu=jnp.zeros((cfg.N, cfg.num_constraints), dtype=dtype),
        )


@pytree_dataclass
class SolveStats:
    """Per-solve telemetry, kept *as data* so it batches and psums
    (SURVEY.md section 5 'failure detection')."""

    iters: Any  # int32: iterations executed
    status: Any  # int32: final LQRSolveStatus
    converged: Any  # bool
    lamb_overflow: Any  # bool: lambda > max_lamb exit
    final_cost: Any  # J of the returned trajectory
    final_lamb: Any
