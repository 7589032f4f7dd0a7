"""Batched constrained-iLQR trajectory-optimization framework (JAX, GPU).

A brand-new JAX/XLA/Pallas implementation of the capabilities of the
reference C++/numpy project ``PuYuuu/toy-example-of-iLQR`` (mounted read-only
during development), re-designed batched-first:

- every kernel is written batched-first and ``vmap``-able; per-scenario
  branchy control flow (line search, lambda schedule, convergence) becomes
  masked lockstep iteration under ``vmap`` of ``lax.while_loop``;
- the horizon-sequential Riccati recursion and rollouts are ``lax.scan``
  programs (exact reference semantics) with an optional parallel-in-time
  associative-scan formulation for long horizons;
- scaling comes from sharding the scenario batch over a
  ``jax.sharding.Mesh`` (``shard_map``/``pjit``), with convergence stats
  reduced via XLA collectives.

Layer map (mirrors SURVEY.md section 1 of the repo):
  config      -- YAML config system (reference: src/global_config.cpp)
  utils       -- splines, reference/routing lines, timing (src/cubic_spline.cpp, src/utils.cpp)
  models      -- vehicle dynamics + linear models (src/utils.cpp:262-342)
  ops         -- constraint/cost/Riccati device kernels (src/cilqr_solver.cpp)
  solvers     -- CILQR, LQR/DARE, LQR path tracking (src/cilqr_solver.cpp, scripts/)
  sim         -- scenario builder + receding-horizon MPC driver (src/motion_planning.cpp)
  parallel    -- mesh / sharding / multi-host launch (no reference counterpart)
  viz         -- matplotlib rendering, sprites, HUD (src/utils.cpp:117-260)
"""

from ilqr_tpu.config import GlobalConfig
from ilqr_tpu.solvers.cilqr import (
    CILQRConfig,
    CILQRWeights,
    CILQRCarry,
    CILQRSolver,
    SolveStatus,
    solve,
)

__all__ = [
    "GlobalConfig",
    "CILQRConfig",
    "CILQRWeights",
    "CILQRCarry",
    "CILQRSolver",
    "SolveStatus",
    "solve",
]

__version__ = "0.1.0"
