"""Regenerate the golden-trajectory pins (tests/goldens/*.npz).

Run ONLY after a deliberate, parity-verified solver-semantics change (the
goldens exist to trip accidental changes). Produces 5 MPC ticks per shipped
scenario with the float64 solver, exactly as tests/test_goldens.py replays
them.

History: first generated at commit 54b64c4 (round 3); regenerated in
round 5 after mirroring the reference's Jacobian slip-angle quirk
beta = atan(tan(stl/2)) (src/utils.cpp:292) exactly -- verified against
the reference's own numpy implementation by tests/test_reference_oracle.py
-- which shifted 5-tick trajectories by up to 1.2e-3 m.

Usage (CPU):
  env JAX_PLATFORMS=cpu python tools/gen_goldens.py
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SCENARIOS = [
    "scenario_two_straight",
    "scenario_two_borrow",
    "scenario_three_straight",
    "scenario_three_bend",
]


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from ilqr_tpu.config import GlobalConfig
    from ilqr_tpu.sim.mpc import run_mpc
    from ilqr_tpu.sim.scenario import build_scenario_setup
    from ilqr_tpu.types import CILQRConfig, CILQRWeights

    golden_dir = os.path.join(REPO, "tests", "goldens")
    for name in SCENARIOS:
        gc = GlobalConfig.from_file(
            os.path.join(REPO, "configs", f"{name}.yaml"))
        st = build_scenario_setup(gc)
        cfg = CILQRConfig.from_global_config(gc)
        w = CILQRWeights.from_global_config(gc, dtype=jnp.float64)
        h = run_mpc(cfg, w, st, dtype=jnp.float64, ticks=5)
        out = os.path.join(golden_dir, f"{name}.npz")
        np.savez(out, ego=np.asarray(h["ego"]),
                 u0=np.asarray(h["u"][:, 0, :]),
                 iters=np.array([int(s.iters) for s in h["stats"]]))
        print(f"wrote {out}: iters={[int(s.iters) for s in h['stats']]}")


if __name__ == "__main__":
    main()
