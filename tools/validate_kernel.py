"""Correctness gates for the solve engines at full size, on the device.

For each shipped scenario yaml, on the standard validation batch (seed-0
perturbed initial states, cold starts, N=30, max_iter=100):

- ``gate_xla_f64``: the XLA engine in float64 against the float64 anchors
  of tools/f64_anchors.json (written on the CPU by tools/f64_truth.py):
  per-row exit-status agreement >= 0.99 and converged fraction within
  0.01. Float64 reassociation can only flip rows that sit exactly on an
  accept threshold.
- ``gate_f32``: each float32 engine (the fused kernel at the benchmark's
  options, and the XLA engine) against the same anchors and against each
  other. Per-row status equality between two f32 builds measures path
  chaos, not correctness (iteration paths diverge chaotically on
  oscillator rows, NOTES.md), so the criteria are:
    agree_f64(engine) >= agree_f64(xla_f32) - 0.01 (1% ~ binomial noise
      at batch 1024);
    gap_truth(engine) <= max(0.03, gap_truth(xla_f32)), gap_truth = |conv
      fraction - anchor| (0.03 ~ 2 binomial sd near conv 0.7);
    on rows both engines converge: final-cost p90 relative gap < 1e-3 and
      position p90 gap < 5e-2 m (converged rows that took different paths
      return equi-optimal trajectories that differ at the cm level along
      the flat along-track directions of the cost valley).

Usage:  python tools/validate_kernel.py [--batch 1024] [--scenario NAME]
Prints a PASS/FAIL line per gate; exits non-zero on any FAIL.
"""

import argparse
import dataclasses
import json
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


def load_anchor(name: str, batch: int):
    """(converged fraction, per-row status) of the f64 anchor run."""
    with open(os.path.join(REPO, "tools", "f64_anchors.json")) as fp:
        a = json.load(fp)[name]
    assert int(a["batch"]) == batch and int(a["seed"]) == 0, \
        f"no anchor for {name} at batch {batch}"
    return float(a["conv"]), np.array([int(c) for c in a["status_rows"]])


def problem(name: str, batch: int, dtype):
    import jax
    import jax.numpy as jnp

    from ilqr_tpu.config import GlobalConfig
    from ilqr_tpu.sim.scenario import build_scenario_setup, perturbed_initial_states
    from ilqr_tpu.types import CILQRConfig, CILQRWeights

    gc = GlobalConfig.from_file(os.path.join(REPO, "configs", name + ".yaml"))
    st = build_scenario_setup(gc)
    cfg = dataclasses.replace(CILQRConfig.from_global_config(gc),
                              use_last_solution=False)
    w = CILQRWeights.from_global_config(gc, dtype=dtype)
    scenario = st.device_scenario(tick=0, dtype=dtype)
    x0_b = jnp.asarray(perturbed_initial_states(st.ego_x0, batch, seed=0),
                       dtype)
    scen_b = jax.tree.map(lambda a: jnp.stack([a] * batch), scenario)
    return gc, cfg, w, x0_b, scen_b


def solve_xla(name: str, batch: int, dtype):
    import jax

    from ilqr_tpu.solvers.cilqr import solve

    _, cfg, w, x0_b, scen_b = problem(name, batch, dtype)
    f = jax.jit(jax.vmap(solve, in_axes=(None, None, 0, 0, None)),
                static_argnums=0)
    u, x, st, _ = f(cfg, w, x0_b, scen_b, None)
    return _host(x, st)


def solve_kernel(name: str, batch: int):
    import jax.numpy as jnp

    from ilqr_tpu.ops.pallas.cilqr_kernel import cilqr_solve_pallas, tuned_options

    gc, cfg, w, x0_b, scen_b = problem(name, batch, jnp.float32)
    u, x, st = cilqr_solve_pallas(cfg, w, x0_b, scen_b, **tuned_options(gc))
    return _host(x, st)


def _host(x, st):
    return {"x": np.asarray(x), "status": np.asarray(st.status),
            "conv": np.asarray(st.converged), "cost": np.asarray(st.final_cost),
            "iters": np.asarray(st.iters)}


def gate_xla_f64(name: str, batch: int, res) -> bool:
    conv_a, rows_a = load_anchor(name, batch)
    agree = float(np.mean(res["status"] == rows_a))
    gap = abs(float(np.mean(res["conv"])) - conv_a)
    ok = agree >= 0.99 and gap <= 0.01
    print(f"{'PASS' if ok else 'FAIL'} xla_f64 {name}: agree_f64={agree:.4f} "
          f"conv={np.mean(res['conv']):.4f} conv_f64={conv_a:.4f} "
          f"gap={gap:.4f} mean_iters={np.mean(res['iters']):.2f}", flush=True)
    return ok


def gate_f32(name: str, batch: int, engine: str, res, ref) -> bool:
    """``res``: the engine's results; ``ref``: the f32 XLA engine's."""
    conv_a, rows_a = load_anchor(name, batch)
    agree = float(np.mean(res["status"] == rows_a))
    agree_ref = float(np.mean(ref["status"] == rows_a))
    gap = abs(float(np.mean(res["conv"])) - conv_a)
    gap_ref = abs(float(np.mean(ref["conv"])) - conv_a)
    both = res["conv"] & ref["conv"]
    rel = (np.abs(res["cost"] - ref["cost"])
           / np.maximum(np.abs(ref["cost"]), 1e-3))
    cost_p90 = float(np.percentile(rel[both], 90)) if both.any() else np.inf
    pos_p90 = (float(np.percentile(np.abs(res["x"][both] - ref["x"][both]),
                                   90)) if both.any() else np.inf)
    ok = (agree >= agree_ref - 0.01 and gap <= max(0.03, gap_ref)
          and cost_p90 < 1e-3 and pos_p90 < 5e-2)
    print(f"{'PASS' if ok else 'FAIL'} {engine}_f32 {name}: "
          f"agree_f64={agree:.4f} (xla_f32 {agree_ref:.4f}) "
          f"gap_truth={gap:.4f} (xla_f32 {gap_ref:.4f}) "
          f"conv={np.mean(res['conv']):.4f} conv_f64={conv_a:.4f} "
          f"cost_relerr_p90={cost_p90:.2e} pos_absdiff_p90={pos_p90:.2e} "
          f"mean_iters={np.mean(res['iters']):.2f}", flush=True)
    return ok


def run_gates(names, batch: int, engines=("kernel", "xla"),
              dump: str = "") -> bool:
    """Every gate for every scenario in ``names``; True when all pass.
    ``dump``: directory for per-scenario npz files of the per-row results
    of the kernel (_k) and the f32 XLA engine (_r), as the row-level
    autopsy tools (bend_autopsy.py, agree_crosstab.py) read them."""
    import jax.numpy as jnp

    ok = True
    for name in names:
        ok = gate_xla_f64(name, batch,
                          solve_xla(name, batch, jnp.float64)) and ok
        ref = solve_xla(name, batch, jnp.float32)
        res = {}
        for engine in engines:
            res[engine] = ref if engine == "xla" else solve_kernel(name,
                                                                   batch)
            ok = gate_f32(name, batch, engine, res[engine], ref) and ok
        if dump and "kernel" in res:
            os.makedirs(dump, exist_ok=True)
            k = res["kernel"]
            np.savez_compressed(
                os.path.join(dump, f"val_{name}.npz"), batch=batch, seed=0,
                **{f"{a}_{s}": d[b] for s, d in (("k", k), ("r", ref))
                   for a, b in (("x", "x"), ("stat", "status"),
                                ("conv", "conv"), ("cost", "cost"),
                                ("it", "iters"))})
    return ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--scenario", default=None)
    ap.add_argument("--dump", default="",
                    help="directory for per-row npz dumps (autopsy tools)")
    args = ap.parse_args()
    from ilqr_tpu import runtime

    platform = runtime.setup(x64=True)
    print(f"platform={platform} device={runtime.device_info()}", flush=True)
    names = [args.scenario] if args.scenario else SCENARIOS
    engines = ("kernel", "xla") if platform == "gpu" else ("xla",)
    sys.exit(0 if run_gates(names, args.batch, engines, args.dump) else 1)


if __name__ == "__main__":
    main()
