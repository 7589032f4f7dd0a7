"""Row-level autopsy of scenario_three_bend's kernel-vs-XLA divergence.

On-device validation has shown the fused kernel and the f32 XLA solver
taking different exits on about a third of scenario_three_bend rows. This
tool decides, row by row, whether
that divergence is a kernel defect or legitimate f32 path-chaos on an
oscillator-heavy scenario, using the float64 reference-semantics solver
(exactly equal to tests/oracle_cilqr.py per tests/test_cilqr.py) as the
ground truth. Reference status machine: src/cilqr_solver.cpp:110-142.

Phase A (always): run the f64 solver on the exact validation batch
(same seed-0 perturbed x0) on CPU and print its convergence fraction,
mean iterations, and status histogram -- the exact-arithmetic anchor
both f32 implementations should straddle.

Phase B (--npz <dump from validate_kernel.py --dump>): for samples
of status-mismatched and status-matched rows, solve fans of f64
problems whose x0 is perturbed at escalating float32 round-off
magnitudes (1, 64, 4096 ulp -- an f32 solve accumulates rounding across
thousands of ops, so its effective perturbation of the iteration path is
far above 1 ulp of x0; 4096 ulp ~ 5e-4 relative is still far below the
0.02-0.5 physical perturbation scales of the bench batch). A mismatch
row is EXPLAINED if any of: (a) the kernel's exit equals the f64 truth
(the comparator flipped, not the kernel); (b) some fan level's exits are
non-unanimous (the row sits on a decision boundary, so any f32-rounding
difference between two correct implementations legitimately flips it);
(c) another independent f32 build of the same semantics (XLA on CPU, or
XLA on the GPU) also exits differently from the truth on this row (the exit
is f32-implementation-sensitive in both directions). A row that is
perturbation-ROBUST at every level, where the kernel alone disagrees
with the truth while both XLA builds match it, would be evidence of a
real kernel defect. Also cross-checks final costs of kernel-converged
rows against the f64 cost.

Usage (CPU):
  env JAX_PLATFORMS=cpu python tools/bend_autopsy.py \
      [--npz dump/val_scenario_three_bend.npz] \
      [--batch 1024] [--rows 24] [--fan 8]
"""

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STATUS_NAMES = {0: "RUN", 1: "CONV", 2: "BWFAIL", 3: "LAMB_OVF",
                4: "SMALL_STEP"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--npz", default="")
    ap.add_argument("--scenario", default="scenario_three_bend")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--rows", type=int, default=24,
                    help="sampled rows per class (mismatch / matched)")
    ap.add_argument("--fan", type=int, default=8,
                    help="f32-magnitude perturbations per sampled row")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from ilqr_tpu.config import GlobalConfig
    from ilqr_tpu.sim.scenario import (build_scenario_setup,
                                       perturbed_initial_states)
    from ilqr_tpu.solvers.cilqr import solve
    from ilqr_tpu.types import CILQRConfig, CILQRWeights

    gc = GlobalConfig.from_file(
        os.path.join(REPO, "configs", args.scenario + ".yaml"))
    st = build_scenario_setup(gc)
    cfg = dataclasses.replace(
        CILQRConfig.from_global_config(gc), use_last_solution=False,
        line_search_width=4)  # bit-identical to width 1 on CPU (validated
    # in tools/validate_kernel.py's criteria discussion)
    w64 = CILQRWeights.from_global_config(gc, dtype=jnp.float64)
    scenario = st.device_scenario(tick=0, dtype=jnp.float64)
    x0_b = np.asarray(perturbed_initial_states(st.ego_x0, args.batch, seed=0),
                      np.float64)
    scen_b = jax.tree.map(lambda a: jnp.stack([a] * args.batch), scenario)

    f = jax.jit(jax.vmap(solve, in_axes=(None, None, 0, 0, None)),
                static_argnums=0)

    # ---- Phase A: f64 ground truth on the validation batch ----
    t0 = time.perf_counter()
    _, x64, st64, _ = f(cfg, w64, jnp.asarray(x0_b), scen_b, None)
    it64 = np.asarray(st64.iters)
    stat64 = np.asarray(st64.status)
    conv64 = np.asarray(st64.converged)
    cost64 = np.asarray(st64.final_cost)
    print(f"[A] f64 truth ({args.scenario}, batch {args.batch}, "
          f"{time.perf_counter()-t0:.0f}s): conv={conv64.mean():.3f} "
          f"mean_iters={it64.mean():.2f}", flush=True)
    hist = {STATUS_NAMES.get(s, s): int((stat64 == s).sum())
            for s in np.unique(stat64)}
    print(f"[A] f64 status histogram: {hist}", flush=True)

    # f32 on CPU: a third independent rounding of the same semantics
    w32 = CILQRWeights.from_global_config(gc, dtype=jnp.float32)
    scen32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32)
                          if a.dtype == jnp.float64 else a, scen_b)
    _, _, st32, _ = f(cfg, w32, jnp.asarray(x0_b, jnp.float32), scen32, None)
    conv32 = np.asarray(st32.converged)
    it32 = np.asarray(st32.iters)
    stat32 = np.asarray(st32.status)
    print(f"[A] f32 CPU XLA:        conv={conv32.mean():.3f} "
          f"mean_iters={it32.mean():.2f}", flush=True)

    if not args.npz:
        print("[B] skipped (no --npz dump)")
        return

    # ---- Phase B: row-level autopsy against the device dump ----
    d = np.load(args.npz)
    assert int(d["batch"]) == args.batch and int(d["seed"]) == 0
    stat_k, stat_r = d["stat_k"], d["stat_r"]
    conv_k, cost_k = d["conv_k"], d["cost_k"]
    it_k, it_r = d["it_k"], d["it_r"]
    mism = np.flatnonzero(stat_k != stat_r)
    match = np.flatnonzero(stat_k == stat_r)
    print(f"[B] dump: {len(mism)} status-mismatch rows / {args.batch} "
          f"(kernel conv {d['conv_k'].mean():.3f}, "
          f"XLA-device conv {d['conv_r'].mean():.3f})", flush=True)
    rng = np.random.default_rng(1)
    samp_m = rng.choice(mism, min(args.rows, len(mism)), replace=False)
    samp_c = rng.choice(match, min(args.rows, len(match)), replace=False)

    # Fans of f32-round-off perturbations per sampled row, solved in f64,
    # at escalating magnitudes: LEVELS[i] f32 ulps of each component
    # (|x| * 2^-23 per ulp). Level 0 (1 ulp) is the floor any two correct
    # f32 evaluations of one quantity may differ by; higher levels stand
    # in for rounding accumulated across an entire f32 iteration path.
    LEVELS = (1.0, 64.0, 4096.0)
    rows = np.concatenate([samp_m, samp_c])
    R, K = len(rows), args.fan
    base = x0_b[rows]  # (R, 4)
    ulp = np.abs(base) * 2.0 ** -23 + 1e-12
    fans = [base[:, None, :]]
    for lv in LEVELS:
        fans.append(base[:, None, :]
                    + rng.standard_normal((R, K, 4)) * (lv * ulp[:, None, :]))
    fan = np.concatenate(fans, axis=1)  # (R, 1 + len(LEVELS)*K, 4)
    F = fan.shape[1]
    scen_f = jax.tree.map(lambda a: jnp.stack([a[0]] * (R * F)), scen_b)
    _, _, stf, _ = f(cfg, w64, jnp.asarray(fan.reshape(-1, 4)), scen_f, None)
    statf = np.asarray(stf.status).reshape(R, F)
    costf = np.asarray(stf.final_cost).reshape(R, F)

    def classify(i, row):
        s_k, s_r, s_64 = int(stat_k[row]), int(stat_r[row]), statf[i, 0]
        s_32 = int(stat32[row])
        # lowest perturbation level whose fan (incl. the base point) is
        # not unanimous; None = robust at every level
        flip_level = None
        for li in range(len(LEVELS)):
            fan_s = statf[i, [0] + list(range(1 + li * K, 1 + (li + 1) * K))]
            if len(np.unique(fan_s)) > 1:
                flip_level = LEVELS[li]
                break
        kernel_is_truth = s_k == s_64
        others_flip = (s_r != s_64) or (s_32 != s_64)
        if s_k == s_r:
            verdict = "boundary" if flip_level is not None else "robust"
        elif kernel_is_truth:
            verdict = "EXPLAINED(kernel=truth)"
        elif flip_level is not None:
            verdict = f"EXPLAINED(boundary@{flip_level:.0f}ulp)"
        elif others_flip:
            verdict = "EXPLAINED(f32-chaos)"
        else:
            verdict = "UNEXPLAINED"
        # cost comparability for kernel-converged rows: the kernel's f32
        # final cost should sit at the f64 solution's cost scale
        cost_note = ""
        if conv_k[row]:
            rel = abs(cost_k[row] - costf[i, 0]) / max(abs(costf[i, 0]), 1e-3)
            cost_note = f" cost_rel_vs_f64={rel:.2e}"
        return (f"row {row:4d}: kernel={STATUS_NAMES[s_k]:10s}"
                f"(it {it_k[row]:3d}) xla={STATUS_NAMES[s_r]:10s}"
                f"(it {it_r[row]:3d}) f32cpu={STATUS_NAMES[s_32]:10s} "
                f"f64={STATUS_NAMES[int(s_64)]:10s} "
                f"fan={''.join(str(int(s)) for s in statf[i])} "
                f"{verdict}{cost_note}"), verdict

    n_expl = n_unex = 0
    print("[B] --- status-mismatch sample ---")
    for i, row in enumerate(rows[:len(samp_m)]):
        line, verdict = classify(i, row)
        print(line, flush=True)
        n_unex += verdict == "UNEXPLAINED"
        n_expl += verdict.startswith("EXPLAINED")
    print("[B] --- status-matched control sample ---")
    ctl_robust = 0
    for j, row in enumerate(rows[len(samp_m):]):
        line, verdict = classify(len(samp_m) + j, row)
        print(line, flush=True)
        ctl_robust += verdict == "robust"
    print(f"[B] mismatch rows: {n_expl} explained, {n_unex} UNEXPLAINED "
          f"of {len(samp_m)}; control: {ctl_robust}/{len(samp_c)} "
          f"perturbation-robust", flush=True)
    print("PASS bend-autopsy" if n_unex == 0 else "FAIL bend-autopsy",
          flush=True)
    sys.exit(0 if n_unex == 0 else 1)


if __name__ == "__main__":
    main()
