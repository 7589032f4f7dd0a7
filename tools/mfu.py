"""Analytic FLOPs/solve and utilization of the fused CILQR kernel.

Computes the *useful* (algorithmically irreducible) floating-point work of
one reference-semantics CILQR solve and divides achieved useful FLOP/s by
the device's peak. "Useful" counts only the math the reference algorithm
requires (src/cilqr_solver.cpp:337-461): nearest-point projections, trial
rollouts, cost evaluations, derivative/Hessian assembly, and the backward
Riccati recursion -- NOT implementation overheads (padding, lockstep slack),
which is what makes the ratio an honest utilization number.

Counting rules: one FLOP per scalar +,-,*,/,compare,select; transcendental
(sin/cos/exp) = 1 FLOP (this *under*states the work, keeping the ratio
conservative).

Usage: python tools/mfu.py --device-kind "NVIDIA H100 80GB HBM3"
           --solves-per-sec S --mean-iters I [--mean-lane-trials T]
           [--window 384] [--proj-rows 9]
(S and I from a bench.py run on that device; T from
tools/measure_ls_trials.py; --proj-rows 0 recovers the full-window
accounting)
"""

import argparse


def flops_per_solve(N=30, M=3, W=384, mean_iters=11.6, mean_trials=2.77):
    """Useful FLOPs of one solve (barrier mode, scenario_two_straight shape).

    Per solver iteration (reference iter_step, src/cilqr_solver.cpp:337-381):
      per line-search trial (src/cilqr_solver.cpp:442-461):
        - rollout: N steps x (control update u = u_hat + alpha*d + K(x-x_hat):
          2x4 matvec 16 + 10 adds/muls; bicycle propagate ~14 incl sin/cos/
          tan at 1 each -- src/utils.cpp:262-283) ~= 40/step
        - projection of the rolled trajectory: (N+1) steps x W window rows x
          (dx,dy,dx^2+dy^2, running-min compare+select) = 6/row
          (get_ref_exact_points, src/cilqr_solver.cpp:289-314, as a dense
          nearest-point scan)
        - total cost: per step: 2 tracking quadratics ~24, 6 state bounds +
          2M obstacle ellipsoid constraints x (margin eval ~12 + exp barrier
          ~4) -- get_total_cost, src/cilqr_solver.cpp:199-287 ~= 220/step
      once per iteration:
        - cost derivatives & Hessians (src/cilqr_solver.cpp:463-690):
          ~per step: l_x,l_u,l_xx,l_uu + (2M+6) constraint gradient chains
          x ~40 ~= 700/step
        - backward Riccati with 4x4/4x2 algebra (src/cilqr_solver.cpp:
          383-440): Q_x,Q_u,Q_xx,Q_uu,Q_ux + 2x2 solve + gain apply
          ~= 2x(4x4x4) matmuls + assorted ~= 400/step
    """
    per_trial = N * 40 + (N + 1) * W * 6 + N * 220
    per_iter = mean_trials * per_trial + N * (700 + 400)
    return mean_iters * per_iter


def mean_scanned_rows(N=30, W=384, proj_rows=9, w_back=24, slack=16):
    """Mean per-step rows actually scanned under the per-step
    search bound row_limits[k] = round8(w_back + slack + k * proj_rows)
    capped at W (cilqr_kernel.derive_proj_rows). Passing this as the
    effective window keeps the FLOP count honest: rows the kernel
    provably never touches are not 'achieved' work."""
    tot = 0
    for k in range(N + 1):
        tot += min(W, -(-(w_back + slack + k * proj_rows) // 8) * 8)
    return tot / (N + 1)


# Published dense peaks, keyed by jax.devices()[0].device_kind. Source:
# NVIDIA H100 SXM data sheet (700 W power limit): 67 TFLOP/s FP32 outside
# the tensor cores, 3.35 TB/s HBM3. The kernel's work is scalar FP32 (no
# matrix products), so the FP32 rate is its compute ceiling.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peaks(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {device_kind!r}")
    return PEAKS[device_kind]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device-kind", required=True,
                    help="jax.devices()[0].device_kind of the measured card")
    ap.add_argument("--solves-per-sec", type=float, required=True)
    ap.add_argument("--mean-iters", type=float, required=True)
    ap.add_argument("--mean-lane-trials", type=float, default=2.77)
    ap.add_argument("--window", type=int, default=384)
    ap.add_argument("--proj-rows", type=int, default=9,
                    help="per-step search-bound rows (the bench's factor "
                    "1.1 on scenario_two_straight = 9); 0 = full window "
                    "scans")
    ap.add_argument("--N", type=int, default=30)
    ap.add_argument("--M", type=int, default=3)
    args = ap.parse_args()

    eff_w = args.window
    if args.proj_rows > 0:
        eff_w = mean_scanned_rows(args.N, args.window, args.proj_rows)
        print(f"effective mean window under proj_rows={args.proj_rows}: "
              f"{eff_w:.1f} rows (of {args.window})")
    fps = flops_per_solve(args.N, args.M, eff_w, args.mean_iters,
                          args.mean_lane_trials)
    useful = fps * args.solves_per_sec
    peak = peaks(args.device_kind)["fp32_flops"]
    print(f"useful FLOPs/solve ~= {fps/1e6:.2f} MFLOP "
          f"(window {args.window}, mean_iters {args.mean_iters}, "
          f"mean lane trials {args.mean_lane_trials})")
    print(f"achieved useful {useful/1e9:.1f} GFLOP/s at "
          f"{args.solves_per_sec:,.0f} solves/s")
    print(f"utilization vs the {peak / 1e12:.0f} TFLOP/s FP32 peak of "
          f"{args.device_kind}: {100 * useful / peak:.3f}%")
    # share of the trial projection term (the probe-measured dominant cost)
    proj = (args.mean_iters * args.mean_lane_trials
            * (args.N + 1) * eff_w * 6)
    print(f"projection share of useful FLOPs: {100*proj/fps:.1f}%")


if __name__ == "__main__":
    main()
