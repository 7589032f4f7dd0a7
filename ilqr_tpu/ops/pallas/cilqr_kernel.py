"""Fused CILQR solver as one Pallas kernel on the Triton route (NVIDIA GPU).

The XLA-composed solver (ilqr_tpu/solvers/cilqr.py) pays thousands of small
operations per solver iteration: scanned Riccati steps, line-search rollout
scans, constraint assembly, and a predicate read per ``while`` step. This
kernel runs the *entire* solve -- projection, cost + derivative assembly, the
backward Riccati recursion, line-search rollouts, the lambda/status state
machine -- inside one ``pallas_call`` with ``backend="triton"``.

Layout: one scenario per thread. A program owns ``block`` scenarios (a power
of two) on the minor axis of every operand; every in-kernel value is a
``(block,)`` vector, so the solve is per-thread scalar FP32 work with no
cross-lane traffic except the block-wide "any lane still running" tests of
the ``while`` loops. Operands are full arrays (no block specs) in a
``(rows, batch)`` layout, so a per-step row is one coalesced ``(block,)``
load at ``[row, program_cols]``. Per-step state lives in global memory
(L1/L2-backed): the current trajectory in the ``u``/``x`` outputs, the
projection, gains and line-search trials in a scratch output. Only loop
carries (the Riccati value function, the trial states, running costs)
stay in registers, so register use does not grow with the horizon.

Per solver iteration (reference src/cilqr_solver.cpp:85-153):
- one backward sweep recomputes the step-k cost derivatives from the stored
  trajectory and runs the sparse 4x4/4x2 Riccati step on them
  (src/cilqr_solver.cpp:383-440 with the bicycle Jacobians'
  sparsity, src/utils.cpp:285-342), writing K and d;
- the line search evaluates ``ls_chunk`` alphas per pass (1 when
  ``ls_chunk == 0``): one forward sweep rolls every trial out, projects it
  onto the reference-line window and sums its cost; each alpha's arithmetic
  is identical in every chunk width, so results are bitwise-equal to the
  serial loop;
- the accepted trial's rows are copied over the current trajectory, and its
  cost becomes the next iteration's ``ori_cost`` (the same forward-order sum
  a recomputation would give).

Semantics match the reference C++ solver in both constraint modes: barrier
and ALM, whose dual state (mu, rho) is kernel I/O (``alm_mu0``/``alm_rho0``,
``return_alm``). Warm starting is kernel I/O too (``u_init``, the shifted
previous solution, reference src/cilqr_solver.cpp:163-180).
"""

from __future__ import annotations

import functools
import math

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ilqr_tpu.types import CILQRConfig, CILQRWeights, SolveStats, SolveStatus

W_BACK = 64  # window rows behind the ego's initial projection
BLOCK = 32  # scenarios per program: one warp, one scenario per thread

# Extra window rows above the per-step search bound (row limit for step k =
# round8(w_back + PROJ_SLACK + k * proj_rows_per_step)).
PROJ_SLACK = 16

# weights input layout: solver scalars, then the lockstep iteration range
# [it0, max_iter) of this call
(_DT, _WB, _WIDTH, _LENGTH, _DSAFE, _VMAX, _VMIN, _AMAX, _AMIN, _STL,
 _WPOS, _WVEL, _WYAW, _WACC, _WSTL, _SQ1, _SQ2, _OQ1, _OQ2,
 _ILAMB, _LDECAY, _LAMP, _LMAX, _CONV, _ACCEPT, _ECLIP,
 _ALM_GAMMA, _MAX_RHO, _MAX_MU, _RHO_INIT, _IT0, _MAXIT) = range(32)
_NWTS = 32

# obstacle input quantities (cos/sin of the heading are precomputed)
_OX, _OY, _OC, _OS = range(4)


def _alpha_count(min_alpha: float) -> int:
    n, a = 0, 1.0
    while a > min_alpha:
        n += 1
        a *= 0.5
    return n


_I0 = np.int32(0)  # int32 loop bounds keep index arithmetic 32-bit under x64


def _pow2_neg(te):
    """Exact 2**-te for an int32 scalar 0 <= te < 127 (bit construction, so
    no transcendental approximation can perturb the line-search alphas)."""
    return lax.bitcast_convert_type((127 - te) << 23, jnp.float32)


def _build_kernel(N: int, M: int, W: int, n_alphas: int, rear_center: bool,
                  use_alm: bool, block: int, cw: int, proj_dot: bool,
                  proj_bound):
    """Returns (kernel body, scratch rows), closed over static shapes.

    Every call resumes: it reads the per-row solver state (iteration count,
    status, flags, lambda) from a stats input and runs lockstep iterations
    ``it0 <= it < max_iter``, both read at run time from the weights
    vector, so the capped first pass and every straggler-compaction resume
    are the same compiled kernel. Resuming is exact: the trajectory is the
    deterministic rollout of the carried controls from x0, its projection
    and cost are pure functions of it, and in ALM mode the duals ride the
    ALM I/O rows. A cold start is the resume from zero iterations with
    lambda = init_lamb.

    ``cw``: line-search alphas per forward sweep. The trials of one sweep
    are the rows of a (CWP, block) tensor, CWP = next power of two >= cw
    (rows >= cw are inert); every row's arithmetic is the serial loop's.

    ``proj_bound``: None (every projection scans the whole window) or
    ``(w_back, slack, rows_per_step)``: step k scans window rows
    [0, round8(w_back + slack + k * rows_per_step)).
    """
    f32, i32 = jnp.float32, jnp.int32
    NP = N + 1
    CWP = pl.next_power_of_2(cw)
    n_chunks = -(-n_alphas // cw)
    # scratch rows: projection index of the current trajectory, gains,
    # trial slots (quantity q, step k, trial j at TR0 + (q*NP + k)*CWP + j;
    # quantities ua, us, px, py, pv, ph, idx)
    IX0 = 0
    KG0 = NP
    TR0 = KG0 + 10 * N
    scratch_rows = TR0 + 7 * NP * CWP

    def kernel(w_ref, x0_ref, uinit_ref, stats_ref, win_ref, obs_ref, *refs):
        if use_alm:
            alm_in, u_out, x_out, st_out, alm_out, scr = refs
        else:
            u_out, x_out, st_out, scr = refs
            alm_in = alm_out = None

        c0 = pl.program_id(0) * block
        cols = pl.ds(c0, block)
        lanes = c0 + lax.iota(i32, block)

        def ld(ref, row):
            return ref[jnp.asarray(row, i32), cols]

        def st(ref, row, val, mask=None):
            row = jnp.asarray(row, i32)
            if mask is None:
                ref[row, cols] = val
            else:
                pltriton.store(ref.at[row, cols], val, mask=mask)

        def gat(ref, rows):
            """Per-lane rows of ``ref`` (rows has shape (..., block))."""
            return ref[rows, jnp.broadcast_to(lanes, rows.shape)]

        wv = [w_ref[j] for j in range(_NWTS)]
        dt, wb = wv[_DT], wv[_WB]
        width, length, d_safe = wv[_WIDTH], wv[_LENGTH], wv[_DSAFE]
        sq1, sq2, oq1, oq2 = wv[_SQ1], wv[_SQ2], wv[_OQ1], wv[_OQ2]
        eclip = wv[_ECLIP]
        # inflated ellipse axes (reference src/utils.cpp:387-393, with the
        # ego disc radius = width / 2 from src/cilqr_solver.cpp:330)
        ell_a = 0.5 * length + 6.0 * d_safe + 0.5 * width
        ell_b = 0.5 * width + d_safe + 0.5 * width
        inv_a2 = 1.0 / (ell_a * ell_a)
        inv_b2 = 1.0 / (ell_b * ell_b)

        x0 = [ld(x0_ref, q) for q in range(4)]
        ref_velo = ld(x0_ref, 6)
        up_bound = ld(x0_ref, 4) - width * 0.5
        lo_bound = ld(x0_ref, 5) + width * 0.5
        zeros = x0[0] * 0.0
        if proj_dot:
            cx0 = ld(win_ref, 0)
            cy0 = ld(win_ref, W)

        # -- per-step primitives -------------------------------------------
        def heading_trig(s):
            return jnp.cos(s[3]), jnp.sin(s[3])

        def _beta_trig(us):
            """sin/cos of the DYNAMICS beta = arctan(tan(us)/2)
            (src/utils.cpp:265)."""
            t = jnp.tan(us)
            inv = lax.rsqrt(1.0 + 0.25 * t * t)
            return 0.5 * t * inv, inv

        def _beta_jac_trig(us):
            """sin/cos of the JACOBIAN's beta = arctan(tan(us / 2)) -- the
            reference quirk at src/utils.cpp:292, deliberately different
            from the dynamics beta."""
            t = jnp.tan(0.5 * us)
            inv = lax.rsqrt(1.0 + t * t)
            return t * inv, inv

        def propagate(s, trig, ua, us):
            px, py, pv, pyaw = s
            cy_, sy_ = trig
            if rear_center:
                return (px + pv * cy_ * dt, py + pv * sy_ * dt, pv + ua * dt,
                        pyaw + pv * jnp.tan(us) * dt / wb)
            sinb, cosb = _beta_trig(us)
            cby = cosb * cy_ - sinb * sy_  # cos(beta + yaw)
            sby = sinb * cy_ + cosb * sy_  # sin(beta + yaw)
            return (px + pv * cby * dt, py + pv * sby * dt, pv + ua * dt,
                    pyaw + 2.0 * pv * sinb * dt / wb)

        def project(px, py, k):
            """Window row of the first nearest sample for each query,
            streamed one window row at a time (one coalesced load per
            quantity per row, shared by all queries)."""
            if proj_bound is None:
                R = W
            else:
                wbk, slack, rps = proj_bound
                R = jnp.minimum(W, (wbk + slack + k * rps + 7) // 8 * 8)
            if proj_dot:
                # centered dot form c' - 2 (rx' x' + ry' y') with r' = r - r0
                # and p' = p - r0: the squared distance's exact-arithmetic
                # argmin, with rounding error at window scale
                qx, qy = px - cx0, py - cy0
            else:
                qx, qy = px, py

            def body(r, carry):
                best, idx = carry
                if proj_dot:
                    d2 = (ld(win_ref, 5 * W + r) + ld(win_ref, 6 * W + r) * qx
                          + ld(win_ref, 7 * W + r) * qy)
                else:
                    dx = ld(win_ref, r) - qx
                    dy = ld(win_ref, W + r) - qy
                    d2 = dx * dx + dy * dy
                better = d2 < best
                return jnp.where(better, d2, best), jnp.where(better, r, idx)

            init = (jnp.full(px.shape, jnp.inf, f32), jnp.zeros(px.shape, i32))
            return lax.fori_loop(_I0, jnp.asarray(R, i32), body, init)[1]

        def pen(c, q1, q2, mu, rho, grads):
            """(value, gamma, eta): gradient = gamma * c', Hessian =
            eta * c' c'^T (src/cilqr_solver.cpp:692-713)."""
            if use_alm:
                shifted = c + mu / rho
                act = shifted > 0
                gam = jnp.where(act, rho * shifted, 0.0)
                val = jnp.where(act, 0.5 * rho * shifted * shifted, 0.0)
                return val, gam, gam
            b = q1 * jnp.exp(jnp.minimum(q2 * c, eclip))
            if not grads:
                return b, None, None
            return b, q2 * b, q2 * q2 * b

        def mu_row(c, k):
            return c * NP + k

        def ego_points(s, trig):
            px, py = s[0], s[1]
            cph, sph = trig
            if rear_center:
                return (px + wb * cph, py + wb * sph), (px, py)
            return ((px + 0.5 * wb * cph, py + 0.5 * wb * sph),
                    (px - 0.5 * wb * cph, py - 0.5 * wb * sph))

        def obstacle(j, k, pts, grads):
            """(margin, d margin / d point) of the front and rear ego points
            against obstacle j at step k (src/utils.cpp:395-439)."""
            row = j * NP + k
            ox = ld(obs_ref, (_OX * M) * NP + row)
            oy = ld(obs_ref, (_OY * M) * NP + row)
            ct = ld(obs_ref, (_OC * M) * NP + row)
            stt = ld(obs_ref, (_OS * M) * NP + row)
            out = []
            for (qx, qy) in pts:
                ddx = qx - ox
                ddy = qy - oy
                xs = ct * ddx + stt * ddy
                ys = -stt * ddx + ct * ddy
                c = 1.0 - (xs * xs * inv_a2 + ys * ys * inv_b2)
                if grads:
                    gxs = -2.0 * xs * inv_a2
                    gys = -2.0 * ys * inv_b2
                    out.append((c, ct * gxs - stt * gys, stt * gxs + ct * gys))
                else:
                    out.append((c, None, None))
            return out

        def bounds(ua, us, s, ref):
            """The 8 bound constraints in ALM column order
            (src/cilqr_solver.cpp:622-676) and the lateral geometry."""
            px, py, pv, _ = s
            rkx, rky, _, rkc, rks = ref
            dx = px - rkx
            dy = py - rky
            d_sign = dy * rkc - dx * rks
            h = jnp.sqrt(dx * dx + dy * dy)
            cur_d = jnp.where(d_sign < 0, f32(-1.0), f32(1.0)) * h
            cs = [ua - wv[_AMAX], wv[_AMIN] - ua, us - wv[_STL],
                  -wv[_STL] - us, pv - wv[_VMAX], wv[_VMIN] - pv,
                  cur_d - up_bound, lo_bound - cur_d]
            return cs, (d_sign, dx, dy, h)

        def step_cost(k, ua, us, s, trig, idx, rho, grads=False):
            """Cost of step k (tracking + control energy + penalties,
            src/cilqr_solver.cpp:199-287); with ``grads`` also its
            derivatives (src/cilqr_solver.cpp:463-690; l_ux == 0)."""
            is_c = k < N
            is_s = k >= 1
            ref = [gat(win_ref, q * W + idx) for q in range(5)]
            px, py, pv, ph = s
            dx = px - ref[0]
            dy = py - ref[1]
            dv = pv - ref_velo
            dh = ph - ref[2]
            cs, lat = bounds(ua, us, s, ref)
            mu = ((lambda c: ld(alm_out, mu_row(c, k))) if use_alm
                  else (lambda c: None))
            vgh = [pen(cs[c], sq1, sq2, mu(c), rho, grads) for c in range(8)]
            val = (wv[_WPOS] * (dx * dx + dy * dy) + wv[_WVEL] * dv * dv
                   + wv[_WYAW] * dh * dh)
            val = val + jnp.where(
                is_c, wv[_WACC] * ua * ua + wv[_WSTL] * us * us
                + (vgh[0][0] + vgh[1][0] + vgh[2][0] + vgh[3][0]), 0.0)
            sv = vgh[4][0] + vgh[5][0] + vgh[6][0] + vgh[7][0]
            pts = ego_points(s, trig)
            if grads:
                cm = jnp.where(is_c, f32(1.0), f32(0.0))
                sm = jnp.where(is_s, f32(1.0), f32(0.0))
                lx = [2.0 * wv[_WPOS] * dx, 2.0 * wv[_WPOS] * dy,
                      2.0 * wv[_WVEL] * dv, 2.0 * wv[_WYAW] * dh]
                lu = [2.0 * wv[_WACC] * ua + (vgh[0][1] - vgh[1][1]) * cm,
                      2.0 * wv[_WSTL] * us + (vgh[2][1] - vgh[3][1]) * cm]
                luu = [2.0 * wv[_WACC] + (vgh[0][2] + vgh[1][2]) * cm,
                       2.0 * wv[_WSTL] + (vgh[2][2] + vgh[3][2]) * cm]
                # l_xx upper triangle; (0,2), (1,2), (2,3) are structurally 0
                lxx = {(0, 0): zeros + 2.0 * wv[_WPOS],
                       (1, 1): zeros + 2.0 * wv[_WPOS],
                       (2, 2): zeros + 2.0 * wv[_WVEL],
                       (3, 3): zeros + 2.0 * wv[_WYAW],
                       (0, 1): zeros, (0, 3): zeros, (1, 3): zeros}
                # velocity bounds: gradient +-e2
                lx[2] = lx[2] + (vgh[4][1] - vgh[5][1]) * sm
                lxx[(2, 2)] = lxx[(2, 2)] + (vgh[4][2] + vgh[5][2]) * sm
                # road borders: gradient (+-gx, +-gy, 0, 0)
                d_sign, ddx, ddy, h = lat
                hs = jnp.where(h > 0, h, f32(1.0))
                flip = jnp.where(d_sign < 0, f32(-1.0), f32(1.0))
                gpx = jnp.where(h > 0, flip * ddx / hs, 0.0)
                gpy = jnp.where(h > 0, flip * ddy / hs, 0.0)
                gsum = (vgh[6][1] - vgh[7][1]) * sm  # lower negates it
                hsum = (vgh[6][2] + vgh[7][2]) * sm
                lx[0] = lx[0] + gsum * gpx
                lx[1] = lx[1] + gsum * gpy
                lxx[(0, 0)] = lxx[(0, 0)] + hsum * gpx * gpx
                lxx[(0, 1)] = lxx[(0, 1)] + hsum * gpx * gpy
                lxx[(1, 1)] = lxx[(1, 1)] + hsum * gpy * gpy
                cph, sph = trig
                # d point / d yaw of the front and rear points
                if rear_center:
                    jac = ((-wb * sph, wb * cph), (zeros, zeros))
                else:
                    jac = ((-0.5 * wb * sph, 0.5 * wb * cph),
                           (0.5 * wb * sph, -0.5 * wb * cph))
                okeys = [(0, 0), (0, 1), (0, 3), (1, 1), (1, 3), (3, 3)]

            def obs_body(j, carry):
                sv = carry[0]
                acc = list(carry[1:])
                for side, (c, gx, gy) in enumerate(obstacle(j, k, pts, grads)):
                    col = 8 + 2 * j + side
                    v, g, e = pen(c, oq1, oq2,
                                  ld(alm_out, mu_row(col, k)) if use_alm
                                  else None, rho, grads)
                    sv = sv + v
                    if grads:
                        jyx, jyy = jac[side]
                        gcoef = g * sm
                        hcoef = e * sm
                        g3 = jyx * gx + jyy * gy  # d c / d yaw
                        lxo = (gx, gy, g3)
                        acc[0] = acc[0] + gcoef * gx
                        acc[1] = acc[1] + gcoef * gy
                        acc[2] = acc[2] + gcoef * g3
                        for n, (a_, b_) in enumerate(okeys):
                            va = lxo[{0: 0, 1: 1, 3: 2}[a_]]
                            vb = lxo[{0: 0, 1: 1, 3: 2}[b_]]
                            acc[3 + n] = acc[3 + n] + hcoef * va * vb
                return (sv, *acc)

            carry = (sv,)
            if grads:
                carry += (lx[0], lx[1], lx[3]) + tuple(lxx[kk] for kk in okeys)
            if M:
                carry = lax.fori_loop(_I0, jnp.int32(M), obs_body, carry)
            val = val + jnp.where(is_s, carry[0], 0.0)
            if not grads:
                return val
            lx[0], lx[1], lx[3] = carry[1:4]
            for kk, v in zip(okeys, carry[4:]):
                lxx[kk] = v
            return val, lx, lu, lxx, luu

        # -- trajectory storage ------------------------------------------
        def load_traj(k):
            kc = jnp.minimum(k, N - 1)
            ua, us = ld(u_out, kc), ld(u_out, N + kc)
            s = tuple(ld(x_out, q * NP + k) for q in range(4))
            idx = ld(scr, IX0 + k).astype(i32)
            return ua, us, s, idx

        def store_cur(k, kc, ua, us, s, idx, mask):
            for q in range(4):
                st(x_out, q * NP + k, s[q], mask)
            st(scr, IX0 + k, idx.astype(f32), mask)

        def store_trials(k, kc, ua, us, s, idx, mask):
            m2 = jnp.broadcast_to(mask, (CWP, block))
            vals = [(0, kc, ua), (1, kc, us)] + [
                (2 + q, k, s[q]) for q in range(4)] + [(6, k, idx.astype(f32))]
            for q, r, v in vals:
                rows = pl.ds(TR0 + (q * NP + r) * CWP, CWP)
                pltriton.store(scr.at[rows, cols],
                               jnp.broadcast_to(v, (CWP, block)),
                               mask=m2 & ((k < N) if q < 2 else True))

        def forward(alphas, rho, mask, store):
            """One sweep k = 0..N: rolls out, projects and costs the current
            controls (``alphas`` None; the open-loop initial trajectory) or
            one trial per row of ``alphas`` (closed-loop u = u_ref +
            K (x - x_ref) + alpha d, src/cilqr_solver.cpp:442-461), storing
            each step's rows. Returns the total costs."""
            shape = (block,) if alphas is None else (CWP, block)

            def step(k, carry):
                s, J = carry
                kc = jnp.minimum(k, N - 1)
                ur = (ld(u_out, kc), ld(u_out, N + kc))
                trig = heading_trig(s)
                idx = project(s[0], s[1], k)
                if alphas is None:
                    ua, us = ur
                else:
                    xr = [ld(x_out, q * NP + k) for q in range(4)]
                    g = [ld(scr, KG0 + q * N + kc) for q in range(10)]
                    e = [s[q] - xr[q] for q in range(4)]
                    ua = (ur[0] + g[0] * e[0] + g[1] * e[1] + g[2] * e[2]
                          + g[3] * e[3] + alphas * g[8])
                    us = (ur[1] + g[4] * e[0] + g[5] * e[1] + g[6] * e[2]
                          + g[7] * e[3] + alphas * g[9])
                J = J + step_cost(k, ua, us, s, trig, idx, rho)
                store(k, kc, ua, us, s, idx, mask)
                return propagate(s, trig, ua, us), J

            init = (tuple(jnp.broadcast_to(v, shape) for v in x0),
                    jnp.zeros(shape, f32))
            return lax.fori_loop(_I0, jnp.int32(NP), step, init)[1]

        def backward(lamb, rho):
            """Sparse Riccati recursion (src/cilqr_solver.cpp:383-440) with
            the step-k derivatives recomputed from the stored trajectory;
            writes K and d rows, returns (dV1, dV2, fail)."""
            keys = [(a, b) for a in range(4) for b in range(a, 4)]
            ua, us, s, idx = load_traj(N)
            _, lxN, _, lxxN, _ = step_cost(N, ua, us, s, heading_trig(s), idx,
                                           rho, grads=True)
            Vx0 = tuple(lxN)
            Vxx0 = tuple(lxxN.get(kk, zeros) for kk in keys)

            def step(kk, carry):
                Vx, Vxx_t, dV1, dV2, fail = carry
                k = N - 1 - kk
                Vxx = dict(zip(keys, Vxx_t))
                ua, us, s, idx = load_traj(k)
                trig = heading_trig(s)
                _, lx, lu, lxx, luu = step_cost(k, ua, us, s, trig, idx, rho,
                                                grads=True)
                v, stl = s[2], us
                cy_, sy_ = trig
                if rear_center:
                    a02 = cy_ * dt
                    a03 = -v * sy_ * dt
                    a12 = sy_ * dt
                    a13 = v * cy_ * dt
                    a32 = jnp.tan(stl) * dt / wb
                    b01 = zeros
                    b11 = zeros
                    cs2 = jnp.cos(stl)
                    b31 = (v * dt / wb) / (cs2 * cs2)
                else:
                    sinb, cosb = _beta_jac_trig(stl)  # quirk beta
                    t2 = jnp.tan(stl) ** 2
                    dbds = 0.5 * (1.0 + t2) / (1.0 + 0.25 * t2)
                    cby = cosb * cy_ - sinb * sy_
                    sby = sinb * cy_ + cosb * sy_
                    a02 = cby * dt
                    a03 = -v * sby * dt
                    a12 = sby * dt
                    a13 = v * cby * dt
                    a32 = 2.0 * sinb * dt / wb
                    b01 = -v * sby * dt * dbds
                    b11 = v * cby * dt * dbds
                    b31 = (2.0 * v * dt / wb) * cosb * dbds

                V = lambda a, b: Vxx[(min(a, b), max(a, b))]
                # M1 = Vxx @ A (A = I + sparse); columns 2, 3 modified
                M1 = {}
                for a in range(4):
                    M1[(a, 0)] = V(a, 0)
                    M1[(a, 1)] = V(a, 1)
                    M1[(a, 2)] = (a02 * V(a, 0) + a12 * V(a, 1) + V(a, 2)
                                  + a32 * V(a, 3))
                    M1[(a, 3)] = a03 * V(a, 0) + a13 * V(a, 1) + V(a, 3)
                # Qxx = lxx + A^T M1
                Qxx = {}
                for b in range(4):
                    Qxx[(0, b)] = M1[(0, b)]
                    Qxx[(1, b)] = M1[(1, b)]
                    Qxx[(2, b)] = (a02 * M1[(0, b)] + a12 * M1[(1, b)]
                                   + M1[(2, b)] + a32 * M1[(3, b)])
                    Qxx[(3, b)] = (a03 * M1[(0, b)] + a13 * M1[(1, b)]
                                   + M1[(3, b)])
                for key, val in lxx.items():
                    Qxx[key] = Qxx[key] + val
                Qx = [lx[0] + Vx[0], lx[1] + Vx[1],
                      lx[2] + a02 * Vx[0] + a12 * Vx[1] + Vx[2] + a32 * Vx[3],
                      lx[3] + a03 * Vx[0] + a13 * Vx[1] + Vx[3]]
                Qu = [lu[0] + dt * Vx[2],
                      lu[1] + b01 * Vx[0] + b11 * Vx[1] + b31 * Vx[3]]
                M2 = {}
                for a in range(4):
                    M2[(a, 0)] = dt * V(a, 2)
                    M2[(a, 1)] = b01 * V(a, 0) + b11 * V(a, 1) + b31 * V(a, 3)
                Quu00 = luu[0] + dt * M2[(2, 0)] + lamb
                Quu01 = dt * M2[(2, 1)]  # l_uu (0,1) structurally zero
                Quu11 = (luu[1] + b01 * M2[(0, 1)] + b11 * M2[(1, 1)]
                         + b31 * M2[(3, 1)] + lamb)
                Qux = [[dt * M1[(2, b)] for b in range(4)],
                       [b01 * M1[(0, b)] + b11 * M1[(1, b)] + b31 * M1[(3, b)]
                        for b in range(4)]]

                det = Quu00 * Quu11 - Quu01 * Quu01
                pd = (Quu00 > 0) & (det > 0)
                dets = jnp.where(pd, det, f32(1.0))
                i00 = Quu11 / dets
                i01 = -Quu01 / dets
                i11 = Quu00 / dets
                d0 = -(i00 * Qu[0] + i01 * Qu[1])
                d1 = -(i01 * Qu[0] + i11 * Qu[1])
                Kr = [[-(i00 * Qux[0][b] + i01 * Qux[1][b]) for b in range(4)],
                      [-(i01 * Qux[0][b] + i11 * Qux[1][b]) for b in range(4)]]
                for q, g in enumerate(Kr[0] + Kr[1] + [d0, d1]):
                    st(scr, KG0 + q * N + k, g)

                # value-function update (src/cilqr_solver.cpp:427-432)
                Qud = [Quu00 * d0 + Quu01 * d1, Quu01 * d0 + Quu11 * d1]
                nVx = tuple(Qx[b] + Kr[0][b] * (Qud[0] + Qu[0])
                            + Kr[1][b] * (Qud[1] + Qu[1])
                            + Qux[0][b] * d0 + Qux[1][b] * d1
                            for b in range(4))
                nVxx = []
                for (a, b) in keys:
                    KQuuK = (Kr[0][a] * (Quu00 * Kr[0][b] + Quu01 * Kr[1][b])
                             + Kr[1][a] * (Quu01 * Kr[0][b] + Quu11 * Kr[1][b]))
                    KQux = Kr[0][a] * Qux[0][b] + Kr[1][a] * Qux[1][b]
                    QuxK = Qux[0][a] * Kr[0][b] + Qux[1][a] * Kr[1][b]
                    nVxx.append(Qxx[(a, b)] + KQuuK + KQux + QuxK)
                return (nVx, tuple(nVxx),
                        dV1 + 0.5 * (d0 * Qud[0] + d1 * Qud[1]),
                        dV2 + d0 * Qu[0] + d1 * Qu[1], fail | ~pd)

            _, _, dV1, dV2, fail = lax.fori_loop(
                _I0, jnp.int32(N), step, (Vx0, Vxx0, zeros, zeros, zeros < 0))
            return dV1, dV2, fail

        def any_(m):
            return jnp.max(jnp.where(m, 1, 0)) > 0

        jj = lax.broadcasted_iota(i32, (CWP, 1), 0)

        def line_search(active, bp_fail, cur_J, dV1, dV2, rho):
            def cond(c):
                return (c[0] < n_chunks) & any_(~c[1])

            def body(c):
                t, ls_done, acc, convf, small, slot_i, nJ = c
                te = t * cw + jj  # (CWP, 1) alpha indices of this sweep
                alpha = _pow2_neg(te)
                costs = forward(alpha, rho, ~ls_done, store_trials)
                decay = cur_J - costs
                is_first = te == 0
                # the convergence check precedes acceptance at alpha == 1
                # (src/cilqr_solver.cpp:358-365)
                conv_s = is_first & (jnp.abs(decay) < wv[_CONV])
                approx = -(alpha * alpha * dV1 + alpha * dV2)
                ratio = jnp.where(approx != 0, decay / approx, f32(jnp.inf))
                acc_s = (decay > 0) & ((approx < 0) | (ratio > wv[_ACCEPT]))
                # inert rows: beyond the chunk width or the alpha schedule
                hit = (conv_s | acc_s) & (jj < cw) & (te < n_alphas)
                first = jnp.min(jnp.where(hit, jj, CWP), axis=0)
                sel = jj == first
                found = (first < CWP) & ~ls_done
                conv_now = found & any_axis0(sel & conv_s)
                acc_now = found & ~conv_now
                slot_i = jnp.where(acc_now, first, slot_i)
                nJ = jnp.where(acc_now,
                               jnp.sum(jnp.where(sel, costs, 0.0), axis=0), nJ)
                small = small | (acc_now & (t * cw + first != 0))
                return (t + 1, ls_done | found, acc | acc_now,
                        convf | conv_now, small, slot_i, nJ)

            false = zeros < 0
            init = (jnp.int32(0), bp_fail | ~active, false, false, false,
                    jnp.zeros((block,), i32), cur_J)
            return lax.while_loop(cond, body, init)[2:]

        def any_axis0(m):
            return jnp.max(jnp.where(m, 1, 0), axis=0) > 0

        def adopt(accepted, slot_i):
            """Copy each accepted lane's winning trial over the current
            trajectory."""
            dests = [(u_out, 0), (u_out, N)] + [
                (x_out, q * NP) for q in range(4)] + [(scr, IX0)]

            def step(k, carry):
                kc = jnp.minimum(k, N - 1)
                for q, (ref, base) in enumerate(dests):
                    r = kc if q < 2 else k
                    v = gat(scr, TR0 + (q * NP + r) * CWP + slot_i)
                    st(ref, base + r, v, accepted)
                return carry
            lax.fori_loop(_I0, jnp.int32(NP), step, 0)

        def alm_update(exhausted, rho, rho2):
            """Dual update on line-search exhaustion (src/cilqr_solver.cpp:
            377-379): mu <- clip(mu + rho c, 0, max_mu) on the rows each
            constraint is evaluated at, then the trajectory's cost under
            the new (mu, rho2)."""
            def upd(col, k, c, valid):
                mu = ld(alm_out, mu_row(col, k))
                mn = jnp.where(valid,
                               jnp.clip(mu + rho * c, 0.0, wv[_MAX_MU]), mu)
                st(alm_out, mu_row(col, k), mn, exhausted)

            def step(k, J):
                ua, us, s, idx = load_traj(k)
                trig = heading_trig(s)
                ref = [gat(win_ref, q * W + idx) for q in range(5)]
                cs, _ = bounds(ua, us, s, ref)
                for col in range(8):
                    upd(col, k, cs[col], (k < N) if col < 4 else (k >= 1))
                pts = ego_points(s, trig)

                def obs_body(j, carry):
                    for side, (c, _, _) in enumerate(obstacle(j, k, pts,
                                                              False)):
                        upd(8 + 2 * j + side, k, c, k >= 1)
                    return carry
                if M:
                    lax.fori_loop(_I0, jnp.int32(M), obs_body, 0)
                return J + step_cost(k, ua, us, s, trig, idx, rho2)
            return lax.fori_loop(_I0, jnp.int32(NP), step, zeros)

        # -- solve ------------------------------------------------------------
        def copy(src, dst, n):
            def body(r, carry):
                st(dst, r, ld(src, r))
                return carry
            lax.fori_loop(_I0, jnp.int32(n), body, 0)

        copy(uinit_ref, u_out, 2 * N)
        if use_alm:
            copy(alm_in, alm_out, (8 + 2 * M) * NP + 1)
            rho0 = ld(alm_in, (8 + 2 * M) * NP)
        else:
            rho0 = zeros + wv[_RHO_INIT]
        J0 = forward(None, rho0, zeros == zeros, store_cur)

        conv0 = ld(stats_ref, 2) > 0.5
        ovf0 = ld(stats_ref, 3) > 0.5
        # rows exit only via converged/overflow, so active == ~(conv|ovf)
        st0 = (wv[_IT0].astype(i32), ~(conv0 | ovf0), ld(stats_ref, 5),
               ld(stats_ref, 1).astype(i32), conv0, ovf0,
               ld(stats_ref, 0).astype(i32), rho0, J0)
        max_it = wv[_MAXIT].astype(i32)

        def iter_cond(c):
            return (c[0] < max_it) & any_(c[1])

        def iter_body(c):
            it, active, lamb, status, conv_f, ovf_f, iters, rho, cur_J = c
            dV1, dV2, bp_fail = backward(lamb, rho)
            ls_acc, ls_conv, ls_small, slot_i, nJ = line_search(
                active, bp_fail, cur_J, dV1, dV2, rho)
            ok = active & ~bp_fail
            accepted = ok & ls_acc
            converged_now = ok & ls_conv
            exhausted = ok & ~ls_acc & ~ls_conv
            bp_failed = active & bp_fail
            adopt(accepted, slot_i)
            cur_J = jnp.where(accepted, nJ, cur_J)

            status2 = jnp.where(
                bp_failed, SolveStatus.BACKWARD_PASS_FAIL,
                jnp.where(converged_now, SolveStatus.CONVERGED,
                          jnp.where(exhausted, SolveStatus.FORWARD_PASS_FAIL,
                                    jnp.where(ls_small & accepted,
                                              SolveStatus.FORWARD_PASS_SMALL_STEP,
                                              SolveStatus.RUNNING))))
            status2 = jnp.where(active, status2, status).astype(i32)
            is_fail = bp_failed | exhausted
            lamb2 = jnp.where(
                is_fail, jnp.maximum(wv[_LAMP], lamb * wv[_LAMP]),
                jnp.where(active & (status2 == SolveStatus.RUNNING),
                          lamb * wv[_LDECAY], lamb))
            overflow_now = active & (lamb2 > wv[_LMAX])
            done_now = overflow_now | converged_now
            if use_alm:
                rho2 = jnp.where(
                    exhausted,
                    jnp.minimum((1.0 + wv[_ALM_GAMMA]) * rho, wv[_MAX_RHO]),
                    rho)
                cur_J = jnp.where(exhausted, alm_update(exhausted, rho, rho2),
                                  cur_J)
                rho = rho2
            return (it + 1, active & ~done_now, lamb2, status2,
                    conv_f | converged_now, ovf_f | overflow_now,
                    iters + jnp.where(active, 1, 0), rho, cur_J)

        (_, _, lambf, statusf, convf, ovff, itersf, rhof,
         Jf) = lax.while_loop(iter_cond, iter_body, st0)

        for r, v in enumerate((itersf.astype(f32), statusf.astype(f32),
                               jnp.where(convf, f32(1.0), f32(0.0)),
                               jnp.where(ovff, f32(1.0), f32(0.0)), Jf,
                               lambf, zeros, zeros)):
            st(st_out, r, v)
        if use_alm:
            st(alm_out, (8 + 2 * M) * NP, rhof)

    return kernel, scratch_rows


def derive_proj_rows(target_velocity, dt, factor: float = 1.1):
    """Rows per horizon step for the projection search bound.

    Step k's nearest-row scan is bounded by w_back + PROJ_SLACK + k * rows
    (see :func:`cilqr_solve_pallas`). Reference-line samples are 0.1 m
    apart (src/utils.cpp:21-35), so the ego consumes ``v * dt / 0.1`` rows
    per step; the bound takes ``factor`` headroom over the TARGET velocity
    the tracking cost pulls toward. A trial that overshoots the bound only
    scans a subset of the window, which can only raise its cost (a min
    over fewer rows), so a bound that never binds on accepted trajectories
    leaves solutions unchanged; whether it binds is what the f64-anchor
    gate (tools/validate_kernel.py) checks per scenario."""
    return int(math.ceil(factor * float(target_velocity) * float(dt) / 0.1))


# straggler schedule for warm-started MPC ticks (they converge in fewer
# iterations than cold solves, so compacting earlier pays)
WARM_CAP = (6, 12, 24)


def tuned_options(gc, block: int = BLOCK) -> dict:
    """The kernel options the benchmark, the sweep and the validation gate
    pass: a 384-sample window with 24 rows behind the ego, straggler caps
    8, 16, 32, the target-velocity projection bound, 4 alphas per
    line-search sweep and dot-form projection scores. Each setting leaves
    the four shipped scenarios inside the f64-anchor gate
    (tools/validate_kernel.py)."""
    return dict(window=384, w_back=24, straggler_cap=(8, 16, 32),
                proj_rows_per_step=derive_proj_rows(
                    gc["vehicle/target_velocity"], gc["delta_t"]),
                ls_chunk=4, proj_dot=True, block=block)


def _weights_vector(w: CILQRWeights):
    vals = {
        _DT: w.dt, _WB: w.wheelbase, _WIDTH: w.width, _LENGTH: w.length,
        _DSAFE: w.d_safe, _VMAX: w.velo_max, _VMIN: w.velo_min,
        _AMAX: w.acc_max, _AMIN: w.acc_min, _STL: w.stl_lim,
        _WPOS: w.w_pos, _WVEL: w.w_vel, _WYAW: w.w_yaw, _WACC: w.w_acc,
        _WSTL: w.w_stl, _SQ1: w.state_exp_q1, _SQ2: w.state_exp_q2,
        _OQ1: w.obstacle_exp_q1, _OQ2: w.obstacle_exp_q2,
        _ILAMB: w.init_lamb, _LDECAY: w.lamb_decay, _LAMP: w.lamb_amplify,
        _LMAX: w.max_lamb, _CONV: w.convergence_threshold,
        _ACCEPT: w.accept_step_threshold, _ECLIP: w.exp_clip,
        _ALM_GAMMA: w.alm_gamma, _MAX_RHO: w.max_rho, _MAX_MU: w.max_mu,
        _RHO_INIT: w.alm_rho_init,
    }
    wt = jnp.zeros((_NWTS,), jnp.float32)
    for i, v in vals.items():
        wt = wt.at[i].set(jnp.asarray(v, jnp.float32))
    return wt


def padded_batch(B: int, block: int) -> int:
    """Rows the kernel runs for a batch of B: the next multiple of block."""
    assert block > 0 and block & (block - 1) == 0, \
        "block must be a power of two"
    return -(-B // block) * block


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "window", "interpret", "straggler_cap",
                     "proj_rows_per_step", "return_alm", "w_back",
                     "ls_chunk", "proj_dot", "block"),
)
def cilqr_solve_pallas(cfg: CILQRConfig, w: CILQRWeights, x0_b, scenario_b,
                       window: int = 512, interpret: bool = False,
                       u_init=None, straggler_cap=0,
                       proj_rows_per_step: int = 0,
                       alm_mu0=None, alm_rho0=None, return_alm: bool = False,
                       w_back: int = W_BACK, ls_chunk: int = 0,
                       proj_dot: bool = False, block: int = BLOCK):
    """Batched CILQR solve via the fused kernel.

    Args mirror :func:`ilqr_tpu.solvers.cilqr.solve_batch`. x0_b: (B, 4);
    scenario_b: Scenario with leading batch axis. B is padded to a multiple
    of ``block`` internally.

    Returns (u (B, N, 2), x (B, N+1, 4), SolveStats), plus
    (alm_mu (B, N, C), alm_rho (B,)) when ``return_alm``.

    ``interpret``: run the kernel in the Pallas interpreter (the CPU test
    vehicle). Never chosen implicitly.

    ALM warm starts: ``alm_mu0`` (B, N, C) / ``alm_rho0`` (B,) seed the dual
    state (None = the reference's cold reset, zero mu + rho_init,
    src/cilqr_solver.cpp:88-93). The warm-start *policy* lives in the
    caller, exactly as :func:`ilqr_tpu.solvers.cilqr.solve` takes it from
    the carry; pass the previous solve's ``return_alm`` outputs to carry.

    ``window``: per-scenario reference-line span in 0.1 m samples
    (``w_back`` rows behind the ego's initial projection, the rest ahead)
    that every projection searches. It must cover everything the planned
    trajectories can reach; too small a window silently distorts the
    road-border and tracking costs, which the f64-anchor gate
    (tools/validate_kernel.py) detects.

    ``straggler_cap``: straggler compaction. A block pays the *max*
    iteration count over its rows. With a cap K, phase 1 runs every row
    for at most K iterations; rows still running are then stably sorted to
    the front (one argsort + column gathers), packed into dense blocks, and
    resumed exactly where they stopped for the remaining budget; all-done
    blocks exit their solver loop immediately. Bitwise-identical results to
    a single pass (the resume carry is exact -- see ``_build_kernel``); 0
    disables. A tuple of strictly increasing caps runs a multi-phase
    schedule.

    ``proj_rows_per_step``: per-step projection search bound (see
    :func:`derive_proj_rows`); step k scans the first
    round8(w_back + PROJ_SLACK + k * this) window rows; 0 scans the whole
    window every step.

    ``ls_chunk``: line-search alphas evaluated per forward sweep; 0 = one
    (the serial early-exit loop). Bitwise-identical results at every width.

    ``proj_dot``: centered dot-form nearest-point scoring -- the same
    exact-arithmetic argmin as the squared distance, different f32
    rounding, so it matches the default statistically, not bitwise.

    ``block``: scenarios per program, a power of two, one per thread; on
    the GPU a multiple of 32 (whole warps, one element per thread, so
    every thread reads back exactly the rows it wrote).
    """
    N, M = cfg.N, cfg.num_obstacles
    NP = N + 1
    f32 = jnp.float32
    x0_b = jnp.asarray(x0_b, f32)
    B = x0_b.shape[0]
    Bp = padded_batch(B, block)
    W = window

    ref = jnp.asarray(scenario_b.ref_line, f32)  # (B, P, 4)
    P = ref.shape[1]
    # per-row window: center on the ego's initial nearest index. The start
    # is NOT clamped to P - W: near the line end the tail rows repeat the
    # last sample (ties resolve to the first copy, whose values are
    # identical), which pins the ego's initial projection at row <= w_back
    # -- the invariant the per-step search bounds rely on.
    d2 = ((ref[:, :, 0] - x0_b[:, None, 0]) ** 2
          + (ref[:, :, 1] - x0_b[:, None, 1]) ** 2)
    c = jnp.argmin(d2, axis=1)
    start = jnp.maximum(c - w_back, 0)
    gidx = jnp.minimum(start[:, None] + jnp.arange(W)[None, :], P - 1)
    win = jnp.take_along_axis(ref, gidx[:, :, None], axis=1)  # (B, W, 4)
    wins = [win[:, :, 0], win[:, :, 1], win[:, :, 2], jnp.cos(win[:, :, 2]),
            jnp.sin(win[:, :, 2])]
    if proj_dot:
        # hoisted score terms in coordinates centered on window row 0
        rxc = win[:, :, 0] - win[:, :1, 0]
        ryc = win[:, :, 1] - win[:, :1, 1]
        wins += [rxc * rxc + ryc * ryc, -2.0 * rxc, -2.0 * ryc]

    def pad_b(a):
        # Padded rows replicate the last real scenario (mode="edge") rather
        # than zeros: a zero scenario never converges, so zero rows would
        # keep their block running to max_iter and re-sort as stragglers
        # in every compaction phase. Edge copies converge exactly when
        # their source row does. Results are sliced back to [:B].
        return jnp.pad(a, ((0, Bp - B),) + ((0, 0),) * (a.ndim - 1),
                       mode="edge")

    def cols(a):
        """(B, ...) -> (rows, Bp): batch on the minor axis."""
        return pad_b(a.reshape(B, -1)).T

    x0_in = cols(jnp.concatenate(
        [x0_b, jnp.broadcast_to(scenario_b.road_borders, (B, 2)).astype(f32),
         jnp.asarray(scenario_b.ref_velo, f32).reshape(B, -1)[:, :1],
         jnp.zeros((B, 1), f32)], axis=1))  # (8, Bp)
    if u_init is None:
        uinit = jnp.zeros((2 * N, Bp), f32)
    else:
        u_init = jnp.asarray(u_init, f32)  # (B, N, 2)
        uinit = cols(jnp.concatenate([u_init[:, :, 0], u_init[:, :, 1]], 1))
    win_in = cols(jnp.concatenate(wins, axis=1))  # (nq * W, Bp)
    if M:
        obs = jnp.asarray(scenario_b.obs_preds, f32)  # (B, M, N+1, 3)
        oq = [obs[..., 0], obs[..., 1], jnp.cos(obs[..., 2]),
              jnp.sin(obs[..., 2])]
        obs_in = cols(jnp.stack(oq, axis=1))  # (4 * M * NP, Bp)
    else:
        obs_in = jnp.zeros((1, Bp), f32)

    alm = cfg.solve_type == "alm"
    C = 8 + 2 * M
    if alm:
        # dual rows: C constraint columns x NP steps + rho. Column c of the
        # (N, C) carry maps to step rows k (control cols 0-3) / k+1 (state
        # and obstacle cols), the steps each constraint is evaluated at.
        slab = jnp.zeros((B, C, NP), f32)
        if alm_mu0 is not None:
            mu_t = jnp.moveaxis(jnp.asarray(alm_mu0, f32), -1, 1)  # (B,C,N)
            slab = slab.at[:, :4, 0:N].set(mu_t[:, :4])
            slab = slab.at[:, 4:, 1:].set(mu_t[:, 4:])
        rho_in = jnp.broadcast_to(
            jnp.asarray(w.alm_rho_init if alm_rho0 is None else alm_rho0,
                        f32), (B,))
        alm_in = cols(jnp.concatenate([slab.reshape(B, C * NP),
                                       rho_in[:, None]], axis=1))
    else:
        alm_in = None

    wt = _weights_vector(w)
    n_alphas = _alpha_count(cfg.min_alpha)
    rear = cfg.reference_point == "rear_center"
    proj_bound = ((w_back, PROJ_SLACK, proj_rows_per_step)
                  if proj_rows_per_step > 0 else None)
    kernel, scratch_rows = _build_kernel(
        N, M, W, n_alphas, rear, alm, block=block, cw=max(ls_chunk, 1),
        proj_dot=proj_dot, proj_bound=proj_bound)
    out_shape = [jax.ShapeDtypeStruct((2 * N, Bp), f32),
                 jax.ShapeDtypeStruct((4 * NP, Bp), f32),
                 jax.ShapeDtypeStruct((8, Bp), f32)]
    if alm:
        out_shape.append(jax.ShapeDtypeStruct(alm_in.shape, f32))
    out_shape.append(jax.ShapeDtypeStruct((scratch_rows, Bp), f32))
    n_in = 7 if alm else 6
    solve_call = pl.pallas_call(
        kernel,
        grid=(Bp // block,),
        in_specs=[pl.no_block_spec] * n_in,
        out_specs=[pl.no_block_spec] * len(out_shape),
        out_shape=out_shape,
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=max(block // 32, 1), num_stages=1),
        interpret=interpret,
        name="cilqr_solve",
    )

    def call_kernel(it0, max_it, x0_s, u_s, stats_s, win_s, obs_s, alm_s):
        wt_k = wt.at[_IT0].set(it0).at[_MAXIT].set(max_it)
        args = (wt_k, x0_s, u_s, stats_s, win_s, obs_s) + (
            (alm_s,) if alm else ())
        outs = solve_call(*args)[:-1]  # drop the scratch
        return outs if alm else outs + (None,)

    caps = (straggler_cap if isinstance(straggler_cap, tuple)
            else ((straggler_cap,) if straggler_cap else ()))
    caps = tuple(c for c in caps if 0 < c < cfg.max_iter)
    assert all(a < b for a, b in zip(caps, caps[1:])), \
        "straggler_cap phases must be strictly increasing"
    schedule = (0,) + caps + (cfg.max_iter,)
    # cold start = a resume from zero iterations at lambda = init_lamb
    stats0 = jnp.zeros((8, Bp), f32).at[5].set(wt[_ILAMB])
    ins = [x0_in, win_in, obs_in]
    u_out, x_out, stats_out, alm_out = call_kernel(
        schedule[0], schedule[1], x0_in, uinit, stats0, win_in, obs_in,
        alm_in)
    if len(schedule) > 2:
        # order[j] = original column of current column j (composed perms)
        order = jnp.arange(Bp)
        for i in range(1, len(schedule) - 1):
            done = ((stats_out[2] > 0.5) | (stats_out[3] > 0.5)).astype(
                jnp.int32)
            perm = jnp.argsort(done)  # stable: stragglers first, order kept
            order = order[perm]
            ins = [a[:, perm] for a in ins]
            u_out, x_out, stats_out, alm_out = call_kernel(
                schedule[i], schedule[i + 1], ins[0], u_out[:, perm],
                stats_out[:, perm], ins[1], ins[2],
                alm_out[:, perm] if alm else None)
        inv = jnp.argsort(order)
        u_out = u_out[:, inv]
        x_out = x_out[:, inv]
        stats_out = stats_out[:, inv]
        if alm:
            alm_out = alm_out[:, inv]

    u = jnp.stack([u_out[0:N, :B], u_out[N:2 * N, :B]], axis=-1)
    u = jnp.moveaxis(u, 1, 0)  # (B, N, 2)
    xs = jnp.stack([x_out[q * NP:(q + 1) * NP, :B] for q in range(4)],
                   axis=-1)
    xs = jnp.moveaxis(xs, 1, 0)  # (B, N+1, 4)
    stats = SolveStats(
        iters=stats_out[0, :B].astype(jnp.int32),
        status=stats_out[1, :B].astype(jnp.int32),
        converged=stats_out[2, :B] > 0.5,
        lamb_overflow=stats_out[3, :B] > 0.5,
        final_cost=stats_out[4, :B],
        final_lamb=stats_out[5, :B],
    )
    if not return_alm:
        return u, xs, stats
    # unpack the final duals into the (B, N, C) carry layout of
    # types.CILQRCarry
    slab_f = alm_out[:C * NP].reshape(C, NP, Bp)
    mu_f = jnp.concatenate([slab_f[:4, 0:N], slab_f[4:, 1:]], axis=0)
    mu_f = jnp.transpose(mu_f, (2, 1, 0))[:B]  # (B, N, C)
    rho_f = alm_out[C * NP, :B]
    return u, xs, stats, (mu_f, rho_f)
