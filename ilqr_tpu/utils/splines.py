"""Natural cubic splines.

Behavioural parity with the reference's ``CubicSpline``/``CubicSpline2D``
(reference: src/cubic_spline.cpp:17-193 and scripts/utils/cubic_spline.py):
natural boundary conditions (second derivative zero at both ends), arc-length
parameterized 2-D variant with yaw/curvature, and a dense course sampler.

Design differences (batched-first, not a translation):

- the tridiagonal natural-spline system is solved with the O(n) Thomas
  algorithm instead of the reference's dense ``colPivHouseholderQr``
  (src/cubic_spline.cpp:29) -- identical solution, linear time;
- fitting is done host-side in float64 (splines are static per scenario),
  while *evaluation* is expressed as vectorized gather + polynomial ops so
  it jits/vmaps on device (``eval_spline``);
- a pure-JAX fit (``fit_natural_cubic``) is provided for building splines
  inside a jitted program (e.g. batched scenario generation on device).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax


def _thomas_solve(lower, diag, upper, rhs):
    """Solve a tridiagonal system (numpy, host-side)."""
    n = len(diag)
    c = np.zeros(n)
    d = np.zeros(n)
    c[0] = upper[0] / diag[0]
    d[0] = rhs[0] / diag[0]
    for i in range(1, n):
        den = diag[i] - lower[i] * c[i - 1]
        c[i] = upper[i] / den if i < n - 1 else 0.0
        d[i] = (rhs[i] - lower[i] * d[i - 1]) / den
    x = np.zeros(n)
    x[-1] = d[-1]
    for i in range(n - 2, -1, -1):
        x[i] = d[i] - c[i] * x[i + 1]
    return x


def _natural_spline_coeffs(x: np.ndarray, y: np.ndarray):
    """Natural-cubic coefficients (a, b, c, d) per knot.

    Same linear system as reference src/cubic_spline.cpp:41-68:
      A c = B with A tridiagonal, first/last rows identity (c0 = cn = 0).
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = len(x)
    h = np.diff(x)
    if np.any(h < 0):
        raise ValueError("x coordinates must be sorted in ascending order")
    a = y.copy()
    # tridiagonal rows: row0: c0 = 0 ; rows 1..n-2: h[i-1] c_{i-1} +
    # 2(h[i-1]+h[i]) c_i + h[i] c_{i+1} = rhs ; row n-1: c_{n-1} = 0
    lower = np.zeros(n)
    diag = np.ones(n)
    upper = np.zeros(n)
    rhs = np.zeros(n)
    for i in range(1, n - 1):
        lower[i] = h[i - 1]
        diag[i] = 2.0 * (h[i - 1] + h[i])
        upper[i] = h[i]
        rhs[i] = 3.0 * (a[i + 1] - a[i]) / h[i] - 3.0 * (a[i] - a[i - 1]) / h[i - 1]
    c = _thomas_solve(lower, diag, upper, rhs)
    b = np.zeros(n - 1)
    d = np.zeros(n - 1)
    for i in range(n - 1):
        d[i] = (c[i + 1] - c[i]) / (3.0 * h[i])
        b[i] = (a[i + 1] - a[i]) / h[i] - h[i] * (c[i + 1] + 2.0 * c[i]) / 3.0
    return a, b, c[:n], d


def fit_natural_cubic(x, y):
    """Pure-JAX natural-cubic fit (Thomas algorithm as two lax.scans).

    Same math as the host-side fit; usable inside jit for device-side
    scenario construction. Returns (a, b, c, d) arrays (a,c length n; b,d
    length n-1).
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    n = x.shape[0]
    h = jnp.diff(x)
    a = y
    lower = jnp.concatenate([jnp.zeros(1, x.dtype), h[:-1], jnp.zeros(1, x.dtype)])
    diag = jnp.concatenate(
        [jnp.ones(1, x.dtype), 2.0 * (h[:-1] + h[1:]), jnp.ones(1, x.dtype)]
    )
    upper = jnp.concatenate([jnp.zeros(1, x.dtype), h[1:], jnp.zeros(1, x.dtype)])
    interior = 3.0 * (a[2:] - a[1:-1]) / h[1:] - 3.0 * (a[1:-1] - a[:-2]) / h[:-1]
    rhs = jnp.concatenate([jnp.zeros(1, x.dtype), interior, jnp.zeros(1, x.dtype)])

    # forward elimination
    def fwd(carry, inp):
        c_prev, d_prev = carry
        lo, di, up, r = inp
        den = di - lo * c_prev
        c_i = up / den
        d_i = (r - lo * d_prev) / den
        return (c_i, d_i), (c_i, d_i)

    (_, _), (cs, ds) = lax.scan(
        fwd, (jnp.zeros((), x.dtype), jnp.zeros((), x.dtype)), (lower, diag, upper, rhs)
    )

    # back substitution
    def bwd(x_next, cd):
        c_i, d_i = cd
        x_i = d_i - c_i * x_next
        return x_i, x_i

    _, sol_rev = lax.scan(bwd, jnp.zeros((), x.dtype), (cs[::-1], ds[::-1]))
    c = sol_rev[::-1]
    d = (c[1:] - c[:-1]) / (3.0 * h)
    b = (a[1:] - a[:-1]) / h - h * (c[1:] + 2.0 * c[:-1]) / 3.0
    return a, b, c, d


def eval_spline(knots_x, a, b, c, d, t, dd: int = 0):
    """Evaluate a fitted cubic spline (jit/vmap friendly; clamps to range).

    dd = 0/1/2 selects position / first / second derivative, matching
    ``CubicSpline::operator()`` (reference src/cubic_spline.cpp:109-124).
    """
    knots_x = jnp.asarray(knots_x)
    t = jnp.asarray(t)
    idx = jnp.clip(jnp.searchsorted(knots_x, t, side="right") - 1, 0, knots_x.shape[0] - 2)
    dx = t - knots_x[idx]
    if dd == 0:
        return a[idx] + b[idx] * dx + c[idx] * dx**2 + d[idx] * dx**3
    if dd == 1:
        return b[idx] + 2.0 * c[idx] * dx + 3.0 * d[idx] * dx**2
    if dd == 2:
        return 2.0 * c[idx] + 6.0 * d[idx] * dx
    raise ValueError("dd must be 0, 1 or 2")


class CubicSpline1D:
    """Host-fitted natural cubic spline over (x, y) knots."""

    def __init__(self, x, y):
        self.x = np.asarray(x, dtype=np.float64)
        self.y = np.asarray(y, dtype=np.float64)
        self.a, self.b, self.c, self.d = _natural_spline_coeffs(self.x, self.y)

    def _index(self, t):
        t = np.asarray(t, dtype=np.float64)
        return np.clip(np.searchsorted(self.x, t, side="right") - 1, 0, len(self.x) - 2)

    def calc_position(self, t):
        i = self._index(t)
        dx = np.asarray(t, dtype=np.float64) - self.x[i]
        return self.a[i] + self.b[i] * dx + self.c[i] * dx**2 + self.d[i] * dx**3

    def calc_first_derivative(self, t):
        i = self._index(t)
        dx = np.asarray(t, dtype=np.float64) - self.x[i]
        return self.b[i] + 2.0 * self.c[i] * dx + 3.0 * self.d[i] * dx**2

    def calc_second_derivative(self, t):
        i = self._index(t)
        dx = np.asarray(t, dtype=np.float64) - self.x[i]
        return 2.0 * self.c[i] + 6.0 * self.d[i] * dx

    def __call__(self, t, dd: int = 0):
        if dd == 0:
            return self.calc_position(t)
        if dd == 1:
            return self.calc_first_derivative(t)
        if dd == 2:
            return self.calc_second_derivative(t)
        raise ValueError("dd must be 0, 1 or 2")


class CubicSpline2D:
    """Arc-length-parameterized 2-D spline (reference src/cubic_spline.cpp:126-175)."""

    def __init__(self, x, y):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        ds = np.hypot(np.diff(x), np.diff(y))
        self.s = np.concatenate([[0.0], np.cumsum(ds)])
        self.sx = CubicSpline1D(self.s, x)
        self.sy = CubicSpline1D(self.s, y)

    def calc_position(self, s):
        return self.sx.calc_position(s), self.sy.calc_position(s)

    def calc_yaw(self, s):
        dx = self.sx.calc_first_derivative(s)
        dy = self.sy.calc_first_derivative(s)
        return np.arctan2(dy, dx)

    def calc_curvature(self, s):
        dx = self.sx.calc_first_derivative(s)
        ddx = self.sx.calc_second_derivative(s)
        dy = self.sy.calc_first_derivative(s)
        ddy = self.sy.calc_second_derivative(s)
        return (ddy * dx - ddx * dy) / np.power(dx * dx + dy * dy, 1.5)


def calc_spline_course(x, y, ds: float = 0.1):
    """Dense (x, y, yaw, curvature, s) course along the spline.

    Matches reference scripts/utils/cubic_spline.py:244-256 (which demo 1
    consumes) -- the sample grid runs from s[0] to s[-1] *exclusive* with
    step ds via accumulation.
    """
    sp = CubicSpline2D(x, y)
    s_samples = []
    s = float(sp.s[0])
    while s < sp.s[-1]:
        s_samples.append(s)
        s += ds
    s_arr = np.asarray(s_samples, dtype=np.float64)
    rx, ry = sp.calc_position(s_arr)
    ryaw = sp.calc_yaw(s_arr)
    rk = sp.calc_curvature(s_arr)
    return rx, ry, ryaw, rk, s_arr
