// Native scenario generator: cubic-spline reference lines + agent routing.
//
// The host-side "data loader" of the framework: batched sweeps feed the GPU
// thousands of scenario variants (initial states x obstacle routings x
// noise draws); generating those on the Python side is a per-tick
// interpreter loop, so the hot path lives here instead. Same math as
// ilqr_tpu/utils/splines.py + ilqr_tpu/sim/scenario.py (which mirror the
// reference's src/cubic_spline.cpp and src/motion_planning.cpp:121-174):
// natural cubic splines fitted with the O(n) Thomas algorithm, dense
// arc-length sampling with float64 accumulation, constant-speed advance
// along s with optional truncated-normal position noise.
//
// Build: g++ -O3 -march=native -shared -fPIC -fopenmp scenario_gen.cpp
//        -o libscenario_gen.so   (see ilqr_tpu/native/__init__.py)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <random>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct Spline {
  std::vector<double> x, a, b, c, d;  // knots + per-segment coefficients

  void fit(const double* xs, const double* ys, int64_t n) {
    x.assign(xs, xs + n);
    a.assign(ys, ys + n);
    std::vector<double> h(n - 1);
    for (int64_t i = 0; i + 1 < n; ++i) h[i] = x[i + 1] - x[i];

    // natural boundary conditions: tridiagonal system, Thomas algorithm
    std::vector<double> diag(n, 1.0), upper(n, 0.0), lower(n, 0.0), rhs(n, 0.0);
    for (int64_t i = 1; i + 1 < n; ++i) {
      lower[i] = h[i - 1];
      diag[i] = 2.0 * (h[i - 1] + h[i]);
      upper[i] = h[i];
      rhs[i] = 3.0 * (a[i + 1] - a[i]) / h[i] - 3.0 * (a[i] - a[i - 1]) / h[i - 1];
    }
    std::vector<double> cp(n, 0.0), dp(n, 0.0);
    cp[0] = upper[0] / diag[0];
    dp[0] = rhs[0] / diag[0];
    for (int64_t i = 1; i < n; ++i) {
      double den = diag[i] - lower[i] * cp[i - 1];
      cp[i] = (i + 1 < n) ? upper[i] / den : 0.0;
      dp[i] = (rhs[i] - lower[i] * dp[i - 1]) / den;
    }
    c.assign(n, 0.0);
    c[n - 1] = dp[n - 1];
    for (int64_t i = n - 2; i >= 0; --i) c[i] = dp[i] - cp[i] * c[i + 1];

    b.assign(n - 1, 0.0);
    d.assign(n - 1, 0.0);
    for (int64_t i = 0; i + 1 < n; ++i) {
      d[i] = (c[i + 1] - c[i]) / (3.0 * h[i]);
      b[i] = (a[i + 1] - a[i]) / h[i] - h[i] * (c[i + 1] + 2.0 * c[i]) / 3.0;
    }
  }

  int64_t segment(double t) const {
    auto it = std::upper_bound(x.begin(), x.end(), t);
    int64_t i = static_cast<int64_t>(it - x.begin()) - 1;
    return std::clamp<int64_t>(i, 0, static_cast<int64_t>(x.size()) - 2);
  }

  double eval(double t) const {
    int64_t i = segment(t);
    double dx = t - x[i];
    return a[i] + b[i] * dx + c[i] * dx * dx + d[i] * dx * dx * dx;
  }

  double deriv(double t) const {
    int64_t i = segment(t);
    double dx = t - x[i];
    return b[i] + 2.0 * c[i] * dx + 3.0 * d[i] * dx * dx;
  }
};

struct Spline2D {
  Spline sx, sy;
  std::vector<double> s;

  void fit(const double* kx, const double* ky, int64_t n) {
    s.assign(n, 0.0);
    for (int64_t i = 1; i < n; ++i)
      s[i] = s[i - 1] + std::hypot(kx[i] - kx[i - 1], ky[i] - ky[i - 1]);
    sx.fit(s.data(), kx, n);
    sy.fit(s.data(), ky, n);
  }

  double length() const { return s.back(); }

  void position(double t, double* px, double* py) const {
    *px = sx.eval(t);
    *py = sy.eval(t);
  }

  double yaw(double t) const { return std::atan2(sy.deriv(t), sx.deriv(t)); }

  // laterally-offset point (ReferenceLine::calc_position semantics)
  void offset_position(double t, double width, double* lx, double* ly,
                       double* lyaw) const {
    double px, py;
    position(t, &px, &py);
    double th = yaw(t);
    *lx = px - width * std::sin(th);
    *ly = py + width * std::cos(th);
    *lyaw = th;
  }
};

double truncated_normal(std::mt19937_64& eng, double mean, double std) {
  std::normal_distribution<double> dist(mean, std);
  double v = dist(eng);
  while (v > 3 * std || v < -3 * std) v = dist(eng);
  return v;
}

}  // namespace

extern "C" {

// Dense offset reference line from knots. out rows are [x, y, yaw, s].
// Returns the number of samples written (call with out == nullptr /
// cap == 0 to query the count).
int64_t ilqr_refline_build(const double* kx, const double* ky, int64_t n_knots,
                           double width, double accuracy, double* out,
                           int64_t cap) {
  Spline2D sp;
  sp.fit(kx, ky, n_knots);
  int64_t count = 0;
  // float64 accumulation, endpoint inclusive -- matches the reference loop
  for (double t = 0.0; t <= sp.length(); t += accuracy) {
    if (out != nullptr && count < cap) {
      double lx, ly, lyaw;
      sp.offset_position(t, width, &lx, &ly, &lyaw);
      out[count * 4 + 0] = lx;
      out[count * 4 + 1] = ly;
      out[count * 4 + 2] = lyaw;
      out[count * 4 + 3] = t;
    }
    ++count;
  }
  return count;
}

// One agent routing line along a center line (by knots + lateral width).
// out rows are [x, y, yaw]; returns tick count.
int64_t ilqr_routing_generate(const double* kx, const double* ky,
                              int64_t n_knots, double line_width,
                              double start_s, double v0, double yaw0,
                              double delta_t, double total_time, int add_noise,
                              uint64_t seed, double noise_std, double* out,
                              int64_t cap) {
  Spline2D sp;
  sp.fit(kx, ky, n_knots);
  std::mt19937_64 eng(seed);
  std::uniform_real_distribution<double> coin(0.0, 1.0);
  const double pi = 3.14159265358979323846;
  int64_t count = 0;
  for (double t = 0.0; t < total_time; t += delta_t) {
    double cur_s, lx, ly, lyaw;
    if (yaw0 <= pi / 2) {
      cur_s = std::min(start_s + t * v0, sp.length());
      sp.offset_position(cur_s, line_width, &lx, &ly, &lyaw);
    } else {
      cur_s = std::max(start_s - t * v0, 0.0);
      sp.offset_position(cur_s, line_width, &lx, &ly, &lyaw);
      lyaw = std::fmod(lyaw + pi, 2 * pi);
    }
    if (add_noise && coin(eng) >= 0.5) {
      lx += truncated_normal(eng, 0.0, noise_std);
      ly += truncated_normal(eng, 0.0, noise_std);
    }
    if (out != nullptr && count < cap) {
      out[count * 3 + 0] = lx;
      out[count * 3 + 1] = ly;
      out[count * 3 + 2] = lyaw;
    }
    ++count;
  }
  return count;
}

// Batched routing variants: one (V, T, 3) block per seed, OpenMP across
// (variant, vehicle) pairs. Vehicle 0 (ego) never gets noise.
//   knots:      (L, n_knots, 2) center-line knots (shared x/y layout)
//   line_width: (L,)
//   veh_line:   (V,) index of each vehicle's snapped center line
//   veh_start:  (V,) start_s ; veh_v0 (V,) ; veh_yaw0 (V,)
//   out:        (n_variants, V, T, 3)
void ilqr_routing_generate_batch(const double* knots, const double* widths,
                                 int64_t L, int64_t n_knots,
                                 const int64_t* veh_line,
                                 const double* veh_start, const double* veh_v0,
                                 const double* veh_yaw0, int64_t V,
                                 double delta_t, double total_time,
                                 int add_noise, uint64_t seed,
                                 double noise_std, int64_t n_variants,
                                 int64_t T, double* out) {
  // fit each center line once
  std::vector<Spline2D> lines(L);
  for (int64_t l = 0; l < L; ++l)
    lines[l].fit(knots + l * n_knots * 2, knots + l * n_knots * 2 + n_knots, n_knots);

  const double pi = 3.14159265358979323846;
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t var = 0; var < n_variants; ++var) {
    for (int64_t v = 0; v < V; ++v) {
      const Spline2D& sp = lines[veh_line[v]];
      double width = widths[veh_line[v]];
      std::mt19937_64 eng(seed + 1315423911ull * var + 2654435761ull * v);
      std::uniform_real_distribution<double> coin(0.0, 1.0);
      double* row = out + ((var * V + v) * T) * 3;
      int64_t k = 0;
      for (double t = 0.0; t < total_time && k < T; t += delta_t, ++k) {
        double cur_s, lx, ly, lyaw;
        if (veh_yaw0[v] <= pi / 2) {
          cur_s = std::min(veh_start[v] + t * veh_v0[v], sp.length());
          sp.offset_position(cur_s, width, &lx, &ly, &lyaw);
        } else {
          cur_s = std::max(veh_start[v] - t * veh_v0[v], 0.0);
          sp.offset_position(cur_s, width, &lx, &ly, &lyaw);
          lyaw = std::fmod(lyaw + pi, 2 * pi);
        }
        if (add_noise && v != 0 && coin(eng) >= 0.5) {
          lx += truncated_normal(eng, 0.0, noise_std);
          ly += truncated_normal(eng, 0.0, noise_std);
        }
        row[k * 3 + 0] = lx;
        row[k * 3 + 1] = ly;
        row[k * 3 + 2] = lyaw;
      }
      // pad any remaining ticks with the last sample
      for (; k < T; ++k) {
        row[k * 3 + 0] = row[(k - 1) * 3 + 0];
        row[k * 3 + 1] = row[(k - 1) * 3 + 1];
        row[k * 3 + 2] = row[(k - 1) * 3 + 2];
      }
    }
  }
}

}  // extern "C"
