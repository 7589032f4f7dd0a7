// Minimal Eigen-compatible shim -- just enough API surface to compile the
// reference's solver sources (src/cilqr_solver.cpp, src/utils.cpp,
// src/cubic_spline.cpp) UNMODIFIED on a box with no Eigen headers
// and no network. This is NOT Eigen: eager evaluation, no
// expression templates, runtime dimension checks only. Numerical
// semantics notes:
//   - storage and linear indexing are column-major like Eigen;
//   - matmul is the naive ascending-k triple loop (same accumulation
//     order Eigen uses for the small coefficient-wise products at these
//     sizes, but not guaranteed bitwise);
//   - .inverse() for 2x2 uses Eigen's analytic cofactor formula;
//   - LLT mirrors Eigen's llt_inplace failure rule (diag <= 0 =>
//     NumericalIssue);
//   - colPivHouseholderQr().solve() is implemented as partial-pivot
//     Gaussian elimination (solutions agree to ~1e-14 on the
//     well-conditioned tridiagonal spline systems it is used for).
// These deviations bound golden fidelity at the f64-roundoff level, not
// bitwise -- see tools/cpp_oracle/README.md.

#pragma once

#define EIGEN_MAKE_ALIGNED_OPERATOR_NEW

#include <algorithm>
#include <cassert>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <initializer_list>
#include <vector>

namespace Eigen {

enum ComputationInfo { Success = 0, NumericalIssue = 1, NoConvergence = 2, InvalidInput = 3 };

constexpr int Dynamic = -1;

class Mat;
class BlockRef;
class ArrayX;
template <int R, int C> class MatrixRC;
using MatrixXd = MatrixRC<Dynamic, Dynamic>;

// ------------------------------------------------------------------ core
class Mat {
  public:
    int rows_ = 0, cols_ = 0;
    std::vector<double> d;  // column-major

    Mat() {}
    Mat(int r, int c) : rows_(r), cols_(c), d(size_t(r) * c, 0.0) {}

    int rows() const { return rows_; }
    int cols() const { return cols_; }
    long size() const { return long(rows_) * cols_; }
    bool isVector() const { return rows_ == 1 || cols_ == 1; }

    double& at(int r, int c) { return d[size_t(r) + size_t(c) * rows_]; }
    double at(int r, int c) const { return d[size_t(r) + size_t(c) * rows_]; }

    double& operator()(int r, int c) { return at(r, c); }
    double operator()(int r, int c) const { return at(r, c); }
    // linear indexing: column-major, like Eigen
    double& operator()(int i) { return d[i]; }
    double operator()(int i) const { return d[i]; }
    double& operator[](int i) { return d[i]; }
    double operator[](int i) const { return d[i]; }
    double* data() { return d.data(); }
    const double* data() const { return d.data(); }
    // vector coordinate accessors
    double x() const { return d[0]; }
    double y() const { return d[1]; }
    double z() const { return d[2]; }
    double& x() { return d[0]; }
    double& y() { return d[1]; }
    double& z() { return d[2]; }

    void resize(int r, int c) { rows_ = r; cols_ = c; d.assign(size_t(r) * c, 0.0); }
    void setZero() { std::fill(d.begin(), d.end(), 0.0); }
    void setZero(int r, int c) { resize(r, c); }
    void setOnes() { std::fill(d.begin(), d.end(), 1.0); }
    void setIdentity() {
        setZero();
        for (int i = 0; i < std::min(rows_, cols_); ++i) at(i, i) = 1.0;
    }
    void setConstant(double v) { std::fill(d.begin(), d.end(), v); }

    // reductions
    double norm() const {
        double s = 0;
        for (double v : d) s += v * v;
        return std::sqrt(s);
    }
    double squaredNorm() const {
        double s = 0;
        for (double v : d) s += v * v;
        return s;
    }
    double sum() const {
        double s = 0;
        for (double v : d) s += v;
        return s;
    }
    double mean() const { return sum() / double(size()); }
    double trace() const {
        double s = 0;
        for (int i = 0; i < std::min(rows_, cols_); ++i) s += at(i, i);
        return s;
    }
    double minCoeff() const { return *std::min_element(d.begin(), d.end()); }
    double maxCoeff() const { return *std::max_element(d.begin(), d.end()); }
    double dot(const Mat& o) const {
        assert(size() == o.size());
        double s = 0;
        for (long i = 0; i < size(); ++i) s += d[i] * o.d[i];
        return s;
    }

    // proxies / slices (defined after BlockRef)
    inline BlockRef row(int i);
    inline BlockRef col(int j);
    inline BlockRef block(int r0, int c0, int nr, int nc);
    template <int NR, int NC> inline BlockRef block(int r0, int c0);
    inline BlockRef head(int n);
    inline BlockRef tail(int n);
    inline BlockRef segment(int i0, int n);
    inline BlockRef topRows(int n);
    inline BlockRef bottomRows(int n);
    inline BlockRef leftCols(int n);
    inline BlockRef rightCols(int n);
    inline MatrixXd row(int i) const;
    inline MatrixXd col(int j) const;
    inline MatrixXd block(int r0, int c0, int nr, int nc) const;
    inline MatrixXd head(int n) const;
    inline MatrixXd bottomRows(int n) const;
    inline MatrixXd topRows(int n) const;

    inline MatrixXd transpose() const;
    inline MatrixXd inverse() const;
    inline MatrixXd replicate(int a, int b) const;
    template <typename F> inline MatrixXd unaryExpr(F f) const;
    inline ArrayX array() const;
    inline MatrixXd cwiseProduct(const Mat& o) const;
    inline MatrixXd cwiseAbs() const;
    inline class QrSolver colPivHouseholderQr() const;

    // copy a same-shape (or vector-orientation-mismatched) matrix in
    void assign_from(const Mat& o) {
        if (rows_ == o.rows_ && cols_ == o.cols_) {
            d = o.d;
            return;
        }
        // Eigen allows vector = vector with different orientation
        if (isVector() && o.isVector() && size() == o.size()) {
            for (long i = 0; i < size(); ++i) d[i] = o.d[i];
            return;
        }
        std::fprintf(stderr, "eigen_mini: shape mismatch assign (%dx%d) <- (%dx%d)\n",
                     rows_, cols_, o.rows_, o.cols_);
        std::abort();
    }
};

// ------------------------------------------------------- typed wrapper
template <int R, int C> class MatrixRC : public Mat {
  public:
    MatrixRC() : Mat(R < 0 ? 0 : R, C < 0 ? (R < 0 ? 0 : 1) : C) {
        // fixed dims pre-size; VectorXd default = 0x1
        if (R < 0 && C < 0) { rows_ = 0; cols_ = 0; d.clear(); }
    }
    MatrixRC(int r, int c) : Mat(r, c) {}
    explicit MatrixRC(int n) : Mat(C == 1 ? n : (R < 0 ? n : R), C == 1 ? 1 : n) {
        // VectorXd v(n) / ArrayXd-like; for Matrix2Xd(2, n) use (r, c) ctor
    }
    MatrixRC(std::initializer_list<double> vals) : Mat(0, 0) {
        // brace init for fixed vectors: Vector2d{a, b}
        rows_ = int(vals.size());
        cols_ = 1;
        d.assign(vals.begin(), vals.end());
    }
    MatrixRC(const Mat& o) : Mat(o.rows_, o.cols_) {
        d = o.d;
        check_fixed();
    }
    inline MatrixRC(const ArrayX& a);  // defined after ArrayX
    MatrixRC& operator=(const Mat& o) {
        rows_ = o.rows_;
        cols_ = o.cols_;
        d = o.d;
        check_fixed();  // handles vector orientation flips; aborts on true
                        // shape mismatch
        return *this;
    }

    void check_fixed() {
        if (R >= 0 && rows_ != R) {
            if (isVector() && size() == R && C == 1) {  // row->col vector flip
                rows_ = R; cols_ = 1;
            } else {
                std::fprintf(stderr, "eigen_mini: fixed rows %d got %dx%d\n", R, rows_, cols_);
                std::abort();
            }
        }
        if (C >= 0 && cols_ != C) {
            if (isVector() && size() == C && R == 1) {
                rows_ = 1; cols_ = C;
            } else {
                std::fprintf(stderr, "eigen_mini: fixed cols %d got %dx%d\n", C, rows_, cols_);
                std::abort();
            }
        }
    }

    static MatrixRC Zero() { static_assert(R >= 0 && C >= 0, "dims"); return MatrixRC(); }
    static MatrixRC Zero(int r, int c) { return MatrixRC(r, c); }
    static MatrixRC Zero(int n) {
        if (C == 1) return MatrixRC(n, 1);
        return MatrixRC(n, n);
    }
    static MatrixRC Identity() {
        MatrixRC m;
        m.setIdentity();
        return m;
    }
    static MatrixRC Identity(int r, int c) {
        MatrixRC m(r, c);
        m.setIdentity();
        return m;
    }
    static MatrixRC Constant(int n, double v) {
        MatrixRC m(C == 1 ? n : n, C == 1 ? 1 : n);
        m.setConstant(v);
        return m;
    }
    static MatrixRC Constant(int r, int c, double v) {
        MatrixRC m(r, c);
        m.setConstant(v);
        return m;
    }
    static MatrixRC LinSpaced(int n, double lo, double hi) {
        MatrixRC m(n, 1);
        for (int i = 0; i < n; ++i)
            m.d[i] = n == 1 ? lo : lo + (hi - lo) * double(i) / double(n - 1);
        return m;
    }
};

using Matrix2d = MatrixRC<2, 2>;
using Matrix3d = MatrixRC<3, 3>;
using Matrix4d = MatrixRC<4, 4>;
using Vector2d = MatrixRC<2, 1>;
using Vector3d = MatrixRC<3, 1>;
using Vector4d = MatrixRC<4, 1>;
using VectorXd = MatrixRC<Dynamic, 1>;
using RowVectorXd = MatrixRC<1, Dynamic>;
using MatrixX2d = MatrixRC<Dynamic, 2>;
using MatrixX3d = MatrixRC<Dynamic, 3>;
using MatrixX4d = MatrixRC<Dynamic, 4>;
using Matrix2Xd = MatrixRC<2, Dynamic>;
using Matrix3Xd = MatrixRC<3, Dynamic>;
using ArrayXd = ArrayX;  // defined below; alias completed there

// Eigen-compatible spelling: Matrix<Scalar, Rows, Cols[, Options...]>
// (only double is supported; extra params ignored)
template <typename S, int R, int C, int O = 0, int MR = R, int MC = C>
using Matrix = MatrixRC<R, C>;

// ----------------------------------------------------------- block proxy
// Write-through proxy: IS-A MatrixXd holding a snapshot copy (so every
// read-only Mat method works), with assignment/compound ops and
// setZero/setIdentity shadowed to write back into the parent. Chained
// proxies (block of a block) are read-only -- not used for writes by the
// reference sources (verified by grep; see the build script header).
class BlockRef : public MatrixXd {
  public:
    Mat* parent_;
    int r0_, c0_;

    BlockRef(Mat* p, int r0, int c0, int nr, int nc)
        : MatrixXd(nr, nc), parent_(p), r0_(r0), c0_(c0) {
        for (int c = 0; c < nc; ++c)
            for (int r = 0; r < nr; ++r) at(r, c) = p->at(r0 + r, c0 + c);
    }

    void write_back() {
        for (int c = 0; c < cols_; ++c)
            for (int r = 0; r < rows_; ++r) parent_->at(r0_ + r, c0_ + c) = at(r, c);
    }

    BlockRef& operator=(const Mat& o) {
        Mat::assign_from(o);
        write_back();
        return *this;
    }
    BlockRef& operator=(const BlockRef& o) { return operator=(static_cast<const Mat&>(o)); }
    BlockRef& operator+=(const Mat& o) {
        assert(size() == o.size());
        for (long i = 0; i < size(); ++i) d[i] += o.d[i];
        write_back();
        return *this;
    }
    BlockRef& operator-=(const Mat& o) {
        assert(size() == o.size());
        for (long i = 0; i < size(); ++i) d[i] -= o.d[i];
        write_back();
        return *this;
    }
    void setZero() {
        Mat::setZero();
        write_back();
    }
    void setIdentity() {
        Mat::setIdentity();
        write_back();
    }
};

inline BlockRef Mat::row(int i) { return BlockRef(this, i, 0, 1, cols_); }
inline BlockRef Mat::col(int j) { return BlockRef(this, 0, j, rows_, 1); }
inline BlockRef Mat::block(int r0, int c0, int nr, int nc) { return BlockRef(this, r0, c0, nr, nc); }
template <int NR, int NC> inline BlockRef Mat::block(int r0, int c0) {
    return BlockRef(this, r0, c0, NR, NC);
}
inline BlockRef Mat::head(int n) {
    return cols_ == 1 ? BlockRef(this, 0, 0, n, 1) : BlockRef(this, 0, 0, 1, n);
}
inline BlockRef Mat::tail(int n) {
    return cols_ == 1 ? BlockRef(this, rows_ - n, 0, n, 1) : BlockRef(this, 0, cols_ - n, 1, n);
}
inline BlockRef Mat::segment(int i0, int n) {
    return cols_ == 1 ? BlockRef(this, i0, 0, n, 1) : BlockRef(this, 0, i0, 1, n);
}
inline BlockRef Mat::topRows(int n) { return BlockRef(this, 0, 0, n, cols_); }
inline BlockRef Mat::bottomRows(int n) { return BlockRef(this, rows_ - n, 0, n, cols_); }
inline BlockRef Mat::leftCols(int n) { return BlockRef(this, 0, 0, rows_, n); }
inline BlockRef Mat::rightCols(int n) { return BlockRef(this, 0, cols_ - n, rows_, n); }

inline MatrixXd Mat::row(int i) const {
    MatrixXd m(1, cols_);
    for (int c = 0; c < cols_; ++c) m.at(0, c) = at(i, c);
    return m;
}
inline MatrixXd Mat::col(int j) const {
    MatrixXd m(rows_, 1);
    for (int r = 0; r < rows_; ++r) m.at(r, 0) = at(r, j);
    return m;
}
inline MatrixXd Mat::block(int r0, int c0, int nr, int nc) const {
    MatrixXd m(nr, nc);
    for (int c = 0; c < nc; ++c)
        for (int r = 0; r < nr; ++r) m.at(r, c) = at(r0 + r, c0 + c);
    return m;
}
inline MatrixXd Mat::head(int n) const {
    return cols_ == 1 ? block(0, 0, n, 1) : block(0, 0, 1, n);
}
inline MatrixXd Mat::bottomRows(int n) const { return block(rows_ - n, 0, n, cols_); }
inline MatrixXd Mat::topRows(int n) const { return block(0, 0, n, cols_); }

inline MatrixXd Mat::transpose() const {
    MatrixXd m(cols_, rows_);
    for (int c = 0; c < cols_; ++c)
        for (int r = 0; r < rows_; ++r) m.at(c, r) = at(r, c);
    return m;
}

inline MatrixXd Mat::replicate(int a, int b) const {
    MatrixXd m(rows_ * a, cols_ * b);
    for (int i = 0; i < a; ++i)
        for (int j = 0; j < b; ++j)
            for (int c = 0; c < cols_; ++c)
                for (int r = 0; r < rows_; ++r) m.at(i * rows_ + r, j * cols_ + c) = at(r, c);
    return m;
}

template <typename F> inline MatrixXd Mat::unaryExpr(F f) const {
    MatrixXd m(rows_, cols_);
    for (long i = 0; i < size(); ++i) m.d[i] = f(d[i]);
    return m;
}

inline MatrixXd Mat::cwiseProduct(const Mat& o) const {
    assert(rows_ == o.rows_ && cols_ == o.cols_);
    MatrixXd m(rows_, cols_);
    for (long i = 0; i < size(); ++i) m.d[i] = d[i] * o.d[i];
    return m;
}

inline MatrixXd Mat::cwiseAbs() const {
    MatrixXd m(rows_, cols_);
    for (long i = 0; i < size(); ++i) m.d[i] = std::fabs(d[i]);
    return m;
}

// 2x2 analytic inverse (Eigen's cofactor path for small fixed sizes);
// general size falls back to Gauss-Jordan with partial pivoting.
inline MatrixXd Mat::inverse() const {
    assert(rows_ == cols_);
    int n = rows_;
    MatrixXd out(n, n);
    if (n == 1) {
        out.at(0, 0) = 1.0 / at(0, 0);
        return out;
    }
    if (n == 2) {
        double det = at(0, 0) * at(1, 1) - at(0, 1) * at(1, 0);
        double inv = 1.0 / det;
        out.at(0, 0) = at(1, 1) * inv;
        out.at(0, 1) = -at(0, 1) * inv;
        out.at(1, 0) = -at(1, 0) * inv;
        out.at(1, 1) = at(0, 0) * inv;
        return out;
    }
    MatrixXd a(n, 2 * n);
    for (int c = 0; c < n; ++c)
        for (int r = 0; r < n; ++r) a.at(r, c) = at(r, c);
    for (int i = 0; i < n; ++i) a.at(i, n + i) = 1.0;
    for (int k = 0; k < n; ++k) {
        int piv = k;
        for (int r = k + 1; r < n; ++r)
            if (std::fabs(a.at(r, k)) > std::fabs(a.at(piv, k))) piv = r;
        for (int c = 0; c < 2 * n; ++c) std::swap(a.at(k, c), a.at(piv, c));
        double p = a.at(k, k);
        for (int c = 0; c < 2 * n; ++c) a.at(k, c) /= p;
        for (int r = 0; r < n; ++r) {
            if (r == k) continue;
            double f = a.at(r, k);
            for (int c = 0; c < 2 * n; ++c) a.at(r, c) -= f * a.at(k, c);
        }
    }
    for (int c = 0; c < n; ++c)
        for (int r = 0; r < n; ++r) out.at(r, c) = a.at(r, n + c);
    return out;
}

// ------------------------------------------------------------- operators
inline MatrixXd operator+(const Mat& a, const Mat& b) {
    assert(a.rows() == b.rows() && a.cols() == b.cols());
    MatrixXd m(a.rows(), a.cols());
    for (long i = 0; i < a.size(); ++i) m.d[i] = a.d[i] + b.d[i];
    return m;
}
inline MatrixXd operator-(const Mat& a, const Mat& b) {
    assert(a.rows() == b.rows() && a.cols() == b.cols());
    MatrixXd m(a.rows(), a.cols());
    for (long i = 0; i < a.size(); ++i) m.d[i] = a.d[i] - b.d[i];
    return m;
}
inline MatrixXd operator-(const Mat& a) {
    MatrixXd m(a.rows(), a.cols());
    for (long i = 0; i < a.size(); ++i) m.d[i] = -a.d[i];
    return m;
}
inline MatrixXd operator*(const Mat& a, const Mat& b) {
    assert(a.cols() == b.rows());
    MatrixXd m(a.rows(), b.cols());
    for (int j = 0; j < b.cols(); ++j)
        for (int i = 0; i < a.rows(); ++i) {
            double s = 0;
            for (int k = 0; k < a.cols(); ++k) s += a.at(i, k) * b.at(k, j);
            m.at(i, j) = s;
        }
    return m;
}
inline MatrixXd operator*(const Mat& a, double s) {
    MatrixXd m(a.rows(), a.cols());
    for (long i = 0; i < a.size(); ++i) m.d[i] = a.d[i] * s;
    return m;
}
inline MatrixXd operator*(double s, const Mat& a) { return a * s; }
inline MatrixXd operator/(const Mat& a, double s) {
    MatrixXd m(a.rows(), a.cols());
    for (long i = 0; i < a.size(); ++i) m.d[i] = a.d[i] / s;
    return m;
}

template <int R, int C> inline MatrixRC<R, C>& operator+=(MatrixRC<R, C>& a, const Mat& b) {
    assert(a.size() == b.size());
    for (long i = 0; i < a.size(); ++i) a.d[i] += b.d[i];
    return a;
}
template <int R, int C> inline MatrixRC<R, C>& operator-=(MatrixRC<R, C>& a, const Mat& b) {
    assert(a.size() == b.size());
    for (long i = 0; i < a.size(); ++i) a.d[i] -= b.d[i];
    return a;
}
template <int R, int C> inline MatrixRC<R, C>& operator*=(MatrixRC<R, C>& a, double s) {
    for (long i = 0; i < a.size(); ++i) a.d[i] *= s;
    return a;
}

// --------------------------------------------------------------- arrays
class ArrayX {
  public:
    Mat m_;
    ArrayX() {}
    ArrayX(const Mat& m) : m_(m) {}
    long size() const { return m_.size(); }
    double operator()(int i) const { return m_.d[i]; }
    double& operator()(int i) { return m_.d[i]; }
    double operator[](int i) const { return m_.d[i]; }

    static ArrayX LinSpaced(int n, double lo, double hi) {
        Mat m(n, 1);
        for (int i = 0; i < n; ++i)
            m.d[i] = n == 1 ? lo : lo + (hi - lo) * double(i) / double(n - 1);
        return ArrayX(m);
    }

    ArrayX map(double (*f)(double)) const {
        ArrayX o(m_);
        for (long i = 0; i < size(); ++i) o.m_.d[i] = f(m_.d[i]);
        return o;
    }
    ArrayX tan() const { return map(std::tan); }
    ArrayX atan() const { return map(std::atan); }
    ArrayX sin() const { return map(std::sin); }
    ArrayX cos() const { return map(std::cos); }
    ArrayX exp() const { return map(std::exp); }
    ArrayX abs() const { return map(std::fabs); }
    ArrayX sqrt() const { return map(std::sqrt); }
    ArrayX square() const {
        ArrayX o(m_);
        for (long i = 0; i < size(); ++i) o.m_.d[i] = m_.d[i] * m_.d[i];
        return o;
    }
    Mat matrix() const { return m_; }
    ArrayX array() const { return *this; }
    double maxCoeff() const { return m_.maxCoeff(); }
    double minCoeff() const { return m_.minCoeff(); }

    // implicit conversion back to matrix types via Mat
    operator Mat() const { return m_; }
};

inline ArrayX Mat::array() const { return ArrayX(*this); }

template <int R, int C> inline MatrixRC<R, C>::MatrixRC(const ArrayX& a) : Mat(a.m_) {
    check_fixed();
}

inline ArrayX operator+(const ArrayX& a, const ArrayX& b) {
    assert(a.size() == b.size());
    ArrayX o(a.m_);
    for (long i = 0; i < a.size(); ++i) o.m_.d[i] = a.m_.d[i] + b.m_.d[i];
    return o;
}
inline ArrayX operator-(const ArrayX& a, const ArrayX& b) {
    assert(a.size() == b.size());
    ArrayX o(a.m_);
    for (long i = 0; i < a.size(); ++i) o.m_.d[i] = a.m_.d[i] - b.m_.d[i];
    return o;
}
inline ArrayX operator*(const ArrayX& a, const ArrayX& b) {
    assert(a.size() == b.size());
    ArrayX o(a.m_);
    for (long i = 0; i < a.size(); ++i) o.m_.d[i] = a.m_.d[i] * b.m_.d[i];
    return o;
}
inline ArrayX operator/(const ArrayX& a, const ArrayX& b) {
    assert(a.size() == b.size());
    ArrayX o(a.m_);
    for (long i = 0; i < a.size(); ++i) o.m_.d[i] = a.m_.d[i] / b.m_.d[i];
    return o;
}
inline ArrayX operator+(double s, const ArrayX& a) {
    ArrayX o(a.m_);
    for (long i = 0; i < a.size(); ++i) o.m_.d[i] = s + a.m_.d[i];
    return o;
}
inline ArrayX operator+(const ArrayX& a, double s) { return s + a; }
inline ArrayX operator-(double s, const ArrayX& a) {
    ArrayX o(a.m_);
    for (long i = 0; i < a.size(); ++i) o.m_.d[i] = s - a.m_.d[i];
    return o;
}
inline ArrayX operator-(const ArrayX& a, double s) {
    ArrayX o(a.m_);
    for (long i = 0; i < a.size(); ++i) o.m_.d[i] = a.m_.d[i] - s;
    return o;
}
inline ArrayX operator*(double s, const ArrayX& a) {
    ArrayX o(a.m_);
    for (long i = 0; i < a.size(); ++i) o.m_.d[i] = s * a.m_.d[i];
    return o;
}
inline ArrayX operator*(const ArrayX& a, double s) { return s * a; }
inline ArrayX operator/(const ArrayX& a, double s) {
    ArrayX o(a.m_);
    for (long i = 0; i < a.size(); ++i) o.m_.d[i] = a.m_.d[i] / s;
    return o;
}

// ------------------------------------------------------ comma initializer
class CommaInit {
  public:
    Mat* m_;
    int row0_ = 0, col_ = 0, block_rows_ = 0;
    CommaInit(Mat* m) : m_(m) {}

    CommaInit& put_scalar(double v) {
        // scalars fill a 1-high block row (Eigen semantics: scalars and
        // blocks mix by filling left-to-right, wrapping when cols full)
        m_->at(row0_, col_) = v;
        block_rows_ = std::max(block_rows_, 1);
        col_ += 1;
        if (col_ == m_->cols()) {
            col_ = 0;
            row0_ += block_rows_;
            block_rows_ = 0;
        }
        return *this;
    }
    CommaInit& put_mat(const Mat& b) {
        for (int c = 0; c < b.cols(); ++c)
            for (int r = 0; r < b.rows(); ++r) m_->at(row0_ + r, col_ + c) = b.at(r, c);
        block_rows_ = std::max(block_rows_, b.rows());
        col_ += b.cols();
        if (col_ == m_->cols()) {
            col_ = 0;
            row0_ += block_rows_;
            block_rows_ = 0;
        }
        return *this;
    }
    CommaInit& operator,(double v) { return put_scalar(v); }
    CommaInit& operator,(const Mat& b) { return put_mat(b); }
};

inline CommaInit operator<<(Mat& m, double v) {
    CommaInit ci(&m);
    ci.put_scalar(v);
    return ci;
}
inline CommaInit operator<<(Mat& m, const Mat& b) {
    CommaInit ci(&m);
    ci.put_mat(b);
    return ci;
}

// ------------------------------------------------------------- decompositions
template <typename MatT> class LLT {
  public:
    ComputationInfo info_ = Success;
    MatrixXd L_;
    LLT(const Mat& a) {
        int n = a.rows();
        L_ = MatrixXd(n, n);
        // mirror Eigen's llt_inplace: fail on diag <= 0
        for (int j = 0; j < n; ++j) {
            double s = a.at(j, j);
            for (int k = 0; k < j; ++k) s -= L_.at(j, k) * L_.at(j, k);
            if (s <= 0.0) {
                info_ = NumericalIssue;
                return;
            }
            L_.at(j, j) = std::sqrt(s);
            for (int i = j + 1; i < n; ++i) {
                double t = a.at(i, j);
                for (int k = 0; k < j; ++k) t -= L_.at(i, k) * L_.at(j, k);
                L_.at(i, j) = t / L_.at(j, j);
            }
        }
    }
    ComputationInfo info() const { return info_; }
    MatrixXd solve(const Mat& b) const {
        int n = L_.rows();
        MatrixXd x = b;
        for (int c = 0; c < x.cols(); ++c) {
            for (int i = 0; i < n; ++i) {
                double s = x.at(i, c);
                for (int k = 0; k < i; ++k) s -= L_.at(i, k) * x.at(k, c);
                x.at(i, c) = s / L_.at(i, i);
            }
            for (int i = n - 1; i >= 0; --i) {
                double s = x.at(i, c);
                for (int k = i + 1; k < n; ++k) s -= L_.at(k, i) * x.at(k, c);
                x.at(i, c) = s / L_.at(i, i);
            }
        }
        return x;
    }
};

class QrSolver {
  public:
    MatrixXd a_;
    QrSolver(const Mat& a) : a_(a) {}
    // partial-pivot Gaussian elimination (see file header for why this
    // substitutes for Householder QR here)
    MatrixXd solve(const Mat& b) const {
        int n = a_.rows();
        MatrixXd a = a_;
        MatrixXd x = b;
        std::vector<int> piv(n);
        for (int k = 0; k < n; ++k) {
            int p = k;
            for (int r = k + 1; r < n; ++r)
                if (std::fabs(a.at(r, k)) > std::fabs(a.at(p, k))) p = r;
            for (int c = 0; c < n; ++c) std::swap(a.at(k, c), a.at(p, c));
            for (int c = 0; c < x.cols(); ++c) std::swap(x.at(k, c), x.at(p, c));
            for (int r = k + 1; r < n; ++r) {
                double f = a.at(r, k) / a.at(k, k);
                for (int c = k; c < n; ++c) a.at(r, c) -= f * a.at(k, c);
                for (int c = 0; c < x.cols(); ++c) x.at(r, c) -= f * x.at(k, c);
            }
        }
        for (int c = 0; c < x.cols(); ++c)
            for (int i = n - 1; i >= 0; --i) {
                double s = x.at(i, c);
                for (int k = i + 1; k < n; ++k) s -= a.at(i, k) * x.at(k, c);
                x.at(i, c) = s / a.at(i, i);
            }
        return x;
    }
};

inline QrSolver Mat::colPivHouseholderQr() const { return QrSolver(*this); }

}  // namespace Eigen
