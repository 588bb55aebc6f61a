// Self-contained bundle adjustment solver (no Ceres / Eigen dependency).
//
// Behavioral parity target: the reference's Ceres-based BA
// (reference: bundle_adjustment/custom_cpp_cost_functions.cpp,
//  code/utils/ceres_utils.py:127-262):
//   - Euclidean camera: 6-dof delta (angle-axis + translation) around packed
//     originals, intrinsics fixed from the 12-double packing
//     (custom_cpp_cost_functions.cpp:105-155).
//   - Projective camera: 12-dof column-major P delta + 3-dof point delta
//     (custom_cpp_cost_functions.cpp:56-102).
//   - Huber loss (delta = 0.1 by default), DENSE_SCHUR, <= 100 iterations,
//     function tolerance 1e-4 (ceres_utils.py:165-175).
//
// Implementation: Levenberg-Marquardt with forward-mode dual-number (jet)
// Jacobians, IRLS-style robust weighting (sqrt(rho')), and a dense Schur
// complement over the camera blocks solved by Cholesky. Point blocks are
// eliminated in closed form. Optional OpenMP threading over observations.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// Forward-mode dual numbers (minimal Ceres-style jets)
// ---------------------------------------------------------------------------

template <int N>
struct Jet {
  double a;
  double v[N];

  Jet() : a(0) { std::memset(v, 0, sizeof(v)); }
  explicit Jet(double x) : a(x) { std::memset(v, 0, sizeof(v)); }
  Jet(double x, int k) : a(x) {
    std::memset(v, 0, sizeof(v));
    v[k] = 1.0;
  }

  Jet operator+(const Jet& o) const {
    Jet r;
    r.a = a + o.a;
    for (int i = 0; i < N; ++i) r.v[i] = v[i] + o.v[i];
    return r;
  }
  Jet operator-(const Jet& o) const {
    Jet r;
    r.a = a - o.a;
    for (int i = 0; i < N; ++i) r.v[i] = v[i] - o.v[i];
    return r;
  }
  Jet operator*(const Jet& o) const {
    Jet r;
    r.a = a * o.a;
    for (int i = 0; i < N; ++i) r.v[i] = v[i] * o.a + a * o.v[i];
    return r;
  }
  Jet operator/(const Jet& o) const {
    Jet r;
    const double inv = 1.0 / o.a;
    r.a = a * inv;
    for (int i = 0; i < N; ++i) r.v[i] = (v[i] - r.a * o.v[i]) * inv;
    return r;
  }
  Jet operator+(double s) const {
    Jet r = *this;
    r.a += s;
    return r;
  }
  Jet operator*(double s) const {
    Jet r;
    r.a = a * s;
    for (int i = 0; i < N; ++i) r.v[i] = v[i] * s;
    return r;
  }
  Jet operator-() const {
    Jet r;
    r.a = -a;
    for (int i = 0; i < N; ++i) r.v[i] = -v[i];
    return r;
  }
};

template <int N>
Jet<N> sqrt_jet(const Jet<N>& x) {
  Jet<N> r;
  r.a = std::sqrt(x.a);
  const double s = 0.5 / std::max(r.a, 1e-300);
  for (int i = 0; i < N; ++i) r.v[i] = x.v[i] * s;
  return r;
}

template <int N>
Jet<N> sin_jet(const Jet<N>& x) {
  Jet<N> r;
  r.a = std::sin(x.a);
  const double c = std::cos(x.a);
  for (int i = 0; i < N; ++i) r.v[i] = x.v[i] * c;
  return r;
}

template <int N>
Jet<N> cos_jet(const Jet<N>& x) {
  Jet<N> r;
  r.a = std::cos(x.a);
  const double s = -std::sin(x.a);
  for (int i = 0; i < N; ++i) r.v[i] = x.v[i] * s;
  return r;
}

// Angle-axis rotation of a point, matching ceres::AngleAxisRotatePoint.
template <typename T>
void AngleAxisRotatePoint(const T w[3], const T p[3], T result[3]) {
  const T theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  if (theta2.a > 1e-16) {
    const T theta = sqrt_jet(theta2);
    const T costheta = cos_jet(theta);
    const T sintheta = sin_jet(theta);
    const T theta_inv = T(1.0) / theta;
    const T a0 = w[0] * theta_inv;
    const T a1 = w[1] * theta_inv;
    const T a2 = w[2] * theta_inv;
    const T w_cross_p0 = a1 * p[2] - a2 * p[1];
    const T w_cross_p1 = a2 * p[0] - a0 * p[2];
    const T w_cross_p2 = a0 * p[1] - a1 * p[0];
    const T dot = a0 * p[0] + a1 * p[1] + a2 * p[2];
    const T tmp = dot * (T(1.0) - costheta);
    result[0] = p[0] * costheta + w_cross_p0 * sintheta + a0 * tmp;
    result[1] = p[1] * costheta + w_cross_p1 * sintheta + a1 * tmp;
    result[2] = p[2] * costheta + w_cross_p2 * sintheta + a2 * tmp;
  } else {
    // Near-zero angle: R ~ I + [w]_x (matches Ceres' small-angle branch).
    const T w_cross_p0 = w[1] * p[2] - w[2] * p[1];
    const T w_cross_p1 = w[2] * p[0] - w[0] * p[2];
    const T w_cross_p2 = w[0] * p[1] - w[1] * p[0];
    result[0] = p[0] + w_cross_p0;
    result[1] = p[1] + w_cross_p1;
    result[2] = p[2] + w_cross_p2;
  }
}

// Overload for plain doubles (residual-only evaluation).
inline void AngleAxisRotatePointD(const double w[3], const double p[3], double result[3]) {
  const double theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  if (theta2 > 1e-16) {
    const double theta = std::sqrt(theta2);
    const double costheta = std::cos(theta);
    const double sintheta = std::sin(theta);
    const double theta_inv = 1.0 / theta;
    const double a0 = w[0] * theta_inv, a1 = w[1] * theta_inv, a2 = w[2] * theta_inv;
    const double wxp0 = a1 * p[2] - a2 * p[1];
    const double wxp1 = a2 * p[0] - a0 * p[2];
    const double wxp2 = a0 * p[1] - a1 * p[0];
    const double dot = a0 * p[0] + a1 * p[1] + a2 * p[2];
    const double tmp = dot * (1.0 - costheta);
    result[0] = p[0] * costheta + wxp0 * sintheta + a0 * tmp;
    result[1] = p[1] * costheta + wxp1 * sintheta + a1 * tmp;
    result[2] = p[2] * costheta + wxp2 * sintheta + a2 * tmp;
  } else {
    result[0] = p[0] + (w[1] * p[2] - w[2] * p[1]);
    result[1] = p[1] + (w[2] * p[0] - w[0] * p[2]);
    result[2] = p[2] + (w[0] * p[1] - w[1] * p[0]);
  }
}

// ---------------------------------------------------------------------------
// Camera models (residual evaluation; CAM_DIM = #optimized camera params)
// ---------------------------------------------------------------------------

// Euclidean: cam_orig is the 12-double packing [rvec(3), t(3), fx, s, cx, fy,
// cy, 1]; optimized delta = [d_rvec(3), d_t(3)].
struct EuclideanModel {
  static constexpr int kCamDim = 6;

  template <typename T>
  static void Residual(const double* cam_orig, const double* x_orig,
                       const T* cam_delta, const T* pt_delta,
                       double obs_x, double obs_y, T res[2]) {
    T w[3], t[3], X[3], Xc[3];
    for (int i = 0; i < 3; ++i) {
      w[i] = cam_delta[i] + cam_orig[i];
      t[i] = cam_delta[i + 3] + cam_orig[i + 3];
      X[i] = pt_delta[i] + x_orig[i];
    }
    AngleAxisRotatePoint(w, X, Xc);
    Xc[0] = Xc[0] + t[0];
    Xc[1] = Xc[1] + t[1];
    Xc[2] = Xc[2] + t[2];
    const double fx = cam_orig[6], s = cam_orig[7], cx = cam_orig[8];
    const double fy = cam_orig[9], cy = cam_orig[10];
    // Parity with custom_cpp_cost_functions.cpp:134-138.
    const T u = (Xc[0] * fx + Xc[1] * s + Xc[2] * cx) / Xc[2];
    const T v = (Xc[1] * fy + Xc[2] * cy) / Xc[2];
    res[0] = u + (-obs_x);
    res[1] = v + (-obs_y);
  }

  static void ResidualD(const double* cam_orig, const double* x_orig,
                        const double* cam_delta, const double* pt_delta,
                        double obs_x, double obs_y, double res[2]) {
    double w[3], t[3], X[3], Xc[3];
    for (int i = 0; i < 3; ++i) {
      w[i] = cam_delta[i] + cam_orig[i];
      t[i] = cam_delta[i + 3] + cam_orig[i + 3];
      X[i] = pt_delta[i] + x_orig[i];
    }
    AngleAxisRotatePointD(w, X, Xc);
    Xc[0] += t[0];
    Xc[1] += t[1];
    Xc[2] += t[2];
    const double fx = cam_orig[6], s = cam_orig[7], cx = cam_orig[8];
    const double fy = cam_orig[9], cy = cam_orig[10];
    res[0] = (Xc[0] * fx + Xc[1] * s + Xc[2] * cx) / Xc[2] - obs_x;
    res[1] = (Xc[1] * fy + Xc[2] * cy) / Xc[2] - obs_y;
  }
};

// Projective: cam_orig is the column-major 12-double P; 12-dof delta.
// Parity with custom_cpp_cost_functions.cpp:56-102.
struct ProjectiveModel {
  static constexpr int kCamDim = 12;

  template <typename T>
  static void Residual(const double* cam_orig, const double* x_orig,
                       const T* cam_delta, const T* pt_delta,
                       double obs_x, double obs_y, T res[2]) {
    T P[12], X[3];
    for (int i = 0; i < 12; ++i) P[i] = cam_delta[i] + cam_orig[i];
    for (int i = 0; i < 3; ++i) X[i] = pt_delta[i] + x_orig[i];
    // Column-major P: proj_r = sum_c P[r + 3c] * X_c (+ P[r + 9]).
    T proj[3];
    for (int r = 0; r < 3; ++r)
      proj[r] = P[r] * X[0] + P[r + 3] * X[1] + P[r + 6] * X[2] + P[r + 9];
    res[0] = proj[0] / proj[2] + (-obs_x);
    res[1] = proj[1] / proj[2] + (-obs_y);
  }

  static void ResidualD(const double* cam_orig, const double* x_orig,
                        const double* cam_delta, const double* pt_delta,
                        double obs_x, double obs_y, double res[2]) {
    double P[12], X[3];
    for (int i = 0; i < 12; ++i) P[i] = cam_delta[i] + cam_orig[i];
    for (int i = 0; i < 3; ++i) X[i] = pt_delta[i] + x_orig[i];
    double proj[3];
    for (int r = 0; r < 3; ++r)
      proj[r] = P[r] * X[0] + P[r + 3] * X[1] + P[r + 6] * X[2] + P[r + 9];
    res[0] = proj[0] / proj[2] - obs_x;
    res[1] = proj[1] / proj[2] - obs_y;
  }
};

// ---------------------------------------------------------------------------
// Robust loss (Huber, Ceres convention: rho(s), s = squared residual norm)
// ---------------------------------------------------------------------------

inline void huber(double s, double delta, double* rho, double* rho_p) {
  const double d2 = delta * delta;
  if (s <= d2) {
    *rho = s;
    *rho_p = 1.0;
  } else {
    const double sq = std::sqrt(s);
    *rho = 2.0 * delta * sq - d2;
    *rho_p = delta / sq;
  }
}

// ---------------------------------------------------------------------------
// Dense linear algebra helpers
// ---------------------------------------------------------------------------

// In-place Cholesky LLT of an n x n row-major SPD matrix. Returns false if
// not positive definite.
bool cholesky_factor(std::vector<double>& A, int n) {
  for (int j = 0; j < n; ++j) {
    double d = A[j * n + j];
    for (int k = 0; k < j; ++k) d -= A[j * n + k] * A[j * n + k];
    if (d <= 0.0) return false;
    const double ljj = std::sqrt(d);
    A[j * n + j] = ljj;
    const double inv = 1.0 / ljj;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n - j > 256)
#endif
    for (int i = j + 1; i < n; ++i) {
      double s = A[i * n + j];
      for (int k = 0; k < j; ++k) s -= A[i * n + k] * A[j * n + k];
      A[i * n + j] = s * inv;
    }
  }
  return true;
}

void cholesky_solve(const std::vector<double>& L, int n, std::vector<double>& b) {
  // L y = b
  for (int i = 0; i < n; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i * n + k] * b[k];
    b[i] = s / L[i * n + i];
  }
  // L^T x = y
  for (int i = n - 1; i >= 0; --i) {
    double s = b[i];
    for (int k = i + 1; k < n; ++k) s -= L[k * n + i] * b[k];
    b[i] = s / L[i * n + i];
  }
}

bool invert3x3(const double A[9], double out[9]) {
  const double a = A[0], b = A[1], c = A[2];
  const double d = A[3], e = A[4], f = A[5];
  const double g = A[6], h = A[7], i = A[8];
  const double det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
  if (std::fabs(det) < 1e-300) return false;
  const double inv = 1.0 / det;
  out[0] = (e * i - f * h) * inv;
  out[1] = (c * h - b * i) * inv;
  out[2] = (b * f - c * e) * inv;
  out[3] = (f * g - d * i) * inv;
  out[4] = (a * i - c * g) * inv;
  out[5] = (c * d - a * f) * inv;
  out[6] = (d * h - e * g) * inv;
  out[7] = (b * g - a * h) * inv;
  out[8] = (a * e - b * d) * inv;
  return true;
}

// ---------------------------------------------------------------------------
// The LM + Schur solver, templated on the camera model
// ---------------------------------------------------------------------------

template <typename Model>
struct Solver {
  static constexpr int C = Model::kCamDim;
  static constexpr int J = C + 3;  // jet dimension

  int n_cams, n_pts, n_obs;
  const double* cam_orig;  // (n_cams, cam_pack_dim)
  int cam_pack_dim;
  const double* Xs;     // (n_pts, 3)
  const double* xs;     // (n_obs, 2)
  const int* cam_idx;   // (n_obs,)
  const int* pt_idx;    // (n_obs,)
  double huber_delta;
  int verbose;

  std::vector<double> cam_delta;  // (n_cams, C)
  std::vector<double> pt_delta;   // (n_pts, 3)

  // Observations sorted by point for the Schur elimination.
  std::vector<int> obs_order;     // n_obs, sorted by pt then cam
  std::vector<int> pt_obs_start;  // n_pts + 1

  Solver(int nc, int np, int no, const double* co, int cpd, const double* X,
         const double* x, const int* ci, const int* pi, double hd, int vb)
      : n_cams(nc), n_pts(np), n_obs(no), cam_orig(co), cam_pack_dim(cpd),
        Xs(X), xs(x), cam_idx(ci), pt_idx(pi), huber_delta(hd), verbose(vb) {
    cam_delta.assign((size_t)n_cams * C, 0.0);
    pt_delta.assign((size_t)n_pts * 3, 0.0);
    obs_order.resize(n_obs);
    for (int k = 0; k < n_obs; ++k) obs_order[k] = k;
    std::stable_sort(obs_order.begin(), obs_order.end(), [&](int a, int b) {
      return pt_idx[a] < pt_idx[b];
    });
    pt_obs_start.assign(n_pts + 1, 0);
    for (int k = 0; k < n_obs; ++k) pt_obs_start[pt_idx[k] + 1]++;
    for (int j = 0; j < n_pts; ++j) pt_obs_start[j + 1] += pt_obs_start[j];
  }

  double cost(const std::vector<double>& cd, const std::vector<double>& pd) const {
    double total = 0.0;
#ifdef _OPENMP
#pragma omp parallel for reduction(+ : total) schedule(static)
#endif
    for (int k = 0; k < n_obs; ++k) {
      const int ci = cam_idx[k], pj = pt_idx[k];
      double r[2];
      Model::ResidualD(cam_orig + (size_t)ci * cam_pack_dim, Xs + (size_t)pj * 3,
                       cd.data() + (size_t)ci * C, pd.data() + (size_t)pj * 3,
                       xs[2 * k], xs[2 * k + 1], r);
      const double s = r[0] * r[0] + r[1] * r[1];
      double rho, rho_p;
      huber(s, huber_delta, &rho, &rho_p);
      total += 0.5 * rho;
    }
    return total;
  }

  // Evaluate robust-weighted residuals and Jacobians for one observation.
  void eval_obs(int k, double r[2], double Jc[2 * C], double Jp[2 * 3]) const {
    const int ci = cam_idx[k], pj = pt_idx[k];
    Jet<J> cd[C], pd[3], res[2];
    for (int i = 0; i < C; ++i) cd[i] = Jet<J>(cam_delta[(size_t)ci * C + i], i);
    for (int i = 0; i < 3; ++i) pd[i] = Jet<J>(pt_delta[(size_t)pj * 3 + i], C + i);
    Model::Residual(cam_orig + (size_t)ci * cam_pack_dim, Xs + (size_t)pj * 3,
                    cd, pd, xs[2 * k], xs[2 * k + 1], res);
    const double s = res[0].a * res[0].a + res[1].a * res[1].a;
    double rho, rho_p;
    huber(s, huber_delta, &rho, &rho_p);
    const double w = std::sqrt(rho_p);
    for (int rI = 0; rI < 2; ++rI) {
      r[rI] = w * res[rI].a;
      for (int i = 0; i < C; ++i) Jc[rI * C + i] = w * res[rI].v[i];
      for (int i = 0; i < 3; ++i) Jp[rI * 3 + i] = w * res[rI].v[C + i];
    }
  }

  // One LM iteration attempt: build normal equations with damping lambda,
  // Schur-eliminate points, solve for camera steps, back-substitute points.
  // Returns false if the linear solve failed.
  bool solve_step(double lambda, std::vector<double>& dcam, std::vector<double>& dpt,
                  double* model_reduction) {
    const int nc = n_cams;
    const size_t sdim = (size_t)nc * C;

    std::vector<double> S(sdim * sdim, 0.0);       // Schur complement
    std::vector<double> g_c(sdim, 0.0);
    std::vector<double> Hc_diag(sdim, 0.0);        // for damping report

    // Per-point accumulation (sequential over points; obs of one point are
    // contiguous in obs_order). Parallel over points.
#ifdef _OPENMP
    int n_threads = omp_get_max_threads();
    {
      // Bound the thread-local Schur scratch: S_t costs sdim^2 doubles PER
      // THREAD, and a projective (C=12) few-hundred-camera scene on a
      // many-core host would otherwise allocate tens of GB per LM attempt.
      // Cap the accumulation team so the scratch stays under ~1 GB total
      // (the dense Schur solve itself is O(sdim^2) memory regardless).
      const double budget_bytes = 1.0e9;
      const double per_thread = (double)sdim * (double)sdim * 8.0;
      if (per_thread * n_threads > budget_bytes)
        n_threads = std::max(1, (int)(budget_bytes / per_thread));
    }
#else
    const int n_threads = 1;
#endif
    std::vector<std::vector<double>> S_t(n_threads), g_t(n_threads);
    for (int t = 0; t < n_threads; ++t) {
      S_t[t].assign(sdim * sdim, 0.0);
      g_t[t].assign(sdim, 0.0);
    }
    std::vector<double> Cinv_store((size_t)n_pts * 9, 0.0);
    std::vector<double> gp_store((size_t)n_pts * 3, 0.0);
    bool ok = true;

#ifdef _OPENMP
// num_threads must match the S_t scratch count: tid indexes S_t.
#pragma omp parallel for schedule(dynamic, 64) num_threads(n_threads)
#endif
    for (int j = 0; j < n_pts; ++j) {
#ifdef _OPENMP
      const int tid = omp_get_thread_num();
#else
      const int tid = 0;
#endif
      std::vector<double>& S_loc = S_t[tid];
      std::vector<double>& g_loc = g_t[tid];

      const int start = pt_obs_start[j], end = pt_obs_start[j + 1];
      const int deg = end - start;
      if (deg == 0) {
        // Unobserved point: identity-damped block, zero step.
        double Cj[9] = {lambda, 0, 0, 0, lambda, 0, 0, 0, lambda};
        invert3x3(Cj, Cinv_store.data() + (size_t)j * 9);
        continue;
      }
      double Cj[9] = {0};
      double gp[3] = {0};
      std::vector<double> Wj((size_t)deg * C * 3, 0.0);  // per-cam C x 3 blocks
      std::vector<int> cams(deg);
      std::vector<double> Bj((size_t)deg * C * C, 0.0);  // camera block contributions

      for (int q = 0; q < deg; ++q) {
        const int k = obs_order[start + q];
        const int ci = cam_idx[k];
        cams[q] = ci;
        double r[2], Jc[2 * C], Jp[6];
        eval_obs(k, r, Jc, Jp);
        // Accumulate C_j += Jp^T Jp; g_p += Jp^T r
        for (int a = 0; a < 3; ++a) {
          for (int b = 0; b < 3; ++b)
            Cj[a * 3 + b] += Jp[0 * 3 + a] * Jp[0 * 3 + b] + Jp[1 * 3 + a] * Jp[1 * 3 + b];
          gp[a] += Jp[0 * 3 + a] * r[0] + Jp[1 * 3 + a] * r[1];
        }
        // W = Jc^T Jp (C x 3); B = Jc^T Jc (C x C); g_c += Jc^T r
        double* W = Wj.data() + (size_t)q * C * 3;
        double* B = Bj.data() + (size_t)q * C * C;
        for (int a = 0; a < C; ++a) {
          for (int b = 0; b < 3; ++b)
            W[a * 3 + b] += Jc[0 * C + a] * Jp[0 * 3 + b] + Jc[1 * C + a] * Jp[1 * 3 + b];
          for (int b = 0; b < C; ++b)
            B[a * C + b] += Jc[0 * C + a] * Jc[0 * C + b] + Jc[1 * C + a] * Jc[1 * C + b];
          g_loc[(size_t)ci * C + a] += Jc[0 * C + a] * r[0] + Jc[1 * C + a] * r[1];
        }
      }
      // Damping on the point block (additive, scaled by diagonal).
      for (int a = 0; a < 3; ++a) Cj[a * 3 + a] += lambda * std::max(Cj[a * 3 + a], 1e-12);
      double Cinv[9];
      if (!invert3x3(Cj, Cinv)) {
        ok = false;
        continue;
      }
      std::memcpy(Cinv_store.data() + (size_t)j * 9, Cinv, sizeof(Cinv));
      std::memcpy(gp_store.data() + (size_t)j * 3, gp, sizeof(gp));

      // Camera diagonal blocks into S, and Schur cross terms.
      for (int q = 0; q < deg; ++q) {
        const int ca = cams[q];
        const double* B = Bj.data() + (size_t)q * C * C;
        for (int a = 0; a < C; ++a)
          for (int b = 0; b < C; ++b)
            S_loc[((size_t)ca * C + a) * sdim + (size_t)ca * C + b] += B[a * C + b];
      }
      // W C^-1 terms
      std::vector<double> WCinv((size_t)deg * C * 3);
      for (int q = 0; q < deg; ++q) {
        const double* W = Wj.data() + (size_t)q * C * 3;
        double* WC = WCinv.data() + (size_t)q * C * 3;
        for (int a = 0; a < C; ++a)
          for (int b = 0; b < 3; ++b) {
            double s = 0;
            for (int c2 = 0; c2 < 3; ++c2) s += W[a * 3 + c2] * Cinv[c2 * 3 + b];
            WC[a * 3 + b] = s;
          }
        // rhs contribution: + (W C^-1) g_p goes into g via sign handling below
      }
      for (int q1 = 0; q1 < deg; ++q1) {
        const int ca = cams[q1];
        const double* WC = WCinv.data() + (size_t)q1 * C * 3;
        // g correction: g_c_eff = g_c - W C^-1 g_p
        for (int a = 0; a < C; ++a) {
          double s = 0;
          for (int b = 0; b < 3; ++b) s += WC[a * 3 + b] * gp[b];
          g_loc[(size_t)ca * C + a] -= s;
        }
        for (int q2 = 0; q2 < deg; ++q2) {
          const int cb = cams[q2];
          const double* W2 = Wj.data() + (size_t)q2 * C * 3;
          // S[ca, cb] -= (W1 C^-1) W2^T
          for (int a = 0; a < C; ++a)
            for (int b = 0; b < C; ++b) {
              double s = 0;
              for (int c2 = 0; c2 < 3; ++c2) s += WC[a * 3 + c2] * W2[b * 3 + c2];
              S_loc[((size_t)ca * C + a) * sdim + (size_t)cb * C + b] -= s;
            }
        }
      }
    }
    if (!ok) return false;

    // Reduce thread-local accumulations.
    for (int t = 0; t < n_threads; ++t) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
      for (long long idx = 0; idx < (long long)(sdim * sdim); ++idx) S[idx] += S_t[t][idx];
      for (size_t idx = 0; idx < sdim; ++idx) g_c[idx] += g_t[t][idx];
    }

    // Camera damping: additive lambda * max(diag, eps) BEFORE the Schur
    // subtraction would be ideal; since diagonal blocks and Schur terms were
    // accumulated together, recover H_cc diagonal damping here by adding to
    // the S diagonal (equivalent to damping the reduced system — standard
    // for LM-Schur).
    for (size_t a = 0; a < sdim; ++a) {
      Hc_diag[a] = S[a * sdim + a];
      S[a * sdim + a] += lambda * std::max(std::fabs(Hc_diag[a]), 1e-12) + 1e-12;
    }

    // Solve S dcam = -g_c_eff
    std::vector<double> b(sdim);
    for (size_t a = 0; a < sdim; ++a) b[a] = -g_c[a];
    if (!cholesky_factor(S, (int)sdim)) return false;
    cholesky_solve(S, (int)sdim, b);
    dcam = b;

    // Back-substitute points: dpt_j = C^-1 (-g_p - W^T dcam)
    dpt.assign((size_t)n_pts * 3, 0.0);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
    for (int j = 0; j < n_pts; ++j) {
      const int start = pt_obs_start[j], end = pt_obs_start[j + 1];
      if (start == end) continue;
      double rhs_p[3] = {-gp_store[(size_t)j * 3], -gp_store[(size_t)j * 3 + 1],
                         -gp_store[(size_t)j * 3 + 2]};
      for (int q = start; q < end; ++q) {
        const int k = obs_order[q];
        const int ci = cam_idx[k];
        // Recompute W (cheaper than storing all W globally for big problems)
        double r[2], Jc[2 * C], Jp[6];
        eval_obs(k, r, Jc, Jp);
        for (int b2 = 0; b2 < 3; ++b2) {
          double s = 0;
          for (int a = 0; a < C; ++a) {
            const double W_ab = Jc[0 * C + a] * Jp[0 * 3 + b2] + Jc[1 * C + a] * Jp[1 * 3 + b2];
            s += W_ab * dcam[(size_t)ci * C + a];
          }
          rhs_p[b2] -= s;
        }
      }
      const double* Cinv = Cinv_store.data() + (size_t)j * 9;
      for (int a = 0; a < 3; ++a) {
        double s = 0;
        for (int b2 = 0; b2 < 3; ++b2) s += Cinv[a * 3 + b2] * rhs_p[b2];
        dpt[(size_t)j * 3 + a] = s;
      }
    }

    // Predicted model reduction: -g^T d - 0.5 d^T H d ~ 0.5 d^T (lambda D d - g)
    // (standard LM approximation using the damped system identity).
    double mr = 0.0;
    for (size_t a = 0; a < sdim; ++a)
      mr += 0.5 * dcam[a] * (lambda * std::max(std::fabs(Hc_diag[a]), 1e-12) * dcam[a] - g_c[a]);
    *model_reduction = std::max(mr, 1e-32);
    return true;
  }

  // Full LM optimization. Returns 1 if converged (usable solution), else 0.
  int run(int max_iters, double ftol, double* out_initial_cost, double* out_final_cost,
          int* out_iters) {
    double current_cost = cost(cam_delta, pt_delta);
    *out_initial_cost = current_cost;
    double lambda = 1e-4;
    double nu = 2.0;
    int iters = 0;
    bool converged = false;

    for (iters = 0; iters < max_iters; ++iters) {
      std::vector<double> dcam, dpt;
      double model_reduction = 0.0;
      if (!solve_step(lambda, dcam, dpt, &model_reduction)) {
        lambda *= nu;
        nu *= 2.0;
        if (lambda > 1e16) break;
        continue;
      }
      std::vector<double> new_cam = cam_delta, new_pt = pt_delta;
      for (size_t i = 0; i < new_cam.size(); ++i) new_cam[i] += dcam[i];
      for (size_t i = 0; i < new_pt.size(); ++i) new_pt[i] += dpt[i];
      const double new_cost = cost(new_cam, new_pt);
      const double rho = (current_cost - new_cost) / model_reduction;

      if (verbose) {
        std::printf("iter %3d  cost %.6e -> %.6e  lambda %.2e  rho %.3f\n",
                    iters, current_cost, new_cost, lambda, rho);
      }

      if (new_cost < current_cost) {
        const double rel_decrease = (current_cost - new_cost) / std::max(current_cost, 1e-300);
        cam_delta.swap(new_cam);
        pt_delta.swap(new_pt);
        current_cost = new_cost;
        const double factor = 1.0 - std::pow(2.0 * rho - 1.0, 3.0);
        lambda *= std::max(1.0 / 3.0, std::min(factor, 2.0 / 3.0));
        lambda = std::max(lambda, 1e-12);
        nu = 2.0;
        if (rel_decrease < ftol) {
          converged = true;
          ++iters;
          break;
        }
      } else {
        lambda *= nu;
        nu *= 2.0;
        if (lambda > 1e16) {
          converged = true;  // stuck at a (local) minimum: solution usable
          break;
        }
      }
    }
    *out_final_cost = current_cost;
    *out_iters = iters;
    if (iters >= max_iters) converged = true;  // Ceres: hitting max iters is usable
    return converged ? 1 : 0;
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

// Euclidean BA. cam_params: (n_cams, 12) packed as in
// ceres_utils.order_cam_param_for_c. Outputs 6-dof camera deltas and 3-dof
// point deltas. Returns 1 if the solution is usable.
int gasfm_ba_euclidean(int n_cams, int n_pts, int n_obs,
                       const double* cam_params, const double* Xs, const double* xs,
                       const int* cam_idx, const int* pt_idx,
                       double* cam_deltas_out, double* pt_deltas_out,
                       double huber_delta, int max_iters, double ftol,
                       int num_threads, int verbose, double* stats_out) {
#ifdef _OPENMP
  if (num_threads > 0) omp_set_num_threads(num_threads);
#endif
  Solver<EuclideanModel> solver(n_cams, n_pts, n_obs, cam_params, 12, Xs, xs,
                                cam_idx, pt_idx, huber_delta, verbose);
  double c0, c1;
  int iters;
  const int ok = solver.run(max_iters, ftol, &c0, &c1, &iters);
  std::memcpy(cam_deltas_out, solver.cam_delta.data(), sizeof(double) * (size_t)n_cams * 6);
  std::memcpy(pt_deltas_out, solver.pt_delta.data(), sizeof(double) * (size_t)n_pts * 3);
  if (stats_out) {
    stats_out[0] = c0;
    stats_out[1] = c1;
    stats_out[2] = iters;
  }
  return ok;
}

// Projective BA. cam_params: (n_cams, 12) column-major P entries.
int gasfm_ba_projective(int n_cams, int n_pts, int n_obs,
                        const double* cam_params, const double* Xs, const double* xs,
                        const int* cam_idx, const int* pt_idx,
                        double* cam_deltas_out, double* pt_deltas_out,
                        double huber_delta, int max_iters, double ftol,
                        int num_threads, int verbose, double* stats_out) {
#ifdef _OPENMP
  if (num_threads > 0) omp_set_num_threads(num_threads);
#endif
  Solver<ProjectiveModel> solver(n_cams, n_pts, n_obs, cam_params, 12, Xs, xs,
                                 cam_idx, pt_idx, huber_delta, verbose);
  double c0, c1;
  int iters;
  const int ok = solver.run(max_iters, ftol, &c0, &c1, &iters);
  std::memcpy(cam_deltas_out, solver.cam_delta.data(), sizeof(double) * (size_t)n_cams * 12);
  std::memcpy(pt_deltas_out, solver.pt_delta.data(), sizeof(double) * (size_t)n_pts * 3);
  if (stats_out) {
    stats_out[0] = c0;
    stats_out[1] = c1;
    stats_out[2] = iters;
  }
  return ok;
}

}  // extern "C"
