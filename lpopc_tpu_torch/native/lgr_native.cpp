// lgr_native.cpp — long-double Legendre–Gauss–Radau (LGR) node/weight/matrix
// generation for the lpopc_tpu_torch collocation layer.
//
// Capability parity with the reference's RPMGenerator (see
// Lpopc/src/Core/RPMGenerator.cpp:253-291 which computes LGR
// points by Newton iteration in double precision): here nodes are found as
// eigenvalues of the Gauss–Radau-modified Jacobi matrix (Golub–Welsch) and then
// polished by Newton iteration on q(x) = P_{N-1}(x) + P_N(x) in `long double`,
// giving ~18-digit nodes that are rounded to f64 for the Python side. This is a
// from-scratch implementation (different algorithm, different language
// idioms); nothing is copied from the reference.
//
// Exposed C ABI (used from Python via ctypes):
//   int lgr_nodes_weights(int n, double* nodes, double* weights);
//   int diff_matrix(int n, const double* pts, double* D);       // (n+1)x(n+1)
//
// Build: g++ -O2 -shared -fPIC -std=c++17 lgr_native.cpp -o liblgr_native.so

#include <cmath>
#include <cstdlib>
#include <vector>

namespace {

using ld = long double;

// Evaluate Legendre P_{n-1}(x), P_n(x) by the three-term recurrence.
inline void legendre_pair(int n, ld x, ld &pnm1, ld &pn) {
  ld p0 = 1.0L, p1 = x;
  if (n == 0) { pnm1 = 0.0L; pn = 1.0L; return; }
  if (n == 1) { pnm1 = 1.0L; pn = x; return; }
  for (int k = 2; k <= n; ++k) {
    ld p2 = ((2.0L * k - 1.0L) * x * p1 - (k - 1.0L) * p0) / (ld)k;
    p0 = p1;
    p1 = p2;
  }
  pnm1 = p0;
  pn = p1;
}

// Symmetric tridiagonal eigenvalues via QL with implicit shifts (no LAPACK).
// d: diagonal (size n), e: off-diagonal (size n, e[n-1] unused). Eigenvalues
// returned in d (ascending not guaranteed; caller sorts). z holds first-row
// components of eigenvectors on input identity seed (z[i]=1 at i==0), used for
// Golub–Welsch weights.
bool tql2_first_row(std::vector<ld> &d, std::vector<ld> &e,
                    std::vector<ld> &z) {
  const int n = (int)d.size();
  for (int i = 1; i < n; ++i) e[i - 1] = e[i];
  e[n - 1] = 0.0L;
  for (int l = 0; l < n; ++l) {
    int iter = 0;
    int m;
    do {
      for (m = l; m < n - 1; ++m) {
        ld dd = fabsl(d[m]) + fabsl(d[m + 1]);
        if (fabsl(e[m]) <= 1e-22L * dd) break;
      }
      if (m != l) {
        if (iter++ == 60) return false;
        ld g = (d[l + 1] - d[l]) / (2.0L * e[l]);
        ld r = hypotl(g, 1.0L);
        g = d[m] - d[l] + e[l] / (g + (g >= 0 ? fabsl(r) : -fabsl(r)));
        ld s = 1.0L, c = 1.0L, p = 0.0L;
        for (int i = m - 1; i >= l; --i) {
          ld f = s * e[i];
          ld b = c * e[i];
          r = hypotl(f, g);
          e[i + 1] = r;
          if (r == 0.0L) {
            d[i + 1] -= p;
            e[m] = 0.0L;
            break;
          }
          s = f / r;
          c = g / r;
          g = d[i + 1] - p;
          r = (d[i] - g) * s + 2.0L * c * b;
          p = s * r;
          d[i + 1] = g + p;
          g = c * r - b;
          // rotate first-row eigenvector components
          f = z[i + 1];
          z[i + 1] = s * z[i] + c * f;
          z[i] = c * z[i] - s * f;
        }
        if (r == 0.0L && m - 1 >= l) continue;
        d[l] -= p;
        e[l] = g;
        e[m] = 0.0L;
      }
    } while (m != l);
  }
  return true;
}

}  // namespace

extern "C" {

// Computes the n LGR points on [-1, 1) (including -1, excluding +1) and the
// matching quadrature weights (exact for polynomials of degree <= 2n-2).
// Returns 0 on success.
int lgr_nodes_weights(int n, double *nodes, double *weights) {
  if (n < 1) return 1;
  if (n == 1) {
    nodes[0] = -1.0;
    weights[0] = 2.0;
    return 0;
  }
  // Jacobi matrix for Legendre measure: alpha_k = 0,
  // beta_k = k^2 / (4k^2 - 1), k = 1..n-1. Gauss–Radau modification fixes the
  // endpoint a = -1 by replacing the last diagonal entry with
  //   alpha_n = a - beta_{n-1} * p_{n-2}(a) / p_{n-1}(a)
  // (monic orthogonal polynomials p_k; Golub 1973).
  std::vector<ld> d(n, 0.0L), e(n, 0.0L), z(n, 0.0L);
  z[0] = 1.0L;
  for (int k = 1; k < n; ++k) {
    ld kk = (ld)k;
    e[k] = sqrtl(kk * kk / (4.0L * kk * kk - 1.0L));  // sqrt(beta_k)
  }
  // monic p_k(a) at a=-1 via recurrence p_{k+1} = (x - alpha_k) p_k - beta_k p_{k-1}
  {
    const ld a = -1.0L;
    ld q0 = 1.0L, qm1 = 0.0L;   // p_0, p_{-1}
    ld pn2 = 0.0L, pn1 = 0.0L;  // p_{n-2}(a), p_{n-1}(a)
    for (int k = 0; k < n; ++k) {
      if (k == n - 2) pn2 = q0;
      if (k == n - 1) pn1 = q0;
      ld bk = (k == 0) ? 0.0L
                       : ((ld)k * (ld)k) / (4.0L * (ld)k * (ld)k - 1.0L);
      ld qnext = a * q0 - bk * qm1;
      qm1 = q0;
      q0 = qnext;
    }
    ld bn1 = ((ld)(n - 1) * (ld)(n - 1)) /
             (4.0L * (ld)(n - 1) * (ld)(n - 1) - 1.0L);
    d[n - 1] = a - bn1 * pn2 / pn1;
  }
  if (!tql2_first_row(d, e, z)) return 2;
  // Sort ascending by node, carrying weights.
  std::vector<int> idx(n);
  for (int i = 0; i < n; ++i) idx[i] = i;
  for (int i = 0; i < n; ++i)
    for (int j = i + 1; j < n; ++j)
      if (d[idx[j]] < d[idx[i]]) { int t = idx[i]; idx[i] = idx[j]; idx[j] = t; }
  std::vector<ld> x(n), w(n);
  for (int i = 0; i < n; ++i) {
    x[i] = d[idx[i]];
    w[i] = 2.0L * z[idx[i]] * z[idx[i]];  // mu_0 = 2 for Legendre on [-1,1]
  }
  x[0] = -1.0L;  // exact by construction
  // Newton polish on q(x) = P_{n-1}(x) + P_n(x) for the interior nodes;
  // q'(x) from P'_n = n (x P_n - P_{n-1}) / (x^2 - 1).
  for (int i = 1; i < n; ++i) {
    ld xi = x[i];
    for (int it = 0; it < 8; ++it) {
      ld pnm1, pn, pnm2, pnm1b;
      legendre_pair(n, xi, pnm1, pn);
      legendre_pair(n - 1, xi, pnm2, pnm1b);
      ld q = pnm1 + pn;
      ld denom = xi * xi - 1.0L;
      ld dpn = (ld)n * (xi * pn - pnm1) / denom;
      ld dpnm1 = (ld)(n - 1) * (xi * pnm1b - pnm2) / denom;
      ld dq = dpn + dpnm1;
      ld step = q / dq;
      xi -= step;
      if (fabsl(step) < 1e-19L) break;
    }
    x[i] = xi;
  }
  // Analytic weights: w_1 = 2/n^2; w_i = (1 - x_i) / (n^2 P_{n-1}(x_i)^2).
  w[0] = 2.0L / ((ld)n * (ld)n);
  for (int i = 1; i < n; ++i) {
    ld pnm1, pn;
    legendre_pair(n, x[i], pnm1, pn);
    w[i] = (1.0L - x[i]) / ((ld)n * (ld)n * pnm1 * pnm1);
  }
  for (int i = 0; i < n; ++i) {
    nodes[i] = (double)x[i];
    weights[i] = (double)w[i];
  }
  return 0;
}

// Dense barycentric differentiation matrix on arbitrary support points.
// pts: m points; D: m*m row-major output, D[i][j] = dL_j/dx (x_i).
int diff_matrix(int m, const double *pts, double *D) {
  if (m < 2) return 1;
  std::vector<ld> x(m), bw(m, 1.0L);
  for (int i = 0; i < m; ++i) x[i] = (ld)pts[i];
  for (int j = 0; j < m; ++j) {
    for (int k = 0; k < m; ++k)
      if (k != j) bw[j] *= (x[j] - x[k]);
    bw[j] = 1.0L / bw[j];
  }
  for (int i = 0; i < m; ++i) {
    ld diag = 0.0L;
    for (int j = 0; j < m; ++j) {
      if (i == j) continue;
      ld v = (bw[j] / bw[i]) / (x[i] - x[j]);
      D[i * m + j] = (double)v;
      diag -= v;
    }
    D[i * m + i] = (double)diag;
  }
  return 0;
}

}  // extern "C"
