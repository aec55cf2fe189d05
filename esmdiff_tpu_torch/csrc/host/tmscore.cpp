// Native TM-score implementation (C++17, no dependencies): the port's own
// copy of native/tmscore/tmscore.cpp, with the superposition repaired.
//
// The reference framework shells out to the external C++ `TMscore` binary
// (slm/utils/tm_utils.py:46-59).  This is a from-scratch implementation of
// the TM-score algorithm (Zhang & Skolnick, Proteins 2004): iterative
// fragment-seeded Kabsch superposition maximizing
//     TM = (1/L) * sum_i 1 / (1 + (d_i/d0)^2),   d0 = 1.24*(L-15)^(1/3) - 1.8
//
// Exposed as a C ABI for ctypes:
//   double tm_score(const double* xa, const double* xb, int n, double* rmsd)
//     xa, xb: n*3 doubles (model / native CA coords, residue-aligned)
//     returns TM-score normalized by n; *rmsd = RMSD of the global Kabsch fit.
//
// The repair: the shared source takes the rotation from a shifted power
// iteration capped at 200 steps, which on poorly superposable pairs (far
// from native) stops short of the optimal fit.  Here the iteration is kept
// where it converges (a step moving q by less than 1e-14), so those fits,
// and the scores of near-native pairs, are the shared library's bit for
// bit; where it reaches its cap, the top eigenvector comes from cyclic
// Jacobi sweeps over the symmetric 4x4 key matrix, run until the
// off-diagonal norm is below 1e-14 of the matrix's, which is the optimal
// (SVD) fit.

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

struct Mat3 {
  double m[3][3];
};

struct Vec3 {
  double v[3];
};

// The eigenvector of the largest eigenvalue of the symmetric 4x4 S, by
// cyclic Jacobi sweeps (Numerical Recipes' rotation) until the off-diagonal
// Frobenius norm is below 1e-14 of S's.
void jacobi_top_eigenvector(const double S[4][4], double q[4]) {
  double A[4][4], V[4][4];
  double fro = 0.0;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      A[i][j] = S[i][j];
      V[i][j] = i == j ? 1.0 : 0.0;
      fro += S[i][j] * S[i][j];
    }
  fro = std::sqrt(fro);
  for (int sweep = 0; sweep < 64; ++sweep) {
    double off = 0.0;
    for (int p = 0; p < 4; ++p)
      for (int r = p + 1; r < 4; ++r) off += 2.0 * A[p][r] * A[p][r];
    if (std::sqrt(off) <= 1e-14 * fro) break;
    for (int p = 0; p < 4; ++p) {
      for (int r = p + 1; r < 4; ++r) {
        if (A[p][r] == 0.0) continue;
        const double theta = (A[r][r] - A[p][p]) / (2.0 * A[p][r]);
        const double t = (theta >= 0.0 ? 1.0 : -1.0) /
                         (std::abs(theta) + std::sqrt(theta * theta + 1.0));
        const double c = 1.0 / std::sqrt(t * t + 1.0), s = t * c;
        for (int k = 0; k < 4; ++k) {  // A <- A J
          const double akp = A[k][p], akr = A[k][r];
          A[k][p] = c * akp - s * akr;
          A[k][r] = s * akp + c * akr;
        }
        for (int k = 0; k < 4; ++k) {  // A <- J^T A
          const double apk = A[p][k], ark = A[r][k];
          A[p][k] = c * apk - s * ark;
          A[r][k] = s * apk + c * ark;
        }
        for (int k = 0; k < 4; ++k) {  // V <- V J
          const double vkp = V[k][p], vkr = V[k][r];
          V[k][p] = c * vkp - s * vkr;
          V[k][r] = s * vkp + c * vkr;
        }
      }
    }
  }
  int top = 0;
  for (int i = 1; i < 4; ++i)
    if (A[i][i] > A[top][top]) top = i;
  for (int i = 0; i < 4; ++i) q[i] = V[i][top];
}

// 3x3 SVD-free Kabsch via quaternion (Horn's method): the top eigenvector
// of the 4x4 key matrix by a shifted power iteration, finished by Jacobi
// sweeps where the iteration reaches its cap (see the header).
// Returns rotation R and translation t minimizing ||R*a + t - b||^2.
void kabsch(const std::vector<Vec3>& a, const std::vector<Vec3>& b,
            const std::vector<int>& idx, Mat3* R, Vec3* t) {
  const int n = static_cast<int>(idx.size());
  double ca[3] = {0, 0, 0}, cb[3] = {0, 0, 0};
  for (int k : idx) {
    for (int d = 0; d < 3; ++d) {
      ca[d] += a[k].v[d];
      cb[d] += b[k].v[d];
    }
  }
  for (int d = 0; d < 3; ++d) {
    ca[d] /= n;
    cb[d] /= n;
  }
  // covariance H = sum (a-ca)(b-cb)^T
  double H[3][3] = {{0, 0, 0}, {0, 0, 0}, {0, 0, 0}};
  for (int k : idx) {
    double pa[3], pb[3];
    for (int d = 0; d < 3; ++d) {
      pa[d] = a[k].v[d] - ca[d];
      pb[d] = b[k].v[d] - cb[d];
    }
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) H[i][j] += pa[i] * pb[j];
  }
  // Build the 4x4 quaternion matrix (Horn 1987).
  double S[4][4];
  S[0][0] = H[0][0] + H[1][1] + H[2][2];
  S[0][1] = H[1][2] - H[2][1];
  S[0][2] = H[2][0] - H[0][2];
  S[0][3] = H[0][1] - H[1][0];
  S[1][1] = H[0][0] - H[1][1] - H[2][2];
  S[1][2] = H[0][1] + H[1][0];
  S[1][3] = H[2][0] + H[0][2];
  S[2][2] = -H[0][0] + H[1][1] - H[2][2];
  S[2][3] = H[1][2] + H[2][1];
  S[3][3] = -H[0][0] - H[1][1] + H[2][2];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < i; ++j) S[i][j] = S[j][i];

  // Largest eigenvector of S by shifted power iteration (Gershgorin shift
  // guarantees the target eigenvalue is the dominant one of S + shift*I).
  double shift = 0.0;
  for (int i = 0; i < 4; ++i) {
    double row = 0.0;
    for (int j = 0; j < 4; ++j) row += std::abs(S[i][j]);
    shift = std::max(shift, row);
  }
  double q[4] = {1, 0.02, 0.03, 0.04};
  bool converged = false;
  for (int it = 0; it < 200; ++it) {
    double nq[4];
    for (int i = 0; i < 4; ++i) {
      nq[i] = shift * q[i];
      for (int j = 0; j < 4; ++j) nq[i] += S[i][j] * q[j];
    }
    double norm = 0;
    for (int i = 0; i < 4; ++i) norm += nq[i] * nq[i];
    norm = std::sqrt(norm);
    if (norm < 1e-30) {
      converged = true;  // a degenerate key matrix: q is kept
      break;
    }
    double diff = 0;
    for (int i = 0; i < 4; ++i) {
      nq[i] /= norm;
      diff += std::abs(nq[i] - q[i]);
      q[i] = nq[i];
    }
    if (diff < 1e-14) {
      converged = true;
      break;
    }
  }
  if (!converged) jacobi_top_eigenvector(S, q);
  const double q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3];
  R->m[0][0] = q0 * q0 + q1 * q1 - q2 * q2 - q3 * q3;
  R->m[0][1] = 2 * (q1 * q2 - q0 * q3);
  R->m[0][2] = 2 * (q1 * q3 + q0 * q2);
  R->m[1][0] = 2 * (q1 * q2 + q0 * q3);
  R->m[1][1] = q0 * q0 - q1 * q1 + q2 * q2 - q3 * q3;
  R->m[1][2] = 2 * (q2 * q3 - q0 * q1);
  R->m[2][0] = 2 * (q1 * q3 - q0 * q2);
  R->m[2][1] = 2 * (q2 * q3 + q0 * q1);
  R->m[2][2] = q0 * q0 - q1 * q1 - q2 * q2 + q3 * q3;
  // Horn's quaternion rotates the a-frame onto the b-frame: y = R*(x-ca)+cb.
  // Fold the centroids into the translation: y = R*x + (cb - R*ca).
  for (int i = 0; i < 3; ++i) {
    t->v[i] = cb[i];
    for (int j = 0; j < 3; ++j) t->v[i] -= R->m[i][j] * ca[j];
  }
}

inline void apply(const Mat3& R, const Vec3& t, const Vec3& x, Vec3* y) {
  for (int i = 0; i < 3; ++i) {
    y->v[i] = t.v[i];
    for (int j = 0; j < 3; ++j) y->v[i] += R.m[i][j] * x.v[j];
  }
}

double score_under(const std::vector<Vec3>& a, const std::vector<Vec3>& b,
                   const Mat3& R, const Vec3& t, double d0,
                   std::vector<double>* dist) {
  const int n = static_cast<int>(a.size());
  double s = 0;
  for (int i = 0; i < n; ++i) {
    Vec3 y;
    apply(R, t, a[i], &y);
    double d2 = 0;
    for (int d = 0; d < 3; ++d) {
      double diff = y.v[d] - b[i].v[d];
      d2 += diff * diff;
    }
    double dd = std::sqrt(d2);
    (*dist)[i] = dd;
    s += 1.0 / (1.0 + (dd / d0) * (dd / d0));
  }
  return s / n;
}

}  // namespace

extern "C" double tm_score(const double* xa, const double* xb, int n,
                           double* rmsd_out) {
  if (n < 3) return 0.0;
  std::vector<Vec3> a(n), b(n);
  for (int i = 0; i < n; ++i) {
    std::memcpy(a[i].v, xa + 3 * i, sizeof(double) * 3);
    std::memcpy(b[i].v, xb + 3 * i, sizeof(double) * 3);
  }
  double d0 = n > 21 ? 1.24 * std::cbrt(n - 15.0) - 1.8 : 0.5;
  d0 = std::max(d0, 0.5);
  const double d0_search = std::min(std::max(d0, 4.5), 8.0);

  // global Kabsch RMSD
  std::vector<int> all(n);
  for (int i = 0; i < n; ++i) all[i] = i;
  {
    Mat3 R;
    Vec3 t;
    kabsch(a, b, all, &R, &t);
    double s2 = 0;
    for (int i = 0; i < n; ++i) {
      Vec3 y;
      apply(R, t, a[i], &y);
      for (int d = 0; d < 3; ++d) {
        double diff = y.v[d] - b[i].v[d];
        s2 += diff * diff;
      }
    }
    if (rmsd_out) *rmsd_out = std::sqrt(s2 / n);
  }

  double best = 0.0;
  std::vector<double> dist(n);
  // fragment seeds: L, L/2, L/4, ... >= 4
  for (int frag = n; frag >= 4; frag /= 2) {
    int step = std::max(frag / 2, 1);
    for (int start = 0; start + frag <= n; start += step) {
      std::vector<int> idx;
      idx.reserve(frag);
      for (int i = start; i < start + frag; ++i) idx.push_back(i);
      // iterative extension with shrinking cutoff
      for (int iter = 0; iter < 20; ++iter) {
        if (static_cast<int>(idx.size()) < 3) break;
        Mat3 R;
        Vec3 t;
        kabsch(a, b, idx, &R, &t);
        double s = score_under(a, b, R, t, d0, &dist);
        if (s > best) best = s;
        // rebuild idx from residues within the search cutoff
        double cut = d0_search - iter * 0.5;
        cut = std::max(cut, 3.0);
        std::vector<int> next;
        for (int i = 0; i < n; ++i)
          if (dist[i] < cut) next.push_back(i);
        if (static_cast<int>(next.size()) < 3) break;
        if (next == idx) break;
        idx.swap(next);
      }
    }
  }
  return best;
}

// Batched entry point: m pairs of n-residue structures.
extern "C" void tm_score_batch(const double* xa, const double* xb, int m,
                               int n, double* tm_out, double* rmsd_out) {
  for (int k = 0; k < m; ++k) {
    tm_out[k] = tm_score(xa + static_cast<long>(k) * n * 3,
                         xb + static_cast<long>(k) * n * 3, n,
                         rmsd_out ? rmsd_out + k : nullptr);
  }
}
