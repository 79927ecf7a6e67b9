// Float64 per-tile refinisher for nuc-stage dyad statistics.
//
// The device computes per-bp norm/smooth tracks in f32 (models/engine.py);
// the printed per-dyad statistics in nucpos.bed (z, LR, signal, fuzz) and
// the candidate mask are re-derived here in float64 from the raw integer
// fragment window + the float64 bias model, making them equal to the
// float64 mirror (mirror/windows.py :: nuc_scores) up to ~1e-13 — far
// below the %.5g print surface, so printed rows are bit-identical to the
// mirror's (DESIGN.md §12). Native because the host has few cores and
// numpy's per-tile overhead (fancy gathers, python loops) costs ~2 ms per
// tile, while this runs in ~0.1-0.3 ms — the reference's analogous inner
// loop was Cython for the same reason (reference:
// nucleoatac/multinomial_cov.pyx, SURVEY.md §3.4.1).
//
// C ABI consumed by nucleoatac_jax/models/nuc_exact.py via ctypes.
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Tables {
  int W, K, Sv, size_lo, core_lo, core_hi;
  double v_floor;
  const double* vmat;  // [Sv*K]
  const double* logv;  // [Sv*K]
  const double* q;     // [Sv]
};

// Dense f64 fragment matrix over the vmat size range.
void rasterize(const int32_t* mids, const int32_t* sizes, long n,
               const Tables& t, std::vector<double>& F) {
  F.assign(static_cast<size_t>(t.Sv) * t.W, 0.0);
  for (long i = 0; i < n; ++i) {
    int m = mids[i], s = sizes[i] - t.size_lo;
    if (m >= 0 && m < t.W && s >= 0 && s < t.Sv)
      F[static_cast<size_t>(s) * t.W + m] += 1.0;
  }
}

// Expected-fragment matrix b0[s, p] = q(s) * e(left) * e(right) /
// core_sum(s), with e(x) = exp(log_bias[x]) inside the window and 1
// outside (log-bias 0), matching mirror.bias_mat / ops/biasmat.py.
void bias_mat(const double* log_bias, const Tables& t,
              std::vector<double>& B0) {
  const int W = t.W;
  std::vector<double> e(W);
  for (int p = 0; p < W; ++p) e[p] = std::exp(log_bias[p]);
  B0.resize(static_cast<size_t>(t.Sv) * W);
  for (int si = 0; si < t.Sv; ++si) {
    int s = t.size_lo + si;
    int a = (s - 1) / 2, b = s / 2;  // left/right insertion offsets
    double* row = &B0[static_cast<size_t>(si) * W];
    for (int p = 0; p < W; ++p) {
      int li = p - a, ri = p + b;
      double el = (li >= 0 && li < W) ? e[li] : 1.0;
      double er = (ri >= 0 && ri < W) ? e[ri] : 1.0;
      row[p] = el * er;
    }
    double cs = 0.0;
    for (int p = t.core_lo; p < t.core_hi; ++p) cs += row[p];
    double scale = t.q[si] / (cs > 0.0 ? cs : 1.0);
    for (int p = 0; p < W; ++p) row[p] *= scale;
  }
}

struct Sums {
  double signal, n, flogv, fo, fo2, bsum, vb, v2b;
};

// All eight footprint reductions at dyad column c (footprint
// [c-K/2, c+K/2]); the column must have a full footprint (guaranteed:
// candidates live in the core and halo >= K/2 + size shifts).
// The k loop is an 8-way FP reduction; gcc -O3 will not vectorize FP
// reductions without explicit permission (reassociation changes the
// summation order), so each sum is carried as SIMD partial sums via
// `omp simd` (-fopenmp-simd, no runtime dependency). This perturbs
// results only within the documented ~1e-13 operation-order band (the
// same function serves every f64 query, so selection comparisons remain
// self-consistent); measured ~3x per-column speedup.
Sums sums_at(const double* F, const double* B0, const Tables& t, long c) {
  const int K = t.K, W = t.W, half = K / 2;
  Sums o{};
  const long j0 = c - half;
  for (int si = 0; si < t.Sv; ++si) {
    const double* f = &F[static_cast<size_t>(si) * W + j0];
    const double* b = &B0[static_cast<size_t>(si) * W + j0];
    const double* v = &t.vmat[static_cast<size_t>(si) * K];
    const double* lv = &t.logv[static_cast<size_t>(si) * K];
    double sg = 0, n = 0, fl = 0, fo = 0, fo2 = 0, bs = 0, vb = 0, v2b = 0;
#pragma omp simd reduction(+ : sg, n, fl, fo, fo2, bs, vb, v2b)
    for (int k = 0; k < K; ++k) {
      double fk = f[k], bk = b[k], vk = v[k];
      double off = k - half;
      sg += vk * fk;
      n += fk;
      fl += lv[k] * fk;
      fo += off * fk;
      fo2 += off * off * fk;
      bs += bk;
      vb += vk * bk;
      v2b += vk * vk * bk;
    }
    o.signal += sg; o.n += n; o.flogv += fl; o.fo += fo; o.fo2 += fo2;
    o.bsum += bs; o.vb += vb; o.v2b += v2b;
  }
  return o;
}

// Norm-only column value: the five sums norm needs (signal, n, bsum,
// vb, v2b) — the SmoothResolver's point queries read nothing else, and
// dropping flogv/fo/fo2 skips the logV stream and ~40% of the flops
// (round 5; the resolver is the largest nuc-finishing term). Partial-sum
// vectorization may differ from sums_at's 8-way reduction, so values
// can sit ~1e-16 apart from the full kernel — inside the module's
// operation-order band (same acceptance as the FFT full-track path),
// and all resolver columns go through ONE kernel so its comparisons
// stay self-consistent.
double norm_col(const double* F, const double* B0, const Tables& t, long c,
                double var_floor) {
  const int K = t.K, W = t.W, half = K / 2;
  const long j0 = c - half;
  double signal = 0, n = 0, bsum = 0, vb = 0, v2b = 0;
  for (int si = 0; si < t.Sv; ++si) {
    const double* f = &F[static_cast<size_t>(si) * W + j0];
    const double* b = &B0[static_cast<size_t>(si) * W + j0];
    const double* v = &t.vmat[static_cast<size_t>(si) * K];
    double sg = 0, nn = 0, bs = 0, vbb = 0, v2 = 0;
#pragma omp simd reduction(+ : sg, nn, bs, vbb, v2)
    for (int k = 0; k < K; ++k) {
      double fk = f[k], bk = b[k], vk = v[k];
      sg += vk * fk;
      nn += fk;
      bs += bk;
      vbb += vk * bk;
      v2 += vk * vk * bk;
    }
    signal += sg; n += nn; bsum += bs; vb += vbb; v2b += v2;
  }
  double safe_b = bsum > 0 ? bsum : 1.0;
  double mu = vb / safe_b;
  double mu2 = v2b / safe_b;
  double var = n * (mu2 - mu * mu);
  bool ok = var > var_floor && n > 0;
  return ok ? (signal - n * mu) / std::sqrt(var) : 0.0;
}

// mirror.nuc_scores finishing formulas (DESIGN.md §7), float64.
void finish(const Sums& s, double var_floor, double* out6) {
  double safe_b = s.bsum > 0 ? s.bsum : 1.0;
  double mu = s.vb / safe_b;
  double mu2 = s.v2b / safe_b;
  double exp_signal = s.n * mu;
  double var = s.n * (mu2 - mu * mu);
  bool ok = var > var_floor && s.n > 0;
  double norm = ok ? (s.signal - exp_signal) / std::sqrt(var) : 0.0;
  double lr =
      s.n > 0 ? s.flogv - s.n * std::log(mu > 1e-300 ? mu : 1e-300) : 0.0;
  double fuzz = 0.0;
  if (s.n > 0) {
    double m1 = s.fo / s.n, m2 = s.fo2 / s.n;
    double d = m2 - m1 * m1;
    fuzz = std::sqrt(d > 0 ? d : 0.0);
  }
  out6[0] = norm;
  out6[1] = lr;
  out6[2] = s.signal;
  out6[3] = fuzz;
  out6[4] = s.n;
  out6[5] = 0.0;  // smooth, filled by caller when requested
}

}  // namespace

extern "C" {

// Build the f64 fragment matrix F [Sv, W] and expected matrix B0 [Sv, W]
// once for a tile; the _pre query entry points below reuse them across
// stats/norm-column calls (the round-4 SmoothResolver issues several
// batched queries per tile, and rebuilding F/B0 per call dominated the
// resolution cost).
int nucrefine_build(const int32_t* mids, const int32_t* sizes, long n_frags,
                    const double* log_bias, const double* q, int W, int K,
                    int Sv, int size_lo, int core_lo, int core_hi,
                    double* outF, double* outB0) {
  Tables t{W, K, Sv, size_lo, core_lo, core_hi, 0.0, nullptr, nullptr, q};
  std::vector<double> F, B0;
  rasterize(mids, sizes, n_frags, t, F);
  bias_mat(log_bias, t, B0);
  std::memcpy(outF, F.data(), F.size() * sizeof(double));
  std::memcpy(outB0, B0.data(), B0.size() * sizeof(double));
  return 0;
}

// nucrefine_stats on prebuilt F/B0 (same math, same summation order).
int nucrefine_stats_pre(const double* Fp, const double* B0p,
                        const double* q, const double* vmat,
                        const double* logv, int W, int K, int Sv,
                        int size_lo, int core_lo, int core_hi,
                        double var_floor, const int64_t* cols, long n_cols,
                        int want_smooth, const double* gk, int gk_len,
                        double* out) {
  Tables t{W, K, Sv, size_lo, core_lo, core_hi, 0.0, vmat, logv, q};
  const int half = K / 2;
  for (long i = 0; i < n_cols; ++i) {
    long c = cols[i];
    if (c < half || c >= W - half) return -1;
    finish(sums_at(Fp, B0p, t, c), var_floor, &out[i * 6]);
    if (want_smooth) {
      int hw = gk_len / 2;
      if (c - hw < half || c + hw >= W - half) return -2;
      double sm = 0.0, tmp[6];
      for (int d = -hw; d <= hw; ++d) {
        finish(sums_at(Fp, B0p, t, c + d), var_floor, tmp);
        sm += gk[d + hw] * tmp[0];
      }
      out[i * 6 + 5] = sm;
    }
  }
  return 0;
}

// nucrefine_norm_track on prebuilt F/B0.
// Norm values at specific columns (the SmoothResolver point path).
int nucrefine_norm_cols_pre(const double* Fp, const double* B0p,
                            const double* q, const double* vmat,
                            const double* logv, int W, int K, int Sv,
                            int size_lo, int core_lo, int core_hi,
                            double var_floor, const int64_t* cols,
                            long n_cols, double* out_norm) {
  Tables t{W, K, Sv, size_lo, core_lo, core_hi, 0.0, vmat, logv, q};
  const int half = K / 2;
  for (long i = 0; i < n_cols; ++i) {
    long c = cols[i];
    if (c < half || c >= W - half) return -1;
    out_norm[i] = norm_col(Fp, B0p, t, c, var_floor);
  }
  return 0;
}

int nucrefine_norm_track_pre(const double* Fp, const double* B0p,
                             const double* q, const double* vmat,
                             const double* logv, int W, int K, int Sv,
                             int size_lo, int core_lo, int core_hi,
                             double var_floor, double* out_norm) {
  Tables t{W, K, Sv, size_lo, core_lo, core_hi, 0.0, vmat, logv, q};
  const int half = K / 2;
  std::memset(out_norm, 0, sizeof(double) * W);
  double tmp[6];
  for (long c = half; c < W - half; ++c) {
    finish(sums_at(Fp, B0p, t, c), var_floor, tmp);
    out_norm[c] = tmp[0];
  }
  return 0;
}

// Per-dyad f64 statistics at window-relative columns `cols`.
// out: [n_cols, 6] = norm, lr, signal, fuzz, n, smooth.
// want_smooth: also compute smooth[c] = sum_t gk[t] * norm64[c + t - hw]
// (gk length 2*hw+1), requiring norm at the 2*hw neighbors of each col.
int nucrefine_stats(const int32_t* mids, const int32_t* sizes, long n_frags,
                    const double* log_bias, const double* q,
                    const double* vmat, const double* logv, int W, int K,
                    int Sv, int size_lo, int core_lo, int core_hi,
                    double var_floor, const int64_t* cols, long n_cols,
                    int want_smooth, const double* gk, int gk_len,
                    double* out) {
  Tables t{W, K, Sv, size_lo, core_lo, core_hi, 0.0, vmat, logv, q};
  std::vector<double> F, B0;
  rasterize(mids, sizes, n_frags, t, F);
  bias_mat(log_bias, t, B0);
  const int half = K / 2;
  for (long i = 0; i < n_cols; ++i) {
    long c = cols[i];
    if (c < half || c >= W - half) return -1;  // no full footprint
    finish(sums_at(F.data(), B0.data(), t, c), var_floor, &out[i * 6]);
    if (want_smooth) {
      int hw = gk_len / 2;
      if (c - hw < half || c + hw >= W - half) return -2;
      double sm = 0.0, tmp[6];
      for (int d = -hw; d <= hw; ++d) {
        finish(sums_at(F.data(), B0.data(), t, c + d), var_floor, tmp);
        sm += gk[d + hw] * tmp[0];
      }
      out[i * 6 + 5] = sm;
    }
  }
  return 0;
}

// Full-width f64 norm track (tie-guard fallback / strict mode): norm at
// every column with a full footprint; columns without one are 0.
int nucrefine_norm_track(const int32_t* mids, const int32_t* sizes,
                         long n_frags, const double* log_bias,
                         const double* q, const double* vmat,
                         const double* logv, int W, int K, int Sv,
                         int size_lo, int core_lo, int core_hi,
                         double var_floor, double* out_norm) {
  Tables t{W, K, Sv, size_lo, core_lo, core_hi, 0.0, vmat, logv, q};
  std::vector<double> F, B0;
  rasterize(mids, sizes, n_frags, t, F);
  bias_mat(log_bias, t, B0);
  const int half = K / 2;
  std::memset(out_norm, 0, sizeof(double) * W);
  double tmp[6];
  for (long c = half; c < W - half; ++c) {
    finish(sums_at(F.data(), B0.data(), t, c), var_floor, tmp);
    out_norm[c] = tmp[0];
  }
  return 0;
}

}  // extern "C"
