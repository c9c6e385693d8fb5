// astrild_native: CPU-side native kernels for the TPU-native framework.
//
// Role (mirrors the reference's native components, SURVEY.md §2):
//  * kappa0_to_alphas / kappa0_to_phi — zero-padded FFT convolution with
//    the isochrone / log kernels, independent C++ implementation of the
//    math in the reference's lib_so_cgls/lensing_funcs.c (FFTW replaced by
//    a self-contained iterative radix-2 FFT) — used to cross-validate the
//    JAX spectral lensing ops.
//  * pairwise_velocity_accumulate — O(N^2) Yasini+18 estimator
//    (reference Cython pairwise_velocity.pyx / numba kernel), OpenMP
//    parallel — correctness oracle for the blocked Pallas/XLA kernels and
//    fast host-side path for small catalogs.
//  * read_f77_doubles — buffered Fortran-record payload extraction for
//    RAMSES grav files (fast path for io/ramses.py).
//
// Exposed with plain C symbols for ctypes; build: `make` in this directory.
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

using cplx = std::complex<double>;

namespace {

// ---------------------------------------------------------- radix-2 FFT
void fft_1d(cplx *a, size_t n, bool inverse) {
  // iterative Cooley-Tukey, n must be a power of two
  for (size_t i = 1, j = 0; i < n; i++) {
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    double ang = 2.0 * M_PI / (double)len * (inverse ? 1.0 : -1.0);
    cplx wlen(std::cos(ang), std::sin(ang));
    for (size_t i = 0; i < n; i += len) {
      cplx w(1.0);
      for (size_t k = 0; k < len / 2; k++) {
        cplx u = a[i + k];
        cplx v = a[i + k + len / 2] * w;
        a[i + k] = u + v;
        a[i + k + len / 2] = u - v;
        w *= wlen;
      }
    }
  }
  if (inverse) {
    for (size_t i = 0; i < n; i++) a[i] /= (double)n;
  }
}

void fft_2d(std::vector<cplx> &a, size_t n, bool inverse) {
  // rows
#pragma omp parallel for schedule(static)
  for (long long r = 0; r < (long long)n; r++) fft_1d(&a[r * n], n, inverse);
  // columns (transpose, fft, transpose back)
  std::vector<cplx> col(n * n);
#pragma omp parallel for schedule(static)
  for (long long r = 0; r < (long long)n; r++)
    for (size_t c = 0; c < n; c++) col[c * n + r] = a[r * n + c];
#pragma omp parallel for schedule(static)
  for (long long r = 0; r < (long long)n; r++) fft_1d(&col[r * n], n, inverse);
#pragma omp parallel for schedule(static)
  for (long long r = 0; r < (long long)n; r++)
    for (size_t c = 0; c < n; c++) a[r * n + c] = col[c * n + r];
}

size_t next_pow2(size_t x) {
  size_t p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// kappa (npix x npix, row-major, opening_angle in radians) ->
// alpha1/alpha2 (same shape). Convolution with the isochrone kernel
// x/(pi r^2) on a zero-padded grid (cf. lensing_funcs.c:45-115).
void kappa0_to_alphas(const double *kappa, int npix, double opening_angle,
                      double *alpha1, double *alpha2) {
  size_t n = (size_t)npix;
  size_t npad = next_pow2(4 * n);
  double ds = opening_angle / (double)n;
  std::vector<cplx> kap(npad * npad), k1(npad * npad), k2(npad * npad);
  for (size_t r = 0; r < n; r++)
    for (size_t c = 0; c < n; c++) kap[r * npad + c] = kappa[r * n + c];
  // kernel centered at (0,0) with wrap-around layout; component i of
  // K(x) = x_i / (pi |x|^2), integrated: multiply by pixel area ds^2
  for (size_t r = 0; r < npad; r++) {
    double x1 = (r <= npad / 2) ? (double)r : (double)r - (double)npad;
    x1 *= ds;
    for (size_t c = 0; c < npad; c++) {
      double x2 = (c <= npad / 2) ? (double)c : (double)c - (double)npad;
      x2 *= ds;
      double r2 = x1 * x1 + x2 * x2;
      if (r2 > 0) {
        k1[r * npad + c] = x1 / (M_PI * r2) * ds * ds;
        k2[r * npad + c] = x2 / (M_PI * r2) * ds * ds;
      }
    }
  }
  fft_2d(kap, npad, false);
  fft_2d(k1, npad, false);
  fft_2d(k2, npad, false);
  for (size_t i = 0; i < npad * npad; i++) {
    cplx kv = kap[i];
    k1[i] *= kv;
    k2[i] *= kv;
  }
  fft_2d(k1, npad, true);
  fft_2d(k2, npad, true);
  for (size_t r = 0; r < n; r++)
    for (size_t c = 0; c < n; c++) {
      // the ds*ds pixel-area quadrature factor is already baked into
      // the kernel at construction above; no output normalization
      alpha1[r * n + c] = k1[r * npad + c].real();
      alpha2[r * n + c] = k2[r * npad + c].real();
    }
}

// kappa -> lensing potential phi via the log kernel ln|x|/pi
// (cf. lensing_funcs.c:117-173).
void kappa0_to_phi(const double *kappa, int npix, double opening_angle,
                   double *phi) {
  size_t n = (size_t)npix;
  size_t npad = next_pow2(4 * n);
  double ds = opening_angle / (double)n;
  std::vector<cplx> kap(npad * npad), ker(npad * npad);
  for (size_t r = 0; r < n; r++)
    for (size_t c = 0; c < n; c++) kap[r * npad + c] = kappa[r * n + c];
  for (size_t r = 0; r < npad; r++) {
    double x1 = (r <= npad / 2) ? (double)r : (double)r - (double)npad;
    x1 *= ds;
    for (size_t c = 0; c < npad; c++) {
      double x2 = (c <= npad / 2) ? (double)c : (double)c - (double)npad;
      x2 *= ds;
      double rr = std::sqrt(x1 * x1 + x2 * x2);
      ker[r * npad + c] = (rr > 0) ? std::log(rr) / M_PI * ds * ds : 0.0;
    }
  }
  fft_2d(kap, npad, false);
  fft_2d(ker, npad, false);
  for (size_t i = 0; i < npad * npad; i++) ker[i] *= kap[i];
  fft_2d(ker, npad, true);
  for (size_t r = 0; r < n; r++)
    for (size_t c = 0; c < n; c++) phi[r * n + c] = ker[r * npad + c].real();
}

// Yasini+18 Eq. 6 pairwise accumulation over all i<j pairs.
// pos/vel: (n,3) row-major; nom/denom: (binnr,) accumulated in place.
void pairwise_velocity_accumulate(const double *pos, const double *vel,
                                  long long n, double binwidth, int binnr,
                                  double *nom, double *denom) {
#ifdef _OPENMP
  int nthreads = omp_get_max_threads();
#else
  int nthreads = 1;
#endif
  std::vector<double> nom_t((size_t)nthreads * binnr, 0.0);
  std::vector<double> den_t((size_t)nthreads * binnr, 0.0);
#pragma omp parallel
  {
#ifdef _OPENMP
    int tid = omp_get_thread_num();
#else
    int tid = 0;
#endif
    double *nm = &nom_t[(size_t)tid * binnr];
    double *dn = &den_t[(size_t)tid * binnr];
#pragma omp for schedule(dynamic, 64)
    for (long long i = 0; i < n - 1; i++) {
      const double *pi = &pos[3 * i];
      const double *vi = &vel[3 * i];
      double ni = std::sqrt(pi[0] * pi[0] + pi[1] * pi[1] + pi[2] * pi[2]);
      double hi0 = pi[0] / ni, hi1 = pi[1] / ni, hi2 = pi[2] / ni;
      for (long long j = i + 1; j < n; j++) {
        const double *pj = &pos[3 * j];
        double d0 = pi[0] - pj[0], d1 = pi[1] - pj[1], d2 = pi[2] - pj[2];
        double dn2 = std::sqrt(d0 * d0 + d1 * d1 + d2 * d2);
        int b = (int)(dn2 / binwidth);
        if (b >= binnr) continue;
        const double *vj = &vel[3 * j];
        double nj = std::sqrt(pj[0] * pj[0] + pj[1] * pj[1] + pj[2] * pj[2]);
        double hj0 = pj[0] / nj, hj1 = pj[1] / nj, hj2 = pj[2] / nj;
        double r0 = d0 / dn2, r1 = d1 / dn2, r2 = d2 / dn2;
        double di = r0 * hi0 + r1 * hi1 + r2 * hi2;
        double dj = r0 * hj0 + r1 * hj1 + r2 * hj2;
        double q0 = 0.5 * (2.0 * r0 - hi0 * di - hj0 * dj);
        double q1 = 0.5 * (2.0 * r1 - hi1 * di - hj1 * dj);
        double q2 = 0.5 * (2.0 * r2 - hi2 * di - hj2 * dj);
        double tv0 = vi[0] - vj[0], tv1 = vi[1] - vj[1], tv2 = vi[2] - vj[2];
        nm[b] += tv0 * q0 + tv1 * q1 + tv2 * q2;
        dn[b] += q0 * q0 + q1 * q1 + q2 * q2;
      }
    }
  }
  for (int t = 0; t < nthreads; t++)
    for (int b = 0; b < binnr; b++) {
      nom[b] += nom_t[(size_t)t * binnr + b];
      denom[b] += den_t[(size_t)t * binnr + b];
    }
}

// Extract the payloads of consecutive Fortran-77 records holding float64
// data from a byte buffer. Returns number of doubles written, or -1 on a
// marker mismatch. Used as the fast path for RAMSES grav parsing.
long long read_f77_doubles(const unsigned char *buf, long long nbytes,
                           double *out, long long max_out) {
  long long pos = 0, nout = 0;
  while (pos + 8 <= nbytes) {
    int32_t m1;
    std::memcpy(&m1, buf + pos, 4);
    if (m1 <= 0 || m1 % 8 != 0 || pos + 8 + m1 > nbytes) break;
    int32_t m2;
    std::memcpy(&m2, buf + pos + 4 + m1, 4);
    if (m1 != m2) return -1;
    long long cnt = m1 / 8;
    if (nout + cnt > max_out) break;
    std::memcpy(out + nout, buf + pos + 4, (size_t)m1);
    nout += cnt;
    pos += 8 + m1;
  }
  return nout;
}

}  // extern "C"
