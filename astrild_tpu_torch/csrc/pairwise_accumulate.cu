// Mean-pairwise-velocity pair sums for Hopper (sm_90a).
//
// Replaces the TPU kernel astrild_tpu/ops/pallas_pairwise.py:
// pairwise_accumulate_pallas (body _kernel). Over all pairs i < j of the
// first n_valid rows it sums, per separation bin b = int(|r_ij| / binwidth)
// < nbins, the Yasini+18 (Eq. 6) numerator and denominator
//
//     nom[b] += (v_i - v_j) . q_ij,     den[b] += q_ij . q_ij,
//     q_ij = (2 rhat - phat_i (rhat . phat_i) - phat_j (rhat . phat_j)) / 2,
//
// with r_ij = x_i - x_j, rhat = r_ij / max(|r_ij|, 1e-12) and phat the unit
// line of sight (computed by the wrapper, astrild_tpu_torch/ops/
// pairwise_cuda.py). The float -> int bin cast is taken only after the
// separation is known to lie below nbins * binwidth, as the XLA path does.
//
// The TPU grid ran sequentially, so its kernel could accumulate into one
// output block across all tiles, and it binned a tile with a loop of masked
// lane reductions. On the card the blocks run in any order: one block per
// (i-tile, j-tile) pair with i-tile <= j-tile stages the j-tile's positions,
// velocities and lines of sight in shared memory, each thread owns one i
// and walks the tile, and pairs beyond the last bin skip the q arithmetic.
// Each warp bins into its own shared-memory copy of the bins (atomics
// contend only inside a warp); the block sums its warps' copies into one
// partial row in device memory. A second kernel reduces the partial rows in
// float64, one block per (quantity, bin), in a fixed order, so the result
// does not depend on the order in which blocks ran, and a float32 atomic
// sum over ~10^10 pairs is avoided. Inside a block the float32 shared-memory
// atomics add in whatever order the hardware serialises a warp's lanes, so
// two runs agree to float32 rounding of a block's sums, not bit for bit.
//
// Bound: arithmetic. Each pair costs ~10 flops to find its separation and
// ~40 more when it lands in a bin; memory traffic is O(n) per tile. The
// partial rows take 2 * nbins floats per block.
//
// Plain C interface (no PyTorch headers): loaded with ctypes by
// astrild_tpu_torch/_ext.py and launched on the caller's stream.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 256;  // particles per tile = threads per block
constexpr int kWarps = kTile / 32;
constexpr int kMaxBins = 128;
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kTile)
    pair_tiles_kernel(const float* __restrict__ pos,
                      const float* __restrict__ vel,
                      const float* __restrict__ hat, int64_t n_valid,
                      int64_t n_tiles, float binwidth, int nbins,
                      float* __restrict__ partials) {
  __shared__ float sp[3][kTile];
  __shared__ float sv[3][kTile];
  __shared__ float sh[3][kTile];
  __shared__ float bins[kWarps][2][kMaxBins];

  // block -> (ti, tj), ti <= tj, row-major over the upper triangle
  int64_t rem = blockIdx.x;
  int64_t ti = 0;
  while (rem >= n_tiles - ti) {
    rem -= n_tiles - ti;
    ++ti;
  }
  const int64_t tj = ti + rem;

  const int warp = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < kWarps * 2 * kMaxBins; k += kTile) {
    (&bins[0][0][0])[k] = 0.0f;
  }
  const int64_t j0 = tj * kTile;
  const int64_t jl = j0 + threadIdx.x;
  for (int c = 0; c < 3; ++c) {
    const bool ok = jl < n_valid;
    sp[c][threadIdx.x] = ok ? pos[3 * jl + c] : 0.0f;
    sv[c][threadIdx.x] = ok ? vel[3 * jl + c] : 0.0f;
    sh[c][threadIdx.x] = ok ? hat[3 * jl + c] : 0.0f;
  }
  __syncthreads();

  const int64_t i = ti * kTile + threadIdx.x;
  if (i < n_valid) {
    const float px = pos[3 * i], py = pos[3 * i + 1], pz = pos[3 * i + 2];
    const float vx = vel[3 * i], vy = vel[3 * i + 1], vz = vel[3 * i + 2];
    const float hx = hat[3 * i], hy = hat[3 * i + 1], hz = hat[3 * i + 2];
    // pairs i < j < n_valid of this tile
    const int64_t first = (i + 1 > j0 ? i + 1 : j0) - j0;
    const int64_t last = (n_valid - j0 < kTile ? n_valid - j0 : kTile);
    for (int64_t jj = first; jj < last; ++jj) {
      const float rx = px - sp[0][jj];
      const float ry = py - sp[1][jj];
      const float rz = pz - sp[2][jj];
      // separation and bin rounded exactly as the plain version's separate
      // ops ((x^2 + y^2) + z^2, sqrt, true division): no FMA contraction,
      // so a pair on a bin edge lands in the same bin in both
      const float dist = sqrtf(__fadd_rn(
          __fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)), __fmul_rn(rz, rz)));
      const float t = __fdiv_rn(dist, binwidth);
      if (!(t < static_cast<float>(nbins))) continue;  // also drops NaN
      const int b = static_cast<int>(t);
      const float inv = 1.0f / fmaxf(dist, 1e-12f);
      const float ux = rx * inv, uy = ry * inv, uz = rz * inv;
      const float hjx = sh[0][jj], hjy = sh[1][jj], hjz = sh[2][jj];
      const float di = ux * hx + uy * hy + uz * hz;
      const float dj = ux * hjx + uy * hjy + uz * hjz;
      const float qx = 0.5f * (2.0f * ux - hx * di - hjx * dj);
      const float qy = 0.5f * (2.0f * uy - hy * di - hjy * dj);
      const float qz = 0.5f * (2.0f * uz - hz * di - hjz * dj);
      const float nom = (vx - sv[0][jj]) * qx + (vy - sv[1][jj]) * qy +
                        (vz - sv[2][jj]) * qz;
      const float den = qx * qx + qy * qy + qz * qz;
      atomicAdd(&bins[warp][0][b], nom);
      atomicAdd(&bins[warp][1][b], den);
    }
  }
  __syncthreads();

  float* row = partials + static_cast<int64_t>(blockIdx.x) * 2 * nbins;
  for (int k = threadIdx.x; k < 2 * nbins; k += kTile) {
    const int q = k / nbins;
    const int b = k - q * nbins;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += bins[w][q][b];
    row[k] = s;
  }
}

// out[k] = sum over blocks of partials[block][k], k < 2 * nbins, in float64
// and in a fixed order (strided per thread, then a tree over the threads).
__global__ void __launch_bounds__(kReduceThreads)
    reduce_partials_kernel(const float* __restrict__ partials,
                           int64_t n_rows, int width,
                           float* __restrict__ out) {
  __shared__ double red[kReduceThreads];
  const int k = blockIdx.x;
  double s = 0.0;
  for (int64_t r = threadIdx.x; r < n_rows; r += kReduceThreads) {
    s += static_cast<double>(partials[r * width + k]);
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int stride = kReduceThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[k] = static_cast<float>(red[0]);
}

int64_t tiles_for(int64_t n) { return (n + kTile - 1) / kTile; }

}  // namespace

// Number of partial rows (2 * nbins floats each) the launcher needs as
// scratch for n_valid rows: one per (i-tile, j-tile) pair with i <= j.
extern "C" int64_t astrild_pairwise_partials_rows(int64_t n_valid) {
  const int64_t t = tiles_for(n_valid);
  return t * (t + 1) / 2;
}

// pos, vel, hat: (n, 3) float32 row-major device arrays (only the first
// n_valid rows are read); partials: scratch of
// astrild_pairwise_partials_rows(n_valid) * 2 * nbins floats; out: (2, nbins)
// float32 = (nom, den). `stream` is a cudaStream_t. Returns the cudaError_t
// of the launches (0 on success).
extern "C" int astrild_pairwise_accumulate(const float* pos, const float* vel,
                                           const float* hat, int64_t n,
                                           int64_t n_valid, float binwidth,
                                           int nbins, float* partials,
                                           float* out, void* stream) {
  if (nbins < 1 || nbins > kMaxBins || n_valid < 0 || n_valid > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t rows = astrild_pairwise_partials_rows(n_valid);
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    pair_tiles_kernel<<<static_cast<unsigned int>(rows), kTile, 0, s>>>(
        pos, vel, hat, n_valid, tiles_for(n_valid), binwidth, nbins,
        partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  reduce_partials_kernel<<<2 * nbins, kReduceThreads, 0, s>>>(
      partials, rows, 2 * nbins, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* astrild_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
