// Windowed CIC/TSC mass assignment for Hopper (sm_90a).
//
// Replaces the TPU kernel astrild_tpu/ops/paint_pallas.py:paint_windowed
// (body _paint_kernel). On a padded (n+2)^3 grid every particle has a base
// key k_p (its CIC base cell or TSC centre cell, shifted by one into the
// pad), and offset (dx, dy, dz) deposits into cell
//
//     k_p + (dx * npd + dy) * npd + dz,          npd = n + 2,
//
// the weight  prod_axis w_axis(frac_p, a) * weight_p  with
//
//     CIC (order 2, a in {0, 1}):     a f + (1 - a)(1 - f)
//     TSC (order 3, a in {-1, 0, 1}): a == 0 ? 0.75 - d^2 : 0.5 (0.5 + a d)^2
//
// The wrapper (astrild_tpu_torch/ops/paint_cuda.py) wraps the positions,
// builds keys and fractions, sorts once by key and folds the pad back; this
// file only accumulates.
//
// The TPU version turned each (window, offset) pair into a one-hot matmul on
// the MXU with a bf16 hi/lo split of the weights. The GPU needs neither:
// one block owns one window of kWindow padded cells in shared memory. The
// offsets are taken in (dx, dy) groups: for a group the particles whose
// cells can land in the window form ONE contiguous range of the sorted keys,
// [base - off_xy - dz_max, base + kWindow - off_xy - dz_min), found by binary
// search in the block, and each of those particles adds its 2 (CIC) or 3
// (TSC) dz contributions with shared-memory atomics. The window is written
// to device memory once, coalesced.
//
// Bound: device-memory and L2 bandwidth. Each particle's key, three
// fractions and weight (16-20 B) are read once per (dx, dy) group, i.e. 4x
// (CIC) or 9x (TSC); the groups' ranges lie about npd^2 keys apart, so
// blocks that run together share most of them through the 50 MB L2. Each
// padded cell is written once. Grouping the dz offsets cuts the reads by
// 2x (CIC) or 3x (TSC) against one pass per offset. Shared-memory atomics
// conflict only where many particles share a cell (dense haloes).
//
// Plain C interface (no PyTorch headers): loaded with ctypes by
// astrild_tpu_torch/_ext.py and launched on the caller's stream.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWindow = 8192;  // padded cells per block: 32 KB of shared memory
constexpr int kThreads = 512;

__device__ __forceinline__ int64_t lower_bound(const int32_t* __restrict__ keys,
                                               int64_t n, int64_t value) {
  int64_t lo = 0;
  int64_t hi = n;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (static_cast<int64_t>(__ldg(keys + mid)) < value) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <int kOrder>
__device__ __forceinline__ float axis_weight(float f, int a) {
  if constexpr (kOrder == 2) {
    return a ? f : 1.0f - f;
  } else {
    if (a == 0) return 0.75f - f * f;
    const float t = 0.5f + static_cast<float>(a) * f;
    return 0.5f * t * t;
  }
}

template <int kOrder, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
    paint_windowed_kernel(const int32_t* __restrict__ keys,
                          const float* __restrict__ frac,
                          const float* __restrict__ weights, int64_t n,
                          int64_t npd, float* __restrict__ out,
                          int64_t n_cells) {
  constexpr int kLo = (kOrder == 2) ? 0 : -1;  // lowest axis offset
  constexpr int kSpan = kOrder;                // offsets per axis
  constexpr int kGroups = kSpan * kSpan;       // (dx, dy) groups
  __shared__ float acc[kWindow];
  __shared__ int64_t range[kGroups][2];

  const int64_t base = static_cast<int64_t>(blockIdx.x) * kWindow;
  for (int i = threadIdx.x; i < kWindow; i += kThreads) acc[i] = 0.0f;
  if (threadIdx.x < 2 * kGroups) {
    const int g = threadIdx.x >> 1;
    const int dx = kLo + g / kSpan;
    const int dy = kLo + g % kSpan;
    const int64_t off_xy = (dx * npd + dy) * npd;
    // keys whose dz offsets reach [base, base + kWindow)
    const int64_t value = (threadIdx.x & 1)
                              ? base + kWindow - off_xy - kLo
                              : base - off_xy - (kLo + kSpan - 1);
    range[g][threadIdx.x & 1] = lower_bound(keys, n, value);
  }
  __syncthreads();

  const float* __restrict__ fx = frac;
  const float* __restrict__ fy = frac + n;
  const float* __restrict__ fz = frac + 2 * n;
#pragma unroll 1
  for (int g = 0; g < kGroups; ++g) {
    const int dx = kLo + g / kSpan;
    const int dy = kLo + g % kSpan;
    const int64_t rel_xy = (dx * npd + dy) * npd - base;
    const int64_t stop = range[g][1];
    for (int64_t p = range[g][0] + threadIdx.x; p < stop; p += kThreads) {
      const int64_t rel0 = static_cast<int64_t>(keys[p]) + rel_xy;
      const float wxy = axis_weight<kOrder>(fx[p], dx) *
                        axis_weight<kOrder>(fy[p], dy);
      const float fzp = fz[p];
      const float wp = kWeighted ? weights[p] : 1.0f;
#pragma unroll
      for (int a = 0; a < kSpan; ++a) {
        const int dz = kLo + a;
        const int64_t rel = rel0 + dz;
        // a key in the group's range has at least one dz inside the
        // window; the guard drops the others (and keeps unsorted input
        // inside shared memory)
        if (rel < 0 || rel >= kWindow) continue;
        float w = wxy * axis_weight<kOrder>(fzp, dz);
        if constexpr (kWeighted) w *= wp;
        atomicAdd(&acc[rel], w);
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kWindow; i += kThreads) {
    const int64_t c = base + i;
    if (c < n_cells) out[c] = acc[i];
  }
}

template <int kOrder>
void launch(const int32_t* keys, const float* frac, const float* weights,
            int64_t n, int64_t npd, float* out, int64_t n_cells,
            unsigned int blocks, cudaStream_t s) {
  if (weights != nullptr) {
    paint_windowed_kernel<kOrder, true>
        <<<blocks, kThreads, 0, s>>>(keys, frac, weights, n, npd, out,
                                     n_cells);
  } else {
    paint_windowed_kernel<kOrder, false>
        <<<blocks, kThreads, 0, s>>>(keys, frac, nullptr, n, npd, out,
                                     n_cells);
  }
}

}  // namespace

// Paints n particles onto the padded grid out[0, n_cells), n_cells = npd^3.
// keys: (n,) int32 padded base keys, sorted ascending; frac: (3, n) float32
// fractions co-sorted with the keys (CIC f in [0, 1], TSC d in [-0.5, 0.5]);
// weights: (n,) float32 co-sorted, or null for unit weights; order 2 (CIC)
// or 3 (TSC). All pointers are device pointers; `stream` is a cudaStream_t.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int astrild_paint_windowed(const int32_t* keys, const float* frac,
                                      const float* weights, int64_t n,
                                      int64_t npd, int order, float* out,
                                      int64_t n_cells, void* stream) {
  if (n_cells <= 0) return static_cast<int>(cudaSuccess);
  if (order != 2 && order != 3) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n_cells + kWindow - 1) / kWindow;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto nb = static_cast<unsigned int>(blocks);
  if (order == 2) {
    launch<2>(keys, frac, weights, n, npd, out, n_cells, nb, s);
  } else {
    launch<3>(keys, frac, weights, n, npd, out, n_cells, nb, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* astrild_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
