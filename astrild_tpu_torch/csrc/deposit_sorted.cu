// Sorted windowed deposit for Hopper (sm_90a).
//
// Replaces the TPU kernel astrild_tpu/ops/paint_pallas.py:deposit_sorted
// (body _kernel / _chunk_contribution / _dot_f32_split). It computes
//
//     out[c] = sum_p w_p * [key_p == c],   c in [0, n_cells),
//
// over keys sorted ascending, with unit weights when `vals` is null.
//
// The TPU version turned each window into a one-hot matmul on the MXU (and
// split f32 weights into bf16 hi/lo halves to keep f32 accuracy). The GPU
// needs neither: one block owns one window of kWindow cells in shared
// memory, finds its particle range by binary search over the sorted keys,
// accumulates with shared-memory atomics and writes the window out once,
// coalesced. Counts accumulate as unsigned integers, so they are exact.
//
// Bound: device-memory bandwidth. Each key is read once (4 B), each weight
// once (4 B) and each output cell written once (4 B); the binary searches
// add two O(log N) probes per block. Because the keys are sorted, one
// block's atomics land in one window and neighbouring threads hit
// neighbouring cells, so shared-memory conflicts stay low.
//
// Plain C interface (no PyTorch headers): loaded with ctypes by
// astrild_tpu_torch/_ext.py and launched on the caller's stream.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWindow = 8192;  // cells per block: 32 KB of shared memory
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

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
    deposit_sorted_kernel(const int32_t* __restrict__ keys,
                          const float* __restrict__ vals, int64_t n,
                          float* __restrict__ out, int64_t n_cells) {
  using Acc = typename std::conditional<kWeighted, float, unsigned int>::type;
  __shared__ Acc acc[kWindow];
  __shared__ int64_t range[2];

  const int64_t base = static_cast<int64_t>(blockIdx.x) * kWindow;
  for (int i = threadIdx.x; i < kWindow; i += kThreads) acc[i] = Acc(0);
  if (threadIdx.x < 2) {
    range[threadIdx.x] = lower_bound(keys, n, base + threadIdx.x * kWindow);
  }
  __syncthreads();

  const int64_t stop = range[1];
  for (int64_t p = range[0] + threadIdx.x; p < stop; p += kThreads) {
    const int64_t rel = static_cast<int64_t>(keys[p]) - base;
    // sorted keys always land inside the window; the guard only keeps
    // unsorted input from writing outside shared memory
    if (rel < 0 || rel >= kWindow) continue;
    if constexpr (kWeighted) {
      atomicAdd(&acc[rel], vals[p]);
    } else {
      atomicAdd(&acc[rel], 1u);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kWindow; i += kThreads) {
    const int64_t c = base + i;
    if (c < n_cells) out[c] = static_cast<float>(acc[i]);
  }
}

}  // namespace

// Deposits n sorted keys (and optional weights) into out[0, n_cells).
// All pointers are device pointers; `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int astrild_deposit_sorted(const int32_t* keys, const float* vals,
                                      int64_t n, float* out, int64_t n_cells,
                                      void* stream) {
  if (n_cells <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n_cells + kWindow - 1) / kWindow;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vals != nullptr) {
    deposit_sorted_kernel<true><<<static_cast<unsigned int>(blocks), kThreads,
                                  0, s>>>(keys, vals, n, out, n_cells);
  } else {
    deposit_sorted_kernel<false><<<static_cast<unsigned int>(blocks), kThreads,
                                   0, s>>>(keys, nullptr, n, out, n_cells);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* astrild_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
