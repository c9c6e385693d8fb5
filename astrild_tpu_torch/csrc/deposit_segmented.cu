// Segment-sorted windowed deposit for Hopper (sm_90a).
//
// Replaces the TPU kernel
// astrild_tpu/ops/paint_pallas.py:deposit_flat_segmented (body
// _kernel_seg). It computes the same sum as deposit_sorted.cu (K1),
//
//     out[c] = sum_p w_p * [key_p == c],   c in [0, n_cells),
//
// with unit weights when `vals` is null, but from keys that are sorted only
// within n_seg equal segments: row s of a (n_seg, seg_len) array, each row
// ascending, the tail of the last rows padded with the sentinel n_cells.
//
// The TPU version gridded over (window, segment) pairs, carrying the
// window's output block across the sequential segment axis, with the
// per-pair ranges computed ahead in XLA and scalar-prefetched. On the GPU
// blocks run in no order, so one block owns one window of kWindow cells in
// shared memory (K1's design) and walks the segments itself. Per pass over
// up to kThreads segments, thread t binary-searches segment s0 + t for the
// window's key range [base, min(base + kWindow, n_cells)); the sentinel
// never falls inside it. A block scan of the range lengths turns the ranges
// into one concatenated index space, which the block sweeps as K1 sweeps
// its single range: item j goes to thread j mod kThreads, neighbouring
// threads read neighbouring keys, and a per-thread cursor walks forward
// through the ranges. Counts accumulate as unsigned integers, so they are
// exact; the window is written out once, coalesced.
//
// Bound: device-memory bandwidth on the keys and weights (each read once,
// 4 B each) and the output (4 B a cell), plus 2 * n_seg binary searches of
// log2(seg_len) dependent probes per window. An empty (window, segment)
// range costs its two searches and nothing else: on input whose file order
// is spatially coherent most ranges are empty.
//
// Plain C interface (no PyTorch headers): loaded with ctypes by
// astrild_tpu_torch/_ext.py and launched on the caller's stream.
#include <cuda_runtime.h>

#include <cstdint>
#include <cub/block/block_scan.cuh>
#include <type_traits>

namespace {

constexpr int kWindow = 8192;  // cells per block: 32 KB of shared memory
constexpr int kThreads = 512;  // also the segments searched per pass

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
    deposit_segmented_kernel(const int32_t* __restrict__ keys,
                             const float* __restrict__ vals, int64_t n_seg,
                             int64_t seg_len, float* __restrict__ out,
                             int64_t n_cells) {
  using Acc = typename std::conditional<kWeighted, float, unsigned int>::type;
  using Scan = cub::BlockScan<int64_t, kThreads>;
  __shared__ Acc acc[kWindow];
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ int64_t start[kThreads];        // first key of each range
  __shared__ int64_t offset[kThreads + 1];   // exclusive prefix of lengths

  const int64_t base = static_cast<int64_t>(blockIdx.x) * kWindow;
  const int64_t stop = base + kWindow < n_cells ? base + kWindow : n_cells;
  for (int i = threadIdx.x; i < kWindow; i += kThreads) acc[i] = Acc(0);

  for (int64_t s0 = 0; s0 < n_seg; s0 += kThreads) {
    const int64_t s = s0 + threadIdx.x;
    int64_t len = 0;
    if (s < n_seg) {
      const int32_t* seg = keys + s * seg_len;
      const int64_t lo = lower_bound(seg, seg_len, base);
      len = lower_bound(seg + lo, seg_len - lo, stop);
      start[threadIdx.x] = s * seg_len + lo;
    }
    int64_t excl = 0;
    int64_t total = 0;
    Scan(scan_tmp).ExclusiveSum(len, excl, total);
    offset[threadIdx.x] = excl;
    if (threadIdx.x == 0) offset[kThreads] = total;
    __syncthreads();

    // ranges past the last segment have length 0, so offset[r + 1] > j
    // stops the cursor at a range that holds item j
    int r = 0;
    for (int64_t j = threadIdx.x; j < total; j += kThreads) {
      while (offset[r + 1] <= j) ++r;
      const int64_t p = start[r] + (j - offset[r]);
      const int64_t rel = static_cast<int64_t>(keys[p]) - base;
      // the searches keep every key inside the window; the guard only keeps
      // unsorted rows from writing outside shared memory
      if (rel < 0 || rel >= kWindow) continue;
      if constexpr (kWeighted) {
        atomicAdd(&acc[rel], vals[p]);
      } else {
        atomicAdd(&acc[rel], 1u);
      }
    }
    // the next pass rewrites start, offset and the scan's storage
    __syncthreads();
  }

  for (int i = threadIdx.x; i < kWindow; i += kThreads) {
    const int64_t c = base + i;
    if (c < n_cells) out[c] = static_cast<float>(acc[i]);
  }
}

}  // namespace

// Deposits the n_seg * seg_len keys of a row-sorted (n_seg, seg_len) array
// (and optional weights in the same layout) into out[0, n_cells); keys equal
// to n_cells are padding. All pointers are device pointers; `stream` is a
// cudaStream_t. Returns the cudaError_t of the launch (0 on success).
extern "C" int astrild_deposit_segmented(const int32_t* keys,
                                         const float* vals, int64_t n_seg,
                                         int64_t seg_len, float* out,
                                         int64_t n_cells, void* stream) {
  if (n_seg < 1 || seg_len < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_cells <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n_cells + kWindow - 1) / kWindow;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vals != nullptr) {
    deposit_segmented_kernel<true>
        <<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
            keys, vals, n_seg, seg_len, out, n_cells);
  } else {
    deposit_segmented_kernel<false>
        <<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
            keys, nullptr, n_seg, seg_len, out, n_cells);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* astrild_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
