// Chunk-sorted deposit for Hopper (sm_90a).
//
// Replaces the TPU kernel
// astrild_tpu/ops/paint_pallas.py:deposit_flat_segmented (body
// _kernel_seg). It computes the same sum as deposit_sorted.cu (K1),
//
//     out[c] += sum_p w_p * [key_p == c],   c in [0, n_cells),
//
// with unit weights when `vals` is null, into an output the caller has
// zeroed, from keys in any order.
//
// The TPU version sorted the keys within n_seg long segments (a monotone
// sort being cheaper than a full one there) and then walked (window,
// segment) pairs. On this card a row-wise device sort costs more than a
// full one and more than the deposit itself, so the sort moves into the
// kernel and shrinks to what shared memory holds: one block takes a
// contiguous chunk of kChunk keys (and weights) in their given order, sorts
// it in shared memory (cub::BlockRadixSort over the bits that n_cells
// needs), reduces each run of equal keys to one sum, and issues one global
// atomicAdd per distinct key. After the sort neighbouring threads hold
// neighbouring keys, so a warp's atomics fall on few L2 sectors. Keys in a
// spatially coherent file order (a snapshot kept in the PM code's particle
// order) fall into a few compact ranges per chunk; shuffled keys degrade to
// one scattered atomic per key, as a plain index_add_ does. No device-wide
// sort and no index array exist, and the result does not depend on how the
// input would have been cut into segments.
//
// Counts accumulate as unsigned integers within a run and land as
// integer-valued float atomics, so they are exact below 2^24 per cell.
//
// Bound: device-memory bandwidth. Each key is read once (4 B), each weight
// once (4 B), and each output cell is written at least once (4 B, the
// caller's zeroing); 2^27 keys into 2^27 cells move 1.07 GB (counts) or
// 1.61 GB (weighted), 0.32 or 0.48 ms at 3.35 TB/s. The atomics read and
// write each touched L2 sector of the output on top of that; the in-block
// sort keeps them to one per distinct key and groups them by sector.
//
// Plain C interface (no PyTorch headers): loaded with ctypes by
// astrild_tpu_torch/_ext.py and launched on the caller's stream.
#include <cuda_runtime.h>

#include <cstdint>
#include <cub/block/block_radix_sort.cuh>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kChunk = kThreads * kItems;  // keys per block
constexpr uint32_t kPad = 0xffffffffu;     // past the chunk's end; >= n_cells

struct RunCounts {
  uint32_t key[kChunk];
};
struct RunWeighted {
  uint32_t key[kChunk];
  float val[kChunk];
};

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
    deposit_chunk_kernel(const int32_t* __restrict__ keys,
                         const float* __restrict__ vals, int64_t n,
                         float* __restrict__ out, int64_t n_cells,
                         int end_bit) {
  using Val = typename std::conditional<kWeighted, float, cub::NullType>::type;
  using Sort = cub::BlockRadixSort<uint32_t, kThreads, kItems, Val>;
  using Run = typename std::conditional<kWeighted, RunWeighted, RunCounts>::type;
  __shared__ union {
    typename Sort::TempStorage sort;
    Run run;  // the sorted chunk in rank order
  } smem;

  // striped load: neighbouring threads read neighbouring keys. The sort
  // takes the items as they come; which thread holds which key before it
  // does not matter. A negative key reads as >= 2^31 and is dropped below.
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kChunk;
  uint32_t k[kItems];
  Val v[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t p = base + i * kThreads + threadIdx.x;
    k[i] = p < n ? static_cast<uint32_t>(__ldg(keys + p)) : kPad;
    if constexpr (kWeighted) v[i] = p < n ? __ldg(vals + p) : 0.0f;
  }
  // item i of thread t comes back holding rank i * kThreads + t
  if constexpr (kWeighted) {
    Sort(smem.sort).SortBlockedToStriped(k, v, 0, end_bit);
  } else {
    Sort(smem.sort).SortBlockedToStriped(k, 0, end_bit);
  }
  __syncthreads();  // the run arrays reuse the sort's storage
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int r = i * kThreads + threadIdx.x;
    smem.run.key[r] = k[i];
    if constexpr (kWeighted) smem.run.val[r] = v[i];
  }
  __syncthreads();

  // the head of each run of equal keys sums the run and adds it once.
  // Keys equal in the sorted bits but not in full (the padding) only split
  // a run in two, which adds the same total.
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int r = i * kThreads + threadIdx.x;
    const uint32_t key = k[i];
    if (static_cast<int64_t>(key) >= n_cells) continue;
    if (r > 0 && smem.run.key[r - 1] == key) continue;
    if constexpr (kWeighted) {
      float sum = v[i];
      for (int e = r + 1; e < kChunk && smem.run.key[e] == key; ++e) {
        sum += smem.run.val[e];
      }
      atomicAdd(out + key, sum);
    } else {
      unsigned int count = 1;
      for (int e = r + 1; e < kChunk && smem.run.key[e] == key; ++e) ++count;
      atomicAdd(out + key, static_cast<float>(count));
    }
  }
}

}  // namespace

// Adds n keys (and optional weights), in any order, into out[0, n_cells),
// which the caller has zeroed; keys outside [0, n_cells) are dropped. All
// pointers are device pointers; `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success). n == 0 still launches one
// block, which adds nothing.
extern "C" int astrild_deposit_segmented(const int32_t* keys,
                                         const float* vals, int64_t n,
                                         float* out, int64_t n_cells,
                                         void* stream) {
  if (n < 0 || n_cells < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_cells == 0) return static_cast<int>(cudaSuccess);
  int64_t blocks = (n + kChunk - 1) / kChunk;
  if (blocks == 0) blocks = 1;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // the fewest low bits that tell every key in [0, n_cells) apart
  int end_bit = 1;
  while (end_bit < 32 && (int64_t{1} << end_bit) < n_cells) ++end_bit;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto nb = static_cast<unsigned int>(blocks);
  if (vals != nullptr) {
    deposit_chunk_kernel<true>
        <<<nb, kThreads, 0, s>>>(keys, vals, n, out, n_cells, end_bit);
  } else {
    deposit_chunk_kernel<false>
        <<<nb, kThreads, 0, s>>>(keys, nullptr, n, out, n_cells, end_bit);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* astrild_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
