// Windowed deposit for Hopper (sm_90a): K1, with its two entry points.
//
// Replaces the TPU kernel astrild_tpu/ops/paint_pallas.py:deposit_sorted
// (body _kernel / _chunk_contribution / _dot_f32_split) and its entry
// deposit_flat, which sorts the keys first. Both compute
//
//     out[c] = sum_p w_p * [key_p == c],   c in [0, n_cells),
//
// with unit weights when `vals` is null. Keys outside [0, n_cells) are
// dropped.
//
// The TPU version turned each window of cells into a one-hot matmul on the
// MXU over keys sorted ahead in XLA. Here the cells are cut into windows of
// kWindow = 8192 cells (32 KB of shared memory) and the entries reach their
// window without a device-wide sort, in passes on the caller's stream:
//
//   astrild_deposit_flat (keys in any order):
//     1. hist:      entries per window, keys read once; the counters live
//                   in shared memory (up to kSharedWindows windows, else in
//                   device memory), a warp adds once per run of a window;
//     2. plan:      one block scans the counts into each window's segment
//                   and cuts each window into chunks of at most `chunk`
//                   entries (a table maps each chunk to its window);
//     3. partition: each entry goes into its window's segment, its key
//                   stored as the 13-bit offset in the window (uint16)
//                   with its weight: 2 or 6 bytes an entry; order inside a
//                   segment is free. A block ranks a tile of 8192 entries
//                   by bin in shared memory, reserves each bin's run with
//                   one atomic and writes the runs whole (an atomic and a
//                   store an entry, straight to its bin's cursor, scatter
//                   over many L2 sectors when the bins are many and the
//                   keys random). A tile holds at most kBins = 1024 bins, so
//                   above 1024 windows the partition takes two levels:
//                   into at most 256 buckets of 2^s windows (keys whole),
//                   then each bucket into its windows;
//     4. zero:      the windows of more than one chunk are zeroed;
//     5. accumulate, below.
//   astrild_deposit_sorted (keys ascending): each window's segment by
//     binary search (bounds), then plan, zero and accumulate as above.
//
// accumulate, the kernel both share, is balanced by entries, not by cells:
// one block takes one chunk, so a heavy window (the lens planes hold ~29
// entries a cell) is split over several blocks. The block sums its chunk
// into the window in shared memory; before each shared atomic a warp sums
// each run of equal offsets (a segmented shuffle scan: sorted or coherent
// input puts long runs in one warp, which would serialise on one address)
// and only the run's last lane adds. A window of one chunk then writes its
// cells once with plain stores; each chunk of a heavy window adds its
// non-zero cells into the zeroed window with float atomics. Counts
// accumulate as unsigned integers in shared memory; across chunks every
// partial sum of a cell is an integer no larger than its total, so float
// addition of them is exact for totals up to 2^24 in any order. The grid
// is launched at the upper bound of chunks, n / chunk + n_windows + 1 (a
// window of c entries takes max(1, ceil(c / chunk)) chunks), and the
// blocks past the planned count exit, so nothing waits on the host.
//
// Bound: device-memory bandwidth. The function reads each key once (4 B)
// and each weight once (4 B) and writes each cell once (4 B): 2^27 keys
// into 2^27 cells (the suite) 1.07 GB, 0.321 ms at 3.35 TB/s; the lens
// plane's 1.226e8 weighted entries into 4,194,305 cells 0.998 GB, 0.298
// ms; a shell image's 1.2e8 keys into 6.29e7 cells 0.73 GB, 0.218 ms. The
// sorted entry point moves those bytes and little more (the bounds' binary
// searches, the zeroed heavy windows). For keys in any order the partition
// adds its own traffic, which is what it costs in place of a radix sort
// (whose passes each read and write the keys and an int64 order): the
// keys read a second time, and each level's output written and read back
// once (a bucket level 4 B a key, the window level 2 B an offset, 4 B a
// weight each): 12 B an entry for counts in one level, 20 B in two.
//
// Plain C interface (no PyTorch headers): loaded with ctypes by
// astrild_tpu_torch/_ext.py and launched on the caller's stream. The
// caller allocates the scratch (astrild_deposit_scratch_bytes) and the
// output; nothing here allocates or synchronises.
#include <cuda_runtime.h>

#include <cstdint>
#include <cub/block/block_scan.cuh>
#include <type_traits>

namespace {

constexpr int kShift = 13;
constexpr int kWindow = 1 << kShift;  // cells per window
constexpr int kThreads = 512;         // accumulate blocks
constexpr int kAccItems = 4;          // entries an accumulate thread loads a trip
constexpr int kPassThreads = 256;     // bounds, zero blocks
constexpr int kHistThreads = 1024;
constexpr int kHistItems = 16;
constexpr int kPlanThreads = 1024;
constexpr int kPlanItems = 8;         // windows a plan thread takes per tile
// partition: a block stages a tile of kPartTile entries by bin (at most
// kBins bins a tile) in shared memory and writes each bin's run whole
constexpr int kPartThreads = 1024;
constexpr int kPartItems = 8;
constexpr int kPartTile = kPartThreads * kPartItems;
constexpr int kBins = kPartThreads;
constexpr uint16_t kDropped = 0xffff;  // partition ranks: a dropped key,
constexpr uint16_t kAlone = 0xfffe;    // an entry past the tile's bins
// with more than kBins windows the partition takes two levels: first into
// at most kBuckets buckets of 2^s windows, then each bucket into windows
constexpr int kBuckets = 256;
// windows whose counters fit a hist block's shared memory (64 KB)
constexpr int kSharedWindows = 16384;
constexpr unsigned kFull = 0xffffffffu;

int64_t windows_of(int64_t n_cells) {
  return (n_cells + kWindow - 1) / kWindow;
}

// log2 of the windows in a bucket of the first partition level, or -1 when
// one level takes the keys straight into their windows
int bucket_shift(int64_t n_windows) {
  if (n_windows <= kBins) return -1;
  int s = 0;
  while (((n_windows + (int64_t{1} << s) - 1) >> s) > kBuckets) ++s;
  return s;
}

// Scratch layout, 256-byte aligned pieces: starts (n_windows + 1) int64,
// chunk_start (n_windows + 1) int32, table (n_windows + n / chunk + 1)
// int32; for keys in any order also cursor (n_windows) int64, counts
// (n_windows) uint32, the partitioned offsets (n) uint16 and, weighted,
// weights (n) float, and with two levels the buckets' cursors (kBuckets)
// int64 and the first level's keys (n) int32 and weights (n) float.
struct Layout {
  int64_t starts, cursor, counts, chunk_start, table, offsets, vals;
  int64_t bucket_cursor, level_keys, level_vals, bytes;
};

int64_t align_up(int64_t x) { return (x + 255) & ~int64_t{255}; }

Layout layout(int64_t n, int64_t n_cells, bool flat, bool weighted,
              int64_t chunk) {
  const int64_t nw = windows_of(n_cells);
  Layout l{};
  int64_t at = 0;
  auto take = [&at](int64_t bytes) {
    const int64_t here = at;
    at = align_up(at + bytes);
    return here;
  };
  l.starts = take(8 * (nw + 1));
  l.cursor = flat ? take(8 * nw) : -1;
  l.counts = flat ? take(4 * nw) : -1;
  l.chunk_start = take(4 * (nw + 1));
  l.table = take(4 * (nw + n / chunk + 1));
  l.offsets = flat ? take(2 * n) : -1;
  l.vals = (flat && weighted) ? take(4 * n) : -1;
  const bool two = flat && bucket_shift(nw) >= 0;
  l.bucket_cursor = two ? take(8 * kBuckets) : -1;
  l.level_keys = two ? take(4 * n) : -1;
  l.level_vals = (two && weighted) ? take(4 * n) : -1;
  l.bytes = at;
  return l;
}

template <typename T>
T* piece(void* scratch, int64_t offset) {
  return offset < 0 ? nullptr
                    : reinterpret_cast<T*>(static_cast<char*>(scratch) +
                                           offset);
}

// The runs of equal `tag` among a warp's lanes (neighbouring lanes only):
// bit i of the result is set where lane i starts a run.
__device__ __forceinline__ unsigned run_heads(int tag, int lane) {
  const int prev = __shfl_up_sync(kFull, tag, 1);
  return __ballot_sync(kFull, lane == 0 || prev != tag);
}

// first lane of this lane's run, and its last
__device__ __forceinline__ int run_first(unsigned heads, int lane) {
  return 31 - __clz(heads & ((2u << lane) - 1u));
}
__device__ __forceinline__ int run_last(unsigned heads, int lane) {
  const unsigned above = heads & ~((2u << lane) - 1u);
  return above ? __ffs(above) - 2 : 31;
}

// 1. entries per window; -1 tags a dropped key. A thread loads kHistItems
// keys of a tile before it counts any, so enough loads are in flight
template <bool kShared>
__global__ void __launch_bounds__(kHistThreads)
    deposit_hist(const int32_t* __restrict__ keys, int64_t n, int64_t n_cells,
                 int n_windows, unsigned* __restrict__ counts) {
  extern __shared__ unsigned shared_counts[];
  unsigned* h = kShared ? shared_counts : counts;
  if constexpr (kShared) {
    for (int i = threadIdx.x; i < n_windows; i += kHistThreads) h[i] = 0;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  constexpr int kTile = kHistThreads * kHistItems;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kTile;
  // t0 is the same for every lane, so a warp's lanes make the same trips
  for (int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile; t0 < n;
       t0 += stride) {
    int32_t key[kHistItems];
#pragma unroll
    for (int i = 0; i < kHistItems; ++i) {
      const int64_t p = t0 + i * kHistThreads + threadIdx.x;
      key[i] = p < n ? __ldg(keys + p) : -1;
    }
#pragma unroll
    for (int i = 0; i < kHistItems; ++i) {
      const int w =
          (key[i] >= 0 && key[i] < n_cells) ? (key[i] >> kShift) : -1;
      const unsigned heads = run_heads(w, lane);
      if (w >= 0 && run_last(heads, lane) == lane) {
        atomicAdd(h + w,
                  static_cast<unsigned>(lane - run_first(heads, lane) + 1));
      }
    }
  }
  if constexpr (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_windows; i += kHistThreads) {
      if (h[i] != 0) atomicAdd(counts + i, h[i]);
    }
  }
}

// 2. one block: each window's segment start (kFromCounts: from the hist
// counts, also copied into cursor, and with two partition levels each
// bucket's start into bucket_cursor; else the bounds are given in starts)
// and its chunks: chunk_start[w] is the first chunk of window w, and
// table[c] the window of chunk c. Chunk ids stop at table_len (the grid of
// accumulate), which only keys given as sorted but not sorted can reach:
// such input gives no defined sums but stays inside every buffer
template <bool kFromCounts>
__device__ __forceinline__ long long window_entries(
    const unsigned* __restrict__ counts, const int64_t* __restrict__ starts,
    int w) {
  return kFromCounts ? static_cast<long long>(counts[w])
                     : starts[w + 1] - starts[w];
}

__device__ __forceinline__ long long chunks_of(long long entries,
                                               int64_t chunk) {
  // a window holds at least one chunk, so an empty one is written too
  return entries > chunk ? (entries + chunk - 1) / chunk : 1;
}

template <bool kFromCounts>
__global__ void __launch_bounds__(kPlanThreads)
    deposit_plan(const unsigned* __restrict__ counts,
                 int64_t* __restrict__ starts, int64_t* __restrict__ cursor,
                 int32_t* __restrict__ chunk_start,
                 int32_t* __restrict__ table, int n_windows, int64_t chunk,
                 int64_t table_len, int shift,
                 int64_t* __restrict__ bucket_cursor) {
  using Scan = cub::BlockScan<long long, kPlanThreads>;
  constexpr int kTile = kPlanThreads * kPlanItems;
  __shared__ typename Scan::TempStorage tmp;
  // a tile's entries a window, loaded coalesced; below 2^32 (the wrapper
  // refuses more keys), and a negative count of input that is not sorted
  // is taken as 0
  __shared__ unsigned tile_entries[kTile];
  __shared__ long long carry_e;
  __shared__ long long carry_c;
  if (threadIdx.x == 0) {
    carry_e = 0;
    carry_c = 0;
  }
  for (int t0 = 0; t0 < n_windows; t0 += kTile) {
#pragma unroll
    for (int k = 0; k < kPlanItems; ++k) {
      const int w = t0 + k * kPlanThreads + threadIdx.x;
      long long e = 0;
      if (w < n_windows) {
        e = window_entries<kFromCounts>(counts, starts, w);
      }
      tile_entries[k * kPlanThreads + threadIdx.x] =
          static_cast<unsigned>(e > 0 ? e : 0);
    }
    __syncthreads();
    const int first = threadIdx.x * kPlanItems;  // in the tile
    long long e_sum = 0;
    long long c_sum = 0;
#pragma unroll
    for (int k = 0; k < kPlanItems; ++k) {
      const long long e = tile_entries[first + k];
      e_sum += e;
      if (t0 + first + k < n_windows) c_sum += chunks_of(e, chunk);
    }
    long long e_off, e_total, c_off, c_total;
    Scan(tmp).ExclusiveSum(e_sum, e_off, e_total);
    __syncthreads();
    Scan(tmp).ExclusiveSum(c_sum, c_off, c_total);
    e_off += carry_e;
    c_off += carry_c;
    for (int k = 0; k < kPlanItems; ++k) {
      const int w = t0 + first + k;
      if (w >= n_windows) break;
      const long long e = tile_entries[first + k];
      const long long c = chunks_of(e, chunk);
      if constexpr (kFromCounts) {
        starts[w] = e_off;
        cursor[w] = e_off;
        if (shift >= 0 && (w & ((1 << shift) - 1)) == 0) {
          bucket_cursor[w >> shift] = e_off;
        }
      }
      chunk_start[w] = static_cast<int32_t>(c_off < table_len ? c_off
                                                               : table_len);
      for (long long j = c_off; j < c_off + c && j < table_len; ++j) {
        table[j] = w;
      }
      e_off += e;
      c_off += c;
    }
    __syncthreads();  // every thread has read the carries and the tile
    if (threadIdx.x == 0) {
      carry_e += e_total;
      carry_c += c_total;
    }
  }
  if (threadIdx.x == 0) {
    if constexpr (kFromCounts) starts[n_windows] = carry_e;
    chunk_start[n_windows] =
        static_cast<int32_t>(carry_c < table_len ? carry_c : table_len);
  }
}

// 3. partition: one block takes a tile of kPartTile entries, ranks them by
// bin (bin = key >> shift, less the tile's base bin) with shared counters,
// stages them in shared memory in bin order, reserves each bin's run with
// one atomic on the bin's cursor, and writes the runs out whole, so the
// writes are coalesced however many bins the entries scatter over.
//   level 1 of 2 (!kFinal): bins are buckets (base 0), keys written whole;
//   the last level (kFinal): bins are windows, each key written as its
//     offset in the window. Its input is either the caller's keys (one
//     level: base 0) or, kSecond, the first level's output, grouped by
//     bucket: the tile's base is the first bucket's first window, and an
//     entry more than kBins windows past it (a tile spanning buckets of
//     many windows) takes its own cursor atomic and is written alone.
// Keys outside [0, n_cells) are dropped here. The count of the first
// level's output lives on the card (n_dev); tiles past it exit.
template <bool kWeighted, bool kFinal, bool kSecond>
__global__ void __launch_bounds__(kPartThreads, 2)
    deposit_partition(const int32_t* __restrict__ keys,
                      const float* __restrict__ vals, int64_t n,
                      const int64_t* __restrict__ n_dev, int64_t n_cells,
                      int shift, int bucket_shift,
                      int64_t* __restrict__ cursor,
                      int32_t* __restrict__ keys_out,
                      uint16_t* __restrict__ offsets_out,
                      float* __restrict__ vals_out) {
  using Scan = cub::BlockScan<int, kPartThreads>;
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ int count[kBins];
  __shared__ int first_of[kBins];
  __shared__ unsigned long long run_at[kBins];
  __shared__ int base;
  extern __shared__ __align__(16) unsigned char staged[];
  int32_t* staged_keys = reinterpret_cast<int32_t*>(staged);
  float* staged_vals = reinterpret_cast<float*>(staged + 4 * kPartTile);
  // each entry's rank in its bin, or kDropped / kAlone; in shared memory,
  // since registers that live across the scan would spill
  uint16_t* ranks = reinterpret_cast<uint16_t*>(
      staged + 4 * kPartTile * (kWeighted ? 2 : 1));

  if constexpr (kSecond) n = __ldg(n_dev);
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kPartTile;
  if (t0 >= n) return;  // the same for the whole block
  const int lane = threadIdx.x & 31;
  count[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    base = kSecond ? (((__ldg(keys + t0) >> kShift) >> bucket_shift)
                      << bucket_shift)
                   : 0;
  }
  int32_t key[kPartItems];
#pragma unroll
  for (int i = 0; i < kPartItems; ++i) {
    const int64_t p = t0 + i * kPartThreads + threadIdx.x;
    key[i] = p < n ? __ldg(keys + p) : -1;
  }
  __syncthreads();

  // rank each entry within its bin; -1 tags a dropped key, -2 an entry
  // past the tile's bins
#pragma unroll
  for (int i = 0; i < kPartItems; ++i) {
    int bin = -1;
    if (key[i] >= 0 && key[i] < n_cells) {
      bin = (key[i] >> shift) - base;
      if (bin >= kBins) bin = -2;
    }
    const unsigned heads = run_heads(bin, lane);
    const int first = run_first(heads, lane);
    const int last = run_last(heads, lane);
    int at = 0;
    if (bin >= 0 && lane == last) at = atomicAdd(count + bin, last - first + 1);
    at = __shfl_sync(kFull, at, last) + lane - first;
    ranks[i * kPartThreads + threadIdx.x] = static_cast<uint16_t>(
        bin >= 0 ? at : (bin == -1 ? kDropped : kAlone));
  }
  __syncthreads();

  // each bin's place in the stage and its run in the output
  const int c = count[threadIdx.x];
  if (c > 0) {
    run_at[threadIdx.x] = atomicAdd(
        reinterpret_cast<unsigned long long*>(cursor) + base + threadIdx.x,
        static_cast<unsigned long long>(c));
  }
  int staged_first, total;
  Scan(scan_tmp).ExclusiveSum(c, staged_first, total);
  first_of[threadIdx.x] = staged_first;
  __syncthreads();

  // the keys are read again (from cache) to stage them
#pragma unroll
  for (int i = 0; i < kPartItems; ++i) {
    const int rank = ranks[i * kPartThreads + threadIdx.x];
    if (rank == kDropped) continue;
    const int64_t p = t0 + i * kPartThreads + threadIdx.x;
    const int32_t key = __ldg(keys + p);
    float v = 0.0f;
    if constexpr (kWeighted) v = __ldg(vals + p);
    if (rank != kAlone) {
      const int q = first_of[(key >> shift) - base] + rank;
      staged_keys[q] = key;
      if constexpr (kWeighted) staged_vals[q] = v;
      continue;
    }
    // past the tile's bins: a run of its own
    const int64_t q = static_cast<int64_t>(atomicAdd(
        reinterpret_cast<unsigned long long*>(cursor) + (key >> shift), 1ull));
    if constexpr (kFinal) {
      offsets_out[q] = static_cast<uint16_t>(key & (kWindow - 1));
    } else {
      keys_out[q] = key;
    }
    if constexpr (kWeighted) vals_out[q] = v;
  }
  __syncthreads();

  for (int j = threadIdx.x; j < total; j += kPartThreads) {
    const int32_t k = staged_keys[j];
    const int bin = (k >> shift) - base;
    const int64_t q =
        static_cast<int64_t>(run_at[bin]) + (j - first_of[bin]);
    if constexpr (kFinal) {
      offsets_out[q] = static_cast<uint16_t>(k & (kWindow - 1));
    } else {
      keys_out[q] = k;
    }
    if constexpr (kWeighted) vals_out[q] = staged_vals[j];
  }
}

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

// 1'. sorted keys: window w's segment starts at the first key >= its first
// cell; the last bound is the first key >= n_cells, so keys past n_cells
// (and below 0) fall outside every segment
__global__ void __launch_bounds__(kPassThreads)
    deposit_bounds(const int32_t* __restrict__ keys, int64_t n,
                   int64_t n_cells, int n_windows,
                   int64_t* __restrict__ starts) {
  const int w = blockIdx.x * kPassThreads + threadIdx.x;
  if (w > n_windows) return;
  const int64_t cell = static_cast<int64_t>(w) * kWindow;
  starts[w] = lower_bound(keys, n, cell < n_cells ? cell : n_cells);
}

__device__ __forceinline__ int window_cells(int w, int64_t n_cells) {
  const int64_t left = n_cells - static_cast<int64_t>(w) * kWindow;
  return left < kWindow ? static_cast<int>(left) : kWindow;
}

// 4. windows of more than one chunk start from zero (their chunks add)
__global__ void __launch_bounds__(kPassThreads)
    deposit_zero(const int32_t* __restrict__ chunk_start, int n_windows,
                 int64_t n_cells, float* __restrict__ out) {
  for (int w = blockIdx.x; w < n_windows; w += gridDim.x) {
    if (chunk_start[w + 1] - chunk_start[w] <= 1) continue;
    float* o = out + static_cast<int64_t>(w) * kWindow;
    const int cells = window_cells(w, n_cells);
    for (int i = threadIdx.x; i < cells; i += kPassThreads) o[i] = 0.0f;
  }
}

// Adds v into acc[rel] for a warp's lanes (rel < 0: no entry; such lanes
// sit after the entries). Each run of equal rel over neighbouring lanes is
// summed by a segmented scan first and added once by its last lane.
template <typename T>
__device__ __forceinline__ void warp_run_add(T* acc, int rel, T v, int lane) {
  const unsigned heads = run_heads(rel, lane);
  if (heads != kFull) {
    const int first = run_first(heads, lane);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T other = __shfl_up_sync(kFull, v, d);
      if (lane - d >= first) v += other;
    }
    if (run_last(heads, lane) != lane) return;
  }
  if (rel >= 0) atomicAdd(acc + rel, v);
}

// 5. one block per chunk: the chunk's entries into its window in shared
// memory, then the window out (plain stores for a window of one chunk,
// float atomics into the zeroed window otherwise). A thread loads
// kAccItems entries a trip before it adds any, so enough loads are in
// flight
template <bool kWeighted, bool kSorted>
__global__ void __launch_bounds__(kThreads)
    deposit_accumulate(const int32_t* __restrict__ keys,
                       const uint16_t* __restrict__ offsets,
                       const float* __restrict__ vals,
                       const int64_t* __restrict__ starts,
                       const int32_t* __restrict__ chunk_start,
                       const int32_t* __restrict__ table, int n_windows,
                       int64_t n_cells, int64_t chunk,
                       float* __restrict__ out) {
  using Acc = typename std::conditional<kWeighted, float, unsigned>::type;
  __shared__ __align__(16) Acc acc[kWindow];
  __shared__ int64_t range[2];
  __shared__ int window;
  __shared__ bool heavy;

  const int b = blockIdx.x;
  if (b >= __ldg(chunk_start + n_windows)) return;  // past the plan
  if (threadIdx.x == 0) {
    const int w = __ldg(table + b);
    const int first = __ldg(chunk_start + w);
    const int64_t lo = __ldg(starts + w) + (b - first) * chunk;
    const int64_t stop = __ldg(starts + w + 1);
    window = w;
    heavy = __ldg(chunk_start + w + 1) - first > 1;
    range[0] = lo;
    range[1] = lo + chunk < stop ? lo + chunk : stop;
  }
  uint4* acc4 = reinterpret_cast<uint4*>(acc);
  for (int i = threadIdx.x; i < kWindow / 4; i += kThreads) {
    acc4[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  const int64_t base = static_cast<int64_t>(window) * kWindow;
  const int cells = window_cells(window, n_cells);
  const int lane = threadIdx.x & 31;
  const int64_t stop = range[1];
  // p0 is the same for the whole block, so a warp's lanes make the same
  // trips and the warp collectives see all 32 lanes
  for (int64_t p0 = range[0]; p0 < stop; p0 += kThreads * kAccItems) {
    int rel[kAccItems];
    Acc v[kAccItems];
#pragma unroll
    for (int i = 0; i < kAccItems; ++i) {
      const int64_t p = p0 + i * kThreads + threadIdx.x;
      rel[i] = -1;
      if (p < stop) {
        if constexpr (kSorted) {
          const int64_t r = static_cast<int64_t>(__ldg(keys + p)) - base;
          // sorted keys lie inside the window; the guard only keeps input
          // that is not sorted from writing outside shared memory
          if (r >= 0 && r < cells) rel[i] = static_cast<int>(r);
        } else {
          rel[i] = __ldg(offsets + p);
        }
      }
      if constexpr (kWeighted) {
        v[i] = p < stop ? __ldg(vals + p) : 0.0f;
      } else {
        v[i] = 1u;
      }
    }
#pragma unroll
    for (int i = 0; i < kAccItems; ++i) {
      warp_run_add<Acc>(acc, rel[i], rel[i] >= 0 ? v[i] : Acc(0), lane);
    }
  }
  __syncthreads();

  float* o = out + base;
  if (!heavy) {
    // the window is 32 KB aligned, so whole quads store as float4
    const int quads = cells / 4;
    for (int i = threadIdx.x; i < quads; i += kThreads) {
      const uint4 a = acc4[i];
      float4 f;
      if constexpr (kWeighted) {
        f = make_float4(__uint_as_float(a.x), __uint_as_float(a.y),
                        __uint_as_float(a.z), __uint_as_float(a.w));
      } else {
        f = make_float4(static_cast<float>(a.x), static_cast<float>(a.y),
                        static_cast<float>(a.z), static_cast<float>(a.w));
      }
      reinterpret_cast<float4*>(o)[i] = f;
    }
    for (int i = 4 * quads + threadIdx.x; i < cells; i += kThreads) {
      o[i] = static_cast<float>(acc[i]);
    }
  } else {
    for (int i = threadIdx.x; i < cells; i += kThreads) {
      const Acc a = acc[i];
      if (a != Acc(0)) atomicAdd(o + i, static_cast<float>(a));
    }
  }
}

int multiprocessors() {
  int dev = 0;
  int sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 132;
  }
  return sms;
}

// the accumulate grid: the most chunks a plan can make
int64_t chunk_bound(int64_t n, int64_t n_cells, int64_t chunk) {
  return windows_of(n_cells) + n / chunk + 1;
}

int check_args(int64_t n, int64_t n_cells, int64_t chunk, int64_t bytes,
               const Layout& l) {
  if (n < 0 || n_cells < 0 || n_cells > 0x7fffffffLL || chunk < 1 ||
      bytes < l.bytes) {
    return cudaErrorInvalidValue;
  }
  // chunk and window ids are int32; hist counts a window in 32 bits
  if (chunk_bound(n, n_cells, chunk) > 0x7fffffffLL || n > 0xffffffffLL) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <bool kWeighted, bool kSorted>
void launch_accumulate(unsigned grid, const int32_t* keys,
                       const uint16_t* offsets, const float* vals,
                       const int64_t* starts, const int32_t* chunk_start,
                       const int32_t* table, int nw, int64_t n_cells,
                       int64_t chunk, float* out, cudaStream_t s) {
  deposit_accumulate<kWeighted, kSorted><<<grid, kThreads, 0, s>>>(
      keys, offsets, vals, starts, chunk_start, table, nw, n_cells, chunk,
      out);
}

template <bool kWeighted, bool kFinal, bool kSecond>
cudaError_t launch_partition(unsigned grid, const int32_t* keys,
                             const float* vals, int64_t n,
                             const int64_t* n_dev, int64_t n_cells, int shift,
                             int bucket_shift, int64_t* cursor,
                             int32_t* keys_out, uint16_t* offsets_out,
                             float* vals_out, cudaStream_t s) {
  // staged keys (and weights), and the ranks
  constexpr int kStaged = 4 * kPartTile * (kWeighted ? 2 : 1) + 2 * kPartTile;
  auto* kernel = deposit_partition<kWeighted, kFinal, kSecond>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStaged);
  if (rc != cudaSuccess) return rc;
  kernel<<<grid, kPartThreads, kStaged, s>>>(keys, vals, n, n_dev, n_cells,
                                             shift, bucket_shift, cursor,
                                             keys_out, offsets_out, vals_out);
  return cudaSuccess;
}

// the keys into their windows' segments, in one level or in two
template <bool kWeighted>
cudaError_t partition(const int32_t* keys, const float* vals, int64_t n,
                      int64_t n_cells, void* scratch, const Layout& l,
                      cudaStream_t s) {
  const int nw = static_cast<int>(windows_of(n_cells));
  const int bs = bucket_shift(nw);
  const auto grid = static_cast<unsigned>((n + kPartTile - 1) / kPartTile);
  auto* cursor = piece<int64_t>(scratch, l.cursor);
  auto* offsets = piece<uint16_t>(scratch, l.offsets);
  auto* part_vals = piece<float>(scratch, l.vals);
  if (bs < 0) {
    return launch_partition<kWeighted, true, false>(
        grid, keys, vals, n, nullptr, n_cells, kShift, 0, cursor, nullptr,
        offsets, part_vals, s);
  }
  auto* level_keys = piece<int32_t>(scratch, l.level_keys);
  auto* level_vals = piece<float>(scratch, l.level_vals);
  const cudaError_t rc = launch_partition<kWeighted, false, false>(
      grid, keys, vals, n, nullptr, n_cells, kShift + bs, 0,
      piece<int64_t>(scratch, l.bucket_cursor), level_keys, nullptr,
      level_vals, s);
  if (rc != cudaSuccess) return rc;
  // the first level's count of kept keys: the plan's last segment end
  return launch_partition<kWeighted, true, true>(
      grid, level_keys, level_vals, n, piece<int64_t>(scratch, l.starts) + nw,
      n_cells, kShift, bs, cursor, nullptr, offsets, part_vals, s);
}

// zero and accumulate: the passes both entry points end with
void launch_tail(const int32_t* keys, const float* vals, int64_t n_cells,
                 int64_t n, int64_t chunk, float* out, void* scratch,
                 const Layout& l, bool sorted, cudaStream_t s) {
  const int nw = static_cast<int>(windows_of(n_cells));
  const auto g = static_cast<unsigned>(chunk_bound(n, n_cells, chunk));
  auto* starts = piece<int64_t>(scratch, l.starts);
  auto* chunk_start = piece<int32_t>(scratch, l.chunk_start);
  auto* table = piece<int32_t>(scratch, l.table);
  auto* offsets = piece<uint16_t>(scratch, l.offsets);
  auto* part_vals = piece<float>(scratch, l.vals);
  deposit_zero<<<nw < 2048 ? nw : 2048, kPassThreads, 0, s>>>(chunk_start, nw,
                                                              n_cells, out);
  if (sorted) {
    if (vals != nullptr) {
      launch_accumulate<true, true>(g, keys, nullptr, vals, starts,
                                    chunk_start, table, nw, n_cells, chunk,
                                    out, s);
    } else {
      launch_accumulate<false, true>(g, keys, nullptr, nullptr, starts,
                                     chunk_start, table, nw, n_cells, chunk,
                                     out, s);
    }
  } else if (vals != nullptr) {
    launch_accumulate<true, false>(g, nullptr, offsets, part_vals, starts,
                                   chunk_start, table, nw, n_cells, chunk,
                                   out, s);
  } else {
    launch_accumulate<false, false>(g, nullptr, offsets, nullptr, starts,
                                    chunk_start, table, nw, n_cells, chunk,
                                    out, s);
  }
}

}  // namespace

// Bytes of scratch the entry points need for n keys into n_cells cells in
// chunks of `chunk` entries (flat: keys in any order; weighted: with vals).
extern "C" int64_t astrild_deposit_scratch_bytes(int64_t n, int64_t n_cells,
                                                 int flat, int weighted,
                                                 int64_t chunk) {
  if (n < 0 || n_cells < 0 || chunk < 1) return -1;
  return layout(n, n_cells, flat != 0, weighted != 0, chunk).bytes;
}

// Deposits n keys in any order (and optional weights) into out[0, n_cells),
// which need not be initialised. scratch: astrild_deposit_scratch_bytes(n,
// n_cells, 1, vals != null, chunk) bytes of device memory. All pointers are
// device pointers; `stream` is a cudaStream_t. Returns the cudaError_t of
// the launches (0 on success).
extern "C" int astrild_deposit_flat(const int32_t* keys, const float* vals,
                                    int64_t n, float* out, int64_t n_cells,
                                    int64_t chunk, void* scratch,
                                    int64_t scratch_bytes, void* stream) {
  const Layout l = layout(n, n_cells, true, vals != nullptr, chunk);
  const int bad = check_args(n, n_cells, chunk, scratch_bytes, l);
  if (bad != cudaSuccess) return bad;
  if (n_cells == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const int nw = static_cast<int>(windows_of(n_cells));
  auto* counts = piece<unsigned>(scratch, l.counts);
  cudaError_t rc = cudaMemsetAsync(counts, 0, 4 * static_cast<size_t>(nw), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (n > 0) {
    constexpr int64_t kTile = kHistThreads * kHistItems;
    const int64_t want = (n + kTile - 1) / kTile;
    // two blocks an SM: each adds its shared counters into device memory
    // once, so fewer blocks flush fewer counters
    const int64_t cap = 2 * static_cast<int64_t>(multiprocessors());
    const auto blocks = static_cast<unsigned>(want < cap ? want : cap);
    if (nw <= kSharedWindows) {
      rc = cudaFuncSetAttribute(deposit_hist<true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                4 * kSharedWindows);
      if (rc != cudaSuccess) return static_cast<int>(rc);
      deposit_hist<true><<<blocks, kHistThreads, 4 * nw, s>>>(keys, n, n_cells,
                                                            nw, counts);
    } else {
      deposit_hist<false><<<blocks, kHistThreads, 0, s>>>(keys, n, n_cells, nw,
                                                         counts);
    }
  }
  const int bs = bucket_shift(nw);
  deposit_plan<true><<<1, kPlanThreads, 0, s>>>(
      counts, piece<int64_t>(scratch, l.starts),
      piece<int64_t>(scratch, l.cursor), piece<int32_t>(scratch, l.chunk_start),
      piece<int32_t>(scratch, l.table), nw, chunk,
      chunk_bound(n, n_cells, chunk), bs,
      piece<int64_t>(scratch, l.bucket_cursor));
  if (n > 0) {
    rc = vals != nullptr
             ? partition<true>(keys, vals, n, n_cells, scratch, l, s)
             : partition<false>(keys, vals, n, n_cells, scratch, l, s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  launch_tail(keys, vals, n_cells, n, chunk, out, scratch, l, false, s);
  return static_cast<int>(cudaGetLastError());
}

// Deposits n keys sorted ascending (and optional weights in the same order)
// into out[0, n_cells), which need not be initialised. scratch:
// astrild_deposit_scratch_bytes(n, n_cells, 0, vals != null, chunk) bytes.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int astrild_deposit_sorted(const int32_t* keys, const float* vals,
                                      int64_t n, float* out, int64_t n_cells,
                                      int64_t chunk, void* scratch,
                                      int64_t scratch_bytes, void* stream) {
  const Layout l = layout(n, n_cells, false, vals != nullptr, chunk);
  const int bad = check_args(n, n_cells, chunk, scratch_bytes, l);
  if (bad != cudaSuccess) return bad;
  if (n_cells == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const int nw = static_cast<int>(windows_of(n_cells));
  auto* starts = piece<int64_t>(scratch, l.starts);
  deposit_bounds<<<(nw + kPassThreads) / kPassThreads, kPassThreads, 0, s>>>(
      keys, n, n_cells, nw, starts);
  deposit_plan<false><<<1, kPlanThreads, 0, s>>>(
      nullptr, starts, nullptr, piece<int32_t>(scratch, l.chunk_start),
      piece<int32_t>(scratch, l.table), nw, chunk,
      chunk_bound(n, n_cells, chunk), -1, nullptr);
  launch_tail(keys, vals, n_cells, n, chunk, out, scratch, l, true, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* astrild_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
