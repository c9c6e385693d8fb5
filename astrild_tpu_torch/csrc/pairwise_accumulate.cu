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
// pairwise_cuda.py, from each row before anything else).
//
// Reordering. The sums are invariant under a permutation of the rows:
// swapping i and j flips the sign of rhat and q_ij and of v_i - v_j, so a
// pair's nom and den are unchanged, and its squared separation is the same
// float (x_i - x_j and x_j - x_i round to values of opposite sign). The
// wrapper therefore sorts the rows along a Morton curve and cuts them into
// tiles of kTile rows, each of kChunks chunks of kChunk rows; the sums
// differ from the plain version's only by the order of float additions.
//
// Exact cut. The TPU kernel took a correctly rounded sqrt and division for
// every pair. Here a pair first computes
//     s = (rx*rx + ry*ry) + rz*rz          (every step an _rn intrinsic)
// and is dropped unless s < s_max, where s_max (found by the wrapper with a
// float32 binary search) is the smallest float s >= 0 for which
// fdiv_rn(sqrt_rn(s), binwidth) >= nbins. Correctly rounded sqrt and
// division are monotone, so s < s_max holds exactly when the plain
// version's test t < nbins holds: the bin decision is bit for bit the plain
// version's. NaN fails both. Only an in-range pair takes sqrtf (IEEE under
// _ext.py's flags), __fdiv_rn and the bin cast.
//
// Box culling. The wrapper gives each chunk and each tile the axis-aligned
// box of its finite rows. A tile pair, and within it a pair of chunks, is
// visited only if its boxes' squared gap
//     gap = (gx*gx + gy*gy) + gz*gz < s_max,
//     gx = max(0, fsub_rn(lo_b, hi_a), fsub_rn(lo_a, hi_b))   (y, z alike)
// with the same _rn operations as s. Soundness: for rows i in a and j in b,
// x_j - x_i >= lo_b - hi_a exactly, and rounding to nearest is monotone and
// odd, so |fsub_rn(x_i, x_j)| >= fsub_rn(lo_b, hi_a); likewise for lo_a -
// hi_b, and |rx| >= 0. Hence |rx| >= gx on each axis, and since fmul_rn and
// fadd_rn are monotone on non-negative operands, s >= gap. A culled pair
// of boxes (gap >= s_max) therefore holds no pair with s < s_max. A row
// with a non-finite coordinate is left out of its box; it forms no pair
// either (its s is NaN or +inf, and +inf < s_max is false).
//
// Design on the card. Bound: arithmetic on the in-range pairs (bytes are
// O(n) per tile). A fixed grid of G blocks (kWaves waves of the resident
// blocks, so that the hardware's block scheduler evens out slices of
// unequal work; 1, 4, 8, 16 and 32 waves were timed, PERF.md) walks the
// upper triangle of tile pairs (ti <= tj) in place, in row-major order:
// block g owns items k = g, g + G, g + 2G, ... Each of its warps decodes 32
// of them at a time (one a lane), tests their tile boxes and votes, and
// the block visits the survivors in order; the four warps reach the same
// votes, so the walk stays in step without a list in memory. A block stages the item's two tiles as packed float4 rows in
// shared memory. Warp w holds the positions of i rows 64w + lane and 64w +
// 32 + lane (chunks 2w and 2w + 1) in registers and tests its 16 (i-chunk,
// j-chunk) box gaps first; it walks the j rows of the chunks in reach,
// kBatch at a time: one broadcast 16-byte load per j row, reused by both
// i rows, the cut per pair, then one vote per pair. A rejected pair costs
// half the load, 3 FADD for the differences, 3 FMUL and 2 FADD for s, one
// FSETP and the vote, plus its share of the batch's test and the loop:
// 12.4 issued instructions a rejected pair (13.4 where a chunk also tests
// j > i or holds a row out of reach), read off cuobjdump -sass of this
// file built for sm_90a (tools/k3_sass.py). The batch is 4 j rows because
// the ring then fits four blocks an SM; 8 rows take a resident block and
// lose more than their loop overhead saves. No FFMA sits on the path that
// computes s or the box gap; t takes sqrtf and __fdiv_rn, whose correctly
// rounded sequences are the only FFMA before the bin.
//
// Accumulation. In-range pairs go to a ring of kQueue entries per warp
// (ballot, rank by popc), and whenever 64 are waiting each lane takes two,
// so the q-vector body runs with every lane busy however sparse the
// in-range pairs are (lanes that each ran only their own pairs, while the
// others waited, were 20% slower at 2^20 tracers, PERF.md). Each thread
// owns one column of a shared-memory table of 2 * nbins rows (laid out
// [row][thread], so a warp's lanes hit 32 banks; 128 KB at nbins = 128)
// and adds its pairs there without atomics, in a fixed order. After every
// item the block folds the table into float64 sums held in registers
// (thread t owns rows t and t + kThreads, read in a staggered order so the
// lanes hit distinct banks) and zeroes it; at the end each block writes one
// float32 partial row. A second kernel reduces the G partial rows in
// float64 in a fixed order. With the deal, the walk, the ring, the fold
// order and the reduction all fixed, two runs on the same input give the
// same bits (on the same card: G depends on its SM count).
//
// Scratch: G * 2 * nbins partial floats beside the chunk and tile boxes,
// O(n_tiles) and never O(n_tiles^2), whatever share of the tile pairs is in
// reach. Row indices and triangle items are int64 and tile indices int32,
// so n_valid up to 2^24 and far beyond cannot overflow.
//
// Plain C interface (no PyTorch headers): loaded with ctypes by
// astrild_tpu_torch/_ext.py and launched on the caller's stream.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 256;               // rows per tile (= TILE in the wrapper)
constexpr int kChunk = 32;               // rows per chunk (= CHUNK), one warp's
constexpr int kChunks = kTile / kChunk;  // chunks per tile
constexpr int kThreads = 128;            // threads per pair block
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kTile / kThreads;  // i rows (chunks) held by each thread
constexpr int kBatch = 4;                // j rows cut before a vote
constexpr int kQueue = 512;              // ring entries per warp
constexpr int kMaxBins = 128;
constexpr int kOwned = 2 * kMaxBins / kThreads;  // table rows a thread folds
constexpr int kMaxBlocksPerSm = 8;
constexpr int kWaves = 16;               // grid = kWaves x resident blocks
constexpr int kReduceThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kRows == 2, "a thread holds two i rows");
static_assert(kRows * kChunk * kWarps == kTile, "a warp holds kRows chunks");
static_assert(kRows * kChunks <= 32, "a warp votes on its chunk pairs");
static_assert(kQueue >= 63 + 32 * kRows * kBatch &&
                  (kQueue & (kQueue - 1)) == 0,
              "the ring holds 63 waiting entries plus one batch's votes");
static_assert(kTile <= 256, "ring entries hold 8-bit row indices");
static_assert(kChunk % kBatch == 0, "batches tile a chunk");

// squared gap between two boxes, rounded as the pairs' s is (see above)
__device__ __forceinline__ float box_gap(float4 alo, float4 ahi, float4 blo,
                                         float4 bhi) {
  const float gx = fmaxf(fmaxf(__fsub_rn(blo.x, ahi.x),
                               __fsub_rn(alo.x, bhi.x)), 0.0f);
  const float gy = fmaxf(fmaxf(__fsub_rn(blo.y, ahi.y),
                               __fsub_rn(alo.y, bhi.y)), 0.0f);
  const float gz = fmaxf(fmaxf(__fsub_rn(blo.z, ahi.z),
                               __fsub_rn(alo.z, bhi.z)), 0.0f);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

__device__ __forceinline__ float sq_sep(float4 a, float4 b, float& rx,
                                        float& ry, float& rz) {
  rx = __fsub_rn(a.x, b.x);
  ry = __fsub_rn(a.y, b.y);
  rz = __fsub_rn(a.z, b.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)),
                   __fmul_rn(rz, rz));
}

// First item of triangle row t: rows t' < t hold n_tiles - t' items each.
__device__ __forceinline__ int64_t row_start(int64_t t, int64_t n_tiles) {
  return t * n_tiles - t * (t - 1) / 2;
}

// Item k of the upper triangle of n_tiles x n_tiles in row-major order:
// (ti, tj), ti <= tj. A float64 estimate of the row, then exact integer
// steps to the row that holds k.
__device__ __forceinline__ void triangle_item(int64_t k, int64_t n_tiles,
                                              int& ti, int& tj) {
  const double b = 2.0 * static_cast<double>(n_tiles) + 1.0;
  int64_t t = static_cast<int64_t>(
      0.5 * (b - sqrt(b * b - 8.0 * static_cast<double>(k))));
  t = t < 0 ? 0 : (t >= n_tiles ? n_tiles - 1 : t);
  while (t > 0 && row_start(t, n_tiles) > k) --t;
  while (t + 1 < n_tiles && row_start(t + 1, n_tiles) <= k) ++t;
  ti = static_cast<int>(t);
  tj = static_cast<int>(t + (k - row_start(t, n_tiles)));
}

struct Staged {  // the item's two tiles in shared memory
  const float4* ip;
  const float4* iv;
  const float4* ih;
  const float4* jp;
  const float4* jv;
  const float4* jh;
};

// The q-vector body of one queued in-range pair (e: its i row << 8 | its
// j row, local to the tiles), added into this thread's column of the
// table. The separation, the bin and rhat are the TPU kernel's: sqrtf and
// true division, correctly rounded under _ext.py's flags, so the bin is
// the plain version's bit for bit. The pair passed s < s_max, so t <
// nbins; the test is kept so that a bin index can never leave the table.
__device__ __forceinline__ void add_pair(const Staged& t, unsigned e,
                                         float binwidth, int nbins,
                                         float* __restrict__ col) {
  const int il = static_cast<int>(e >> 8);
  const int jj = static_cast<int>(e & 0xffu);
  float rx, ry, rz;
  const float dist = sqrtf(sq_sep(t.ip[il], t.jp[jj], rx, ry, rz));
  const float tb = __fdiv_rn(dist, binwidth);
  if (!(tb < static_cast<float>(nbins))) return;
  const int b = static_cast<int>(tb);
  const float4 hi = t.ih[il], hj = t.jh[jj];
  const float4 vi = t.iv[il], vj = t.jv[jj];
  const float inv = 1.0f / fmaxf(dist, 1e-12f);
  const float ux = rx * inv, uy = ry * inv, uz = rz * inv;
  const float di = ux * hi.x + uy * hi.y + uz * hi.z;
  const float dj = ux * hj.x + uy * hj.y + uz * hj.z;
  const float qx = 0.5f * (2.0f * ux - hi.x * di - hj.x * dj);
  const float qy = 0.5f * (2.0f * uy - hi.y * di - hj.y * dj);
  const float qz = 0.5f * (2.0f * uz - hi.z * di - hj.z * dj);
  const float nom = (vi.x - vj.x) * qx + (vi.y - vj.y) * qy +
                    (vi.z - vj.z) * qz;
  const float den = qx * qx + qy * qy + qz * qz;
  col[b * kThreads] += nom;
  col[(nbins + b) * kThreads] += den;
}

// A warp's ring of in-range pairs: entries (il << 8) | jj at positions
// head .. tail - 1 (mod kQueue); head and tail are the same in every lane.
struct Ring {
  uint16_t* q;
  unsigned head, tail;
};

// The thread's i rows il0 and il1 (positions p0, p1) against the kChunk j
// rows from j0 on, kBatch at a time: each j row loaded once and cut
// against both rows, then the batch's votes into the ring in a fixed
// order, then, while 64 pairs wait, each lane takes two. kLimit: row r
// counts only j rows jj > lim_r (its own chunk of a diagonal tile pair:
// lim_r = its il; a row not in reach: kTile).
template <bool kLimit>
__device__ __forceinline__ void scan_chunk(const Staged& t, float4 p0,
                                           float4 p1, int il0, int il1,
                                           int lim0, int lim1, int j0,
                                           float s_max, float binwidth,
                                           int nbins, Ring& ring,
                                           float* __restrict__ col) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll 1
  for (int k0 = j0; k0 < j0 + kChunk; k0 += kBatch) {
    unsigned m[kRows * kBatch];
    unsigned any = 0u;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int jj = k0 + k;
      const float4 pj = t.jp[jj];
      float rx, ry, rz;
      const float s0 = sq_sep(p0, pj, rx, ry, rz);
      const float s1 = sq_sep(p1, pj, rx, ry, rz);
      m[2 * k] = __ballot_sync(kFull, s0 < s_max && (!kLimit || jj > lim0));
      m[2 * k + 1] =
          __ballot_sync(kFull, s1 < s_max && (!kLimit || jj > lim1));
      any |= m[2 * k] | m[2 * k + 1];
    }
    if (any == 0u) continue;
#pragma unroll
    for (int e = 0; e < kRows * kBatch; ++e) {
      if ((m[e] >> lane) & 1u) {
        ring.q[(ring.tail + __popc(m[e] & lt)) & (kQueue - 1)] =
            static_cast<uint16_t>((((e & 1) ? il1 : il0) << 8) |
                                  (k0 + (e >> 1)));
      }
      ring.tail += __popc(m[e]);
    }
    __syncwarp();
    while (ring.tail - ring.head >= 64u) {  // two pairs a lane, interleaved
      const unsigned e0 = ring.q[(ring.head + lane) & (kQueue - 1)];
      const unsigned e1 = ring.q[(ring.head + 32 + lane) & (kQueue - 1)];
      add_pair(t, e0, binwidth, nbins, col);
      add_pair(t, e1, binwidth, nbins, col);
      ring.head += 64u;
    }
    __syncwarp();
  }
}

// Fold the table rows this thread owns (t, t + kThreads, ...) into its
// float64 sums and zero them; the staggered start puts a warp's lanes on
// distinct banks.
__device__ __forceinline__ void fold(float* __restrict__ table, int width,
                                     double (&owned)[kOwned]) {
#pragma unroll
  for (int m = 0; m < kOwned; ++m) {
    const int k = threadIdx.x + m * kThreads;
    if (k >= width) continue;
    float* row = table + k * kThreads;
    double s0 = 0.0, s1 = 0.0;
    for (int c = 0; c < kThreads; c += 2) {
      const int c0 = (c + threadIdx.x) % kThreads;
      const int c1 = (c + 1 + threadIdx.x) % kThreads;
      s0 += static_cast<double>(row[c0]);
      s1 += static_cast<double>(row[c1]);
      row[c0] = 0.0f;
      row[c1] = 0.0f;
    }
    owned[m] += s0 + s1;
  }
}

size_t pair_smem_bytes(int nbins) {
  return 6 * kTile * sizeof(float4) +
         static_cast<size_t>(2 * nbins) * kThreads * sizeof(float) +
         kWarps * kQueue * sizeof(uint16_t);
}

// The tile pair (ti, tj), whose tile boxes are in reach: stage its two
// tiles, test the chunk pairs and walk those in reach, then run the pairs
// still in the warp's ring. Every thread of the block calls it with the
// same item.
__device__ __forceinline__ void visit(
    int ti, int tj, const float4* __restrict__ pos4,
    const float4* __restrict__ vel4, const float4* __restrict__ hat4,
    const float4* __restrict__ clo, const float4* __restrict__ chi,
    float4* smem, Ring& ring, float s_max, float binwidth, int nbins,
    float* __restrict__ table, double (&owned)[kOwned]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // the previous item's pairs are all in the table
  fold(table, 2 * nbins, owned);
  const int64_t i0 = static_cast<int64_t>(ti) * kTile;
  const int64_t j0 = static_cast<int64_t>(tj) * kTile;
  const Staged t{smem, smem + kTile, smem + 2 * kTile,
                 smem + 3 * kTile, smem + 4 * kTile, smem + 5 * kTile};
  for (int k = threadIdx.x; k < kTile; k += kThreads) {
    smem[k] = pos4[i0 + k];
    smem[kTile + k] = vel4[i0 + k];
    smem[2 * kTile + k] = hat4[i0 + k];
    smem[3 * kTile + k] = pos4[j0 + k];
    smem[4 * kTile + k] = vel4[j0 + k];
    smem[5 * kTile + k] = hat4[j0 + k];
  }
  const bool diag = ti == tj;
  // bit m + kRows * c: i chunk kRows * warp + m against j chunk c is in
  // reach (on a diagonal tile pair: and c >= the i chunk)
  bool reach = false;
  if (lane < kRows * kChunks) {
    const int m = lane % kRows, c = lane / kRows;
    const int ic = kRows * warp + m;
    const int64_t a = static_cast<int64_t>(ti) * kChunks + ic;
    const int64_t b = static_cast<int64_t>(tj) * kChunks + c;
    reach = box_gap(clo[a], chi[a], clo[b], chi[b]) < s_max &&
            (!diag || c >= ic);
  }
  const unsigned in_reach = __ballot_sync(kFull, reach);
  const int ic0 = kRows * warp, ic1 = kRows * warp + 1;
  const int il0 = ic0 * kChunk + lane, il1 = ic1 * kChunk + lane;
  __syncthreads();  // the tiles are staged and the table zeroed
  const float4 p0 = t.ip[il0], p1 = t.ip[il1];
  float* col = table + threadIdx.x;
  for (int c = 0; c < kChunks; ++c) {
    const unsigned both = (in_reach >> (kRows * c)) & 3u;
    if (both == 0u) continue;
    const bool own0 = diag && c == ic0, own1 = diag && c == ic1;
    if (both == 3u && !own0 && !own1) {
      scan_chunk<false>(t, p0, p1, il0, il1, 0, 0, c * kChunk, s_max,
                        binwidth, nbins, ring, col);
    } else {
      const int lim0 = !(both & 1u) ? kTile : (own0 ? il0 : -1);
      const int lim1 = !(both & 2u) ? kTile : (own1 ? il1 : -1);
      scan_chunk<true>(t, p0, p1, il0, il1, lim0, lim1, c * kChunk, s_max,
                       binwidth, nbins, ring, col);
    }
  }
  // the pairs still waiting: fewer than 64
  __syncwarp();
  for (unsigned k = lane; k < ring.tail - ring.head; k += 32u) {
    add_pair(t, ring.q[(ring.head + k) & (kQueue - 1)], binwidth, nbins,
             col);
  }
  ring.head = ring.tail;
  __syncwarp();
}

// pos4, vel4, hat4: (n_tiles * kTile) rows of float4 in tile order (rows
// past n_valid hold NaN positions, so they pair with nothing); clo, chi:
// the boxes of the (n_tiles * kChunks) chunks; lo, hi: the tiles' boxes;
// s_max: the cut of the last bin edge. Block g walks triangle items g,
// g + G, g + 2G, ... and visits those whose tile boxes are in reach.
__global__ void __launch_bounds__(kThreads, 4)
    pair_tiles_kernel(const float4* __restrict__ pos4,
                      const float4* __restrict__ vel4,
                      const float4* __restrict__ hat4,
                      const float4* __restrict__ clo,
                      const float4* __restrict__ chi,
                      const float4* __restrict__ lo,
                      const float4* __restrict__ hi, int64_t n_tiles,
                      float s_max, float binwidth, int nbins,
                      float* __restrict__ partials) {
  extern __shared__ float4 smem[];
  float* table = reinterpret_cast<float*>(smem + 6 * kTile);
  const int lane = threadIdx.x & 31;
  const int width = 2 * nbins;
  Ring ring{reinterpret_cast<uint16_t*>(table + width * kThreads) +
                (threadIdx.x >> 5) * kQueue,
            0u, 0u};
  for (int k = 0; k < width; ++k) table[k * kThreads + threadIdx.x] = 0.0f;
  double owned[kOwned];
#pragma unroll
  for (int m = 0; m < kOwned; ++m) owned[m] = 0.0;

  const int64_t total = n_tiles * (n_tiles + 1) / 2;
  const int64_t G = gridDim.x;
  for (int64_t p0 = 0; blockIdx.x + p0 * G < total; p0 += 32) {
    const int64_t k = blockIdx.x + (p0 + lane) * G;
    int ti = 0, tj = 0;
    bool keep = false;
    if (k < total) {
      triangle_item(k, n_tiles, ti, tj);
      keep = box_gap(lo[ti], hi[ti], lo[tj], hi[tj]) < s_max;
    }
    // the same votes in every warp: the block visits the survivors in step
    unsigned todo = __ballot_sync(kFull, keep);
    while (todo != 0u) {
      const int b = __ffs(todo) - 1;
      todo &= todo - 1u;
      visit(__shfl_sync(kFull, ti, b), __shfl_sync(kFull, tj, b), pos4, vel4,
            hat4, clo, chi, smem, ring, s_max, binwidth, nbins, table,
            owned);
    }
  }
  __syncthreads();
  fold(table, width, owned);
  float* out = partials + static_cast<int64_t>(blockIdx.x) * width;
#pragma unroll
  for (int m = 0; m < kOwned; ++m) {
    const int k = threadIdx.x + m * kThreads;
    if (k < width) out[k] = static_cast<float>(owned[m]);
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

cudaError_t set_pair_smem(int nbins) {
  return cudaFuncSetAttribute(pair_tiles_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(pair_smem_bytes(nbins)));
}

}  // namespace

// Rows per tile and per chunk: the wrapper pads the sorted rows to a
// multiple of the tile and gives a box per chunk.
extern "C" int astrild_pairwise_tile_rows() { return kTile; }
extern "C" int astrild_pairwise_chunk_rows() { return kChunk; }

// Blocks of the pair kernel for nbins bins on the current device (the
// number of partial rows the wrapper allocates), or minus a cudaError_t.
extern "C" int64_t astrild_pairwise_grid(int nbins) {
  if (nbins < 1 || nbins > kMaxBins) {
    return -static_cast<int64_t>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) err = set_pair_smem(nbins);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pair_tiles_kernel, kThreads, pair_smem_bytes(nbins));
  }
  if (err != cudaSuccess) return -static_cast<int64_t>(err);
  if (per_sm < 1) return -static_cast<int64_t>(cudaErrorInvalidConfiguration);
  return static_cast<int64_t>(kWaves) * sms *
         (per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm);
}

// pos4, vel4, hat4: (n_tiles * kTile, 4) float32 rows in tile order; clo,
// chi: (n_tiles * kChunks, 4) float32 chunk boxes; lo, hi: (n_tiles, 4)
// float32 tile boxes; partials: grid * 2 * nbins floats of scratch (grid
// from astrild_pairwise_grid); out: (2, nbins) float32 = (nom, den).
// `stream` is a cudaStream_t. Returns the cudaError_t of the launches (0 on
// success).
extern "C" int astrild_pairwise_accumulate(
    const float* pos4, const float* vel4, const float* hat4, const float* clo,
    const float* chi, const float* lo, const float* hi, int64_t n_tiles,
    float s_max, float binwidth, int nbins, int64_t grid, float* partials,
    float* out, void* stream) {
  if (nbins < 1 || nbins > kMaxBins || n_tiles < 0 ||
      n_tiles > 0x7fffffffLL || grid < 1 || grid > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = set_pair_smem(nbins);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_tiles_kernel<<<static_cast<unsigned int>(grid), kThreads,
                      pair_smem_bytes(nbins), s>>>(
      reinterpret_cast<const float4*>(pos4),
      reinterpret_cast<const float4*>(vel4),
      reinterpret_cast<const float4*>(hat4),
      reinterpret_cast<const float4*>(clo),
      reinterpret_cast<const float4*>(chi),
      reinterpret_cast<const float4*>(lo), reinterpret_cast<const float4*>(hi),
      n_tiles, s_max, binwidth, nbins, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials_kernel<<<2 * nbins, kReduceThreads, 0, s>>>(
      partials, grid, 2 * nbins, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* astrild_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
