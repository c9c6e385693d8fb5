// Tile-binned CIC/TSC mass assignment for Hopper (sm_90a).
//
// Replaces the TPU kernel astrild_tpu/ops/paint_pallas.py:paint_windowed
// (body _paint_kernel). Each particle, wrapped into the periodic box, has a
// base cell b (CIC: floor(x/h - 0.5); TSC: the centre cell floor(x/h)
// clipped to [0, n-1]) and fractions along each axis, and deposits
//
//     w_x(f_x, a) w_y(f_y, b) w_z(f_z, c) * weight_p   into cell
//     (b_x + lo + a, b_y + lo + b, b_z + lo + c) mod n,   a, b, c in [0, order)
//
//     CIC (order 2, lo = 0):  offset 0: 1 - f, offset 1: f
//     TSC (order 3, lo = -1): offset 0: 0.75 - d^2, offset +-1: 0.5 (0.5 +- d)^2
//
// The arithmetic of the base cell and the fractions is that of the plain
// version's keys (astrild_tpu_torch/ops/paint_cuda.py:_windowed_keys),
// step for step and rounded the same way: remainder (fmod, + box below 0),
// a true division by h (not a multiplication by 1/h), floor, and for TSC
// the clip before d is taken from the clipped index.
//
// The TPU version turned each (window, offset) pair into a one-hot matmul on
// the MXU over keys sorted ahead in XLA. Here the usual particle-mesh layout
// of a GPU takes its place, a counting sort by output tile, in four
// launches on the caller's stream:
//   1. bin:     one pass over x, y, z computes each particle's tile (a
//               kTX x kTY x kTZ block of base cells) and counts the
//               particles per tile; a warp adds its count once per distinct
//               tile (__match_any_sync), so the long runs of one tile that
//               particle-mesh order makes do not serialise on one counter;
//   2. scan:    one block turns the counts into tile offsets;
//   3. scatter: each particle's int32 id goes to its tile's range;
//   4. deposit: one block per tile reads its particles' positions once,
//               computes the fractions, adds all 8 (CIC) or 27 (TSC)
//               contributions into the tile and its halo in shared memory,
//               and flushes the non-zero cells with atomicAdd into the
//               (n, n, n) output the caller has zeroed, wrapping periodically.
// There is no padded grid and no fold; tiles need not divide n.
//
// Bound: device-memory bandwidth. Positions are read once (12 B a particle,
// +4 B with weights) and the grid written once (4 B a cell): 2^27 particles
// onto 512^3 move 2.15 GB, 0.64 ms at 3.35 TB/s. The binning adds about
// 20 B a particle (the tile id written and read back, the id scattered and
// read back), and the flush about (1 + order - 1 over the tile's sides) of
// the grid as L2 atomics. On a clustered snapshot the shared-memory
// atomics cost most: float atomicAdd on shared memory compiles to a
// compare-and-swap loop for sm_90a, which retries wherever lanes hit one
// cell, as the particles of a dense halo do. The deposit therefore sums
// the weights of the lanes of a warp that share a base cell before it adds
// (one atomic per group and cell instead of one per particle and cell).
//
// The adjoint (astrild_paint_windowed_adjoint) is the deposit's gradient,
// which the TPU version had none of (the JAX package differentiated only
// its XLA scatter, astrild_tpu/ops/field_infer.py:81-83). The transpose of
// a scatter is a gather: one thread a particle recomputes its base cell
// and fractions with the same arithmetic as the bin pass, reads the 8
// (CIC) or 27 (TSC) cells of the incoming gradient grid around it
// (wrapping periodically, the transpose of the fold) and writes
//     dL/dw_p   = sum_c W_c g_c,
//     dL/dx_p,a = w_p sum_c (dW_c / df_a) g_c / h,
// with dW/df along an axis -1, +1 (CIC) or -(0.5 - d), -2d, 0.5 + d (TSC)
// times the other two axes' weights. Bound: device-memory bandwidth, 12 B
// of positions and 12 B of position gradient a particle (+8 B with
// weights) and the gradient grid read once (4 B a cell); the cell reads
// of neighbouring particles meet in L1 and L2 when the particles come in
// particle-mesh order.
//
// Plain C interface (no PyTorch headers): loaded with ctypes by
// astrild_tpu_torch/_ext.py and launched on the caller's stream.
#include <cuda_runtime.h>

#include <cstdint>
#include <cub/block/block_scan.cuh>

namespace {

// base cells per tile along x, y, z (z fastest in the output); the tile
// with its halo is 17 x 17 x 33 floats (CIC, 38 KB) or 18 x 18 x 34 (TSC,
// 44 KB) of shared memory. ops/paint_cuda.py:_TILE holds the same numbers.
constexpr int kTX = 16;
constexpr int kTY = 16;
constexpr int kTZ = 32;
constexpr int kThreads = 256;      // bin and scatter blocks
constexpr int kScanThreads = 1024;

// One axis of _windowed_keys: the unwrapped base index (CIC in [-1, n-1],
// TSC in [0, n-1]) and the fraction (CIC f in [0, 1], TSC d in
// [-0.5, 0.5]). The _rn intrinsics keep the compiler from contracting or
// reordering any step.
template <int kOrder>
__device__ __forceinline__ int axis_cell(float x, float box, float h, int n,
                                         float& frac) {
  float c = fmodf(x, box);
  if (c != 0.0f && c < 0.0f) c = __fadd_rn(c, box);  // torch.remainder
  if constexpr (kOrder == 2) {
    const float u = __fsub_rn(__fdiv_rn(c, h), 0.5f);
    const float i0 = floorf(u);
    frac = __fsub_rn(u, i0);
    return static_cast<int>(i0);
  } else {
    const float u = __fdiv_rn(c, h);
    int ic = static_cast<int>(floorf(u));
    ic = ic < 0 ? 0 : (ic > n - 1 ? n - 1 : ic);
    frac = __fsub_rn(__fsub_rn(u, static_cast<float>(ic)), 0.5f);
    return ic;
  }
}

// the base cell wrapped into [0, n), or -1 outside the arithmetic's range
// (non-finite input)
__device__ __forceinline__ int wrap_base(int i, int n) {
  if (i == -1) return n - 1;
  return (i >= 0 && i < n) ? i : -1;
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

// d(axis_weight)/df
template <int kOrder>
__device__ __forceinline__ float axis_dweight(float f, int a) {
  if constexpr (kOrder == 2) {
    return a ? 1.0f : -1.0f;
  } else {
    if (a == 0) return -2.0f * f;
    return static_cast<float>(a) * (0.5f + static_cast<float>(a) * f);
  }
}

struct Geometry {
  const float* pos;  // (3, n_part): x, y, z
  int64_t n_part;
  int n;             // cells per side
  float box;
  float h;           // box / n, rounded to float
  int nty, ntz;      // tiles along y and z
};

// the particle's base cells (wrapped) and fractions; false if it has none
template <int kOrder>
__device__ __forceinline__ bool particle_cell(const Geometry& g, int64_t p,
                                              int (&b)[3], float (&f)[3],
                                              int (&raw)[3]) {
  bool ok = true;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    raw[ax] = axis_cell<kOrder>(__ldg(g.pos + ax * g.n_part + p), g.box, g.h,
                                g.n, f[ax]);
    b[ax] = wrap_base(raw[ax], g.n);
    ok = ok && b[ax] >= 0;
  }
  return ok;
}

__device__ __forceinline__ int tile_of_cell(const Geometry& g,
                                            const int (&b)[3]) {
  return ((b[0] / kTX) * g.nty + b[1] / kTY) * g.ntz + b[2] / kTZ;
}

// 1. tile of each particle (-1 if it has none) and particles per tile;
// with keys_out, also the plain version's padded keys and fractions (a
// check of the arithmetic)
template <int kOrder>
__global__ void __launch_bounds__(kThreads)
    paint_windowed_bin(Geometry g, int32_t* __restrict__ tile_of,
                       int32_t* __restrict__ counts,
                       int32_t* __restrict__ keys_out,
                       float* __restrict__ frac_out) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int tile = -1;
  if (p < g.n_part) {
    int b[3], raw[3];
    float f[3];
    if (particle_cell<kOrder>(g, p, b, f, raw)) tile = tile_of_cell(g, b);
    tile_of[p] = tile;
    if (keys_out != nullptr) {
      const int npd = g.n + 2;
      keys_out[p] = ((raw[0] + 1) * npd + (raw[1] + 1)) * npd + (raw[2] + 1);
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) frac_out[ax * g.n_part + p] = f[ax];
    }
  }
  const unsigned active = __ballot_sync(0xffffffffu, tile >= 0);
  if (tile >= 0) {
    const unsigned peers = __match_any_sync(active, tile);
    if ((threadIdx.x & 31) == __ffs(peers) - 1) {
      atomicAdd(counts + tile, __popc(peers));
    }
  }
}

// 2. offsets[0, n_tiles) hold counts; they become exclusive starts,
// offsets[n_tiles] the total, and cursor a copy of the starts
__global__ void __launch_bounds__(kScanThreads)
    paint_windowed_scan(int32_t* __restrict__ offsets,
                        int32_t* __restrict__ cursor, int n_tiles) {
  using Scan = cub::BlockScan<int32_t, kScanThreads>;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ int32_t carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int b = 0; b < n_tiles; b += kScanThreads) {
    const int i = b + threadIdx.x;
    const int32_t c = i < n_tiles ? offsets[i] : 0;
    int32_t excl, total;
    Scan(tmp).ExclusiveSum(c, excl, total);
    if (i < n_tiles) {
      offsets[i] = carry + excl;
      cursor[i] = carry + excl;
    }
    __syncthreads();  // every thread has read carry and left the scan
    if (threadIdx.x == 0) carry += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) offsets[n_tiles] = carry;
}

// 3. the ids of each tile's particles into its range (in no set order)
__global__ void __launch_bounds__(kThreads)
    paint_windowed_scatter(const int32_t* __restrict__ tile_of, int64_t n_part,
                           int32_t* __restrict__ cursor,
                           int32_t* __restrict__ ids) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int tile = p < n_part ? tile_of[p] : -1;
  const unsigned active = __ballot_sync(0xffffffffu, tile >= 0);
  if (tile < 0) return;
  const unsigned peers = __match_any_sync(active, tile);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  int32_t start = 0;
  if (lane == leader) start = atomicAdd(cursor + tile, __popc(peers));
  start = __shfl_sync(peers, start, leader);
  ids[start + __popc(peers & ((1u << lane) - 1u))] = static_cast<int32_t>(p);
}

// threads per deposit block: four CIC blocks of 512 fill an SM within
// shared memory; TSC's 27 weights a thread take the registers that allow
// only 256
template <int kOrder>
constexpr int kDepositThreads = (kOrder == 2) ? 512 : 256;

// 4. one block per tile: deposit into shared memory, flush with atomics
template <int kOrder, bool kWeighted>
__global__ void __launch_bounds__(kDepositThreads<kOrder>)
    paint_windowed_deposit(Geometry g, const float* __restrict__ weights,
                           const int32_t* __restrict__ offsets,
                           const int32_t* __restrict__ ids,
                           float* __restrict__ out) {
  constexpr int kBlock = kDepositThreads<kOrder>;
  constexpr int kLo = (kOrder == 2) ? 0 : -1;  // lowest cell offset
  constexpr int kSX = kTX + kOrder - 1;
  constexpr int kSY = kTY + kOrder - 1;
  constexpr int kSZ = kTZ + kOrder - 1;
  constexpr int kCells = kSX * kSY * kSZ;
  constexpr int kW = kOrder * kOrder * kOrder;  // cells a particle reaches
  __shared__ float acc[kCells];

  const int tile = blockIdx.x;
  const int start = offsets[tile];
  const int stop = offsets[tile + 1];
  if (start == stop) return;  // an empty tile adds nothing
  const int tz = tile % g.ntz;
  const int ty = (tile / g.ntz) % g.nty;
  const int tx = tile / (g.ntz * g.nty);
  const int o[3] = {tx * kTX, ty * kTY, tz * kTZ};  // first base cell
  for (int i = threadIdx.x; i < kCells; i += kBlock) acc[i] = 0.0f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  // every lane of a warp makes the same trips, so the warp collectives
  // below see all 32 lanes
  for (int j0 = start; j0 < stop; j0 += kBlock) {
    const int j = j0 + threadIdx.x;
    int cell = -1;  // the base cell's index in acc, -1 for no particle
    float w[kW] = {};
    int b[3], raw[3];
    float f[3];
    // the bin pass put the particle here with the same arithmetic, so its
    // base cell lies in this tile; the checks only keep shared memory safe
    if (j < stop && particle_cell<kOrder>(g, ids[j], b, f, raw)) {
      const int lx = b[0] - o[0];
      const int ly = b[1] - o[1];
      const int lz = b[2] - o[2];
      if (lx >= 0 && lx < kTX && ly >= 0 && ly < kTY && lz >= 0 &&
          lz < kTZ) {
        cell = (lx * kSY + ly) * kSZ + lz;
        float wx[kOrder], wy[kOrder], wz[kOrder];
#pragma unroll
        for (int a = 0; a < kOrder; ++a) {
          wx[a] = axis_weight<kOrder>(f[0], kLo + a);
          wy[a] = axis_weight<kOrder>(f[1], kLo + a);
          wz[a] = axis_weight<kOrder>(f[2], kLo + a);
        }
        const float wp = kWeighted ? __ldg(weights + ids[j]) : 1.0f;
#pragma unroll
        for (int a = 0; a < kOrder; ++a) {
#pragma unroll
          for (int c = 0; c < kOrder; ++c) {
#pragma unroll
            for (int d = 0; d < kOrder; ++d) {
              float v = wx[a] * wy[c] * wz[d];
              if constexpr (kWeighted) v *= wp;
              w[(a * kOrder + c) * kOrder + d] = v;
            }
          }
        }
      }
    }
    // Float atomicAdd on shared memory is a compare-and-swap loop on this
    // card, and in dense haloes many lanes of a warp hold particles of one
    // base cell, i.e. add into the same kW cells. Such a group sums its
    // weights first, by pointer jumping along its lanes (after k steps a
    // lane holds the sum over itself and the next 2^k - 1 members), and
    // only its lowest lane adds.
    const unsigned peers = __match_any_sync(0xffffffffu, cell);
    const int largest = __reduce_max_sync(0xffffffffu, __popc(peers));
    const unsigned above = peers & ~((2u << lane) - 1u);
    bool linked = above != 0;
    int next = linked ? __ffs(above) - 1 : lane;
    for (int span = 1; span < largest; span <<= 1) {
#pragma unroll
      for (int q = 0; q < kW; ++q) {
        const float v = __shfl_sync(0xffffffffu, w[q], next);
        if (linked) w[q] += v;
      }
      const int next_next = __shfl_sync(0xffffffffu, next, next);
      const int next_linked = __shfl_sync(0xffffffffu, linked ? 1 : 0, next);
      if (linked) {
        linked = next_linked != 0;
        next = next_next;
      }
    }
    if (cell < 0 || (peers & ((1u << lane) - 1u)) != 0) continue;
#pragma unroll
    for (int a = 0; a < kOrder; ++a) {
#pragma unroll
      for (int c = 0; c < kOrder; ++c) {
        float* row = acc + cell + (a * kSY + c) * kSZ;
#pragma unroll
        for (int d = 0; d < kOrder; ++d) {
          atomicAdd(row + d, w[(a * kOrder + c) * kOrder + d]);
        }
      }
    }
  }
  __syncthreads();

  // cells the tile's base cells can reach: the last tile along an axis
  // may hold fewer than kT base cells
  const int64_t n = g.n;
  const int ex = min(kTX, g.n - o[0]) + kOrder - 1;
  const int ey = min(kTY, g.n - o[1]) + kOrder - 1;
  const int ez = min(kTZ, g.n - o[2]) + kOrder - 1;
  for (int i = threadIdx.x; i < kCells; i += kBlock) {
    const float v = acc[i];
    if (v == 0.0f) continue;
    const int sz = i % kSZ;
    const int sy = (i / kSZ) % kSY;
    const int sx = i / (kSZ * kSY);
    if (sx >= ex || sy >= ey || sz >= ez) continue;
    // global cells lie in [-1, n + 1): one periodic wrap each
    int gx = o[0] + kLo + sx;
    int gy = o[1] + kLo + sy;
    int gz = o[2] + kLo + sz;
    gx = gx < 0 ? gx + g.n : (gx >= g.n ? gx - g.n : gx);
    gy = gy < 0 ? gy + g.n : (gy >= g.n ? gy - g.n : gy);
    gz = gz < 0 ? gz + g.n : (gz >= g.n ? gz - g.n : gz);
    atomicAdd(out + (gx * n + gy) * n + gz, v);
  }
}

// 5. the adjoint: one thread per particle gathers the incoming gradient
// grid g around its base cell (see the header)
template <int kOrder>
__global__ void __launch_bounds__(kThreads)
    paint_windowed_adjoint(Geometry g, const float* __restrict__ weights,
                           const float* __restrict__ grad_out,
                           float* __restrict__ grad_pos,
                           float* __restrict__ grad_w) {
  constexpr int kLo = (kOrder == 2) ? 0 : -1;  // lowest cell offset
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= g.n_part) return;
  float sw = 0.0f;
  float s[3] = {0.0f, 0.0f, 0.0f};
  int b[3], raw[3];
  float f[3];
  // a particle without a base cell (non-finite input) deposited nothing
  if (particle_cell<kOrder>(g, p, b, f, raw)) {
    const int64_t n = g.n;
    float w[3][kOrder], dw[3][kOrder];
    int64_t cell[3][kOrder];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
#pragma unroll
      for (int a = 0; a < kOrder; ++a) {
        w[ax][a] = axis_weight<kOrder>(f[ax], kLo + a);
        dw[ax][a] = axis_dweight<kOrder>(f[ax], kLo + a);
        // b + kLo + a lies in [-1, n + 1): one periodic wrap
        int c = b[ax] + kLo + a;
        c = c < 0 ? c + g.n : (c >= g.n ? c - g.n : c);
        cell[ax][a] = c;
      }
    }
#pragma unroll
    for (int a = 0; a < kOrder; ++a) {
#pragma unroll
      for (int c = 0; c < kOrder; ++c) {
        const float* row = grad_out + (cell[0][a] * n + cell[1][c]) * n;
#pragma unroll
        for (int d = 0; d < kOrder; ++d) {
          const float v = __ldg(row + cell[2][d]);
          const float wyz = w[1][c] * w[2][d];
          sw += w[0][a] * wyz * v;
          s[0] += dw[0][a] * wyz * v;
          s[1] += w[0][a] * dw[1][c] * w[2][d] * v;
          s[2] += w[0][a] * w[1][c] * dw[2][d] * v;
        }
      }
    }
  }
  if (grad_w != nullptr) grad_w[p] = sw;
  if (grad_pos != nullptr) {
    const float wp = weights != nullptr ? __ldg(weights + p) : 1.0f;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      grad_pos[ax * g.n_part + p] = __fdiv_rn(wp * s[ax], g.h);
    }
  }
}

int64_t tiles_along(int64_t n, int t) { return (n + t - 1) / t; }

unsigned int particle_blocks(int64_t n_part) {
  const int64_t blocks = (n_part + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks > 0 ? blocks : 1);
}

int check_shape(int64_t n_part, int64_t ngrid, int order) {
  if (order != 2 && order != 3) return cudaErrorInvalidValue;
  if (n_part < 0 || n_part > 0x7fffffffLL || ngrid < 1) {
    return cudaErrorInvalidValue;
  }
  if ((ngrid + 2) * (ngrid + 2) * (ngrid + 2) > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

int check_args(int64_t n_part, int64_t ngrid, int order, int64_t n_tiles) {
  const int bad = check_shape(n_part, ngrid, order);
  if (bad != cudaSuccess) return bad;
  if (n_tiles != tiles_along(ngrid, kTX) * tiles_along(ngrid, kTY) *
                     tiles_along(ngrid, kTZ)) {
    return cudaErrorInvalidValue;  // the caller's tile shape differs
  }
  return cudaSuccess;
}

Geometry make_geometry(const float* pos, int64_t n_part, int64_t ngrid,
                       float box, float h) {
  return Geometry{pos,
                  n_part,
                  static_cast<int>(ngrid),
                  box,
                  h,
                  static_cast<int>(tiles_along(ngrid, kTY)),
                  static_cast<int>(tiles_along(ngrid, kTZ))};
}

template <int kOrder>
void launch_bin(const Geometry& g, int32_t* tile_of, int32_t* counts,
                int32_t* keys_out, float* frac_out, cudaStream_t s) {
  paint_windowed_bin<kOrder><<<particle_blocks(g.n_part), kThreads, 0, s>>>(
      g, tile_of, counts, keys_out, frac_out);
}

template <int kOrder>
void launch_deposit(const Geometry& g, const float* weights,
                    const int32_t* offsets, const int32_t* ids, float* out,
                    unsigned int n_tiles, cudaStream_t s) {
  if (weights != nullptr) {
    paint_windowed_deposit<kOrder, true>
        <<<n_tiles, kDepositThreads<kOrder>, 0, s>>>(g, weights, offsets, ids,
                                                     out);
  } else {
    paint_windowed_deposit<kOrder, false>
        <<<n_tiles, kDepositThreads<kOrder>, 0, s>>>(g, nullptr, offsets, ids,
                                                     out);
  }
}

}  // namespace

// Paints n_part particles onto out, an (ngrid, ngrid, ngrid) float32 grid the
// caller has zeroed. pos: (3, n_part) float32, x, y and z concatenated;
// weights: (n_part,) float32 or null for unit weights; order 2 (CIC) or 3
// (TSC); box and h = box / ngrid as float32. Scratch from the caller:
// tile_of and ids, (n_part,) int32 each, and offsets, (2 n_tiles + 1,)
// int32 zeroed, with n_tiles the number of 16 x 16 x 32 tiles that cover
// the grid. All pointers are device pointers; `stream` is a cudaStream_t.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int astrild_paint_windowed(const float* pos, const float* weights,
                                      int64_t n_part, int64_t ngrid, float box,
                                      float h, int order, int32_t* tile_of,
                                      int32_t* ids, int32_t* offsets,
                                      int64_t n_tiles, float* out,
                                      void* stream) {
  const int bad = check_args(n_part, ngrid, order, n_tiles);
  if (bad != cudaSuccess) return bad;
  const auto s = static_cast<cudaStream_t>(stream);
  const Geometry g = make_geometry(pos, n_part, ngrid, box, h);
  int32_t* cursor = offsets + n_tiles + 1;
  if (order == 2) {
    launch_bin<2>(g, tile_of, offsets, nullptr, nullptr, s);
  } else {
    launch_bin<3>(g, tile_of, offsets, nullptr, nullptr, s);
  }
  paint_windowed_scan<<<1, kScanThreads, 0, s>>>(offsets, cursor,
                                                 static_cast<int>(n_tiles));
  paint_windowed_scatter<<<particle_blocks(n_part), kThreads, 0, s>>>(
      tile_of, n_part, cursor, ids);
  const auto nt = static_cast<unsigned int>(n_tiles);
  if (order == 2) {
    launch_deposit<2>(g, weights, offsets, ids, out, nt, s);
  } else {
    launch_deposit<3>(g, weights, offsets, ids, out, nt, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The bin pass alone, for checking it: tile_of (n_part,) int32, counts
// (n_tiles,) int32 zeroed, and the plain version's padded keys (n_part,)
// int32 and fractions (3, n_part) float32.
extern "C" int astrild_paint_windowed_bins(const float* pos, int64_t n_part,
                                           int64_t ngrid, float box, float h,
                                           int order, int32_t* tile_of,
                                           int32_t* counts, int64_t n_tiles,
                                           int32_t* keys_out, float* frac_out,
                                           void* stream) {
  const int bad = check_args(n_part, ngrid, order, n_tiles);
  if (bad != cudaSuccess) return bad;
  const auto s = static_cast<cudaStream_t>(stream);
  const Geometry g = make_geometry(pos, n_part, ngrid, box, h);
  if (order == 2) {
    launch_bin<2>(g, tile_of, counts, keys_out, frac_out, s);
  } else {
    launch_bin<3>(g, tile_of, counts, keys_out, frac_out, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The deposit's adjoint: given grad_out, the gradient of a loss with
// respect to astrild_paint_windowed's (ngrid, ngrid, ngrid) output, writes
// the loss's gradient with respect to the positions, grad_pos (3, n_part)
// float32, and to the weights, grad_w (n_part,) float32; either may be
// null to skip it. pos, weights, n_part, ngrid, box, h and order are the
// deposit's own (weights null for unit weights). Returns the cudaError_t
// of the launch (0 on success).
extern "C" int astrild_paint_windowed_adjoint(
    const float* pos, const float* weights, int64_t n_part, int64_t ngrid,
    float box, float h, int order, const float* grad_out, float* grad_pos,
    float* grad_w, void* stream) {
  const int bad = check_shape(n_part, ngrid, order);
  if (bad != cudaSuccess) return bad;
  if (n_part == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const Geometry g = make_geometry(pos, n_part, ngrid, box, h);
  if (order == 2) {
    paint_windowed_adjoint<2><<<particle_blocks(n_part), kThreads, 0, s>>>(
        g, weights, grad_out, grad_pos, grad_w);
  } else {
    paint_windowed_adjoint<3><<<particle_blocks(n_part), kThreads, 0, s>>>(
        g, weights, grad_out, grad_pos, grad_w);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* astrild_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
