// The tile body shared by warp_tiles.cu and warp_views_sum.cu: the
// multi-view bilinear warp-and-sum
//
//     out[b, n, k] = sum_v sum_t w[b, v, n, t] * feats[b, v, idx[b, v, n, t], k]
//
// computed as a dense product on the tensor cores over the source rows
// that a tile of BEV cells shares.
//
// Why. A cell's 4 taps a view read 4 source rows, and neighbouring cells
// read nearly the same rows: on the flagship LUT (7 ring cameras, BEV
// 120x360, a 34x60 map) an 8x8 tile of cells touches 52.6 distinct rows
// over all views on average (91 at most) for 1,485 live taps. A walk that
// gathers row by row pays a 16-byte load, eight widenings and eight fmaf
// per tap per 8 channels however often the row was read before: the
// ablation of the old walk (PERF.md, row 8) took 0.462 ms with every tap on
// one cached row ('row0') against 0.482 ms in full, and 0.143 ms with no
// map read at all ('no_gather'). So the cost was the per-element work, not
// the bytes.
//
// Design. A block owns a tile of 64 cells (8x8 of the grid when the caller
// gives its width, else 64 consecutive cells) of one frame (blockIdx.z)
// and up to kMaxChunksPerBlock chunks of 64 channels (blockIdx.y):
//   1. it loads the tile's V*64*4 taps and drops the dead ones (weight 0,
//      or an index outside [0, P)); it marks each live tap's row (v*P + p)
//      in a bitmap over the frame's V*P rows and numbers the marked rows by
//      a prefix popcount: the tile's distinct rows in row order, a tap's
//      slot (no sort, no host sync, the same slots every launch). A tap on
//      the row of an earlier tap of its cell and view (which the LUT, whose
//      in-bounds corners are distinct, never makes) is numbered in a second
//      pass of the bitmap (a third, a fourth), after all the first pass's
//      rows, so that every tap has a weight-tile entry of its own;
//   2. it builds the weight tile A[64 cells][slots] in shared memory, each
//      live tap's weight at (its cell, its slot), a place no other tap has,
//      split into NA bf16 planes (below); A is built once when the tile's T
//      slots fit one piece of kASlots, and piece by piece (again for every
//      chunk) when not;
//   3. for each chunk it stages the slots' rows into shared memory, a
//      piece at a time for bf16 maps and 16 rows at a time for f32 maps
//      (double-buffered through registers: the next stage's loads are in
//      flight during this stage's products), as NB bf16 planes, and
//      multiplies: mma.sync m16n8k16 bf16 -> f32, fragments by ldmatrix,
//      8 warps each a 16-cell x 32-channel tile of the 64 x 64 output, the
//      f32 sum in registers across stages, stored once a chunk.
// The per-element work is then one tensor-core product per 16x8x16 block.
// What is left is the tile's fixed work (taps, slots, weight tile) and
// its latency, hidden by several blocks an SM: the warp tiles are small
// (16 accumulators a thread), shared memory is 65-75 KB a block, and a
// stage of bf16 rows is a whole piece of slots, so one sync covers its
// products.
//
// Arithmetic. Every product of two bf16 values is exact in f32; the sums
// are f32, in another order than a walk. A holds the tap weight as the
// caller's contract wants it:
//   * bf16 maps with bf16-rounded weights (warp_tiles): one plane, the
//     rounded weight;
//   * float32 weights (warp_views_sum; warp_tiles on f32 maps): three planes,
//     w = hi + mid + lo, each the bf16 rounding of what is left, which is
//     exact for the 24 bits of an f32;
//   * f32 maps: the staged rows split the same way, x = hi + mid + lo; the
//     products of plane pairs (i, j) with i + j <= 2 are summed (the rest
//     are below 2^-24 of the product).
// So each weight multiplies as it is, as in the walk. Products with a zero
// weight add exactly 0, so a cell that no view sees stays 0 whatever the
// (finite) maps hold. No float atomics: two launches give the same bits.
//
// Shared memory: A (NA * 64 * (kASlots + 8) bf16), two stages (2 * NB *
// kStageRows * 72 bf16), the taps (8 bytes each), the bitmap and its
// prefix (V*P/8 bytes each) and the slots' rows; above 48 KB by
// cudaFuncSetAttribute. The launch returns -1 where that exceeds the
// card's 227 KB.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace warp_mma {

constexpr int kThreads = 256;     // 8 warps: 4 along the cells, 2 along the channels
constexpr int kCells = 64;        // BEV cells a tile
constexpr int kChunk = 64;        // channels a pass
constexpr int kBStride = kChunk + 8;  // bf16 a staged row (+16 B: ldmatrix without bank conflicts)
constexpr int kMaxChunksPerBlock = 8;
constexpr int kMaxViews = 64;
constexpr size_t kMaxSmem = 232448;   // what a block may opt into on an H100

enum Variant { kFull = 0, kConstWeights = 1, kRow0 = 2, kNoGather = 3, kVariants = 4 };

// planes of the weight tile and of the staged rows, slots a piece of A,
// rows a stage
template <typename Tin, bool F32W>
struct Planes {
  static constexpr bool kRoundW = !F32W && sizeof(Tin) == 2;  // weights rounded to bf16
  static constexpr int NA = kRoundW ? 1 : 3;
  static constexpr int NB = sizeof(Tin) == 4 ? 3 : 1;
  static constexpr int kASlots = NA == 1 ? 96 : 64;  // the flagship's tiles take at most 91 rows
  static constexpr int kAStride = kASlots + 8;
  // bf16 maps: a stage is a whole piece, its products between two syncs;
  // f32 maps stage 16 rows at a time, so that three blocks fit an SM
  static constexpr int kStageRows = NB == 1 ? kASlots : 16;
  static_assert(kASlots % kStageRows == 0, "a stage lies in one piece of the weight tile");
};

struct Args {
  const void* feats;  // [B, V, P, K]
  const int* idx;     // [B, V, N, 4]
  const float* wts;   // [B, V, N, 4]
  void* out;          // [B, N, K]
  int V, P, N, K;
  int Hg, Wg, TH, TW;  // the grid (Hg * Wg == N) and the tile (TH * TW == kCells)
  int tiles_w;         // tiles across the grid
  int chunks_per_block;
  int vec;             // K % 8 == 0 and 16-byte aligned maps and output
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// byte offsets of the shared-memory sections (host and device agree)
struct Layout {
  size_t a, b, slot, w, bits, prefix, rows, scan, total;
  __host__ __device__ Layout(int NA, int NB, int a_stride, int stage_rows, int V, int P) {
    const size_t taps = static_cast<size_t>(V) * kCells * 4;
    const size_t words = (static_cast<size_t>(V) * P + 31) / 32;
    size_t o = 0;
    a = o;      o = align16(o + static_cast<size_t>(NA) * kCells * a_stride * 2);
    b = o;      o = align16(o + static_cast<size_t>(2) * NB * stage_rows * kBStride * 2);
    slot = o;   o = align16(o + taps * 4);
    w = o;      o = align16(o + taps * 4);
    bits = o;   o = align16(o + words * 4);
    prefix = o; o = align16(o + words * 4);
    rows = o;   o = align16(o + taps * 4);  // T <= the live taps
    scan = o;   o = align16(o + 16 * 4);
    total = o;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 sum
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = p[0] + p[1] + p[2] exactly for a finite f32 (each piece the bf16
// rounding of what the ones before leave); NP = 1 keeps the rounding alone
template <int NP>
__device__ __forceinline__ void split(float x, __nv_bfloat16 p[NP]) {
  float r = x;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    p[i] = __float2bfloat16_rn(r);
    r -= __bfloat162float(p[i]);
  }
}

// the exclusive prefix of x over the block, and the block's total
__device__ __forceinline__ int block_scan(int x, int* s_scan, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_scan[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kThreads / 32 ? s_scan[lane] : 0;
#pragma unroll
    for (int d = 1; d < kThreads / 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < kThreads / 32) s_scan[8 + lane] = s;
  }
  __syncthreads();
  const int excl = incl - x + (warp > 0 ? s_scan[8 + warp - 1] : 0);
  total = s_scan[8 + kThreads / 32 - 1];
  __syncthreads();  // s_scan is free again
  return excl;
}

__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
// 8 copies of v, one 16-byte store (two for f32)
__device__ __forceinline__ void store8_same(__nv_bfloat16* p, float v) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v, v);
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
  *reinterpret_cast<uint4*>(p) = make_uint4(u, u, u, u);
}
__device__ __forceinline__ void store8_same(float* p, float v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v, v, v, v);
  reinterpret_cast<float4*>(p)[1] = make_float4(v, v, v, v);
}

#ifndef WARP_MMA_MIN_BLOCKS
#define WARP_MMA_MIN_BLOCKS 3  // blocks an SM the registers leave room for
#endif

template <typename Tin, typename Tout, int VARIANT, bool F32W>
__global__ void __launch_bounds__(kThreads, WARP_MMA_MIN_BLOCKS) tile_kernel(const Args a) {
  using PL = Planes<Tin, F32W>;
  constexpr int NA = PL::NA, NB = PL::NB, kASlots = PL::kASlots, kAStride = PL::kAStride;
  constexpr int kStageRows = PL::kStageRows;
  constexpr int E = 16 / static_cast<int>(sizeof(Tin));  // elements a 16-byte load
  constexpr int LPR = kChunk / E;                         // loads a staged row
  constexpr int LPT = kStageRows * LPR / kThreads;        // loads a thread a stage
  static_assert(LPT >= 1 && kStageRows * LPR == LPT * kThreads, "a stage is whole loads a thread");
  using Raw = typename std::conditional<sizeof(Tin) == 2, unsigned short, unsigned int>::type;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(NA, NB, kAStride, kStageRows, a.V, a.P);
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem + L.a);
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem + L.b);
  int* s_slot = reinterpret_cast<int*>(smem + L.slot);
  float* s_w = reinterpret_cast<float*>(smem + L.w);
  unsigned* s_bits = reinterpret_cast<unsigned*>(smem + L.bits);
  int* s_prefix = reinterpret_cast<int*>(smem + L.prefix);
  int* s_rows = reinterpret_cast<int*>(smem + L.rows);
  int* s_scan = reinterpret_cast<int*>(smem + L.scan);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int V = a.V, P = a.P, N = a.N, K = a.K;
  const long long frame = blockIdx.z;
  const Tin* feats = static_cast<const Tin*>(a.feats) + frame * V * P * K;
  const int* idx = a.idx + frame * V * N * 4;
  const float* wts = a.wts + frame * V * N * 4;
  Tout* out = static_cast<Tout*>(a.out) + frame * N * K;
  const int ty = blockIdx.x / a.tiles_w, tx = blockIdx.x - ty * a.tiles_w;
  const int chunk0 = blockIdx.y * a.chunks_per_block;
  const int nchunks = min(a.chunks_per_block, (K + kChunk - 1) / kChunk - chunk0);

  // the grid cell of tile slot c, or -1 past the grid's edge
  auto cell_n = [&](int c) {
    const int i = c / a.TW, j = c - i * a.TW;
    const int r = ty * a.TH + i, col = tx * a.TW + j;
    return (r < a.Hg && col < a.Wg) ? r * a.Wg + col : -1;
  };

  // 1. the tile's taps, (view, cell, tap) in order: a live tap's key
  //    level * V*P + v*P + p, its level the earlier live taps of its cell
  //    and view on the same row (0 for every tap of the LUT); -1 dead
  const int VP = V * P, pairs = V * kCells, taps = pairs * 4;
  const int words = (VP + 31) >> 5;
  bool repeat = false;
  for (int pr = tid; pr < pairs; pr += kThreads) {
    const int v = pr / kCells, n = cell_n(pr - v * kCells);
    int4 id = make_int4(0, 0, 0, 0);
    float4 w4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n >= 0) {
      const long long off = (static_cast<long long>(v) * N + n) * 4;
      id = *reinterpret_cast<const int4*>(idx + off);
      w4 = *reinterpret_cast<const float4*>(wts + off);
    }
    const int ids[4] = {id.x, id.y, id.z, id.w};
    const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
    int row[4];
    bool live[4];
    int4 sl;
    float4 wl;
    int* slp = &sl.x;
    float* wlp = &wl.x;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float w = VARIANT == kConstWeights ? 0.25f : ws[t];
      if constexpr (PL::kRoundW) w = __bfloat162float(__float2bfloat16_rn(w));
      // an index outside [0, P) is never made by the LUT: skip it rather
      // than read out of bounds
      live[t] = n >= 0 && ids[t] >= 0 && ids[t] < P && w != 0.f;
      row[t] = v * P + (VARIANT == kRow0 ? 0 : ids[t]);
      int level = 0;
#pragma unroll
      for (int u = 0; u < t; ++u) level += live[u] && row[u] == row[t];
      repeat = repeat || (live[t] && level > 0);
      slp[t] = live[t] ? level * VP + row[t] : -1;
      wlp[t] = live[t] ? w : 0.f;
    }
    reinterpret_cast<int4*>(s_slot)[pr] = sl;
    reinterpret_cast<float4*>(s_w)[pr] = wl;
  }
  const int levels = __syncthreads_or(repeat) ? 4 : 1;

  if constexpr (VARIANT == kNoGather) {
    // no staging and no product: each channel gets the sum of the cell's
    // weights, views then taps, as the walk added them
    float* s_sum = reinterpret_cast<float*>(smem + L.a);
    if (tid < kCells) {
      float sum = 0.f;
      for (int j = 0; j < V * 4; ++j) sum += s_w[((j >> 2) * kCells + tid) * 4 + (j & 3)];
      s_sum[tid] = sum;
    }
    __syncthreads();
    const int k_begin = chunk0 * kChunk, width = min(K, k_begin + nchunks * kChunk) - k_begin;
    const int group = a.vec ? 8 : 1, groups = width / group;  // width % 8 == 0 when vec
    for (int e = tid; e < kCells * groups; e += kThreads) {
      const int c = e / groups, n = cell_n(c);
      if (n < 0) continue;
      Tout* dst = out + static_cast<long long>(n) * K + k_begin + (e - c * groups) * group;
      if (a.vec)
        store8_same(dst, s_sum[c]);
      else
        store_out(dst, s_sum[c]);
    }
    return;
  }

  // 2. the slots, level by level: the level's rows marked in a bitmap over
  //    the frame's V*P rows and numbered by a prefix popcount, so in
  //    (level, row) order. Levels past 0 run only where a tap repeats a
  //    row; a tap of level l > 0 has one of level l - 1 in its cell and
  //    view, so the first level without taps ends the loop. A tap's key
  //    becomes -2 - slot while the levels run
  int T = 0;
  for (int level = 0; level < levels; ++level) {
    const int lo = level * VP;
    for (int i = tid; i < words; i += kThreads) s_bits[i] = 0u;
    __syncthreads();
    int marked = 0;
    for (int i = tid; i < taps; i += kThreads) {
      const int r = s_slot[i] - lo;
      if (r >= 0 && r < VP) {
        atomicOr(&s_bits[r >> 5], 1u << (r & 31));
        marked = 1;
      }
    }
    if (!__syncthreads_or(marked)) break;
    const int per = (words + kThreads - 1) / kThreads, w0 = tid * per;
    int local = 0;
    for (int i = 0; i < per; ++i)
      if (w0 + i < words) local += __popc(s_bits[w0 + i]);
    int count;
    int run = T + block_scan(local, s_scan, count);
    for (int i = 0; i < per; ++i) {
      const int w = w0 + i;
      if (w < words) {
        s_prefix[w] = run;
        run += __popc(s_bits[w]);
      }
    }
    __syncthreads();
    for (int i = tid; i < taps; i += kThreads) {
      const int r = s_slot[i] - lo;
      if (r >= 0 && r < VP) s_slot[i] = -2 - (s_prefix[r >> 5] + __popc(s_bits[r >> 5] & ((1u << (r & 31)) - 1u)));
    }
    for (int w = tid; w < words; w += kThreads) {
      unsigned bits = s_bits[w];
      int s = s_prefix[w];
      while (bits) {
        s_rows[s++] = (w << 5) + __ffs(bits) - 1;
        bits &= bits - 1;
      }
    }
    T += count;
    __syncthreads();
  }
  for (int i = tid; i < taps; i += kThreads)
    if (s_slot[i] < -1) s_slot[i] = -2 - s_slot[i];

  // 3. the products. A tile no view sees still runs one stage of zeros
  const int Tpad = T > 0 ? (T + 15) & ~15 : 16;
  const int nst = (Tpad + kStageRows - 1) / kStageRows;  // stages a chunk
  const int total = nchunks * nst;
  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 32;  // this warp's 16 x 32 of the 64 x 64 output
  const int n_of[2] = {cell_n(wm + (lane >> 2)), cell_n(wm + 8 + (lane >> 2))};

  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  uint4 pre[LPT];  // the next stage's rows, in flight
  auto load_stage = [&](int it) {
    const int k0 = (chunk0 + it / nst) * kChunk, s0 = (it % nst) * kStageRows;
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const int e = tid + l * kThreads, r = e / LPR, ch = k0 + (e - r * LPR) * E;
      const int slot = s0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (slot < T && ch < K) {
        const Tin* src = feats + static_cast<long long>(s_rows[slot]) * K + ch;
        if (a.vec) {
          v = __ldg(reinterpret_cast<const uint4*>(src));
        } else {  // ragged K: element by element, zeros past K
          const Raw* s = reinterpret_cast<const Raw*>(src);
          uint32_t q[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (E == 8) {
              const uint32_t lo = ch + 2 * i < K ? s[2 * i] : 0u, hi = ch + 2 * i + 1 < K ? s[2 * i + 1] : 0u;
              q[i] = lo | (hi << 16);
            } else {
              q[i] = ch + i < K ? s[i] : 0u;
            }
          }
          v = make_uint4(q[0], q[1], q[2], q[3]);
        }
      }
      pre[l] = v;
    }
  };

  int built = -1;
  load_stage(0);
  for (int it = 0; it < total; ++it) {
    const int st = it % nst, s0 = st * kStageRows;
    const int piece = s0 / kASlots, pbase = piece * kASlots;
    if (piece != built) {
      // the weight tile of slots [pbase, pbase + width): zero, then each
      // live tap writes its weight at (its cell, its slot)
      __syncthreads();
      const int width = min(kASlots, Tpad - pbase);
      const int vecs = width / 8;
      for (int e = tid; e < NA * kCells * vecs; e += kThreads) {
        const int r = e / vecs;
        *reinterpret_cast<uint4*>(sA + r * kAStride + (e - r * vecs) * 8) = make_uint4(0u, 0u, 0u, 0u);
      }
      __syncthreads();
      for (int pr = tid; pr < pairs; pr += kThreads) {
        const int c = pr % kCells;
        const int4 sl = reinterpret_cast<const int4*>(s_slot)[pr];
        const float4 wl = reinterpret_cast<const float4*>(s_w)[pr];
        const int s[4] = {sl.x, sl.y, sl.z, sl.w};
        const float w[4] = {wl.x, wl.y, wl.z, wl.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int col = s[t] - pbase;
          if (s[t] < 0 || col < 0 || col >= width) continue;
          __nv_bfloat16 p[NA];
          split<NA>(w[t], p);
#pragma unroll
          for (int i = 0; i < NA; ++i) sA[(i * kCells + c) * kAStride + col] = p[i];
        }
      }
      __syncthreads();
      built = piece;
    }

    // this stage's rows into buffer it & 1, as NB bf16 planes
    const int buf = it & 1;
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const int e = tid + l * kThreads, r = e / LPR, c0 = (e - r * LPR) * E;
      __nv_bfloat16* dst = sB + ((buf * NB) * kStageRows + r) * kBStride + c0;
      if constexpr (NB == 1) {
        *reinterpret_cast<uint4*>(dst) = pre[l];
      } else {  // 4 floats -> 4 bf16 in each of 3 planes
        const float x[4] = {__uint_as_float(pre[l].x), __uint_as_float(pre[l].y), __uint_as_float(pre[l].z),
                            __uint_as_float(pre[l].w)};
        uint32_t packed[3][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          __nv_bfloat16 p[3], q[3];
          split<3>(x[2 * i], p);
          split<3>(x[2 * i + 1], q);
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const __nv_bfloat162 h = __halves2bfloat162(p[j], q[j]);
            packed[j][i] = *reinterpret_cast<const uint32_t*>(&h);
          }
        }
#pragma unroll
        for (int j = 0; j < NB; ++j)
          *reinterpret_cast<uint2*>(dst + j * kStageRows * kBStride) = make_uint2(packed[j][0], packed[j][1]);
      }
    }
    __syncthreads();
    if (it + 1 < total) load_stage(it + 1);

    // products: k-steps of 16 slots, plane pairs (i, j) with i + j <= 2
#pragma unroll
    for (int ks = 0; ks < kStageRows / 16; ++ks) {
      if (s0 + ks * 16 >= Tpad) break;
      const int acol = s0 - pbase + ks * 16;
      uint32_t af[NA][4];
#pragma unroll
      for (int i = 0; i < NA; ++i)
        ldmatrix_x4(af[i], sA + (i * kCells + wm + (lane & 15)) * kAStride + acol + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        uint32_t bf[4][2];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, sB + ((buf * NB + j) * kStageRows + ks * 16 + (lane & 15)) * kBStride +
                                   wn + np * 16 + (lane >> 4) * 8);
          bf[2 * np][0] = r[0];
          bf[2 * np][1] = r[1];
          bf[2 * np + 1][0] = r[2];
          bf[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          if (i + j > 2) continue;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[nt], af[i], bf[nt][0], bf[nt][1]);
        }
      }
    }

    if (st == nst - 1) {
      // the chunk's sums, stored once; the accumulators start again
      const int k0 = (chunk0 + it / nst) * kChunk;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = k0 + wn + nt * 8 + 2 * (lane & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n_of[h];
          if (n >= 0 && col < K) {
            Tout* dst = out + static_cast<long long>(n) * K + col;
            if (a.vec) {
              store_pair(dst, acc[nt][2 * h], acc[nt][2 * h + 1]);
            } else {
              store_out(dst, acc[nt][2 * h]);
              if (col + 1 < K) store_out(dst + 1, acc[nt][2 * h + 1]);
            }
          }
          acc[nt][2 * h] = 0.f;
          acc[nt][2 * h + 1] = 0.f;
        }
      }
    }
  }
}

// Launch over B frames. grid_w > 0 and dividing N: 8x8 tiles of the
// Hb x grid_w grid; else runs of 64 consecutive cells. Returns 0, a
// cudaError_t, or -1 for what the kernel does not take.
template <typename Tin, typename Tout, int VARIANT, bool F32W>
int launch(const void* feats, const int* idx, const float* wts, void* out, int B, int V, int P, int N, int K,
           int grid_w, cudaStream_t stream) {
  using PL = Planes<Tin, F32W>;
  if (B < 0 || B > 65535 || V < 1 || V > kMaxViews || P < 1 || N < 0 || K < 1) return -1;
  if (reinterpret_cast<uintptr_t>(idx) % 16 != 0 || reinterpret_cast<uintptr_t>(wts) % 16 != 0) return -1;
  if (4LL * V * P >= (1LL << 31)) return -1;  // the taps' keys
  if (B == 0 || N == 0) return 0;
  const Layout L(PL::NA, PL::NB, PL::kAStride, PL::kStageRows, V, P);
  if (L.total > kMaxSmem) return -1;
  Args a;
  a.feats = feats;
  a.idx = idx;
  a.wts = wts;
  a.out = out;
  a.V = V;
  a.P = P;
  a.N = N;
  a.K = K;
  if (grid_w > 0 && N % grid_w == 0) {
    a.Wg = grid_w, a.Hg = N / grid_w, a.TH = 8, a.TW = 8;
  } else {
    a.Wg = N, a.Hg = 1, a.TH = 1, a.TW = kCells;
  }
  a.tiles_w = (a.Wg + a.TW - 1) / a.TW;
  const int tiles = a.tiles_w * ((a.Hg + a.TH - 1) / a.TH);
  // a tile's fixed work (taps, slots, weight tile) is shared by its
  // block's chunks: more chunks a block ran faster at every shape measured,
  // even where the launch then holds fewer blocks than three an SM
  const int nchunk = (K + kChunk - 1) / kChunk;
  a.chunks_per_block = nchunk < kMaxChunksPerBlock ? nchunk : kMaxChunksPerBlock;
  a.vec = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(feats) % 16 == 0) &&
          (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  auto kernel = tile_kernel<Tin, Tout, VARIANT, F32W>;
  if (L.total > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.total));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>((nchunk + a.chunks_per_block - 1) / a.chunks_per_block),
                  static_cast<unsigned>(B));
  kernel<<<grid, kThreads, L.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace warp_mma
