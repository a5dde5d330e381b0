// Grouped bilinear sampling and its gradients:
//
//     sample:          out[g, n, k]   = sum_t w[g,n,t] * maps[g, idx[g,n,t], k]
//     scatter_tapdot:  dmaps[g, p, k] = sum_{n,t: idx[g,n,t] = p} w[g,n,t] * gout[g,n,k]
//                      d_wts[g, n, t] = sum_k maps[g, idx[g,n,t], k] * gout[g,n,k]
//     scatter_taps:    dmaps alone
//     taps_dot:        d_wts alone
//
// maps [G, P, K] (P padded source pixels, K channels: batch folded in),
// idx/w [G, N, 4] bilinear taps of N samples, gout [G, N, K]. maps and gout
// are float32 or bfloat16 (the compute dtype); sums are float32; dmaps and
// d_wts are float32, out is the compute dtype. sample also takes 9 taps a
// sample, idx/w [G, N, 9]: a bilinear upsample folded into the warp's
// taps (ops/warp.folded_taps), rows of the unpadded map.
//
// Replaces the TPU kernels sample_tiles_grouped, scatter_tapdot_grouped
// (vsta_tpu/ops/warp_pallas.py:1288, body _grouped_bwd_gmajor_kernel :1212),
// scatter_taps_windowed (:686, bodies _scatter_kernel :592 and
// _scatter_gmajor_kernel :643) and taps_dot_grouped. Those build one-hot
// [span, tile] matrices and multiply them on the matrix unit over 512-row
// spans of a VMEM-resident map, because Mosaic has no dynamic gather or
// scatter. A GPU gathers directly, so none of that carries over.
//
// Rounding: with bf16 maps each tap weight is rounded to bf16 before its
// product, as the TPU kernels cast the one-hot matrix to the compute dtype;
// a product of two bf16 values is exact in f32. sample's 9-tap weights are
// products of two bilinear weights and multiply as the float32 they are.
//
// Bound: memory bytes (a few flops per element moved): for the scatters
// gout, idx and wts read once and dmaps written once (scatter_tapdot: the
// map rows the taps touch read once and d_wts written once besides), over
// 3.35 TB/s. The sort of the taps below is not in the bound.
//
// sample: sample-major. A sub-warp of L lanes owns a sample, lane l the
// runs l, l + L, ... of V channels of its row (V the widest load, at most
// 16 bytes, that divides K and to which maps and out are aligned: 2
// channels at the flagship's K = 82 in bf16, 8 at K = 32, 128 and 1,280;
// L a power of two up to 32 that covers the K / V runs with the fewest
// idle lanes: 16 at K = 82, 4 at K = 32). A block owns `cells` = (256 / L)
// sub-warps x S (8) consecutive samples of one group. It first loads all
// its samples' taps, a sample a thread (an int4 of indices, a float4 of
// weights rounded to bf16 once), so that every tap load of the block is in
// flight at once, into shared memory; a lane then reads its sample's taps
// once and holds them in registers for all its runs, its 4 loads issued
// before the first FMA. Each element's sum is fmaf over t = 0..3 in order,
// taps of weight 0 (and indices outside [0, P)) skipped, as
// sample_tiles_grouped_ref adds them: the kernel is bit-equal to it. With 9
// taps a sample (the TAPS template parameter) the block's taps are one
// contiguous run of cells x 9 indices and weights, loaded element by
// element, coalesced; a thread a sample then moves its live taps to the
// front, in order, and a lane sums them in rounds of 4 (4 loads in flight,
// then 4 FMAs an element), stopping at the first weight 0: MVDet's 3x
// upsample leaves at most 4 live of 9, so one round, and registers for 4
// loads, not 9 (9 loads in flight a lane took 4.5 ms at MVDet's G = 112,
// K = 512 on the H100, rounds of 4 3.0 ms). The partition, the sums'
// order (live taps in order, weight 0 skipped) and the stores are the
// 4-tap path's. Its rows (the source pixels under a cell's resized 2 x 2)
// are shared by the block's neighbouring cells, so most come from L1 (a
// group's map, 90 x 160 x 512 bf16 in MVDet, 14.7 MB, stays in L2 while its
// blocks, consecutive in the grid, run). A lane
// whose load is 16 bytes stores straight from registers (a warp's stores
// are then contiguous); a narrower one (K = 82: 4 bytes) writes into a
// shared tile of the block's output, which is one run of cells x K
// elements, placed at the run's offset modulo 16 bytes and stored as
// 16-byte words, its unaligned head and tail element by element (a row too
// long to stage, past 6 KB, is stored from registers). Bytes do
// not hold it (the map rows it gathers are L1/L2 hits): loads in flight
// and the instructions a byte do. On the H100, two samples a lane at a time
// (more registers a thread, fewer blocks an SM), more runs a lane in
// flight, and staging stores that are 16 bytes already were each slower
// at the model's shapes.

// The scatters are a segmented reduction over the taps sorted by the row
// they read (Merrill and Garland's merge-based sparse product, with a K-wide
// right-hand side), deterministic and without float atomics.
//
// The sort (tap_lut): one key a tap, g*P + idx for a live tap (idx in
// [0, P), weight != 0) and G*P for a dead one, int32, sorted stably with
// the flat tap index (g*N + n)*4 + t as the value by CUB's radix sort over
// the key's bits only (2 passes of 8 bits for the flagship's 14, 3 for
// the deformable sampler's 17): rows[] are the sorted keys (the live taps by row, then every dead
// tap), order[] the tap indices, increasing within a row. No counts, no
// offsets: a kernel finds where a row ends by comparing neighbours.
//
// scatter_taps: the sorted taps are cut into chunks of C (CHUNK_TAPS in
// the wrapper); one warp owns a chunk and a slice of channels: each lane 1
// or 2 runs of V channels (V the widest of 16-, 8-, 4- or 2-byte loads that
// K allows with 32 runs a row or more). It stages 32 taps at a time, a tap
// a lane (rows, order: coalesced; weights: gathered), the next batch's
// loads issued before this batch is summed, and walks them in order:
// up to 16 taps' cotangent rows loaded before their sums, each tap's row
// and weight shuffled from the staging lane when it is summed, w * gout[n]
// added in f32 registers while the row holds. When the row changes it
// stores the finished sum: straight to dmaps for a row that begins and
// ends in the chunk; to a carry buffer [chunks, 2, K] for the chunk's
// first row if it began in an earlier chunk (slot 0) and its last if it
// goes on into the next (slot 1). The time follows the number of live taps
// over the number of warps, not the busiest row; what holds it is the
// loads in flight (the registers they land in: three blocks of 8 warps an
// SM), as the cotangent rows are gathered once for each of their 4 taps.
//
// scatter_carry: one warp a chunk; the chunk in which a split row begins
// (its owner) adds the row's partial sums in chunk order and stores the
// row. Every row's sum so has one order, taps in sorted order within a
// chunk, chunks in order, whatever the scheduling. Rows no live tap reads
// are the memset's 0.
//
// scatter_tapdot: the same chunks of the same sort and the same walk, so
// its dmaps equal scatter_taps' bit for bit (a channel's sum is the same
// sequence of fmaf whatever lane holds it), with the dots beside: the
// segment's map row is loaded once, with the cotangent rows of the taps
// around the one it begins at, and held in registers; each live tap's
// partial <map row, gout[n]> is taken per lane, and a round of U taps is
// reduced together by a transposing butterfly (U - 1 + log2(32 / U)
// shuffles for U dots, where 5 a dot would take 5 U). The dead taps, at
// the end of the order, add nothing to dmaps but each still gets its dot
// with the map row idx points at (0 outside [0, P)). Slices of channels
// add up in shared memory, so each d_wts[f] is stored once.
//
// taps_dot: sample-major, no sort. A sub-warp of L lanes owns a sample,
// lane l the runs l, l + L, ... of V channels (V the widest load, at most
// 16 bytes, that divides K and to which maps and gout are aligned; L the
// power of two, 4 to 32, that covers the K / V runs: 4 lanes at K = 32 in
// bf16, 8 samples a warp; 16 at K = 128), S (8) samples a sub-warp in a
// block. The block first loads its samples' indices, an int4 a sample and
// a thread, into shared memory (every load in flight at once); a lane
// reads its sample's int4 there, loads its cotangent run and the 4 tap
// rows' runs before any FMA and sums its share of the 4 dots in f32, in a
// fixed order; the transposing butterfly of scatter_tapdot (transpose_sum)
// then leaves dot t in lane t, 3 + log2(L / 4) shuffles for the 4 (3 at
// L = 4, where a butterfly a dot took 20), and lanes 0..3 store the
// sample's 16 contiguous bytes. No atomics: two launches are bit-equal.
// Every tap is computed, weight 0 or not (a clamped index is a valid row;
// the caller's mask multiplies junk away); a tap outside [0, P) gives 0.

#include <cub/device/device_radix_sort.cuh>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // chunks a block
// samples a sub-warp of sample_kernel and taps_dot_kernel takes in a block
// (fewer where sample's shared memory would pass kMaxSmem, the 48 KB a
// launch gets without opting in)
constexpr int kSamplesPerLane = 8;
constexpr long long kMaxSmem = 48 * 1024;
constexpr int kMaxChunk = 1024;  // scatter_tapdot keeps a chunk's dots in shared memory
constexpr unsigned kFull = 0xffffffffu;

// a tap weight as it multiplies a T value (see "Rounding" above)
__device__ __forceinline__ float tap_weight(float w, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(w));
}
__device__ __forceinline__ float tap_weight(float w, const float*) { return w; }

// a run of V elements of T as one load brings it (2 to 16 bytes), widened
// to f32 only where it is used, so that the loads in flight hold it packed
template <typename T, int V>
using Raw = typename std::conditional<
    std::is_same<T, float>::value,
    typename std::conditional<V == 4, float4, typename std::conditional<V == 2, float2, float>::type>::type,
    typename std::conditional<
        V == 8, uint4,
        typename std::conditional<V == 4, uint2, typename std::conditional<V == 2, unsigned, unsigned short>::type>::type>::type>::type;

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_raw(const T* p) {
  return __ldg(reinterpret_cast<const Raw<T, V>*>(p));
}

template <typename T, int V>
__device__ __forceinline__ void widen(const Raw<T, V>& r, float* v) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (V == 4) {
      v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
    } else if constexpr (V == 2) {
      v[0] = r.x; v[1] = r.y;
    } else {
      v[0] = r;
    }
  } else if constexpr (V == 1) {
    v[0] = __bfloat162float(__ushort_as_bfloat16(r));
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// CH contiguous elements (1, 2, 4 or 8) widened to f32: one load, two for
// 8 floats
template <int CH, typename T>
__device__ __forceinline__ void load_run(const T* p, float* v) {
  if constexpr (std::is_same<T, float>::value && CH == 8) {
    widen<float, 4>(load_raw<float, 4>(p), v);
    widen<float, 4>(load_raw<float, 4>(p + 4), v + 4);
  } else {
    widen<T, CH>(load_raw<T, CH>(p), v);
  }
}

// V f32 values stored as V elements of T (one store of 2 to 16 bytes)
template <typename T, int V>
__device__ __forceinline__ void narrow_store(T* p, const float* v) {
  Raw<T, V> r;
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (V == 4) r = make_float4(v[0], v[1], v[2], v[3]);
    else if constexpr (V == 2) r = make_float2(v[0], v[1]);
    else r = v[0];
  } else if constexpr (V == 1) {
    r = __bfloat16_as_ushort(__float2bfloat16_rn(v[0]));
  } else {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  *reinterpret_cast<Raw<T, V>*>(p) = r;
}

template <int CH>
__device__ __forceinline__ void store_run(float* p, const float* v) {
  if constexpr (CH == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else if constexpr (CH == 4) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (CH == 2) {
    reinterpret_cast<float2*>(p)[0] = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// a sample's 4 taps as the sampler multiplies them: weights rounded to T's
// precision, an index outside [0, P) (or a sample past the end) weight 0
// (9-tap samples: sample_kernel loads them itself)
template <typename T>
__device__ __forceinline__ void sample_taps(const int* __restrict__ idx, const float* __restrict__ wts, long long s,
                                            bool live, bool taps16, int P, int (&id)[4], float (&w)[4]) {
  int4 i4 = make_int4(0, 0, 0, 0);
  float4 w4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live && taps16) {
    i4 = __ldg(reinterpret_cast<const int4*>(idx) + s);
    w4 = __ldg(reinterpret_cast<const float4*>(wts) + s);
  } else if (live) {
    i4 = make_int4(idx[4 * s], idx[4 * s + 1], idx[4 * s + 2], idx[4 * s + 3]);
    w4 = make_float4(wts[4 * s], wts[4 * s + 1], wts[4 * s + 2], wts[4 * s + 3]);
  }
  const int ids[4] = {i4.x, i4.y, i4.z, i4.w};
  const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const bool in = ids[t] >= 0 && ids[t] < P;  // never made by the taps; skipped, not read out of bounds
    id[t] = in ? ids[t] : 0;
    w[t] = in ? tap_weight(ws[t], static_cast<const T*>(nullptr)) : 0.f;
  }
}

// n elements from src (shared memory) to dst, which agree modulo 16 bytes:
// 16-byte words, the head before dst's first 16-byte boundary and the tail
// after its last element by element
template <typename T>
__device__ __forceinline__ void flat_store(T* __restrict__ dst, const T* __restrict__ src, int n) {
  constexpr int E = 16 / sizeof(T);
  const int to16 = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15);  // bytes
  const int head = min(n, to16 / static_cast<int>(sizeof(T)));
  const int words = (n - head) / E;
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int i = threadIdx.x; i < words; i += blockDim.x) d4[i] = s4[i];
  const int rest = n - words * E;  // head and tail
  for (int i = threadIdx.x; i < rest; i += blockDim.x) {
    const int e = i < head ? i : head + words * E + (i - head);
    dst[e] = src[e];
  }
}

// grid (ceil(N / cells), G), cells = (kThreads / L) * S; sub-warp q of the
// block owns samples q, q + kThreads / L, ... (S of them); TAPS taps a
// sample, 4 or 9. Dynamic shared memory: the block's taps (cells x TAPS
// indices, then cells x TAPS weights: an int4 and a float4 a sample at 4),
// then, if staged, its output tile (cells * K elements + 16 bytes)
template <typename T, int V, int TAPS>
__global__ void __launch_bounds__(kThreads)
sample_kernel(const T* __restrict__ maps, const int* __restrict__ idx, const float* __restrict__ wts,
              T* __restrict__ out, int P, int N, int K, int L, int S, bool staged, bool taps16) {
  static_assert(TAPS == 4 || TAPS == 9, "4 bilinear taps, or 9 with an upsample folded in");
  extern __shared__ __align__(16) unsigned char s_raw[];
  const int groups = kThreads / L, cells = groups * S;
  int* s_id = reinterpret_cast<int*>(s_raw);
  float* s_w = reinterpret_cast<float*>(s_raw + cells * TAPS * sizeof(int));
  const int lane = threadIdx.x & (L - 1), q = threadIdx.x / L;
  const long long g = blockIdx.y;
  const long long n0 = static_cast<long long>(blockIdx.x) * cells;
  const int nc = static_cast<int>(min(static_cast<long long>(cells), N - n0));
  const T* gmap = maps + g * P * static_cast<long long>(K);
  T* run = out + (g * N + n0) * K;  // the block's output, nc * K elements
  // the tile sits at the run's offset modulo 16 bytes, so that a 16-byte
  // word of the run is one of the tile
  T* tile = reinterpret_cast<T*>(s_raw + cells * TAPS * (sizeof(int) + sizeof(float))) +
            (reinterpret_cast<uintptr_t>(run) & 15) / sizeof(T);
  if constexpr (TAPS == 4) {
    // the block's taps, a sample a thread: every load in flight at once
    for (int i = threadIdx.x; i < cells; i += kThreads) {
      int id[4];
      float w[4];
      sample_taps<T>(idx, wts, g * N + n0 + i, i < nc, taps16, P, id, w);
      reinterpret_cast<int4*>(s_id)[i] = make_int4(id[0], id[1], id[2], id[3]);
      reinterpret_cast<float4*>(s_w)[i] = make_float4(w[0], w[1], w[2], w[3]);
    }
  } else {
    // the block's taps are one run of nc * TAPS: loaded element by element,
    // coalesced, an index outside [0, P) weight 0; weights as they are
    const long long t0 = (g * N + n0) * TAPS;
    for (int i = threadIdx.x; i < nc * TAPS; i += kThreads) {
      const int id = __ldg(idx + t0 + i);
      const bool in = id >= 0 && id < P;
      s_id[i] = in ? id : 0;
      s_w[i] = in ? __ldg(wts + t0 + i) : 0.f;
    }
    __syncthreads();
    // a sample's live taps to its front, in order, then weight 0: the sums
    // below take them 4 at a time and stop at the first weight 0
    for (int c = threadIdx.x; c < nc; c += kThreads) {
      int n = 0;
      for (int t = 0; t < TAPS; ++t) {
        const float w = s_w[c * TAPS + t];
        if (w != 0.f) {
          s_id[c * TAPS + n] = s_id[c * TAPS + t];
          s_w[c * TAPS + n] = w;
          ++n;
        }
      }
      for (; n < TAPS; ++n) {
        s_id[c * TAPS + n] = 0;
        s_w[c * TAPS + n] = 0.f;
      }
    }
  }
  __syncthreads();
  const int R = K / V;
  for (int j = 0; j < S; ++j) {
    const int c = q + j * groups;
    if (c >= nc) break;  // and the sub-warp's later samples
    int id[TAPS];
    float w[TAPS];
    if constexpr (TAPS == 4) {
      const int4 i4 = reinterpret_cast<const int4*>(s_id)[c];
      const float4 w4 = reinterpret_cast<const float4*>(s_w)[c];
      id[0] = i4.x; id[1] = i4.y; id[2] = i4.z; id[3] = i4.w;
      w[0] = w4.x; w[1] = w4.y; w[2] = w4.z; w[3] = w4.w;
    } else {
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {
        id[t] = s_id[c * TAPS + t];
        w[t] = s_w[c * TAPS + t];
      }
    }
    for (int r = lane; r < R; r += L) {
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
      // 4 taps' loads in flight, then their sums (9 taps: the live ones,
      // compacted, a round of 4 at a time while any is left)
#pragma unroll
      for (int t0 = 0; t0 < TAPS; t0 += 4) {
        if (TAPS > 4 && w[t0] == 0.f) break;
        constexpr int U = 4;
        Raw<T, V> raw[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (t0 + u < TAPS && w[t0 + u] != 0.f)
            raw[u] = load_raw<T, V>(gmap + static_cast<long long>(id[t0 + u]) * K + r * V);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (t0 + u >= TAPS || w[t0 + u] == 0.f) continue;
          float x[V];
          widen<T, V>(raw[u], x);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = fmaf(w[t0 + u], x[e], acc[e]);
        }
      }
      narrow_store<T, V>((staged ? tile : run) + static_cast<long long>(c) * K + r * V, acc);
    }
  }
  if (staged) {
    __syncthreads();
    flat_store<T>(run, tile, nc * K);
  }
}

// the sort's input: keys (the row a live tap reads, else `dead` = G*P) and
// values (the flat tap index), one thread a tap
__global__ void __launch_bounds__(kThreads)
tap_keys_kernel(const int* __restrict__ idx, const float* __restrict__ wts, int* __restrict__ keys,
                int* __restrict__ vals, int n, int P, int taps_per_group, int dead) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= n) return;
  const int id = idx[f];
  const bool live = id >= 0 && id < P && wts[f] != 0.f;
  keys[f] = live ? (f / taps_per_group) * P + id : dead;
  vals[f] = f;
}

// a chunk of the sorted taps, as every lane of its warp sees it
struct Chunk {
  int j0, j1;       // taps [j0, j1) of the order
  int first, last;  // the rows of its first and last tap (`dead` for a dead tap)
  bool head_split;  // its first row began in the chunk before
  bool tail_split;  // its last row goes on into the chunk after
};

__device__ __forceinline__ Chunk chunk_at(const int* __restrict__ rows, long long c, int C, int n, int dead) {
  Chunk ch;
  ch.j0 = static_cast<int>(c * C);
  ch.j1 = static_cast<int>(min(c * C + C, static_cast<long long>(n)));
  ch.first = rows[ch.j0];
  ch.last = rows[ch.j1 - 1];
  ch.head_split = ch.first != dead && ch.j0 > 0 && rows[ch.j0 - 1] == ch.first;
  ch.tail_split = ch.last != dead && ch.j1 < n && rows[ch.j1] == ch.last;
  return ch;
}

// where a chunk's finished row goes: the first segment of a chunk whose
// head is split to carry slot 0, the last one of a chunk whose tail is
// split to slot 1, any other straight to dmaps
__device__ __forceinline__ float* row_out(float* dmaps, float* carry, const Chunk& ch, long long c, int row,
                                          bool first_seg, bool last_seg, int K) {
  if (first_seg && ch.head_split) return carry + (2 * c) * K;
  if (last_seg && ch.tail_split) return carry + (2 * c + 1) * K;
  return dmaps + static_cast<long long>(row) * K;
}

// taps whose rows a lane keeps in flight at once (`rows` a tap: 1 for
// scatter_taps, 2 for scatter_tapdot): 32 registers of raw runs, at most
// 16 taps (8 for scatter_tapdot, which holds a dot a tap besides). A tap's
// row and weight are shuffled out of the batch's staging again when it is
// summed, so the registers in flight are the runs alone.
template <typename T, int V, int R, int rows>
__host__ __device__ constexpr int taps_in_flight() {
  constexpr int words = rows * ((V * static_cast<int>(sizeof(T)) * R + 3) / 4);
  constexpr int most = rows == 1 ? 16 : 8;
  return 32 / words < 2 ? 2 : (32 / words > most ? most : 32 / words);
}

// one warp a (chunk, slice of 32 x R runs of V channels): grid
// (ceil(chunks / 8), slices). A lane's run i holds channels
// k0 + i*32*V .. + V.
template <typename T, int V, int R>
__global__ void __launch_bounds__(kThreads, 3)
scatter_taps_kernel(const T* __restrict__ gout, const float* __restrict__ wts,
                    const int* __restrict__ rows, const int* __restrict__ order,
                    float* __restrict__ dmaps, float* __restrict__ carry,
                    int n, int C, int K, int dead, long long chunks) {
  constexpr int U = taps_in_flight<T, V, R, 1>();
  const int lane = threadIdx.x & 31;
  const long long c = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (c >= chunks) return;  // whole warps leave together
  const Chunk ch = chunk_at(rows, c, C, n, dead);
  if (ch.first == dead) return;  // dead taps only: nothing for dmaps
  const int k0 = (blockIdx.y * 32 * R + lane) * V;
  float acc[R][V];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[i][e] = 0.f;
  int cur = ch.first;
  bool first_seg = true;
  auto emit = [&](bool last_seg) {
    float* dst = row_out(dmaps, carry, ch, c, cur, first_seg, last_seg, K) + k0;
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (k0 + i * 32 * V < K) store_run<V>(dst + i * 32 * V, acc[i]);
  };
  // a lane stages one tap of each batch of 32: its row, index and weight
  int r_l = dead, f_l = 0;
  float w_l = 0.f;
  if (ch.j0 + lane < ch.j1) {
    r_l = rows[ch.j0 + lane];
    f_l = order[ch.j0 + lane];
    if (r_l != dead) w_l = tap_weight(wts[f_l], gout);
  }
  for (int jb = ch.j0; jb < ch.j1; jb += 32) {
    const int nb = min(32, ch.j1 - jb);
    // the batch's live taps come first: the dead ones sort last
    const int nl = __popc(__ballot_sync(kFull, lane < nb && r_l != dead));
    if (nl == 0) break;  // and so do all the batches after it
    // the next batch's rows and indices load while this one is summed
    int nr_l = dead, nf_l = 0;
    float nw_l = 0.f;
    if (jb + 32 + lane < ch.j1) {
      nr_l = rows[jb + 32 + lane];
      nf_l = order[jb + 32 + lane];
    }
    for (int q0 = 0; q0 < nl; q0 += U) {
      Raw<T, V> raw[U][R];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int f = __shfl_sync(kFull, f_l, (q0 + u) & 31);
        const T* g = gout + static_cast<long long>(f >> 2) * K + k0;
#pragma unroll
        for (int i = 0; i < R; ++i)
          if (q0 + u < nl && k0 + i * 32 * V < K) raw[u][i] = load_raw<T, V>(g + i * 32 * V);
      }
      // the next batch's weights, behind this batch's loads
      if (q0 == 0 && nr_l != dead) nw_l = tap_weight(wts[nf_l], gout);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = __shfl_sync(kFull, r_l, (q0 + u) & 31);
        const float w = __shfl_sync(kFull, w_l, (q0 + u) & 31);
        if (q0 + u >= nl) break;  // the same for the whole warp
        if (r != cur) {
          emit(false);
          cur = r;
          first_seg = false;
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int e = 0; e < V; ++e) acc[i][e] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (k0 + i * 32 * V < K) {
            float g[V];
            widen<T, V>(raw[u][i], g);
#pragma unroll
            for (int e = 0; e < V; ++e) acc[i][e] = fmaf(w, g[e], acc[i][e]);
          }
        }
      }
    }
    r_l = nr_l;
    f_l = nf_l;
    w_l = nw_l;
  }
  emit(true);
}

// one warp a chunk: the owner of a split row (the chunk it begins in) adds
// its partial sums in chunk order and stores it; other warps leave
__global__ void __launch_bounds__(kThreads)
scatter_carry_kernel(const int* __restrict__ rows, const float* __restrict__ carry,
                     float* __restrict__ dmaps, int n, int C, int K, int dead, long long chunks) {
  const int lane = threadIdx.x & 31;
  const long long c = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (c >= chunks) return;
  const Chunk ch = chunk_at(rows, c, C, n, dead);
  if (!ch.tail_split || (ch.head_split && ch.first == ch.last)) return;
  const int row = ch.last;
  // the row's last chunk: chunks c+1.. hold it while the chunk after them
  // begins with it; 32 chunks checked at a time
  long long c_end = c + 1;
  for (;;) {
    const long long d = c_end + 1 + lane;
    const bool more = d * C < n && rows[d * C] == row;
    const unsigned m = __ballot_sync(kFull, more);
    if (m == kFull) {
      c_end += 32;
      continue;
    }
    c_end += __ffs(~m) - 1;
    break;
  }
  for (int k = lane; k < K; k += 32) {
    float s = carry[(2 * c + 1) * K + k];
#pragma unroll 8
    for (long long d = c + 1; d <= c_end; ++d) s += carry[(2 * d) * K + k];
    dmaps[static_cast<long long>(row) * K + k] = s;
  }
}

// v[0..U) a lane; after it, every lane l holds the sum over its aligned
// group of `width` lanes (a power of two, U to 32) of v[l % U]: a
// transposing butterfly, U - 1 + log2(width / U) shuffles for U sums where
// one sum alone takes log2(width)
template <int U>
__device__ __forceinline__ float transpose_sum(float (&v)[U], int lane, int width = 32) {
#pragma unroll
  for (int h = U / 2; h >= 1; h >>= 1) {
    const bool up = lane & h;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = up ? v[i] : v[i + h];
      const float keep = up ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, h);
    }
  }
  for (int o = U; o < width; o <<= 1) v[0] += __shfl_xor_sync(kFull, v[0], o);
  return v[0];
}

// one warp a chunk, its slices of 32 x R runs of V channels in turn;
// dynamic shared memory: kWarps * C floats (a chunk's dots)
template <typename T, int V, int R>
__global__ void __launch_bounds__(kThreads, 3)
scatter_tapdot_kernel(const T* __restrict__ maps, const T* __restrict__ gout,
                      const float* __restrict__ wts, const int* __restrict__ idx,
                      const int* __restrict__ rows, const int* __restrict__ order,
                      float* __restrict__ dmaps, float* __restrict__ carry, float* __restrict__ dwts,
                      int n, int C, int K, int P, int N, int dead, long long chunks, int slices) {
  constexpr int U = taps_in_flight<T, V, R, 2>();  // a tap's cotangent row and map row
  extern __shared__ float s_dots[];
  const int lane = threadIdx.x & 31;
  const long long c = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (c >= chunks) return;
  float* dots = s_dots + (threadIdx.x >> 5) * C;
  const Chunk ch = chunk_at(rows, c, C, n, dead);
  for (int s = 0; s < slices; ++s) {
    const int k0 = (s * 32 * R + lane) * V;
    float acc[R][V], m[R][V];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[i][e] = m[i][e] = 0.f;
    int cur = ch.first;
    bool first_seg = true;
    auto emit = [&](bool last_seg) {
      float* dst = row_out(dmaps, carry, ch, c, cur, first_seg, last_seg, K) + k0;
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (k0 + i * 32 * V < K) store_run<V>(dst + i * 32 * V, acc[i]);
    };
    if (cur != dead) {
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (k0 + i * 32 * V < K) load_run<V>(maps + static_cast<long long>(cur) * K + k0 + i * 32 * V, m[i]);
    }
    int prev = cur;  // the row of the tap before the batch
    // a lane stages one tap of each batch of 32: its row, index, weight
    // and, for a dead tap, the map row it points at (-1: none)
    int r_l = dead, f_l = 0, d_l = -1;
    float w_l = 0.f;
    auto stage_rest = [&](int r, int f, float& w, int& d) {
      if (r != dead) {
        w = tap_weight(wts[f], maps);
      } else {
        const int id = idx[f];
        if (id >= 0 && id < P) d = (f / (4 * N)) * P + id;
      }
    };
    if (ch.j0 + lane < ch.j1) {
      r_l = rows[ch.j0 + lane];
      f_l = order[ch.j0 + lane];
      stage_rest(r_l, f_l, w_l, d_l);
    }
    for (int jb = ch.j0; jb < ch.j1; jb += 32) {
      const int nb = min(32, ch.j1 - jb);
      const int nl = __popc(__ballot_sync(kFull, lane < nb && r_l != dead));  // live taps first
      // the map row a tap's dot needs, loaded once: a live tap's where its
      // row begins (the row before is in registers), a dead tap's own
      const int up = __shfl_up_sync(kFull, r_l, 1);
      const int m_l = r_l != dead ? (r_l != (lane == 0 ? prev : up) ? r_l : -1) : d_l;
      prev = __shfl_sync(kFull, r_l, nb - 1);
      const bool more = jb + 32 + lane < ch.j1;
      int nr_l = dead, nf_l = 0, nd_l = -1;
      float nw_l = 0.f;
      if (more) {
        nr_l = rows[jb + 32 + lane];
        nf_l = order[jb + 32 + lane];
      }
      for (int q0 = 0; q0 < nb; q0 += U) {
        Raw<T, V> graw[U][R], mraw[U][R];
        float part[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int q = (q0 + u) & 31;
          const int f = __shfl_sync(kFull, f_l, q);
          const int mrow = __shfl_sync(kFull, m_l, q);
          const T* g = gout + static_cast<long long>(f >> 2) * K + k0;
          const T* mp = maps + static_cast<long long>(mrow) * K + k0;
#pragma unroll
          for (int i = 0; i < R; ++i) {
            if (q0 + u < nb && k0 + i * 32 * V < K) graw[u][i] = load_raw<T, V>(g + i * 32 * V);
            if (q0 + u < nb && mrow >= 0 && k0 + i * 32 * V < K) mraw[u][i] = load_raw<T, V>(mp + i * 32 * V);
          }
        }
        // the next batch's weights and dead rows, behind this batch's loads
        if (q0 == 0 && more) stage_rest(nr_l, nf_l, nw_l, nd_l);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int q = (q0 + u) & 31;
          const int r = __shfl_sync(kFull, r_l, q);
          const float w = __shfl_sync(kFull, w_l, q);
          const int mrow = __shfl_sync(kFull, m_l, q);
          float p = 0.f;
          if (q0 + u < nl) {  // a live tap; the same for the whole warp
            if (r != cur) {
              emit(false);
              cur = r;
              first_seg = false;
#pragma unroll
              for (int i = 0; i < R; ++i) {
#pragma unroll
                for (int e = 0; e < V; ++e) acc[i][e] = 0.f;
                if (k0 + i * 32 * V < K) widen<T, V>(mraw[u][i], m[i]);
              }
            }
#pragma unroll
            for (int i = 0; i < R; ++i) {
              if (k0 + i * 32 * V < K) {
                float g[V];
                widen<T, V>(graw[u][i], g);
#pragma unroll
                for (int e = 0; e < V; ++e) {
                  acc[i][e] = fmaf(w, g[e], acc[i][e]);
                  p = fmaf(m[i][e], g[e], p);
                }
              }
            }
          } else if (q0 + u < nb && mrow >= 0) {  // a dead tap: its dot alone
#pragma unroll
            for (int i = 0; i < R; ++i) {
              if (k0 + i * 32 * V < K) {
                float g[V], x[V];
                widen<T, V>(graw[u][i], g);
                widen<T, V>(mraw[u][i], x);
#pragma unroll
                for (int e = 0; e < V; ++e) p = fmaf(x[e], g[e], p);
              }
            }
          }
          part[u] = p;
        }
        const float t = transpose_sum<U>(part, lane);
        const int j = q0 + lane;  // lane l < U holds tap q0 + l's dot over this slice
        if (lane < U && j < nb) dots[jb - ch.j0 + j] = s == 0 ? t : dots[jb - ch.j0 + j] + t;
      }
      r_l = nr_l;
      f_l = nf_l;
      w_l = nw_l;
      d_l = nd_l;
    }
    if (ch.first != dead) emit(true);
  }
  __syncwarp();
  // every tap's d_wts once
  for (int j = ch.j0 + lane; j < ch.j1; j += 32) dwts[order[j]] = dots[j - ch.j0];
}

// one sub-warp of L lanes (4 to 32) a sample; sub-warp q of block b owns
// samples b * cells + q, + kThreads / L, ... (S of them). Dynamic shared
// memory: the block's indices, cells int4
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 4)
taps_dot_kernel(const T* __restrict__ maps, const T* __restrict__ gout, const int* __restrict__ idx,
                float* __restrict__ dwts, long long samples, int P, int N, int K, int L, int S) {
  extern __shared__ __align__(16) int4 s_idx[];
  const int groups = kThreads / L, cells = groups * S;
  const int lane = threadIdx.x & (L - 1), q = threadIdx.x / L;
  const long long s0 = static_cast<long long>(blockIdx.x) * cells;
  // the block's indices, a sample a thread: every load in flight at once
  for (int i = threadIdx.x; i < cells; i += kThreads)
    s_idx[i] = s0 + i < samples ? __ldg(reinterpret_cast<const int4*>(idx) + s0 + i) : make_int4(-1, -1, -1, -1);
  __syncthreads();
  long long g = (s0 + q) / N;  // the group of the sub-warp's sample, found once and stepped
  for (int j = 0; j < S; ++j) {  // every lane stays for the shuffles
    const long long s = s0 + q + static_cast<long long>(j) * groups;
    const bool live = s < samples;
    while ((g + 1) * N <= s) ++g;
    const int4 i4 = s_idx[q + j * groups];
    const int id[4] = {i4.x, i4.y, i4.z, i4.w};
    bool in[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) in[t] = id[t] >= 0 && id[t] < P;
    const T* gmap = maps + g * P * static_cast<long long>(K);
    float dot[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = lane; live && r < K / V; r += L) {
      const Raw<T, V> graw = load_raw<T, V>(gout + s * K + r * V);
      Raw<T, V> mraw[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (in[t]) mraw[t] = load_raw<T, V>(gmap + static_cast<long long>(id[t]) * K + r * V);
      float gv[V];
      widen<T, V>(graw, gv);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (!in[t]) continue;
        float x[V];
        widen<T, V>(mraw[t], x);
#pragma unroll
        for (int e = 0; e < V; ++e) dot[t] = fmaf(x[e], gv[e], dot[t]);
      }
    }
    const float d = transpose_sum<4>(dot, lane, L);  // lane l: dot l % 4
    if (live && lane < 4) dwts[4 * s + lane] = d;
  }
}

struct Partition {
  int V;        // channels a load
  int L;        // lanes a sample
  int S;        // samples a sub-warp takes in a block
  int cells;    // samples a block: (kThreads / L) * S
  int staged;   // sample: the block's output staged in shared memory
};

// the widest vector of T (at most 16 bytes) that divides K, leaves at least
// `least` of them a row and that every pointer is aligned to
template <typename T>
int vector_width(int K, const void* const* ptrs, int nptr, int least) {
  int v = 16 / static_cast<int>(sizeof(T));
  for (; v > 1; v >>= 1) {
    bool ok = K % v == 0 && K / v >= least;
    for (int i = 0; i < nptr; ++i) ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % (v * sizeof(T)) == 0;
    if (ok) break;
  }
  return v;
}

// lanes a sample for R runs a row: the least power of two from `least` up
// to 32 that covers them, halved while that leaves fewer lanes idle with at
// most 4 runs a lane (never below 8): 41 runs take 16 lanes, 3 passes,
// where 32 would take 2 with 23 of 64 slots idle
int sub_warp_lanes(int R, int least) {
  int L = least;
  while (L < R && L < 32) L <<= 1;
  while (L > 8 && (R + L / 2 - 1) / (L / 2) <= 4 &&
         (R + L / 2 - 1) / (L / 2) * (L / 2) < (R + L - 1) / L * L)
    L >>= 1;
  return L;
}

// bytes of dynamic shared memory sample_kernel takes with `taps` taps a
// sample
template <typename T>
long long sample_smem(const Partition& p, int K, int taps) {
  return static_cast<long long>(p.cells) * taps * (sizeof(int) + sizeof(float)) +
         (p.staged ? static_cast<long long>(p.cells) * K * sizeof(T) + 16 : 0);
}

template <typename T>
Partition sample_partition(int K, const void* maps, const void* out, int taps) {
  const void* ptrs[] = {maps, out};
  Partition p;
  p.V = vector_width<T>(K, ptrs, 2, 1);
  p.L = sub_warp_lanes(K / p.V, 1);
  const int groups = kThreads / p.L;
  // a lane's stores are 16 bytes wide already, or go through the tile
  p.staged = p.V * static_cast<int>(sizeof(T)) < 16;
  p.S = 1;
  p.cells = groups;
  if (sample_smem<T>(p, K, taps) > kMaxSmem) p.staged = 0;  // a row too long to stage
  p.S = kSamplesPerLane;
  p.cells = groups * p.S;
  while (p.S > 1 && sample_smem<T>(p, K, taps) > kMaxSmem) {
    p.S /= 2;
    p.cells = groups * p.S;
  }
  return p;
}

template <typename T>
Partition taps_dot_partition(int K, const void* maps, const void* gout) {
  const void* ptrs[] = {maps, gout};
  Partition p;
  p.V = vector_width<T>(K, ptrs, 2, 1);
  p.L = sub_warp_lanes(K / p.V, 4);
  p.S = kSamplesPerLane;
  p.cells = kThreads / p.L * p.S;
  p.staged = 0;
  return p;
}

template <typename T, int V>
void launch_sample_v(const Partition& p, const T* maps, const int* idx, const float* wts, T* out,
                     int G, int P, int N, int K, int taps, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((static_cast<long long>(N) + p.cells - 1) / p.cells), static_cast<unsigned>(G));
  const size_t smem = static_cast<size_t>(sample_smem<T>(p, K, taps));
  const bool taps16 = reinterpret_cast<uintptr_t>(idx) % 16 == 0 && reinterpret_cast<uintptr_t>(wts) % 16 == 0;
  if (taps == 9)
    sample_kernel<T, V, 9><<<grid, kThreads, smem, stream>>>(maps, idx, wts, out, P, N, K, p.L, p.S,
                                                             p.staged != 0, taps16);
  else
    sample_kernel<T, V, 4><<<grid, kThreads, smem, stream>>>(maps, idx, wts, out, P, N, K, p.L, p.S,
                                                             p.staged != 0, taps16);
}

template <typename T>
int launch_sample(const void* maps, const int* idx, const float* wts, void* out,
                  int G, int P, int N, int K, int taps, cudaStream_t stream) {
  const Partition p = sample_partition<T>(K, maps, out, taps);
  const T* m = static_cast<const T*>(maps);
  T* o = static_cast<T*>(out);
  if (p.V == 4) launch_sample_v<T, 4>(p, m, idx, wts, o, G, P, N, K, taps, stream);
  else if (p.V == 2) launch_sample_v<T, 2>(p, m, idx, wts, o, G, P, N, K, taps, stream);
  else if (p.V == 1) launch_sample_v<T, 1>(p, m, idx, wts, o, G, P, N, K, taps, stream);
  else if constexpr (sizeof(T) == 2) launch_sample_v<T, 8>(p, m, idx, wts, o, G, P, N, K, taps, stream);  // bf16 only
  return static_cast<int>(cudaGetLastError());
}

// the scatters' runs: the widest vector that leaves at least 32 of them a
// row (a warp's lanes all hold channels), then the runs a lane holds, 1 or 2
template <typename T>
void vector_shape(int K, const void* const* ptrs, int nptr, int* V, int* R) {
  *V = vector_width<T>(K, ptrs, nptr, 32);
  *R = K / *V > 32 ? 2 : 1;
}

struct ScatterArgs {
  const void* maps;
  const void* gout;
  const float* wts;
  const int* idx;
  const int* rows;
  const int* order;
  float* dmaps;
  float* carry;
  float* dwts;
  int n, C, K, P, N, dead;
  long long chunks;
};

template <typename T, int V, int R>
void launch_walk(const ScatterArgs& a, unsigned blocks, cudaStream_t stream) {
  const int slices = (a.K / V + 32 * R - 1) / (32 * R);
  if (a.dwts == nullptr) {
    scatter_taps_kernel<T, V, R><<<dim3(blocks, slices), kThreads, 0, stream>>>(
        static_cast<const T*>(a.gout), a.wts, a.rows, a.order, a.dmaps, a.carry, a.n, a.C, a.K, a.dead, a.chunks);
  } else {
    const size_t smem = static_cast<size_t>(kWarps) * a.C * sizeof(float);
    scatter_tapdot_kernel<T, V, R><<<blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(a.maps), static_cast<const T*>(a.gout), a.wts, a.idx, a.rows, a.order,
        a.dmaps, a.carry, a.dwts, a.n, a.C, a.K, a.P, a.N, a.dead, a.chunks, slices);
  }
}

template <typename T, int V>
void launch_walk_v(const ScatterArgs& a, int R, unsigned blocks, cudaStream_t stream) {
  if (R == 2) launch_walk<T, V, 2>(a, blocks, stream);
  else launch_walk<T, V, 1>(a, blocks, stream);
}

// dmaps = 0, the walk (scatter_taps_kernel, or scatter_tapdot_kernel where
// dwts is given), then the carries
template <typename T>
int launch_scatter(const ScatterArgs& a, cudaStream_t stream) {
  const long long blocks = (a.chunks + kWarps - 1) / kWarps;
  if (blocks >= (1LL << 31)) return -1;
  const long long dm_bytes = static_cast<long long>(a.dead) * a.K * sizeof(float);
  cudaError_t err = cudaMemsetAsync(a.dmaps, 0, dm_bytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned nb = static_cast<unsigned>(blocks);
  const void* ptrs[] = {a.gout, a.dmaps, a.carry, a.maps == nullptr ? a.gout : a.maps};
  int V, R;
  vector_shape<T>(a.K, ptrs, 4, &V, &R);
  if (V == 4) launch_walk_v<T, 4>(a, R, nb, stream);
  else if (V == 2) launch_walk_v<T, 2>(a, R, nb, stream);
  else if (V == 1) launch_walk_v<T, 1>(a, R, nb, stream);
  else if constexpr (sizeof(T) == 2) launch_walk_v<T, 8>(a, R, nb, stream);  // 16-byte runs: bf16 only
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_carry_kernel<<<nb, kThreads, 0, stream>>>(a.rows, a.carry, a.dmaps, a.n, a.C, a.K, a.dead, a.chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
void launch_taps_dot_v(const T* maps, const T* gout, const int* idx, float* dwts, long long samples, int P,
                       int N, int K, const Partition& p, unsigned blocks, cudaStream_t stream) {
  taps_dot_kernel<T, V><<<blocks, kThreads, p.cells * sizeof(int4), stream>>>(maps, gout, idx, dwts, samples, P, N,
                                                                              K, p.L, p.S);
}

template <typename T>
int launch_taps_dot(const void* maps, const void* gout, const int* idx, float* dwts,
                    long long samples, int P, int N, int K, cudaStream_t stream) {
  const Partition p = taps_dot_partition<T>(K, maps, gout);
  const long long blocks = (samples + p.cells - 1) / p.cells;
  if (blocks >= (1LL << 31)) return -1;
  const T* m = static_cast<const T*>(maps);
  const T* g = static_cast<const T*>(gout);
  const unsigned nb = static_cast<unsigned>(blocks);
  if (p.V == 4) launch_taps_dot_v<T, 4>(m, g, idx, dwts, samples, P, N, K, p, nb, stream);
  else if (p.V == 2) launch_taps_dot_v<T, 2>(m, g, idx, dwts, samples, P, N, K, p, nb, stream);
  else if (p.V == 1) launch_taps_dot_v<T, 1>(m, g, idx, dwts, samples, P, N, K, p, nb, stream);
  else if constexpr (sizeof(T) == 2) launch_taps_dot_v<T, 8>(m, g, idx, dwts, samples, P, N, K, p, nb, stream);
  return static_cast<int>(cudaGetLastError());
}

// the taps of G groups of N samples: n = G*N*4 < 2**31, keys in [0, G*P]
bool lut_shape_ok(int G, int P, int N) {
  return G >= 1 && P >= 1 && N >= 1 && static_cast<long long>(G) * N * 4 < (1LL << 31) &&
         static_cast<long long>(G) * P < (1LL << 31);
}

int key_bits(int G, int P) {  // the bits of the dead key G*P, the largest
  const unsigned dead = static_cast<unsigned>(G) * static_cast<unsigned>(P);
  return 32 - __builtin_clz(dead);
}

size_t round_up(size_t x, size_t m) { return (x + m - 1) / m * m; }

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. Each launches on `stream`, which
// belongs to the caller's current device, and returns 0, a cudaError_t
// from the launch, or -1 for arguments the kernel does not take.
// sample: idx/wts [G, N, taps], taps 4 or 9
int grouped_sample_launch(const void* maps, const void* idx, const void* wts, void* out,
                          int G, int P, int N, int K, int taps, int dtype, void* stream) {
  if (G < 0 || G > 65535 || P < 1 || N < 0 || K < 1 || (taps != 4 && taps != 9)) return -1;
  if (G == 0 || N == 0) return 0;
  const int* i = static_cast<const int*>(idx);
  const float* w = static_cast<const float*>(wts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_sample<__nv_bfloat16>(maps, i, w, out, G, P, N, K, taps, s);
  if (dtype == 0) return launch_sample<float>(maps, i, w, out, G, P, N, K, taps, s);
  return -1;
}

// the workspace bytes of grouped_tap_lut_launch: the sort's input keys and
// values and its temporary storage
int grouped_tap_lut_workspace(int G, int P, int N, size_t* bytes) {
  if (!lut_shape_ok(G, P, N)) return -1;
  const int n = G * N * 4;
  size_t temp = 0;
  cudaError_t err = cub::DeviceRadixSort::SortPairs(
      nullptr, temp, static_cast<const int*>(nullptr), static_cast<int*>(nullptr),
      static_cast<const int*>(nullptr), static_cast<int*>(nullptr), n, 0, key_bits(G, P));
  *bytes = 2 * round_up(static_cast<size_t>(n) * sizeof(int), 256) + temp;
  return static_cast<int>(err);
}

// rows/order [G*N*4] int32: the taps sorted by the row they read (see the
// top of the file); work: grouped_tap_lut_workspace's bytes, 256-byte
// aligned
int grouped_tap_lut_launch(const void* idx, const void* wts, void* rows, void* order, void* work,
                           size_t work_bytes, int G, int P, int N, void* stream) {
  if (!lut_shape_ok(G, P, N) || reinterpret_cast<uintptr_t>(work) % 256 != 0) return -1;
  const int n = G * N * 4;
  const size_t part = round_up(static_cast<size_t>(n) * sizeof(int), 256);
  if (work_bytes < 2 * part) return -1;
  int* keys = static_cast<int*>(work);
  int* vals = reinterpret_cast<int*>(static_cast<char*>(work) + part);
  void* temp = static_cast<char*>(work) + 2 * part;
  size_t temp_bytes = work_bytes - 2 * part;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tap_keys_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const int*>(idx), static_cast<const float*>(wts), keys, vals, n, P, N * 4, G * P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cub::DeviceRadixSort::SortPairs(temp, temp_bytes, keys, static_cast<int*>(rows), vals,
                                        static_cast<int*>(order), n, 0, key_bits(G, P), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// both gradients over the sorted taps: dmaps [G, P, K] and dwts [G, N, 4]
// float32, carry [ceil(G*N*4 / chunk), 2, K] float32 scratch; chunk taps a
// warp (both scatters must use the same for their dmaps to agree)
int grouped_scatter_tapdot_launch(const void* maps, const void* gout, const void* wts, const void* idx,
                                  const void* rows, const void* order, void* dmaps, void* carry,
                                  void* dwts, int G, int P, int N, int K, int chunk, int dtype,
                                  void* stream) {
  if (!lut_shape_ok(G, P, N) || K < 1 || chunk < 1 || chunk > kMaxChunk) return -1;
  const int n = G * N * 4;
  const ScatterArgs a{maps, gout, static_cast<const float*>(wts), static_cast<const int*>(idx),
                      static_cast<const int*>(rows), static_cast<const int*>(order),
                      static_cast<float*>(dmaps), static_cast<float*>(carry), static_cast<float*>(dwts),
                      n, chunk, K, P, N, G * P, (static_cast<long long>(n) + chunk - 1) / chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_scatter<__nv_bfloat16>(a, s);
  if (dtype == 0) return launch_scatter<float>(a, s);
  return -1;
}

// dmaps alone over the same sort and chunks
int grouped_scatter_taps_launch(const void* gout, const void* wts, const void* rows, const void* order,
                                void* dmaps, void* carry, int G, int P, int N, int K, int chunk, int dtype,
                                void* stream) {
  if (!lut_shape_ok(G, P, N) || K < 1 || chunk < 1 || chunk > kMaxChunk) return -1;
  const int n = G * N * 4;
  const ScatterArgs a{nullptr, gout, static_cast<const float*>(wts), nullptr,
                      static_cast<const int*>(rows), static_cast<const int*>(order),
                      static_cast<float*>(dmaps), static_cast<float*>(carry), nullptr,
                      n, chunk, K, P, N, G * P, (static_cast<long long>(n) + chunk - 1) / chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_scatter<__nv_bfloat16>(a, s);
  if (dtype == 0) return launch_scatter<float>(a, s);
  return -1;
}

// d_wts alone; idx and dwts [G, N, 4], 16-byte aligned
int grouped_taps_dot_launch(const void* maps, const void* gout, const void* idx, void* dwts,
                            int G, int P, int N, int K, int dtype, void* stream) {
  if (G < 0 || P < 1 || N < 0 || K < 1) return -1;
  const long long samples = static_cast<long long>(G) * N;
  if (samples == 0) return 0;
  if (reinterpret_cast<uintptr_t>(idx) % 16 != 0 || reinterpret_cast<uintptr_t>(dwts) % 16 != 0)
    return -1;
  const int* i = static_cast<const int*>(idx);
  float* dw = static_cast<float*>(dwts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_taps_dot<__nv_bfloat16>(maps, gout, i, dw, samples, P, N, K, s);
  if (dtype == 0) return launch_taps_dot<float>(maps, gout, i, dw, samples, P, N, K, s);
  return -1;
}

// the work partition sample_tiles_grouped (kernel 0: a = maps, b = out,
// `taps` taps a sample) or taps_dot_grouped (kernel 1: a = maps, b = gout)
// takes for these K, dtype and pointers: shape[0..4] = V, L, S, cells, staged
int grouped_partition(int kernel, int K, int taps, int dtype, const void* a, const void* b, int* shape) {
  if (K < 1 || (dtype != 0 && dtype != 1) || (kernel != 0 && kernel != 1) || (taps != 4 && taps != 9)) return -1;
  Partition p;
  if (kernel == 0)
    p = dtype == 1 ? sample_partition<__nv_bfloat16>(K, a, b, taps) : sample_partition<float>(K, a, b, taps);
  else p = dtype == 1 ? taps_dot_partition<__nv_bfloat16>(K, a, b) : taps_dot_partition<float>(K, a, b);
  shape[0] = p.V;
  shape[1] = p.L;
  shape[2] = p.S;
  shape[3] = p.cells;
  shape[4] = p.staged;
  return 0;
}

const char* grouped_taps_error_string(int code) {
  if (code == -1) return "argument not supported by grouped_taps";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
