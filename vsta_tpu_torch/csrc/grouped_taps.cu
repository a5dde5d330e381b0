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
// d_wts are float32, out is the compute dtype.
//
// Replaces the TPU kernels sample_tiles_grouped, scatter_tapdot_grouped,
// scatter_taps_windowed and taps_dot_grouped (vsta_tpu/ops/warp_pallas.py).
// Those build one-hot [span, tile] matrices and multiply them on the matrix
// unit over 512-row spans of a VMEM-resident map, because Mosaic has no
// dynamic gather or scatter. A GPU gathers directly, so none of that
// carries over.
//
// Rounding: with bf16 maps each tap weight is rounded to bf16 before its
// product, as the TPU kernels cast the one-hot matrix to the compute dtype;
// a product of two bf16 values is exact in f32.
//
// Bound: memory bytes (a few flops per element moved).
//
// sample: a block takes `cells` consecutive samples of one group and stages
// their 4 taps in shared memory; each thread sums the 4 taps of one item
// (a sample and a run of channels) in f32. K % 8 == 0 with 16-byte aligned
// pointers takes 8 channels an item in 16-byte loads; any other K (the
// flagship's 82 = 2 x 41 is one) takes one channel an item, so consecutive
// threads still read consecutive channels of a row and the loads coalesce.
// Taps of weight 0 are skipped.
//
// scatter_tapdot: deterministic, with no float atomics. The wrapper sorts
// the taps by the source row they read (CSR: offsets over the G*P rows,
// order = flat tap indices (g*N + n)*4 + t, increasing within a row). One
// warp owns one source row: its lanes hold the row's channels (the map row
// in registers, the dmaps accumulator in registers) and walk the row's
// taps in order; per tap they add w * gout[n] into the accumulator and
// reduce <map row, gout[n]> across the warp into d_wts[n, t], which no
// other warp writes. Zero-weight taps stay in the walk: they add nothing
// to dmaps but their d_wts is real. A row no tap reads gets dmaps = 0.
// Rows wider than one pass (32 lanes x kChanPerLane channels) are walked
// once per pass, d_wts adding up the passes.
//
// scatter_taps: the same walk over the same CSR without the tap dots, so
// it needs no map and no reduction across lanes: one thread owns one
// (source row, channel) and adds w * gout[n, k] over the row's taps in
// order, which makes its dmaps equal scatter_tapdot's bit for bit.
// Consecutive threads own consecutive channels of a row, so the cotangent
// loads coalesce and the (tap, weight) loads are one broadcast. The
// wrapper may leave taps of weight 0 out of the CSR: they add nothing.
//
// taps_dot: sample-major, no sort and no CSR. A sub-warp of L lanes (8, 16
// or 32, the least that covers K up to 32) owns one sample: the lanes
// stride over K, each summing its share of the 4 dots <map row of tap t,
// gout[n]> in f32, a butterfly of shuffles adds the shares, and lane 0
// stores the sample's 4 dots as one 16-byte word. Every tap is computed,
// weight 0 or not (a clamped index is a valid row; the caller's mask
// multiplies junk away); a tap outside [0, P) gives 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItemsPerThread = 4;
constexpr int kMaxStagedCells = 48 * 1024 / (4 * 8);  // 4 taps x (idx + wt)
constexpr int kChanPerLane = 4;                       // 128 channels a pass
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// a tap weight as it multiplies a T value (see "Rounding" above)
__device__ __forceinline__ float tap_weight(float w, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(w));
}
__device__ __forceinline__ float tap_weight(float w, const float*) { return w; }

// CH contiguous elements: 16-byte loads and stores for CH == 8, else one
template <int CH>
__device__ __forceinline__ void load_run(const __nv_bfloat16* p, float* v) {
  if constexpr (CH == 8) {
    uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <int CH>
__device__ __forceinline__ void load_run(const float* p, float* v) {
  if constexpr (CH == 8) {
    float4 a = __ldg(reinterpret_cast<const float4*>(p));
    float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    v[0] = p[0];
  }
}

template <int CH>
__device__ __forceinline__ void store_run(__nv_bfloat16* p, const float* v) {
  if constexpr (CH == 8) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

template <int CH>
__device__ __forceinline__ void store_run(float* p, const float* v) {
  if constexpr (CH == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    p[0] = v[0];
  }
}

// grid (ceil(N / cells), G); CH = channels an item (8 or 1)
template <typename T, int CH>
__global__ void __launch_bounds__(kThreads)
sample_kernel(const T* __restrict__ maps, const int* __restrict__ idx,
              const float* __restrict__ wts, T* __restrict__ out,
              int P, int N, int K, int cells) {
  extern __shared__ int s_taps[];
  int* s_idx = s_taps;
  float* s_wts = reinterpret_cast<float*>(s_taps + cells * 4);
  const long long g = blockIdx.y;
  const long long n0 = static_cast<long long>(blockIdx.x) * cells;

  for (int i = threadIdx.x; i < cells * 4; i += blockDim.x) {
    const long long n = n0 + (i >> 2);
    float w = 0.f;
    int id = 0;
    if (n < N) {
      const long long off = (g * N + n) * 4 + (i & 3);
      w = wts[off];
      id = idx[off];
    }
    // an index outside [0, P) is never made by the taps; skip it rather
    // than read out of bounds
    if (id < 0 || id >= P) {
      w = 0.f;
      id = 0;
    }
    s_idx[i] = id;
    s_wts[i] = tap_weight(w, maps);
  }
  __syncthreads();

  const T* gmap = maps + g * P * static_cast<long long>(K);
  const int nrun = (K + CH - 1) / CH;
  for (int it = threadIdx.x; it < cells * nrun; it += blockDim.x) {
    const int c = it / nrun;
    const long long n = n0 + c;
    if (n >= N) break;  // samples past the end: later items too
    const int k0 = (it - c * nrun) * CH;
    float acc[CH];
#pragma unroll
    for (int e = 0; e < CH; ++e) acc[e] = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float wt = s_wts[c * 4 + t];
      if (wt == 0.f) continue;
      float x[CH];
      load_run<CH>(gmap + static_cast<long long>(s_idx[c * 4 + t]) * K + k0, x);
#pragma unroll
      for (int e = 0; e < CH; ++e) acc[e] = fmaf(wt, x[e], acc[e]);
    }
    store_run<CH>(out + (g * N + n) * K + k0, acc);
  }
}

// one warp a source row r in [0, G*P); 8 rows a block
template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_tapdot_kernel(const T* __restrict__ maps, const T* __restrict__ gout,
                      const float* __restrict__ wts, const int* __restrict__ order,
                      const int* __restrict__ offsets, float* __restrict__ dmaps,
                      float* __restrict__ dwts, int rows, int K) {
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;  // whole warps leave together
  const int beg = offsets[r], end = offsets[r + 1];
  const T* mrow = maps + r * K;

  for (int k0 = 0; k0 < K; k0 += 32 * kChanPerLane) {
    float m[kChanPerLane], acc[kChanPerLane];
#pragma unroll
    for (int i = 0; i < kChanPerLane; ++i) {
      const int k = k0 + lane + 32 * i;
      m[i] = k < K ? to_f(mrow[k]) : 0.f;
      acc[i] = 0.f;
    }
    // taps in batches of 32: each lane loads one (index, weight), then the
    // warp walks the batch in order, broadcasting each with a shuffle
    for (int j0 = beg; j0 < end; j0 += 32) {
      const int nb = min(32, end - j0);
      int f_l = 0;
      float w_l = 0.f;
      if (lane < nb) {
        f_l = order[j0 + lane];
        w_l = tap_weight(wts[f_l], maps);
      }
      for (int q = 0; q < nb; ++q) {
        const int f = __shfl_sync(kFull, f_l, q);
        const float w = __shfl_sync(kFull, w_l, q);
        const T* grow = gout + static_cast<long long>(f >> 2) * K;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kChanPerLane; ++i) {
          const int k = k0 + lane + 32 * i;
          if (k < K) {
            const float gv = to_f(grow[k]);
            acc[i] = fmaf(w, gv, acc[i]);
            dot = fmaf(m[i], gv, dot);
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);
        if (lane == 0) dwts[f] = k0 == 0 ? dot : dwts[f] + dot;
      }
    }
#pragma unroll
    for (int i = 0; i < kChanPerLane; ++i) {
      const int k = k0 + lane + 32 * i;
      if (k < K) dmaps[r * K + k] = acc[i];
    }
  }
}

// one thread a (source row, channel): item = r * K + k over rows * K items
template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_taps_kernel(const T* __restrict__ gout, const float* __restrict__ wts,
                    const int* __restrict__ order, const int* __restrict__ offsets,
                    float* __restrict__ dmaps, long long items, int K) {
  const long long item = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (item >= items) return;
  const long long r = item / K;
  const int k = static_cast<int>(item - r * K);
  const int beg = offsets[r], end = offsets[r + 1];
  float acc = 0.f;
  for (int j = beg; j < end; ++j) {
    const int f = order[j];
    const float w = tap_weight(wts[f], gout);
    acc = fmaf(w, to_f(gout[static_cast<long long>(f >> 2) * K + k]), acc);
  }
  dmaps[item] = acc;
}

// one sub-warp of L lanes a sample s in [0, G*N); kThreads / L samples a block
template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
taps_dot_kernel(const T* __restrict__ maps, const T* __restrict__ gout,
                const int* __restrict__ idx, float* __restrict__ dwts,
                long long samples, int P, int N, int K) {
  const int lane = threadIdx.x % L;
  const long long s = static_cast<long long>(blockIdx.x) * (kThreads / L) + threadIdx.x / L;
  const bool live = s < samples;  // every lane stays for the shuffles
  float dot[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
    const T* gmap = maps + (s / N) * P * static_cast<long long>(K);
    const T* grow = gout + s * K;
    const int4 tap = __ldg(reinterpret_cast<const int4*>(idx) + s);
    const int id[4] = {tap.x, tap.y, tap.z, tap.w};
    for (int k = lane; k < K; k += L) {
      const float gv = to_f(grow[k]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (id[t] >= 0 && id[t] < P)
          dot[t] = fmaf(to_f(gmap[static_cast<long long>(id[t]) * K + k]), gv, dot[t]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) dot[t] += __shfl_xor_sync(kFull, dot[t], o);
  }
  if (live && lane == 0)
    reinterpret_cast<float4*>(dwts)[s] = make_float4(dot[0], dot[1], dot[2], dot[3]);
}

template <typename T>
int launch_sample(const void* maps, const int* idx, const float* wts, void* out,
                  int G, int P, int N, int K, cudaStream_t stream) {
  const bool vec = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(maps) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int ch = vec ? 8 : 1;
  const int nrun = (K + ch - 1) / ch;
  int cells = (kItemsPerThread * kThreads + nrun - 1) / nrun;
  cells = cells < 1 ? 1 : (cells > kMaxStagedCells ? kMaxStagedCells : cells);
  const size_t smem = static_cast<size_t>(cells) * 4 * (sizeof(int) + sizeof(float));
  const dim3 grid(static_cast<unsigned>((static_cast<long long>(N) + cells - 1) / cells),
                  static_cast<unsigned>(G));
  const T* m = static_cast<const T*>(maps);
  T* o = static_cast<T*>(out);
  if (vec)
    sample_kernel<T, 8><<<grid, kThreads, smem, stream>>>(m, idx, wts, o, P, N, K, cells);
  else
    sample_kernel<T, 1><<<grid, kThreads, smem, stream>>>(m, idx, wts, o, P, N, K, cells);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scatter(const void* maps, const void* gout, const float* wts, const int* order,
                   const int* offsets, float* dmaps, float* dwts, int rows, int K,
                   cudaStream_t stream) {
  const int per_block = kThreads / 32;
  const unsigned blocks = static_cast<unsigned>((rows + per_block - 1) / per_block);
  scatter_tapdot_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(maps), static_cast<const T*>(gout), wts, order, offsets,
      dmaps, dwts, rows, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scatter_taps(const void* gout, const float* wts, const int* order, const int* offsets,
                        float* dmaps, long long rows, int K, cudaStream_t stream) {
  const long long items = rows * K;
  const long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return -1;
  scatter_taps_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(gout), wts, order, offsets, dmaps, items, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int L>
int launch_taps_dot_l(const T* maps, const T* gout, const int* idx, float* dwts,
                      long long samples, int P, int N, int K, cudaStream_t stream) {
  const int per_block = kThreads / L;
  const long long blocks = (samples + per_block - 1) / per_block;
  if (blocks >= (1LL << 31)) return -1;
  taps_dot_kernel<T, L><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      maps, gout, idx, dwts, samples, P, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_taps_dot(const void* maps, const void* gout, const int* idx, float* dwts,
                    long long samples, int P, int N, int K, cudaStream_t stream) {
  const T* m = static_cast<const T*>(maps);
  const T* g = static_cast<const T*>(gout);
  if (K <= 8) return launch_taps_dot_l<T, 8>(m, g, idx, dwts, samples, P, N, K, stream);
  if (K <= 16) return launch_taps_dot_l<T, 16>(m, g, idx, dwts, samples, P, N, K, stream);
  return launch_taps_dot_l<T, 32>(m, g, idx, dwts, samples, P, N, K, stream);
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. Each launches on `stream`, which
// belongs to the caller's current device, and returns 0, a cudaError_t
// from the launch, or -1 for arguments the kernel does not take.
int grouped_sample_launch(const void* maps, const void* idx, const void* wts, void* out,
                          int G, int P, int N, int K, int dtype, void* stream) {
  if (G < 0 || G > 65535 || P < 1 || N < 0 || K < 1) return -1;
  if (G == 0 || N == 0) return 0;
  const int* i = static_cast<const int*>(idx);
  const float* w = static_cast<const float*>(wts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_sample<__nv_bfloat16>(maps, i, w, out, G, P, N, K, s);
  if (dtype == 0) return launch_sample<float>(maps, i, w, out, G, P, N, K, s);
  return -1;
}

// order/offsets: the CSR of the taps by source row (see the top of the file)
int grouped_scatter_tapdot_launch(const void* maps, const void* gout, const void* wts,
                                  const void* order, const void* offsets, void* dmaps,
                                  void* dwts, int G, int P, int K, int dtype, void* stream) {
  if (G < 0 || P < 1 || K < 1) return -1;
  const long long rows = static_cast<long long>(G) * P;
  if (rows == 0) return 0;
  if (rows >= (1LL << 31)) return -1;
  const float* w = static_cast<const float*>(wts);
  const int* o = static_cast<const int*>(order);
  const int* off = static_cast<const int*>(offsets);
  float* dm = static_cast<float*>(dmaps);
  float* dw = static_cast<float*>(dwts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_scatter<__nv_bfloat16>(maps, gout, w, o, off, dm, dw, static_cast<int>(rows), K, s);
  if (dtype == 0)
    return launch_scatter<float>(maps, gout, w, o, off, dm, dw, static_cast<int>(rows), K, s);
  return -1;
}

// dmaps alone; order/offsets as above (the wrapper may leave out taps of
// weight 0)
int grouped_scatter_taps_launch(const void* gout, const void* wts, const void* order,
                                const void* offsets, void* dmaps, int G, int P, int K,
                                int dtype, void* stream) {
  if (G < 0 || P < 1 || K < 1) return -1;
  const long long rows = static_cast<long long>(G) * P;
  if (rows == 0) return 0;
  if (rows >= (1LL << 31)) return -1;
  const float* w = static_cast<const float*>(wts);
  const int* o = static_cast<const int*>(order);
  const int* off = static_cast<const int*>(offsets);
  float* dm = static_cast<float*>(dmaps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_scatter_taps<__nv_bfloat16>(gout, w, o, off, dm, rows, K, s);
  if (dtype == 0) return launch_scatter_taps<float>(gout, w, o, off, dm, rows, K, s);
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

const char* grouped_taps_error_string(int code) {
  if (code == -1) return "argument not supported by grouped_taps";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
