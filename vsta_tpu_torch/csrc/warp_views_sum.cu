// Multi-view bilinear warp-and-sum for per-frame cameras:
//
//     out[b, n, c] = sum_v sum_t wts[b, v, n, t] * feats[b, v, idx[b, v, n, t], c]
//
// feats [B, V, P, C] (P = Hf*Wf source pixels of one frame's view), idx/wts
// [B, V, N, 4] bilinear taps of the N BEV cells under that frame's
// calibration, out [B, N, C] float32.
//
// Replaces the TPU kernel warp_views_sum_pallas (vsta_tpu/ops/warp_pallas.py,
// body _warp_kernel), which builds a dense one-hot [TILE_N, P] matrix a
// view and multiplies it with the whole map on the matrix unit, because
// Mosaic has no dynamic gather. A GPU gathers the four source rows directly,
// so neither the one-hot matrix nor the padding of P, C and N carries over.
//
// Bound: memory bytes (2 flops a gathered element). Unlike the
// shared-camera warp, every frame has its own taps, so the LUT is a large
// share of the traffic (at C = 128 bf16: 32 bytes of taps a view against
// 256 of map row), and the float32 output is the largest term. Design:
//   * a block takes `cells` consecutive BEV cells of one frame
//     (blockIdx.y) and stages their V*4 (idx, wts) taps in shared memory;
//     the staging loop runs cell-and-tap fastest within a view, so a warp
//     reads 128 contiguous bytes of idx and of wts;
//   * each item is 8 contiguous channels of one cell (one 16-byte load of
//     bf16, two of f32; two 16-byte stores); `cells` grows as C shrinks,
//     so a block has about 4 items a thread at any C (64 cells at C = 128);
//   * taps of weight 0 (views that do not see the cell, out-of-image
//     corners, non-finite coordinates) are skipped, which keeps them at
//     exactly 0 whatever the map holds;
//   * neighbouring cells sample neighbouring source pixels, so repeated
//     reads of a source row are served from L2.
// Offsets are 64-bit. A C that is not a multiple of 8 (or a pointer not
// 16-byte aligned) takes the masked scalar path.
//
// Rounding: the tap weights stay float32 and the map value is widened to
// float32 before the product, as the TPU kernel does (the other warp
// kernels round the weights to the compute dtype; this one does not). The
// sum is float32, views then taps in order, and is stored as float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItemsPerThread = 4;  // (cell, 8-channel chunk) items
constexpr int kMaxViews = 64;
// staged taps per block: (int idx + float wt) each, within the 48 KB of
// shared memory a block gets without opting in
constexpr int kMaxStagedTaps = 48 * 1024 / 8;

// 8 contiguous elements as float; vectorised 16-byte loads when VEC.
template <bool VEC>
__device__ __forceinline__ void load8(const __nv_bfloat16* p, int valid, float v[8]) {
  if (VEC) {
    uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i < valid ? __bfloat162float(p[i]) : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void load8(const float* p, int valid, float v[8]) {
  if (VEC) {
    float4 a = __ldg(reinterpret_cast<const float4*>(p));
    float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i < valid ? p[i] : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store8(float* p, int valid, const float v[8]) {
  if (VEC) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < valid) p[i] = v[i];
  }
}

template <typename Tin, bool VEC>
__global__ void __launch_bounds__(kThreads)
warp_views_sum_kernel(const Tin* __restrict__ feats, const int* __restrict__ idx,
                      const float* __restrict__ wts, float* __restrict__ out,
                      int V, int P, int N, int C, int cells) {
  extern __shared__ int s_taps[];
  const int taps = V * 4;
  int* s_idx = s_taps;
  float* s_wts = reinterpret_cast<float*>(s_taps + cells * taps);
  const long long b = blockIdx.y;
  const long long n0 = static_cast<long long>(blockIdx.x) * cells;

  // stage the block's taps: i -> (view, cell, tap), cell and tap fastest,
  // which is the order of idx/wts in memory within one view
  const int per_view = cells * 4;
  for (int i = threadIdx.x; i < V * per_view; i += blockDim.x) {
    const int v = i / per_view, r = i - v * per_view;
    const int c = r >> 2, t = r & 3;
    const long long n = n0 + c;
    float w = 0.f;
    int id = 0;
    if (n < N) {
      const long long off = (((b * V + v) * N) + n) * 4 + t;
      w = wts[off];
      id = idx[off];
    }
    // an index outside [0, P) is never made by the LUT; skip it rather
    // than read out of bounds
    if (id < 0 || id >= P) w = 0.f;
    s_idx[c * taps + v * 4 + t] = id;
    s_wts[c * taps + v * 4 + t] = w;
  }
  __syncthreads();

  // items in cell-major order: w -> (cell w / nchunk, chunk w % nchunk)
  const int nchunk = (C + 7) >> 3;
  const Tin* fb = feats + b * V * P * C;
  float* ob = out + b * N * C;
  for (int w = threadIdx.x; w < cells * nchunk; w += blockDim.x) {
    const int c = w / nchunk;
    const long long n = n0 + c;
    if (n >= N) break;  // cells past the end of the grid: later w too
    const int c0 = (w - c * nchunk) << 3;
    const int valid = C - c0;
    const int* ci = s_idx + c * taps;
    const float* cw = s_wts + c * taps;
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    for (int j = 0; j < taps; ++j) {
      const float wt = cw[j];
      if (wt == 0.f) continue;
      const long long row = static_cast<long long>(j >> 2) * P + ci[j];
      float x[8];
      load8<VEC>(fb + row * C + c0, valid, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = fmaf(wt, x[e], acc[e]);
    }
    store8<VEC>(ob + n * C + c0, valid, acc);
  }
}

template <typename Tin>
void launch(const void* feats, const int* idx, const float* wts, float* out,
            int B, int V, int P, int N, int C, bool vec, cudaStream_t stream) {
  const int nchunk = (C + 7) / 8;
  int cells = (kItemsPerThread * kThreads + nchunk - 1) / nchunk;
  cells = cells < 1 ? 1 : cells;
  if (cells * V * 4 > kMaxStagedTaps) cells = kMaxStagedTaps / (V * 4);
  const size_t smem = static_cast<size_t>(cells) * V * 4 * (sizeof(int) + sizeof(float));
  const dim3 grid(static_cast<unsigned>((static_cast<long long>(N) + cells - 1) / cells),
                  static_cast<unsigned>(B));
  const Tin* f = static_cast<const Tin*>(feats);
  if (vec)
    warp_views_sum_kernel<Tin, true><<<grid, kThreads, smem, stream>>>(f, idx, wts, out, V, P, N, C, cells);
  else
    warp_views_sum_kernel<Tin, false><<<grid, kThreads, smem, stream>>>(f, idx, wts, out, V, P, N, C, cells);
}

}  // namespace

extern "C" {

// in_dtype: 0 = float32, 1 = bfloat16; out is float32. Launches on
// `stream`, which belongs to the caller's current device. Returns 0, a
// cudaError_t from the launch, or -1 for arguments the kernel does not take.
int warp_views_sum_launch(const void* feats, const void* idx, const void* wts, void* out,
                          int B, int V, int P, int N, int C, int in_dtype, void* stream) {
  if (B < 0 || B > 65535 || V < 1 || V > kMaxViews || P < 1 || N < 0 || C < 1) return -1;
  if (B == 0 || N == 0) return 0;
  const bool vec = (C % 8 == 0) &&
                   (reinterpret_cast<uintptr_t>(feats) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int* i = static_cast<const int*>(idx);
  const float* w = static_cast<const float*>(wts);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1)
    launch<__nv_bfloat16>(feats, i, w, o, B, V, P, N, C, vec, s);
  else if (in_dtype == 0)
    launch<float>(feats, i, w, o, B, V, P, N, C, vec, s);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

const char* warp_views_sum_error_string(int code) {
  if (code == -1) return "argument not supported by warp_views_sum";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
