// Multi-view bilinear warp-and-sum for batch-shared cameras:
//
//     out[n, k] = sum_v sum_t wts[v, n, t] * feats[v, idx[v, n, t], k]
//
// feats [V, P, K] (P = Hf*Wf source pixels, K = B*C_out channels with the
// batch folded in), idx/wts [V, N, 4] bilinear taps of the N BEV cells,
// out [N, K]. Accumulation is float32; the output is stored in the
// caller's dtype.
//
// Replaces the TPU kernels warp_tiles_resident and warp_tiles_windowed
// (vsta_tpu/ops/warp_pallas.py), which compute this one function and
// differ only in output dtype. Those kernels build one-hot scatter
// matrices and multiply them on the matrix unit, with scalar-prefetched
// span worklists and 8-row-aligned windows, because Mosaic has no dynamic
// gather. A GPU gathers directly, so none of that carries over.
//
// Bound: memory bytes. The op does ~2 flops per gathered element; the
// least traffic is feats read once, out written once and the LUT read
// once. Design:
//   * a block takes `cells` consecutive BEV cells and stages their V*4
//     (idx, wts) taps in shared memory; `cells` grows as K shrinks, so a
//     block has about 4 (cell, channel-chunk) items per thread at any K
//     (4 cells at K = 2048, 64 at K = 128);
//   * each item is 8 contiguous channels of one cell (one 16-byte load of
//     bf16, two of f32); consecutive threads take consecutive chunks, so
//     a warp reads 512 (bf16) or 1024 (f32) contiguous bytes of one
//     source row and the loads coalesce;
//   * taps with weight 0 (views that do not see the cell, out-of-image
//     corners) are skipped: that is where most bytes are saved, and it
//     keeps masked taps at exactly 0 whatever the source holds;
//   * neighbouring BEV cells sample neighbouring source pixels, so
//     repeated reads of a source row are served from L2.
// Row offsets are 64-bit. A K that is not a multiple of 8 (or a pointer
// not 16-byte aligned) takes the masked scalar path.
//
// Rounding: with bf16 feats each tap weight is rounded to bf16 before the
// product, as the TPU kernels cast their one-hot weight matrix to the
// compute dtype at the matmul; the product of two bf16 values is exact in
// f32, the sum is f32 and the result is rounded once to the output dtype.
// f32 feats keep f32 weights.
//
// Ablation variants (warp_tiles_variant_launch), the counterpart of the TPU
// script's _resident_variant (scripts/roofline_warp.py): the same kernel
// with one part taken out at compile time, wrong by design, to see where
// its time goes. No model path runs them.
//   kFull          the kernel as it is (warp_tiles_launch runs this one);
//   kConstWeights  every tap weighs 0.25 and wts is never read: all V*4
//                  taps of a cell are gathered, none is skipped;
//   kRow0          every tap reads source row 0 of its view: the LUT is
//                  walked and the weights applied as in kFull, but the
//                  scattered gather becomes one cached row a view;
//   kNoGather      feats is never read: each channel of a cell gets the
//                  sum of the cell's tap weights, so what is left is the
//                  LUT walk and the stores.

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

enum Variant { kFull = 0, kConstWeights = 1, kRow0 = 2, kNoGather = 3, kVariants = 4 };

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
__device__ __forceinline__ void store8(__nv_bfloat16* p, int valid, const float v[8]) {
  if (VEC) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < valid) p[i] = __float2bfloat16_rn(v[i]);
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

// a tap weight as it multiplies a Tin value (see "Rounding" above)
__device__ __forceinline__ float tap_weight(float w, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(w));
}
__device__ __forceinline__ float tap_weight(float w, const float*) { return w; }

template <typename Tin, typename Tout, bool VEC, int VARIANT>
__global__ void __launch_bounds__(kThreads)
warp_tiles_kernel(const Tin* __restrict__ feats, const int* __restrict__ idx,
                  const float* __restrict__ wts, Tout* __restrict__ out,
                  int V, int P, int N, int K, int cells) {
  extern __shared__ int s_taps[];
  const int taps = V * 4;
  int* s_idx = s_taps;
  float* s_wts = reinterpret_cast<float*>(s_taps + cells * taps);
  const long long n0 = static_cast<long long>(blockIdx.x) * cells;

  for (int i = threadIdx.x; i < cells * taps; i += blockDim.x) {
    const int c = i / taps, r = i - c * taps;
    const int v = r >> 2, t = r & 3;
    const long long n = n0 + c;
    float w = 0.f;
    int id = 0;
    if (n < N) {
      const long long off = (static_cast<long long>(v) * N + n) * 4 + t;
      w = VARIANT == kConstWeights ? 0.25f : wts[off];
      id = idx[off];
    }
    // an index outside [0, P) is never made by the LUT; skip it rather
    // than read out of bounds
    if (id < 0 || id >= P) w = 0.f;
    s_idx[i] = VARIANT == kRow0 ? 0 : id;
    s_wts[i] = tap_weight(w, feats);
  }
  __syncthreads();

  // items in cell-major order: w -> (cell w / nchunk, chunk w % nchunk)
  const int nchunk = (K + 7) >> 3;
  for (int w = threadIdx.x; w < cells * nchunk; w += blockDim.x) {
    const int c = w / nchunk;
    const long long n = n0 + c;
    if (n >= N) break;  // cells past the end of the grid: later w too
    const int k0 = (w - c * nchunk) << 3;
    const int valid = K - k0;
    const int* ci = s_idx + c * taps;
    const float* cw = s_wts + c * taps;
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    for (int j = 0; j < taps; ++j) {
      const float wt = cw[j];
      if (wt == 0.f) continue;
      if (VARIANT == kNoGather) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += wt;
        continue;
      }
      const long long row = static_cast<long long>(j >> 2) * P + ci[j];
      float x[8];
      load8<VEC>(feats + row * K + k0, valid, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = fmaf(wt, x[e], acc[e]);
    }
    store8<VEC>(out + n * K + k0, valid, acc);
  }
}

template <typename Tin, typename Tout, int VARIANT>
void launch_variant(const void* feats, const int* idx, const float* wts, void* out,
                    int V, int P, int N, int K, bool vec, cudaStream_t stream) {
  const int nchunk = (K + 7) / 8;
  int cells = (kItemsPerThread * kThreads + nchunk - 1) / nchunk;
  cells = cells < 1 ? 1 : cells;
  if (cells * V * 4 > kMaxStagedTaps) cells = kMaxStagedTaps / (V * 4);
  const size_t smem = static_cast<size_t>(cells) * V * 4 * (sizeof(int) + sizeof(float));
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(N) + cells - 1) / cells);
  const Tin* f = static_cast<const Tin*>(feats);
  Tout* o = static_cast<Tout*>(out);
  if (vec)
    warp_tiles_kernel<Tin, Tout, true, VARIANT><<<blocks, kThreads, smem, stream>>>(f, idx, wts, o, V, P, N, K, cells);
  else
    warp_tiles_kernel<Tin, Tout, false, VARIANT><<<blocks, kThreads, smem, stream>>>(f, idx, wts, o, V, P, N, K, cells);
}

template <typename Tin, typename Tout>
void launch(const void* feats, const int* idx, const float* wts, void* out,
            int V, int P, int N, int K, bool vec, int variant, cudaStream_t stream) {
  switch (variant) {
    case kConstWeights: launch_variant<Tin, Tout, kConstWeights>(feats, idx, wts, out, V, P, N, K, vec, stream); break;
    case kRow0: launch_variant<Tin, Tout, kRow0>(feats, idx, wts, out, V, P, N, K, vec, stream); break;
    case kNoGather: launch_variant<Tin, Tout, kNoGather>(feats, idx, wts, out, V, P, N, K, vec, stream); break;
    default: launch_variant<Tin, Tout, kFull>(feats, idx, wts, out, V, P, N, K, vec, stream); break;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. Launches on `stream`, which
// belongs to the caller's current device. Returns 0, a cudaError_t from
// the launch, or -1 for arguments the kernel does not take.
// `variant` is one of the Variant codes above.
int warp_tiles_variant_launch(const void* feats, const void* idx, const void* wts, void* out,
                              int V, int P, int N, int K, int in_dtype, int out_dtype,
                              int variant, void* stream) {
  if (V < 1 || V > kMaxViews || P < 1 || N < 0 || K < 1) return -1;
  if (variant < 0 || variant >= kVariants) return -1;
  if (N == 0) return 0;
  const bool vec = (K % 8 == 0) &&
                   (reinterpret_cast<uintptr_t>(feats) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int* i = static_cast<const int*>(idx);
  const float* w = static_cast<const float*>(wts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1 && out_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(feats, i, w, out, V, P, N, K, vec, variant, s);
  else if (in_dtype == 1 && out_dtype == 0)
    launch<__nv_bfloat16, float>(feats, i, w, out, V, P, N, K, vec, variant, s);
  else if (in_dtype == 0 && out_dtype == 0)
    launch<float, float>(feats, i, w, out, V, P, N, K, vec, variant, s);
  else if (in_dtype == 0 && out_dtype == 1)
    launch<float, __nv_bfloat16>(feats, i, w, out, V, P, N, K, vec, variant, s);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

int warp_tiles_launch(const void* feats, const void* idx, const void* wts, void* out,
                      int V, int P, int N, int K, int in_dtype, int out_dtype,
                      void* stream) {
  return warp_tiles_variant_launch(feats, idx, wts, out, V, P, N, K, in_dtype, out_dtype, kFull, stream);
}

const char* warp_tiles_error_string(int code) {
  if (code == -1) return "argument not supported by warp_tiles";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
