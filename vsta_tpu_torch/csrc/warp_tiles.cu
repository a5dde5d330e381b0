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
// gather.
//
// Bound on an H100: memory bytes. Each touched source row read once (at
// the flagship's K = 2,048 bf16, 4,392 rows: 18 MB), the taps once (9.7
// MB) and the output once (177 MB bf16, 354 MB f32): 0.061 ms bf16 at
// 3.35 TB/s. The products are 4.1 GFLOP, far under the tensor cores' rate.
//
// Design: warp_mma.cuh, shared with warp_views_sum.cu. A block stages the
// distinct source rows of a tile of 64 cells once a 128-channel chunk and
// multiplies the tile's weights by them with mma.sync; its header says why
// (the per-element cost of the old row-by-row walk, which its ablation
// measured) and how. Here the weights are rounded to bf16 when the maps
// are bf16, as the TPU kernels cast their one-hot weight matrix to the
// compute dtype at the matmul (one weight plane), and stay float32 for f32
// maps (three planes, and three for the maps).
//
// Ablation variants (warp_tiles_variant_launch), the counterpart of the TPU
// script's _resident_variant (scripts/roofline_warp.py): the same kernel
// with one part taken out at compile time, wrong by design, to see where
// its time goes. No model path runs them.
//   kFull          the kernel as it is (warp_tiles_launch runs this one);
//   kConstWeights  every tap weighs 0.25 and wts is never read: every tap
//                  in range is live, so a dead tap's clamped row joins the
//                  tile's distinct rows;
//   kRow0          every tap reads source row 0 of its view: the taps are
//                  loaded and the weights applied as in kFull, but a tile
//                  stages one row a view (four times: a cell's other taps
//                  of a view on it take slots of their own);
//   kNoGather      feats is never read: no staging and no product, each
//                  channel of a cell gets the sum of the cell's tap
//                  weights, so what is left is the taps and the stores.

#include "warp_mma.cuh"

namespace {

using warp_mma::kConstWeights;
using warp_mma::kFull;
using warp_mma::kNoGather;
using warp_mma::kRow0;

template <typename Tin, typename Tout>
int launch(const void* feats, const int* idx, const float* wts, void* out, int V, int P, int N, int K,
           int variant, int grid_w, cudaStream_t s) {
  switch (variant) {
    case kFull: return warp_mma::launch<Tin, Tout, kFull, false>(feats, idx, wts, out, 1, V, P, N, K, grid_w, s);
    case kConstWeights:
      return warp_mma::launch<Tin, Tout, kConstWeights, false>(feats, idx, wts, out, 1, V, P, N, K, grid_w, s);
    case kRow0: return warp_mma::launch<Tin, Tout, kRow0, false>(feats, idx, wts, out, 1, V, P, N, K, grid_w, s);
    case kNoGather:
      return warp_mma::launch<Tin, Tout, kNoGather, false>(feats, idx, wts, out, 1, V, P, N, K, grid_w, s);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. `grid_w`: the BEV grid's width
// (N = Hb * grid_w), for tiles of 8x8 cells; 0 takes runs of 64
// consecutive cells. Launches on `stream`, which belongs to the caller's
// current device. Returns 0, a cudaError_t from the launch, or -1 for
// arguments the kernel does not take. `variant` is a warp_mma::Variant.
int warp_tiles_variant_launch(const void* feats, const void* idx, const void* wts, void* out,
                              int V, int P, int N, int K, int in_dtype, int out_dtype,
                              int variant, int grid_w, void* stream) {
  const int* i = static_cast<const int*>(idx);
  const float* w = static_cast<const float*>(wts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(feats, i, w, out, V, P, N, K, variant, grid_w, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(feats, i, w, out, V, P, N, K, variant, grid_w, s);
  if (in_dtype == 0 && out_dtype == 0)
    return launch<float, float>(feats, i, w, out, V, P, N, K, variant, grid_w, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(feats, i, w, out, V, P, N, K, variant, grid_w, s);
  return -1;
}

int warp_tiles_launch(const void* feats, const void* idx, const void* wts, void* out,
                      int V, int P, int N, int K, int in_dtype, int out_dtype, int grid_w,
                      void* stream) {
  return warp_tiles_variant_launch(feats, idx, wts, out, V, P, N, K, in_dtype, out_dtype, kFull, grid_w, stream);
}

const char* warp_tiles_error_string(int code) {
  if (code == -1) return "argument not supported by warp_tiles";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
