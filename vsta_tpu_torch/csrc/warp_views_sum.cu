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
// Mosaic has no dynamic gather.
//
// Bound on an H100: memory bytes. Unlike the shared-camera warp every
// frame has its own taps, so at B = 16, C = 128 bf16 the least traffic is
// the taps (155 MB), the float32 output (354 MB) and each touched source
// row once (18 MB): 0.157 ms at 3.35 TB/s.
//
// Design: warp_mma.cuh, shared with warp_tiles.cu: a block takes a tile of
// 64 cells of one frame (blockIdx.z), stages the tile's distinct source
// rows once and multiplies the tile's weights by them with mma.sync (its
// header says why: the old walk paid a load, eight widenings and eight
// fmaf per tap per 8 channels, which the ablation of the shared-camera
// walk showed to be its cost). C = 128 is one chunk.
//
// Rounding: the tap weights stay float32, as the TPU kernel keeps them
// (the other warp kernels round them to the compute dtype; this one does
// not): the weight tile holds each weight as three bf16 planes whose sum
// is the weight to the bit, and bf16 maps multiply each plane exactly.
// f32 maps are split into three planes too. The sum is float32 and is
// stored as float32.

#include "warp_mma.cuh"

extern "C" {

// in_dtype: 0 = float32, 1 = bfloat16; out is float32. `grid_w`: the BEV
// grid's width (N = Hb * grid_w), for tiles of 8x8 cells; 0 takes runs of
// 64 consecutive cells. Launches on `stream`, which belongs to the caller's
// current device. Returns 0, a cudaError_t from the launch, or -1 for
// arguments the kernel does not take.
int warp_views_sum_launch(const void* feats, const void* idx, const void* wts, void* out,
                          int B, int V, int P, int N, int C, int in_dtype, int grid_w, void* stream) {
  const int* i = static_cast<const int*>(idx);
  const float* w = static_cast<const float*>(wts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1)
    return warp_mma::launch<__nv_bfloat16, float, warp_mma::kFull, true>(feats, i, w, out, B, V, P, N, C, grid_w, s);
  if (in_dtype == 0)
    return warp_mma::launch<float, float, warp_mma::kFull, true>(feats, i, w, out, B, V, P, N, C, grid_w, s);
  return -1;
}

const char* warp_views_sum_error_string(int code) {
  if (code == -1) return "argument not supported by warp_views_sum";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
