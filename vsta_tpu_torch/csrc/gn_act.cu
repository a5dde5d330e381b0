// GroupNorm and the ReLU after it, over a bfloat16 channels-last map:
//
//     mean, var = the f32 mean and biased variance of group g of frame n:
//                 its C / G channels over all H * W cells of the frame
//     a[n, c] = rsqrt(var + eps) * weight[c],  b[n, c] = -a[n, c] * mean + bias[c]
//     y = round_bf16(a * x + b)
//     y = max(y, 0)                                     (where the caller asks)
//
// x and y [N, C, H, W], both channels-last (NHWC) contiguous; weight and
// bias float32 [C].
//
// Replaces no TPU kernel: on the TPU, XLA fuses Flax's GroupNorm and the
// ReLU after it into the passes around them. On the card the CenterNet
// head's eager path ran each of its three GroupNorms as a cast to f32, the
// copy of the channels-last map to NCHW that F.group_norm makes, its
// moments and its affine pass in f32, a cast back and a ReLU: about 34
// bytes of traffic a bf16 element.
//
// Bound on an H100: memory bytes. The statistics need every element read
// once, the normalisation reads it again and writes it once: 6 bytes a
// bf16 element at 3.35 TB/s. The head's three at batch 16 (16 x 120 x 360
// cells at C = 512, 128 and 128) hold 531 M elements: 3.19 GB, 0.95 ms a
// request (0.63 ms counting each input read once, the kernel table's rule).
// The design reads and writes nothing else of that size: three launches,
// of which the middle one touches a few KB.
//
//  1. gn_act_stats_kernel, grid (chunks, N): a block takes a fixed chunk
//     of one frame's cells; a thread takes one 16-byte word (8 channels)
//     of every R-th cell of it (R = 256 / (C / 8) cells side by side, so
//     neighbouring threads read neighbouring words), 4 words in flight.
//     It sums each channel's values and squares in f32, shifted by the
//     first value it reads, so that the sum of squares does not cancel
//     where the mean is large against the spread. The block merges the
//     threads' (count, mean, M2) in a fixed order (Chan, Golub and
//     LeVeque's pairwise update): over its rows channel by channel, then
//     over each group's channels; one partial a chunk and group goes to
//     the scratch the wrapper allocates. The chunks a frame adapt to
//     N * H * W: the wrapper asks for enough blocks to fill every SM once,
//     so at batch 1 (32 groups in all) the card is as full as at batch 16.
//  2. gn_act_coeffs_kernel, grid N: a warp a group merges its chunks'
//     partials in a fixed order (lane-strided, then a shuffle tree), and
//     the block writes every channel's a and b as PyTorch's own CUDA
//     GroupNorm forms them (rsqrtf, the product, one fused multiply-add).
//  3. gn_act_apply_kernel, grid (chunks, N): the same partition; a thread
//     keeps its 8 channels' a and b in registers for its whole chunk,
//     reads 16-byte words, 4 in flight, and writes the fused multiply-add
//     a * x + b (PyTorch's affine pass contracts to the same) rounded to
//     bf16 once. The ReLU is taken before the rounding: max(round(y), 0)
//     equals round(max(y, 0)) because the rounding keeps the sign.
//
// No atomics and a partition fixed by (N, H * W, C, the card's SM count):
// two launches are bit-equal. The statistics are summed in another order
// than PyTorch's Welford pass, so a few elements that lie on a bf16
// rounding boundary round the other way. The kernels launch on the
// caller's stream, so a CUDA graph captures them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;    // 4 blocks of 256 an SM at <= 64 registers: the wrapper's grid fills each SM once
constexpr int kVec = 8;          // bf16 elements in 16 bytes
constexpr int kUnroll = 4;       // words in flight a thread
constexpr int kMaxChannels = 2048;  // C / 8 <= 256 words: a block holds one cell's words at least once

// Count, mean and sum of squared deviations of a set of values.
struct Moments {
  float n, mean, m2;
};

// Merges (nb, mb, m2b) into a (Chan et al.); an empty set changes nothing.
__device__ __forceinline__ void merge(Moments& a, float nb, float mb, float m2b) {
  if (nb == 0.0f) return;
  const float n = a.n + nb;
  const float d = mb - a.mean;
  const float f = nb / n;
  a.mean = a.mean + d * f;
  a.m2 = a.m2 + m2b + d * d * a.n * f;
  a.n = n;
}

__device__ __forceinline__ void unpack(const uint4& w, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// Cells of [p0, p1) that row r of `rows` takes: p0 + r, p0 + r + rows, ...
__device__ __forceinline__ long long row_cells(long long p0, long long p1, int r, int rows) {
  return p1 - p0 > r ? (p1 - p0 - r + rows - 1) / rows : 0;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
gn_act_stats_kernel(const uint4* __restrict__ x, float2* __restrict__ part, long long hw, int C, int G,
                    long long chunk) {
  extern __shared__ float4 smem4[];
  const int words = C / kVec;
  const int rows = blockDim.x / words;
  const int col = threadIdx.x % words, row = threadIdx.x / words;
  const long long p0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long p1 = p0 + chunk < hw ? p0 + chunk : hw;
  const uint4* xs = x + static_cast<long long>(blockIdx.y) * hw * words + col;

  float shift[kVec], s1[kVec], s2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) shift[j] = s1[j] = s2[j] = 0.0f;
  long long p = p0 + row;
  if (p < p1) unpack(__ldg(xs + p * words), shift);
  for (; p + (kUnroll - 1) * rows < p1; p += kUnroll * rows) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) w[u] = __ldg(xs + (p + u * rows) * words);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float v[kVec];
      unpack(w[u], v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float d = v[j] - shift[j];
        s1[j] += d;
        s2[j] = fmaf(d, d, s2[j]);
      }
    }
  }
  for (; p < p1; p += rows) {
    float v[kVec];
    unpack(__ldg(xs + p * words), v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float d = v[j] - shift[j];
      s1[j] += d;
      s2[j] = fmaf(d, d, s2[j]);
    }
  }

  // each thread's 8 channels: mean and M2 of its cells, [rows][C] each
  float* means = reinterpret_cast<float*>(smem4);
  float* m2s = means + rows * C;
  const long long cnt = row_cells(p0, p1, row, rows);
  float mean[kVec], m2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float q = cnt ? s1[j] / static_cast<float>(cnt) : 0.0f;
    mean[j] = shift[j] + q;
    m2[j] = cnt ? fmaxf(s2[j] - s1[j] * q, 0.0f) : 0.0f;
  }
  float4* mrow = reinterpret_cast<float4*>(means + row * C + col * kVec);
  float4* vrow = reinterpret_cast<float4*>(m2s + row * C + col * kVec);
  mrow[0] = make_float4(mean[0], mean[1], mean[2], mean[3]);
  mrow[1] = make_float4(mean[4], mean[5], mean[6], mean[7]);
  vrow[0] = make_float4(m2[0], m2[1], m2[2], m2[3]);
  vrow[1] = make_float4(m2[4], m2[5], m2[6], m2[7]);
  __syncthreads();

  // the rows, channel by channel, in row order, into row 0
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    Moments s{0.0f, 0.0f, 0.0f};
    for (int r = 0; r < rows; ++r)
      merge(s, static_cast<float>(row_cells(p0, p1, r, rows)), means[r * C + c], m2s[r * C + c]);
    means[c] = s.mean;
    m2s[c] = s.m2;
  }
  __syncthreads();

  // each group's channels, in channel order: the chunk's partial
  const int cpg = C / G;
  const float cells = static_cast<float>(p1 > p0 ? p1 - p0 : 0);
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    Moments s{0.0f, 0.0f, 0.0f};
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) merge(s, cells, means[c], m2s[c]);
    part[(static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * G + g] = make_float2(s.mean, s.m2);
  }
}

__global__ void __launch_bounds__(kThreads)
gn_act_coeffs_kernel(const float2* __restrict__ part, const float* __restrict__ weight,
                     const float* __restrict__ bias, float2* __restrict__ coef, long long hw, int C, int G,
                     long long chunk, int chunks, float eps) {
  extern __shared__ float4 smem4[];
  float* gmean = reinterpret_cast<float*>(smem4);
  float* grstd = gmean + G;
  const int n = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  const int cpg = C / G;
  for (int g = warp; g < G; g += warps) {
    Moments s{0.0f, 0.0f, 0.0f};
    for (int k = lane; k < chunks; k += 32) {
      const long long p0 = static_cast<long long>(k) * chunk;
      const long long cells = p0 < hw ? (hw - p0 < chunk ? hw - p0 : chunk) : 0;
      const float2 v = part[(static_cast<long long>(n) * chunks + k) * G + g];
      merge(s, static_cast<float>(cells * cpg), v.x, v.y);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float nb = __shfl_down_sync(0xffffffffu, s.n, o);
      const float mb = __shfl_down_sync(0xffffffffu, s.mean, o);
      const float m2b = __shfl_down_sync(0xffffffffu, s.m2, o);
      if (lane < o) merge(s, nb, mb, m2b);
    }
    if (lane == 0) {
      gmean[g] = s.mean;
      grstd[g] = rsqrtf(s.m2 / s.n + eps);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / cpg;
    const float a = grstd[g] * weight[c];
    coef[static_cast<long long>(n) * C + c] = make_float2(a, fmaf(-a, gmean[g], bias[c]));
  }
}

template <bool kRelu>
__device__ __forceinline__ uint4 apply_word(const uint4& w, const float* a, const float* b) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    float y0 = fmaf(a[2 * j], f.x, b[2 * j]);
    float y1 = fmaf(a[2 * j + 1], f.y, b[2 * j + 1]);
    if (kRelu) {  // NaN passes, as F.relu passes it
      y0 = y0 < 0.0f ? 0.0f : y0;
      y1 = y1 < 0.0f ? 0.0f : y1;
    }
    o[j] = __floats2bfloat162_rn(y0, y1);
  }
  return out;
}

template <bool kRelu>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gn_act_apply_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, const float2* __restrict__ coef,
                    long long hw, int C, long long chunk) {
  const int words = C / kVec;
  const int rows = blockDim.x / words;
  const int col = threadIdx.x % words, row = threadIdx.x / words;
  const long long p0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long p1 = p0 + chunk < hw ? p0 + chunk : hw;
  float a[kVec], b[kVec];
  const float4* k = reinterpret_cast<const float4*>(coef + static_cast<long long>(blockIdx.y) * C + col * kVec);
#pragma unroll
  for (int h = 0; h < kVec / 2; ++h) {
    const float4 t = k[h];
    a[2 * h] = t.x, b[2 * h] = t.y, a[2 * h + 1] = t.z, b[2 * h + 1] = t.w;
  }
  const long long base = static_cast<long long>(blockIdx.y) * hw * words + col;
  long long p = p0 + row;
  for (; p + (kUnroll - 1) * rows < p1; p += kUnroll * rows) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) w[u] = __ldg(x + base + (p + u * rows) * words);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) y[base + (p + u * rows) * words] = apply_word<kRelu>(w[u], a, b);
  }
  for (; p < p1; p += rows) y[base + p * words] = apply_word<kRelu>(__ldg(x + base + p * words), a, b);
}

}  // namespace

extern "C" {

// x, y: N frames of hw cells of C bf16 channels, channels-last, 16-byte
// aligned, C % 8 == 0 and 8 <= C <= 2048; weight, bias: C floats; groups
// divides C; relu 1 to apply the ReLU; chunks: the blocks a frame (the
// cells split into chunks of ceil(hw / chunks)); scratch: 16-byte aligned
// float32, 2 * N * chunks * groups rounded up to a multiple of 4, then 2 * N
// * C more. Launches on `stream`, which belongs to the caller's current
// device. Returns 0, a cudaError_t from a launch, or -1 for arguments the
// kernels do not take.
int gn_act_launch(const void* x, void* y, const void* weight, const void* bias, void* scratch, float eps, int N,
                  int C, long long hw, int groups, int relu, int chunks, void* stream) {
  if (N < 1 || N > 65535 || C < kVec || C > kMaxChannels || C % kVec || groups < 1 || C % groups || hw < 1 ||
      chunks < 1)
    return -1;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(scratch)) % 16)
    return -1;
  const int words = C / kVec;
  const int rows = kThreads / words;
  const int threads = rows * words;
  const long long chunk = (hw + chunks - 1) / chunks;
  const long long part_floats = (2LL * N * chunks * groups + 3) / 4 * 4;
  float2* part = static_cast<float2*>(scratch);
  float2* coef = reinterpret_cast<float2*>(static_cast<float*>(scratch) + part_floats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(chunks, N);

  gn_act_stats_kernel<<<grid, threads, 2 * sizeof(float) * rows * C, s>>>(static_cast<const uint4*>(x), part, hw,
                                                                          C, groups, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  gn_act_coeffs_kernel<<<N, kThreads, 2 * sizeof(float) * groups, s>>>(
      part, static_cast<const float*>(weight), static_cast<const float*>(bias), coef, hw, C, groups, chunk, chunks,
      eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (relu)
    gn_act_apply_kernel<true><<<grid, threads, 0, s>>>(static_cast<const uint4*>(x), static_cast<uint4*>(y), coef,
                                                       hw, C, chunk);
  else
    gn_act_apply_kernel<false><<<grid, threads, 0, s>>>(static_cast<const uint4*>(x), static_cast<uint4*>(y), coef,
                                                        hw, C, chunk);
  return static_cast<int>(cudaGetLastError());
}

const char* gn_act_error_string(int code) {
  if (code == -1) return "argument not supported by gn_act";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
