// Eval-mode BatchNorm and the activation after it, in one pass over a
// bfloat16 map:
//
//     y = round_bf16((x - mean[c]) * (weight[c] / sqrt(var[c] + eps)) + bias[c])
//     y = round_bf16(silu(y))                        (where the caller asks)
//
// x and y [N, C, H, W], both NCHW-contiguous or both channels-last
// (NHWC) contiguous; the four per-channel vectors float32.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the normalisation and the
// activation into the convolution's epilogue. On the card the eval path
// ran four passes: a cast to float32, cuDNN's float32 BatchNorm, a cast
// back and a SiLU, 24 bytes of traffic a bf16 element (20 without the
// SiLU); this kernel reads and writes each element once, 4 bytes.
//
// Bound on an H100: memory bytes, 4 a element at 3.35 TB/s. The flagship's
// batch-16 request runs 15 of them over 1,325.7 M elements (5.3 GB,
// 1.58 ms); the largest, stage 1's first expansion, 348 M (0.42 ms).
//
// Rounding, as the four passes did it: the arithmetic is float32, in
// Flax's order (the difference, the product by weight * rsqrt, the bias;
// each rounded on its own, no fused multiply-add), the result rounded to
// bf16; the SiLU, x / (1 + exp(-x)) with the accurate expf and an IEEE
// division as PyTorch's own SiLU on a bf16 tensor computes it, takes that
// bf16 value and is rounded to bf16 again. Build without fast math.
//
// Design: a grid-stride loop sized to the card (the launcher's `grid`), a
// block computes the C channels' mean, multiplier and bias once into
// shared memory. Where the layout allows (channels-last with C % 8 == 0,
// NCHW with H * W % 8 == 0, both pointers 16-byte aligned) a thread takes
// 8 elements at once with one 16-byte load and one 16-byte store; else one
// element at a time. Channels-last, the grid's stride is a multiple of the
// C / 8 channel groups, so a thread meets one group only and keeps its 24
// coefficients in registers: the loop reads no shared memory (a reading
// a word, 8 lanes 32 bytes apart, would conflict 8 ways). No atomics: two launches are bit-equal. The kernels
// launch on the caller's stream, so a CUDA graph captures them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;              // bf16 elements in 16 bytes
constexpr int kMaxChannels = 4096;   // 3 * 4096 floats: the 48 KB of shared memory a block has by default

struct Coeffs {
  const float* mean;
  const float* mul;
  const float* bias;
};

// Fills shared memory with each channel's mean, weight / sqrt(var + eps)
// and bias; returns pointers into it.
__device__ __forceinline__ Coeffs load_coeffs(float* s, const float* __restrict__ mean,
                                              const float* __restrict__ var, const float* __restrict__ weight,
                                              const float* __restrict__ bias, float eps, int C) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    s[c] = mean[c];
    s[C + c] = __fmul_rn(__fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var[c], eps))), weight[c]);
    s[2 * C + c] = bias[c];
  }
  __syncthreads();
  return Coeffs{s, s + C, s + 2 * C};
}

template <bool kSilu>
__device__ __forceinline__ __nv_bfloat16 bn_act_one(float x, float mean, float mul, float bias) {
  const float t = __fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), bias);
  __nv_bfloat16 r = __float2bfloat16_rn(t);
  if (kSilu) {
    const float v = __bfloat162float(r);
    r = __float2bfloat16_rn(__fdiv_rn(v, __fadd_rn(1.0f, expf(-v))));
  }
  return r;
}

// 8 elements of one 16-byte word, all of channel c (NCHW).
template <bool kSilu>
__device__ __forceinline__ uint4 bn_act_word(uint4 raw, const Coeffs& k, int c) {
  const __nv_bfloat16* in = reinterpret_cast<const __nv_bfloat16*>(&raw);
  uint4 out;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&out);
  const float m = k.mean[c], mul = k.mul[c], b = k.bias[c];
#pragma unroll
  for (int j = 0; j < kVec; ++j) o[j] = bn_act_one<kSilu>(__bfloat162float(in[j]), m, mul, b);
  return out;
}

// The 8 channels of group g (channels 8g .. 8g + 7), in registers.
struct Group {
  float mean[kVec], mul[kVec], bias[kVec];
};

__device__ __forceinline__ void load_group(Group& r, const Coeffs& k, int g) {
#pragma unroll
  for (int h = 0; h < kVec; h += 4) {
    const float4 m = *reinterpret_cast<const float4*>(k.mean + g * kVec + h);
    const float4 u = *reinterpret_cast<const float4*>(k.mul + g * kVec + h);
    const float4 b = *reinterpret_cast<const float4*>(k.bias + g * kVec + h);
    r.mean[h] = m.x, r.mean[h + 1] = m.y, r.mean[h + 2] = m.z, r.mean[h + 3] = m.w;
    r.mul[h] = u.x, r.mul[h + 1] = u.y, r.mul[h + 2] = u.z, r.mul[h + 3] = u.w;
    r.bias[h] = b.x, r.bias[h + 1] = b.y, r.bias[h + 2] = b.z, r.bias[h + 3] = b.w;
  }
}

// Channels-last, 8 elements a thread: word v holds the channels of group
// v % (C / 8). The launcher makes the grid's stride a multiple of C / 8
// wherever a thread takes more than one word, so a thread's group, and
// the 24 coefficients it keeps in registers, stay the same all through
// its loop (else it moves the group on and reloads them).
template <bool kSilu>
__global__ void __launch_bounds__(kThreads)
bn_act_nhwc_vec_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, const float* __restrict__ mean,
                       const float* __restrict__ var, const float* __restrict__ weight,
                       const float* __restrict__ bias, float eps, long long words, int C) {
  extern __shared__ float4 smem[];
  const Coeffs k = load_coeffs(reinterpret_cast<float*>(smem), mean, var, weight, bias, eps, C);
  const int groups = C / kVec;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int step = static_cast<int>(stride % groups);
  long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int g = static_cast<int>(v % groups);
  Group r;
  load_group(r, k, g);
  for (; v < words; v += stride) {
    const uint4 raw = __ldg(x + v);
    const __nv_bfloat16* in = reinterpret_cast<const __nv_bfloat16*>(&raw);
    uint4 out;
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
    for (int j = 0; j < kVec; ++j) o[j] = bn_act_one<kSilu>(__bfloat162float(in[j]), r.mean[j], r.mul[j], r.bias[j]);
    y[v] = out;
    if (step) {
      g += step;
      if (g >= groups) g -= groups;
      load_group(r, k, g);
    }
  }
}

// NCHW, 8 elements a thread: a word lies inside one channel's plane
// (plane % 8 == 0), channel (v / (plane / 8)) % C.
template <bool kSilu>
__global__ void __launch_bounds__(kThreads)
bn_act_nchw_vec_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, const float* __restrict__ mean,
                       const float* __restrict__ var, const float* __restrict__ weight,
                       const float* __restrict__ bias, float eps, long long words, int C, long long plane) {
  extern __shared__ float4 smem[];
  const Coeffs k = load_coeffs(reinterpret_cast<float*>(smem), mean, var, weight, bias, eps, C);
  const long long plane_words = plane / kVec;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; v < words; v += stride)
    y[v] = bn_act_word<kSilu>(__ldg(x + v), k, static_cast<int>((v / plane_words) % C));
}

// Any dense layout, one element a thread: channel (i / inner) % C, inner
// 1 channels-last and H * W for NCHW.
template <bool kSilu>
__global__ void __launch_bounds__(kThreads)
bn_act_scalar_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y,
                     const float* __restrict__ mean, const float* __restrict__ var,
                     const float* __restrict__ weight, const float* __restrict__ bias, float eps, long long n,
                     int C, long long inner) {
  extern __shared__ float4 smem[];
  const Coeffs k = load_coeffs(reinterpret_cast<float*>(smem), mean, var, weight, bias, eps, C);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int c = static_cast<int>((i / inner) % C);
    y[i] = bn_act_one<kSilu>(__bfloat162float(x[i]), k.mean[c], k.mul[c], k.bias[c]);
  }
}

template <bool kSilu>
int launch(const void* x, void* y, const float* mean, const float* var, const float* weight, const float* bias,
           float eps, long long n, int C, long long plane, int channels_last, int vec, int grid, cudaStream_t s) {
  const size_t smem = 3 * sizeof(float) * static_cast<size_t>(C);
  if (vec && channels_last) {
    // a stride of a multiple of C / 8 words keeps each thread on one group
    const int groups = C / kVec;
    if (static_cast<long long>(grid) * kThreads < n / kVec) {
      int a = groups, b = kThreads;
      while (b) {
        const int t = a % b;
        a = b, b = t;
      }
      const int q = groups / a;  // groups / gcd(groups, kThreads)
      grid = grid >= q ? grid / q * q : q;
    }
    bn_act_nhwc_vec_kernel<kSilu><<<grid, kThreads, smem, s>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(y), mean, var, weight, bias, eps, n / kVec, C);
  } else if (vec) {
    bn_act_nchw_vec_kernel<kSilu><<<grid, kThreads, smem, s>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(y), mean, var, weight, bias, eps, n / kVec, C, plane);
  } else {
    bn_act_scalar_kernel<kSilu><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), mean, var, weight, bias, eps, n,
        C, channels_last ? 1 : plane);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: n bf16 elements of C channels, planes of `plane` = H * W elements;
// channels_last 1 for NHWC, 0 for NCHW; vec 1 for 16-byte words (x and y
// 16-byte aligned, and C % 8 == 0 channels-last or plane % 8 == 0 NCHW);
// silu 1 to apply SiLU after the normalisation; grid: the number of
// blocks of 256 threads. Launches on `stream`, which belongs to the
// caller's current device. Returns 0, a cudaError_t from the launch, or
// -1 for arguments the kernels do not take.
int bn_act_launch(const void* x, void* y, const void* mean, const void* var, const void* weight, const void* bias,
                  float eps, long long n, int C, long long plane, int channels_last, int silu, int vec, int grid,
                  void* stream) {
  if (n <= 0 || C < 1 || C > kMaxChannels || plane < 1 || grid < 1 || n % (static_cast<long long>(C) * plane))
    return -1;
  if (vec) {
    const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0;
    if (!aligned || (channels_last ? C % kVec : plane % kVec) != 0) return -1;
  }
  const float* m = static_cast<const float*>(mean);
  const float* v = static_cast<const float*>(var);
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return silu ? launch<true>(x, y, m, v, w, b, eps, n, C, plane, channels_last, vec, grid, s)
              : launch<false>(x, y, m, v, w, b, eps, n, C, plane, channels_last, vec, grid, s);
}

const char* bn_act_error_string(int code) {
  if (code == -1) return "argument not supported by bn_act";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
