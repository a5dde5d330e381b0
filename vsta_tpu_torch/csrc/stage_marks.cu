// Stage markers: one empty kernel a stage of a request, launched at the
// stage's start (`utils/tracing.py`'s `mark`), so that a device trace names
// the stages of a replayed CUDA graph, in which no Python runs.
//
// Replaces no TPU kernel: a marker does no work. Each costs one kernel
// node of a graph, or one launch in an eager call: its launch latency and
// about a microsecond of device time, bound by neither bytes nor
// operations. Each kernel is `extern "C"`, so a profiler shows its name
// unmangled: `vsta_stage_<stage>`, in the order of `tracing.STAGES`.

#include <cuda_runtime.h>

extern "C" {

__global__ void vsta_stage_encoder() {}
__global__ void vsta_stage_fusion() {}
__global__ void vsta_stage_head() {}
__global__ void vsta_stage_decode() {}
__global__ void vsta_stage_end() {}

// Launches stage `stage`'s marker (its index in `tracing.STAGES`) as one
// thread on `stream`, which belongs to the caller's current device.
// Returns 0, a cudaError_t from the launch, or -1 for an unknown stage.
int stage_mark_launch(int stage, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: vsta_stage_encoder<<<1, 1, 0, s>>>(); break;
    case 1: vsta_stage_fusion<<<1, 1, 0, s>>>(); break;
    case 2: vsta_stage_head<<<1, 1, 0, s>>>(); break;
    case 3: vsta_stage_decode<<<1, 1, 0, s>>>(); break;
    case 4: vsta_stage_end<<<1, 1, 0, s>>>(); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* stage_mark_error_string(int code) {
  if (code == -1) return "unknown stage";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
