// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel takes one element type T for all its tensor operands: bf16
// (through the tensor cores, fp32 accumulation) or fp32 (plain FMA in full
// fp32, no TF32).  The C entry points return the launch's cudaGetLastError()
// as an int; the Python wrapper raises on anything but 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vt {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch and XLA
}

// Activation codes shared with the Python wrappers.
enum Act { kGeluErf = 0, kGeluTanh = 1, kRelu = 2 };

__device__ __forceinline__ float activate(float x, int act) {
  if (act == kGeluErf) return x * (erff(x * 0.70710678118654752440f) + 1.0f) * 0.5f;
  if (act == kGeluTanh) {
    const float k = 0.79788456080286535588f;  // sqrt(2/pi)
    return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
  }
  return fmaxf(x, 0.0f);
}

enum Dtype { kF32 = 0, kBF16 = 1 };

}  // namespace vt

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
