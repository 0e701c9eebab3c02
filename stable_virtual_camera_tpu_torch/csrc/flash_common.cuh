// What the flash-attention sources share besides the Hopper primitives of
// sm90.cuh: the head dim, the bf16 packing of two fp32 values, and the error
// string every library exports.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace svc {

constexpr int kD = 64;  // head dim

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace svc

extern "C" const char* svc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
