// Shared helpers of the port's kernels: element conversions for the two
// input types (float32, bfloat16), the 4-D stride record the kernels read
// their operands through, and the C export macro.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define EXPORT extern "C" __attribute__((visibility("default")))

// Logit given to a key masked by position, as in the reference kernels.
// A key past the end of the sequence gets -inf instead and weighs nothing.
constexpr float kNegInf = -1e30f;

// Element strides of a 4-D operand, in the reference kernels' axis order
// ([B, H, T, hd] for attention, [B, KV, G|S, hd] for decode; the scans'
// [B, T, H, hd] operands are given in the same (b, h, t, d) order).
struct Strides {
  int64_t b, h, t, d;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// Raise a kernel's dynamic shared-memory limit to `bytes` once per device,
// not on every launch: `done` is the caller's static bit mask of devices.
template <typename K>
cudaError_t set_smem_once(K kernel, int bytes, unsigned long long* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (*done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done |= bit;
  return err;
}

// dtype codes passed from Python.
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };
