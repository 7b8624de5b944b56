// Peak rate of the legacy warp-level tensor-core instruction (mma.sync) on
// this card, for TF32 m16n8k8 (what the scan kernels issue, three per f32
// product) and bf16 m16n8k16, at 4, 8 and 16 warps per SM, each warp
// running 8 independent accumulator chains.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_rate tools/mma_rate.cu
//   ./mma_rate
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>

template <bool TF32>
__global__ void chains(float* out, int iters) {
  float d[8][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(blockIdx.x * 1e-3f + i);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (TF32)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  float* out = nullptr;
  cudaMalloc(&out, (size_t)sms * 2 * 512 * sizeof(float));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 4096;
  printf("%s, %d SMs\n", prop.name, sms);
  for (int warps : {4, 8, 16}) {
    for (int tf32 = 1; tf32 >= 0; --tf32) {
      // Two blocks per SM, warps / 2 warps each.
      const dim3 grid(sms * 2), block(warps * 16);
      auto run = [&] {
        if (tf32) chains<true><<<grid, block>>>(out, iters);
        else chains<false><<<grid, block>>>(out, iters);
      };
      run();
      cudaDeviceSynchronize();
      cudaEventRecord(e0);
      run();
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms = 0.f;
      cudaEventElapsedTime(&ms, e0, e1);
      const double mmas = (double)grid.x * (warps / 2) * iters * 8;
      const double flop = mmas * (tf32 ? 2048.0 : 4096.0);
      printf("%-14s %2d warps/SM: %8.3f ms, %7.1f TFLOP/s, %.3e mma/s\n",
             tf32 ? "tf32 m16n8k8" : "bf16 m16n8k16", warps, ms,
             flop / (ms * 1e-3) / 1e12, mmas / (ms * 1e-3));
    }
  }
  const cudaError_t err = cudaGetLastError();
  printf("%s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
