// Building blocks of the two scan kernels (ssm_scan.cu, rwkv6_wkv.cu):
// 3xTF32 tensor-core products on mma.sync, chunk loads into a
// double-buffered stage (16-byte cp.async for f32, converted register
// loads for bf16), and stores of two output elements.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

// x = hi + lo for 3xTF32, by integer operations at the full ALU rate
// (cvt.rna.tf32.f32 is a conversion, issued at a fraction of it): hi is x
// rounded to TF32 (10 mantissa bits, to nearest, ties away from zero: add
// half an ulp of TF32 to the magnitude's bits, then clear the low 13);
// x - hi is exact in f32 and lo is it truncated to TF32. hi + lo holds x
// to ~2^-21 relative.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                          uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d (16x8) += a (16x8, row) * b (8x8, col), TF32 operands, f32 sum.
// Fragments (lane l, g = l / 4, q = l % 4): a[0] (g, q), a[1] (g + 8, q),
// a[2] (g, q + 4), a[3] (g + 8, q + 4); b[0] (k q, n g), b[1] (k q + 4,
// n g); d[0] (g, 2q), d[1] (g, 2q + 1), d[2] (g + 8, 2q), d[3] (g + 8,
// 2q + 1).
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An f32 operand fragment split for 3xTF32.
template <int K>
struct Frag {
  uint32_t hi[K], lo[K];
  __device__ __forceinline__ void set(int i, float x) {
    split_tf32(x, hi[i], lo[i]);
  }
};

// 3xTF32: d += a b as hi*hi + hi*lo + lo*hi, the small terms first. The
// dropped lo*lo is ~2^-22 of the product: f32-grade, where one TF32
// product alone keeps ~2^-11.
__device__ __forceinline__ void mma3(float* d, const Frag<4>& a,
                                     const Frag<2>& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// 3xTF32 with the three products in separate accumulators (d, d1, d2,
// summed by the caller), so a chain of k-steps is a third as deep.
__device__ __forceinline__ void mma3_split(float* d, float* d1, float* d2,
                                           const Frag<4>& a,
                                           const Frag<2>& b) {
  mma_tf32(d2, a.lo, b.hi);
  mma_tf32(d1, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// 4-byte asynchronous copy global -> shared, zero-filled when src_bytes
// is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// A ROWS x COLS tile (row r at src + r * stride, unit column stride) into
// f32 shared memory at dst (row stride ld floats), by the NT threads of a
// block; rows >= valid are zero-filled. Each thread keeps one column
// piece and walks down the rows NT / pieces-per-row apart, so its
// addresses are one base and constant steps. f32 goes by 16-byte cp.async
// (committed by the caller); bf16 by 16-byte register loads converted to
// f32 on the way. Needs src, stride and ld aligned to 16 bytes.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src, int64_t stride,
                                          int valid, int tid) {
  constexpr int PPR = COLS / 4, RSTEP = NT / PPR;
  static_assert(COLS % 4 == 0 && NT % PPR == 0, "tile shape");
  const int r0 = tid / PPR, c = 4 * (tid % PPR);
  const float* s = src + r0 * stride + c;
#pragma unroll
  for (int k = 0; k * RSTEP < ROWS; ++k) {
    const int r = r0 + k * RSTEP;
    if (ROWS % RSTEP == 0 || r < ROWS) {
      const bool in = r < valid;
      cp_async16(dst + r * ld + c, in ? s + k * RSTEP * stride : src,
                 in ? 16 : 0);
    }
  }
}

template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const __nv_bfloat16* src,
                                          int64_t stride, int valid,
                                          int tid) {
  constexpr int PPR = COLS / 8, RSTEP = NT / PPR;
  static_assert(COLS % 8 == 0 && NT % PPR == 0, "tile shape");
  const int r0 = tid / PPR, c = 8 * (tid % PPR);
#pragma unroll
  for (int k = 0; k * RSTEP < ROWS; ++k) {
    const int r = r0 + k * RSTEP;
    if (ROWS % RSTEP == 0 || r < ROWS) {
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (r < valid)
        raw = *reinterpret_cast<const uint4*>(src + r * stride + c);
      const __nv_bfloat162* h =
          reinterpret_cast<const __nv_bfloat162*>(&raw);
      float4* out = reinterpret_cast<float4*>(dst + r * ld + c);
      const float2 f0 = __bfloat1622float2(h[0]);
      const float2 f1 = __bfloat1622float2(h[1]);
      const float2 f2 = __bfloat1622float2(h[2]);
      const float2 f3 = __bfloat1622float2(h[3]);
      out[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
      out[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
    }
  }
}

// Two neighbouring output elements.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
