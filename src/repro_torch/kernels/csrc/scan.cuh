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

// Fragment loads of the scan backwards (ssm_scan_bwd.cu, rwkv6_wkv_bwd.cu)
// from f32 shared memory, split for 3xTF32. `p` points at the tile's
// (row 0, k 0) element; `ld` is the row stride in floats. "perm" loads
// take k-index q from column 2q and q + 4 from 2q + 1 of each 8, by one
// 8-byte load; the two operands of a product must agree on it. With a row
// stride of 8 mod 32 words, the 8-byte loads and the scalar k-major loads
// are free of bank conflicts; a k-major perm load has two-way conflicts.
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// A (16 x 8): element (m, k) at p[m * ld + k], permuted.
__device__ __forceinline__ void frag_a_perm(Frag<4>& a, const float* p,
                                            int ld, int g, int q) {
  const float2 r0 = ld2(p + g * ld + 2 * q);
  const float2 r1 = ld2(p + (g + 8) * ld + 2 * q);
  a.set(0, r0.x), a.set(1, r1.x), a.set(2, r0.y), a.set(3, r1.y);
}

// A (16 x 8): element (m, k) at p[k * ld + m].
__device__ __forceinline__ void frag_a_kmaj(Frag<4>& a, const float* p,
                                            int ld, int g, int q) {
  a.set(0, p[q * ld + g]), a.set(1, p[q * ld + g + 8]);
  a.set(2, p[(q + 4) * ld + g]), a.set(3, p[(q + 4) * ld + g + 8]);
}

// B (8 x 8): element (k, n) at p[n * ld + k], permuted.
__device__ __forceinline__ void frag_b_perm(Frag<2>& b, const float* p,
                                            int ld, int g, int q) {
  const float2 v = ld2(p + g * ld + 2 * q);
  b.set(0, v.x), b.set(1, v.y);
}

// B (8 x 8): element (k, n) at p[k * ld + n].
__device__ __forceinline__ void frag_b_kmaj(Frag<2>& b, const float* p,
                                            int ld, int g, int q) {
  b.set(0, p[q * ld + g]), b.set(1, p[(q + 4) * ld + g]);
}

// B (8 x 8): element (k, n) at p[k * ld + n], permuted.
__device__ __forceinline__ void frag_b_kmaj_perm(Frag<2>& b, const float* p,
                                                 int ld, int g, int q) {
  b.set(0, p[2 * q * ld + g]), b.set(1, p[(2 * q + 1) * ld + g]);
}

// Sum over the four lanes of a quad (the lanes sharing g).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
