// Grouped int8 GEMM for the W8A8 experts: out[e] = a[e] @ b[e] for every
// expert e, int8 x int8 -> int32, for Hopper (sm_90a).
//
// Not a port of a TPU kernel: the reference computes these products as XLA
// einsums (repro/models/moe.py, `_w8a8_ffn`: the three
// einsum(..., preferred_element_type=int32)). PyTorch has no batched int8
// product on CUDA (torch.bmm has no integer kernel; torch._int_mm is 2-D
// and wants more than 16 rows, while a decode step gives each expert one),
// so the port has its own.
//
// What it computes: a [E, C, K] int8 and b [E, K, N] int8, read through
// their strides (unit stride on the last axis), into out [E, C, N] int32
// (contiguous). Integer products summed in int32 are exact: |sum| <=
// K * 128^2 < 2^31 for K < 131072, which the wrapper checks.
//
// What bounds it on the H100: each expert's b is read once per 64-row tile
// of a, for 2 C operations per byte of b. The int8 tensor cores' ridge is
// 1,979 TOP/s over 3.35 TB/s, ~590 operations a byte, so a decode step
// (C = 1) and kimi-k2's prefill (C = 208) are bound by the bytes of b, and
// llama4-scout's prefill (C = 624) by the operations.
//
// Design (simple first): one block of 4 warps per (128-column tile, 64-row
// tile, expert). 64-deep k slices of a (64 x 64 bytes) and b (64 x 128
// bytes) stream by 16-byte cp.async into a 3-stage ring in shared memory
// (two slices in flight while one is used; zero fill past C, K and N).
// Each warp owns 32 columns of all 64 rows and runs
// mma.sync.m16n8k32.s32.s8.s8.s32 on them, skipping its 16-row tiles past
// C (at C = 1 it runs one of four).
//  * The a fragment holds 4 consecutive k of one row per register: one
//    32-bit shared load, since a is k-contiguous.
//  * The b fragment also wants 4 consecutive k of one column per register,
//    but b is n-contiguous. Each thread loads one 32-bit word (4 columns)
//    from each of 4 k rows and transposes the 4 x 4 bytes in registers
//    (__byte_perm), which gives it 4 columns' fragments. For those to be
//    the columns its fragments need, a warp's columns are permuted: column
//    l of n8-tile j is column 4 l + j of the warp's 32. The permutation
//    makes each thread's 8 output columns of a row consecutive, so the
//    epilogue writes them as two 16-byte stores.
//  * The ring is XOR-swizzled by 16-byte chunk (a: by row pair, b: by
//    4-row group), so the fragment loads of a warp hit 32 distinct banks
//    while the cp.async destinations stay 16-byte chunks.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BM = 64;        // rows of a (and out) per block
constexpr int BN = 128;       // columns of b (and out) per block
constexpr int BK = 64;        // k per ring stage
constexpr int STAGES = 3;
constexpr int THREADS = 128;  // 4 warps, 32 columns each
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// w[i] holds bytes (i, 0..3) of a 4 x 4 byte block; on return v[j] holds
// bytes (0..3, j), row 0 in the lowest byte.
__device__ __forceinline__ void transpose4x4(const uint32_t* w, uint32_t* v) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  v[0] = __byte_perm(lo01, lo23, 0x5410);
  v[1] = __byte_perm(lo01, lo23, 0x7632);
  v[2] = __byte_perm(hi01, hi23, 0x5410);
  v[3] = __byte_perm(hi01, hi23, 0x7632);
}

// Byte offset of 16-byte chunk `ch` of row `r` in an a stage (64-byte rows,
// chunks swizzled by row pair) and in a b stage (128-byte rows, chunk
// pairs swizzled by 4-row group).
__device__ __forceinline__ int a_chunk(int r, int ch) {
  return r * BK + ((ch ^ ((r >> 1) & 3)) << 4);
}
__device__ __forceinline__ int b_chunk(int r, int ch) {
  return r * BN + ((ch ^ (((r >> 2) & 3) << 1)) << 4);
}

__global__ void __launch_bounds__(THREADS)
    int8_gmm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                    int32_t* __restrict__ out, int C, int K, int N,
                    int64_t sa_e, int64_t sa_c, int64_t sb_e, int64_t sb_k,
                    int64_t so_e, int64_t so_c) {
  __shared__ __align__(128) int8_t sa[STAGES][BM * BK];
  __shared__ __align__(128) int8_t sb[STAGES][BK * BN];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int8_t* ae = a + blockIdx.z * sa_e;
  const int8_t* be = b + blockIdx.z * sb_e;
  const int rows = min(BM, C - m0);
  const int n_k = (K + BK - 1) / BK;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < BM * BK / 16 / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c >> 2, ch = c & 3, k = k0 + ch * 16;
      const bool ok = r < rows && k < K;
      cp_async16(&sa[stage][a_chunk(r, ch)],
                 ok ? ae + (int64_t)(m0 + r) * sa_c + k : ae, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < BK * BN / 16 / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c >> 3, ch = c & 7, k = k0 + r, n = n0 + ch * 16;
      const bool ok = k < K && n < N;
      cp_async16(&sb[stage][b_chunk(r, ch)],
                 ok ? be + (int64_t)k * sb_k + n : be, ok ? 16 : 0);
    }
  };

  int acc[4][4][4];  // [16-row tile][n8 tile][fragment]
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice kt landed; the stage read at kt - 1 is free
    if (kt + STAGES - 1 < n_k) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const int8_t* As = sa[kt % STAGES];
    const int8_t* Bs = sb[kt % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      // b fragments of the warp's 4 n8 tiles: rows kk + 16 h + 4 t + i,
      // columns 4 g .. 4 g + 3 of the warp's 32 (word 8 warp + g of the
      // row, swizzled by the row's 4-row group, which is t).
      uint32_t bf[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w[4], v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = kk + 16 * h + 4 * t + i;
          const int word = (warp * 8 + g) ^ (t << 3);
          w[i] = *reinterpret_cast<const uint32_t*>(Bs + r * BN + word * 4);
        }
        transpose4x4(w, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) bf[j][h] = v[j];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt * 16 >= rows) break;  // warp-uniform
        // a fragment: rows mt 16 + g (+ 8), k words kk / 4 + t (+ 4).
        uint32_t af[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = mt * 16 + g + 8 * (q & 1);
          const int kw = kk / 4 + 4 * (q >> 1) + t;
          af[q] = *reinterpret_cast<const uint32_t*>(
              As + a_chunk(r, kw >> 2) + (kw & 3) * 4);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[mt][j], af, bf[j]);
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue: fragment c0/c1 of n8 tile j is column 2 t / 2 t + 1 of the
  // tile, i.e. columns 8 t + j / 8 t + 4 + j of the warp's 32; c2/c3 the
  // same for row g + 8.
  const int col = n0 + warp * 32 + 8 * t;
  if (col >= N) return;
  int32_t* oe = out + blockIdx.z * so_e + col;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 16 + g + 8 * half;
      if (r >= rows) continue;
      int4* dst = reinterpret_cast<int4*>(oe + (int64_t)(m0 + r) * so_c);
      dst[0] = make_int4(acc[mt][0][2 * half], acc[mt][1][2 * half],
                         acc[mt][2][2 * half], acc[mt][3][2 * half]);
      dst[1] = make_int4(acc[mt][0][2 * half + 1], acc[mt][1][2 * half + 1],
                         acc[mt][2][2 * half + 1], acc[mt][3][2 * half + 1]);
    }
  }
}

}  // namespace

// a [E, C, K] int8 with strides (sa_e, sa_c, 1), b [E, K, N] int8 with
// strides (sb_e, sb_k, 1), out [E, C, N] int32 with strides (so_e, so_c, 1).
// K and N are multiples of 16, bases and strides 16-byte aligned (the
// wrapper checks both). Returns a cudaError_t.
EXPORT int int8_grouped_matmul_fwd(const void* a, const void* b, void* out,
                                   int E, int C, int K, int N, int64_t sa_e,
                                   int64_t sa_c, int64_t sb_e, int64_t sb_k,
                                   int64_t so_e, int64_t so_c, void* stream) {
  if (E <= 0 || E > 65535 || C <= 0 || K <= 0 || N <= 0 || K % 16 ||
      N % 16 || K >= 131072 || (C + BM - 1) / BM > MAX_GRID_Y || so_c % 4)
    return cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (C + BM - 1) / BM, E);
  int8_gmm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<int32_t*>(out), C, K, N, sa_e, sa_c, sb_e, sb_k, so_e,
      so_c);
  return cudaGetLastError();
}
