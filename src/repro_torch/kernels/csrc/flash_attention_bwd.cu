// Flash attention backward: dQ, dK and dV of causal grouped-query attention
// with an online softmax, for Hopper (sm_90a).
//
// Replaces: nothing on the TPU side. The reference trains by differentiating
// its XLA attention twin (repro/training/train_loop.py via jax.value_and_grad);
// none of its Pallas kernels has a backward. This is the backward of
// flash_attention.cu (which replaces repro/kernels/flash_attention/kernel.py,
// `flash_attention`), for the port's training path.
//
// What it computes, per (b, h), with s = q k^T / sqrt(hd) masked as the
// forward masks it (k_pos <= q_pos and, with window > 0, k_pos > q_pos -
// window; masked logits are the constant -1e30), P = exp(s - lse) from the
// forward's natural-log LSE and D = rowsum(dO * O):
//     dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),
//     dQ = dS K / sqrt(hd),  dK = dS^T Q / sqrt(hd),
// dK and dV summed over the G query heads of each KV head. A row with no
// admissible key (LSE +inf, the forward's mark) took the uniform average of
// v over all Tk keys: it gives every key dV += dO / Tk, and nothing to dQ or
// dK, since all its logits are the constant -1e30.
//
// What bounds it on the H100: five products of 2 * Tq * Tk * hd operations
// per head over the admitted (query, key) pairs, against reading q, k, v, o,
// dO once and writing dq, dk, dv once: at training lengths (T 2048) ~T/2
// operations per byte, far above the ~295 FLOP/byte ridge, so bf16 is bound
// by the tensor cores' 989 TFLOP/s.
//
// Design (simple and deterministic; no float atomics anywhere, so two runs
// give bit-identical gradients):
//  1. bwd_prep_kernel: D = rowsum(dO * O) in f32 per query row; per 32-row
//     query tile whether a row of it is lost (LSE +inf), per (b, h); per
//     32-row query tile and 64-key tile the min and max position, which the
//     two main kernels read to skip tiles whose every pair is masked.
//  2. dK/dV: one block per (64-key tile, KV head, b), 4 warps of 16 keys.
//     It loops over the G query heads and the query tiles the causal/window
//     bound admits (a tile with a lost row is always admitted), recomputes
//     S^T = K Q^T and dP^T = V dO^T, forms P^T and dS^T in registers and
//     accumulates dV += P^T dO and dK += dS^T Q in registers; dK and dV are
//     written once. GQA therefore needs no atomics.
//  3. dQ: one block per (64-row query tile, head, b), 4 warps of 16 rows,
//     looping over the admitted 64-key tiles: S = Q K^T, dP = dO V^T, dS,
//     dQ += dS K; written once.
//  bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate) with ldmatrix
//  fragments; the block's own tile (K and V, or Q and dO) is loaded once,
//  the streamed tiles are double-buffered by 16-byte cp.async (zero-filled
//  past the ragged end); P and dS are rounded to bf16 as mma operands, as
//  the forward rounds P. Rows of shared tiles are padded by 16 bytes, so the
//  8 rows an ldmatrix reads hit distinct banks.
//  f32: scalar IEEE f32 FMAs on the CUDA cores (no TF32: the f32 checks hold
//  it at 2e-5), 16 x 16 threads over 64 x 32 tiles; it exists for the tight
//  checks, not for speed.
// Head dims 64 and 128. Operands are read through their strides (unit last
// stride; the bf16 path needs 16-byte-aligned bases and strides).

#include <climits>
#include <math.h>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int PREP_ROWS = 32;   // query rows per prep block and per lost flag
constexpr int KT = 64;          // keys per tile (dK/dV blocks, dQ's tiles)
constexpr int QT = 64;          // query rows per dQ block
constexpr float kLog2e = 1.4426950408889634f;

// Position range [lo, hi] of a tile, INT_MAX / INT_MIN when it is empty.
struct Range {
  int lo, hi;
};

// Whether some (query, key) pair of a query range and a key range is
// admissible under the causal/window bound.
__device__ __forceinline__ bool admits(Range q, Range k, int window) {
  if (q.lo > q.hi || k.lo > k.hi) return false;
  if (k.lo > q.hi) return false;
  if (window > 0 && (long long)k.hi <= (long long)q.lo - window) return false;
  return true;
}

__device__ __forceinline__ bool admissible(int kp, int qp, int window) {
  return kp <= qp && (window <= 0 || kp > qp - window);
}

// ------------------------------------------------------------------- prep

// grid (max(#32-row query tiles, #64-key tiles), H, B), 256 threads: D and
// the lost flags of 32 query rows of (b, h); blocks of (h, b) = (0, 0) also
// record the position ranges of query tile x and key tile x.
template <typename T, int HD>
__global__ void __launch_bounds__(256) bwd_prep_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ Dsum,
    int* __restrict__ lost, int* __restrict__ qrange,
    int* __restrict__ krange, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, int Tq, int Tk, Strides so,
    Strides sdo) {
  const int x = blockIdx.x, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_qt = (Tq + PREP_ROWS - 1) / PREP_ROWS;
  const int n_kt = (Tk + KT - 1) / KT;
  if (h == 0 && b == 0 && warp == 0) {
    if (x < n_qt) {
      const int r = x * PREP_ROWS + lane;
      const bool in = r < Tq;
      const int p = in ? q_pos[r] : 0;
      const int lo = __reduce_min_sync(0xffffffffu, in ? p : INT_MAX);
      const int hi = __reduce_max_sync(0xffffffffu, in ? p : INT_MIN);
      if (lane == 0) {
        qrange[2 * x] = lo;
        qrange[2 * x + 1] = hi;
      }
    }
    if (x < n_kt) {
      int lo = INT_MAX, hi = INT_MIN;
      for (int j = lane; j < KT; j += 32) {
        const int kk = x * KT + j;
        if (kk < Tk) {
          lo = min(lo, k_pos[kk]);
          hi = max(hi, k_pos[kk]);
        }
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if (lane == 0) {
        krange[2 * x] = lo;
        krange[2 * x + 1] = hi;
      }
    }
  }
  if (x >= n_qt) return;       // uniform per block
  const int64_t bh = (int64_t)b * H + h;
  int my_lost = 0;
  // 8 warps x 4 rows; lanes over the head dim.
  for (int rr = 0; rr < PREP_ROWS / 8; ++rr) {
    const int r = x * PREP_ROWS + warp * (PREP_ROWS / 8) + rr;
    if (r >= Tq) break;
    const T* orow = o + b * so.b + h * so.h + r * so.t;
    const T* drow = dout + b * sdo.b + h * sdo.h + r * sdo.t;
    float acc = 0.f;
#pragma unroll
    for (int d = lane; d < HD; d += 32)
      acc = fmaf(to_float(orow[d]), to_float(drow[d]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      Dsum[bh * Tq + r] = acc;
      if (isinf(lse[bh * Tq + r])) my_lost = 1;
    }
  }
  const int any_lost = __syncthreads_or(my_lost);
  if (tid == 0) lost[bh * n_qt + x] = any_lost;
}

// Position range of query rows [r0, r0 + n) from the 32-row prep ranges
// (r0 and n multiples of 32), and whether a row of them is lost in head bh.
__device__ __forceinline__ Range q_tiles(const int* qrange, const int* lost,
                                         int64_t bh, int n_qt32, int r0,
                                         int n, bool* any_lost) {
  Range q{INT_MAX, INT_MIN};
  bool l = false;
  for (int x = r0 / PREP_ROWS; x < (r0 + n) / PREP_ROWS && x < n_qt32; ++x) {
    q.lo = min(q.lo, qrange[2 * x]);
    q.hi = max(q.hi, qrange[2 * x + 1]);
    l |= lost[bh * n_qt32 + x] != 0;
  }
  *any_lost = l;
  return q;
}

// ------------------------------------------------------------ bf16 kernels

template <int HD>
struct BCfg {
  static constexpr int LD = HD + 8;            // padded shared row (bf16)
  static constexpr int C = HD / 8;             // 16-byte chunks per row
  static constexpr int KS = HD / 16;           // 16-deep steps over hd
  static constexpr int NO = HD / 8;            // 8-column tiles over hd
  // dK/dV: query rows per streamed tile (register budget: dK and dV take
  // HD / 2 registers each per thread, S^T and dP^T BQ / 2 each).
  static constexpr int BQ = HD > 64 ? 32 : 64;
  static constexpr int KV_SMEM =
      2 * KT * LD * 2                          // K, V tiles of the block
      + 2 * 2 * BQ * LD * 2                    // Q, dO: two stages each
      + 2 * BQ * (4 + 4 + 4);                  // lse, D, q_pos per stage
  static constexpr int Q_SMEM =
      2 * QT * LD * 2                          // Q, dO of the block
      + 2 * 2 * KT * LD * 2                    // K, V: two stages each
      + 2 * KT * 4;                            // k_pos per stage
};

// Rows [r0, r0 + rows) of a strided [T, HD] bf16 matrix into a padded
// shared tile by 16-byte cp.async, rows past T zero-filled.
template <int HD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t st, int r0, int rows, int T,
                                          int tid, int nthreads) {
  using Cf = BCfg<HD>;
  for (int idx = tid; idx < rows * Cf::C; idx += nthreads) {
    const int r = idx / Cf::C, c = idx % Cf::C;
    const bool in = r0 + r < T;
    const int64_t row = in ? (int64_t)(r0 + r) : 0;
    cp_async16(dst + r * Cf::LD + c * 8, src + row * st + c * 8, in ? 16 : 0);
  }
}

// The (16 x n) product of the warp's 16 rows of A (shared, rows at `a`)
// with the n rows of B (shared, at `b`), both [rows][HD] row-major: acc
// [n/8][4] (+)= A B^T, in the mma accumulator layout.
template <int HD, int N>
__device__ __forceinline__ void mma_abt(float (*acc)[4],
                                        const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, int lane) {
  using Cf = BCfg<HD>;
#pragma unroll
  for (int kk = 0; kk < Cf::KS; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a + ((lane & 7) + ((lane >> 3) & 1) * 8) * Cf::LD +
                        16 * kk + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + (16 * np + ((lane >> 4) & 1) * 8 + (lane & 7)) *
                              Cf::LD +
                          16 * kk + ((lane >> 3) & 1) * 8);
      mma_16816(acc[2 * np], af, bf[0], bf[1]);
      mma_16816(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc [HD/8][4] += X (16 x n, registers: x[n/8][4] in the accumulator
// layout, rounded to bf16) times the n rows of B (shared, [n][HD]).
template <int HD, int N>
__device__ __forceinline__ void mma_xb(float (*acc)[4], const float (*x)[4],
                                       const __nv_bfloat16* b, int lane) {
  using Cf = BCfg<HD>;
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
    const uint32_t xa[4] = {pack_bf16x2(x[2 * kc][0], x[2 * kc][1]),
                            pack_bf16x2(x[2 * kc][2], x[2 * kc][3]),
                            pack_bf16x2(x[2 * kc + 1][0], x[2 * kc + 1][1]),
                            pack_bf16x2(x[2 * kc + 1][2], x[2 * kc + 1][3])};
#pragma unroll
    for (int np = 0; np < Cf::NO / 2; ++np) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b + (16 * kc + ((lane >> 3) & 1) * 8 +
                                 (lane & 7)) * Cf::LD +
                                16 * np + (lane >> 4) * 8);
      mma_16816(acc[2 * np], xa, bf[0], bf[1]);
      mma_16816(acc[2 * np + 1], xa, bf[2], bf[3]);
    }
  }
}

// Store a warp's 16 x HD accumulator (rows r0.., scaled) as bf16 into a
// strided [T, HD] matrix; rows past T are dropped.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, int64_t st,
                                           const float (*acc)[4], float scale,
                                           int r0, int T, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + g + 8 * i;
      if (r < T)
        *reinterpret_cast<uint32_t*>(dst + r * st + 8 * n + 2 * t) =
            pack_bf16x2(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
    }
}

template <int HD>
__global__ void __launch_bounds__(128) bwd_dkdv_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ Dsum, const int* __restrict__ lost,
    const int* __restrict__ qrange, const int* __restrict__ krange,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Tq,
    int Tk, int G, int window, float scale, Strides sq, Strides sk,
    Strides sv, Strides sdo, Strides sdk, Strides sdv) {
  using Cf = BCfg<HD>;
  using bf16 = __nv_bfloat16;
  constexpr int BQ = Cf::BQ, LD = Cf::LD, NS = BQ / 8, NO = Cf::NO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + KT * LD;
  bf16* Qs = Vs + KT * LD;                  // [2][BQ][LD]
  bf16* Ds = Qs + 2 * BQ * LD;              // dO: [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(Ds + 2 * BQ * LD);   // [2][BQ]
  float* D_s = lse_s + 2 * BQ;                                  // [2][BQ]
  int* qp_s = reinterpret_cast<int*>(D_s + 2 * BQ);             // [2][BQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y * G, k0 = kt * KT;
  const int n_qt32 = (Tq + PREP_ROWS - 1) / PREP_ROWS;
  const int n_qt = (Tq + BQ - 1) / BQ;
  const Range kr{krange[2 * kt], krange[2 * kt + 1]};
  const float scale_log2 = scale * kLog2e, inv_tk = 1.f / (float)Tk;

  // This warp's 16 keys: positions (rows g and g + 8), validity.
  int kp[2];
  bool kin[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kk = k0 + warp * 16 + g + 8 * i;
    kin[i] = kk < Tk;
    kp[i] = kin[i] ? k_pos[kk] : 0;
  }

  // Work items: (query tile, head in group), query tiles outer. An item is
  // taken when the bound admits a pair of it or a row of it is lost.
  auto admitted = [&](int item) {
    const int qt = item / G, hh = kvh * G + item % G;
    bool any_lost;
    const Range qr = q_tiles(qrange, lost, (int64_t)b * H + hh, n_qt32,
                             qt * BQ, BQ, &any_lost);
    return any_lost || admits(qr, kr, window);
  };
  auto next_item = [&](int from) {
    int it = from;
    while (it < n_qt * G && !admitted(it)) ++it;
    return it;
  };
  auto issue = [&](int item, int st) {
    if (item < n_qt * G) {
      const int qt = item / G, hh = kvh * G + item % G;
      const int64_t bh = (int64_t)b * H + hh;
      load_rows<HD>(Qs + st * BQ * LD, q + b * sq.b + hh * sq.h, sq.t,
                    qt * BQ, BQ, Tq, tid, 128);
      load_rows<HD>(Ds + st * BQ * LD, dout + b * sdo.b + hh * sdo.h, sdo.t,
                    qt * BQ, BQ, Tq, tid, 128);
      for (int r = tid; r < BQ; r += 128) {
        const int qi = qt * BQ + r;
        const bool in = qi < Tq;
        lse_s[st * BQ + r] = in ? lse[bh * Tq + qi] : 0.f;
        D_s[st * BQ + r] = in ? Dsum[bh * Tq + qi] : 0.f;
        qp_s[st * BQ + r] = in ? q_pos[qi] : 0;
      }
    }
    cp_async_commit();
  };

  load_rows<HD>(Ks, k + b * sk.b + kvh * sk.h, sk.t, k0, KT, Tk, tid, 128);
  load_rows<HD>(Vs, v + b * sv.b + kvh * sv.h, sv.t, k0, KT, Tk, tid, 128);
  int cur = next_item(0);
  issue(cur, 0);

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[n][c] = dv_acc[n][c] = 0.f;

  const bf16* Kw = Ks + warp * 16 * LD;
  const bf16* Vw = Vs + warp * 16 * LD;
  for (int stage = 0; cur < n_qt * G; stage ^= 1) {
    cp_async_wait<0>();
    __syncthreads();          // item `cur` landed; the other stage is free
    const int nxt = next_item(cur + 1);
    issue(nxt, stage ^ 1);
    const int q0 = (cur / G) * BQ;
    const bf16* Qt = Qs + stage * BQ * LD;
    const bf16* Dt = Ds + stage * BQ * LD;
    const float* ls = lse_s + stage * BQ;
    const float* dsum = D_s + stage * BQ;
    const int* qps = qp_s + stage * BQ;

    // S^T = K Q^T and dP^T = V dO^T: rows = the warp's keys, cols = queries.
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
    mma_abt<HD, BQ>(s, Kw, Qt, lane);
    mma_abt<HD, BQ>(dp, Vw, Dt, lane);

    // P^T into s, dS^T into dp.
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1, col = 8 * n + 2 * t + (c & 1);
        const float l = ls[col];
        float p = 0.f, ds = 0.f;
        if (kin[i] && q0 + col < Tq) {
          if (isinf(l)) {
            p = inv_tk;                       // lost row: uniform average
          } else if (admissible(kp[i], qps[col], window)) {
            p = exp2f(s[n][c] * scale_log2 - l * kLog2e);
            ds = p * (dp[n][c] - dsum[col]);
          }
        }
        s[n][c] = p;
        dp[n][c] = ds;
      }
    mma_xb<HD, BQ>(dv_acc, s, Dt, lane);
    mma_xb<HD, BQ>(dk_acc, dp, Qt, lane);
    cur = nxt;
  }
  cp_async_wait<0>();

  const int r0 = k0 + warp * 16;
  store_rows<HD>(dk + b * sdk.b + kvh * sdk.h, sdk.t, dk_acc, scale, r0, Tk,
                 lane);
  store_rows<HD>(dv + b * sdv.b + kvh * sdv.h, sdv.t, dv_acc, 1.f, r0, Tk,
                 lane);
}

template <int HD>
__global__ void __launch_bounds__(128) bwd_dq_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ Dsum, const int* __restrict__ qrange,
    const int* __restrict__ krange, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, __nv_bfloat16* __restrict__ dq, int Tq,
    int Tk, int G, int window, float scale, Strides sq, Strides sk,
    Strides sv, Strides sdo, Strides sdq) {
  using Cf = BCfg<HD>;
  using bf16 = __nv_bfloat16;
  constexpr int LD = Cf::LD, NS = KT / 8, NO = Cf::NO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ds = Qs + QT * LD;
  bf16* Ks = Ds + QT * LD;                  // [2][KT][LD]
  bf16* Vs = Ks + 2 * KT * LD;              // [2][KT][LD]
  int* kp_s = reinterpret_cast<int*>(Vs + 2 * KT * LD);   // [2][KT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, hk = h / G, q0 = qt * QT;
  const int64_t bh = (int64_t)b * H + h;
  const int n_qt32 = (Tq + PREP_ROWS - 1) / PREP_ROWS;
  const int n_kt = (Tk + KT - 1) / KT;
  const float scale_log2 = scale * kLog2e;
  Range qr{INT_MAX, INT_MIN};
  for (int x = q0 / PREP_ROWS; x < (q0 + QT) / PREP_ROWS && x < n_qt32; ++x) {
    qr.lo = min(qr.lo, qrange[2 * x]);
    qr.hi = max(qr.hi, qrange[2 * x + 1]);
  }

  // This warp's rows g and g + 8: position, LSE, D (lost rows get no dQ).
  int qp[2];
  float lr[2], dr[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + warp * 16 + g + 8 * i;
    const bool in = qi < Tq;
    qp[i] = in ? q_pos[qi] : 0;
    lr[i] = in ? lse[bh * Tq + qi] : INFINITY;
    dr[i] = in ? Dsum[bh * Tq + qi] : 0.f;
    live[i] = !isinf(lr[i]);
  }

  auto next_tile = [&](int from) {
    int x = from;
    while (x < n_kt && !admits(qr, Range{krange[2 * x], krange[2 * x + 1]},
                               window))
      ++x;
    return x;
  };
  auto issue = [&](int x, int st) {
    if (x < n_kt) {
      load_rows<HD>(Ks + st * KT * LD, k + b * sk.b + hk * sk.h, sk.t, x * KT,
                    KT, Tk, tid, 128);
      load_rows<HD>(Vs + st * KT * LD, v + b * sv.b + hk * sv.h, sv.t, x * KT,
                    KT, Tk, tid, 128);
      for (int j = tid; j < KT; j += 128) {
        const int kk = x * KT + j;
        kp_s[st * KT + j] = kk < Tk ? k_pos[kk] : 0;
      }
    }
    cp_async_commit();
  };

  load_rows<HD>(Qs, q + b * sq.b + h * sq.h, sq.t, q0, QT, Tq, tid, 128);
  load_rows<HD>(Ds, dout + b * sdo.b + h * sdo.h, sdo.t, q0, QT, Tq, tid,
                128);
  int cur = next_tile(0);
  issue(cur, 0);

  float dq_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq_acc[n][c] = 0.f;

  const bf16* Qw = Qs + warp * 16 * LD;
  const bf16* Dw = Ds + warp * 16 * LD;
  for (int stage = 0; cur < n_kt; stage ^= 1) {
    cp_async_wait<0>();
    __syncthreads();
    const int nxt = next_tile(cur + 1);
    issue(nxt, stage ^ 1);
    const int k0 = cur * KT;
    const bf16* Kt = Ks + stage * KT * LD;
    const bf16* Vt = Vs + stage * KT * LD;
    const int* kps = kp_s + stage * KT;

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
    mma_abt<HD, KT>(s, Qw, Kt, lane);
    mma_abt<HD, KT>(dp, Dw, Vt, lane);

#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1, col = 8 * n + 2 * t + (c & 1);
        float ds = 0.f;
        if (live[i] && k0 + col < Tk && admissible(kps[col], qp[i], window)) {
          const float p = exp2f(s[n][c] * scale_log2 - lr[i] * kLog2e);
          ds = p * (dp[n][c] - dr[i]);
        }
        dp[n][c] = ds;
      }
    mma_xb<HD, KT>(dq_acc, dp, Kt, lane);
    cur = nxt;
  }
  cp_async_wait<0>();
  store_rows<HD>(dq + b * sdq.b + h * sdq.h, sdq.t, dq_acc, scale,
                 q0 + warp * 16, Tq, lane);
}

// ------------------------------------------------------------- f32 kernels

constexpr int FK = 64;        // keys per dK/dV block; query rows per dQ block
constexpr int FS = 32;        // rows of the streamed tiles
constexpr int FLS = FS + 1;   // odd row of the P^T / dS tiles

template <int HD>
constexpr int f32_smem_bytes() {
  return ((2 * FK + 2 * FS) * (HD + 1) + 2 * FK * FLS + 3 * FS) * 4;
}

// dK/dV in f32: block (64 keys, KV head, b), 256 threads (ty, tx) on 16 x
// 16; a thread holds keys ty + 16 i (i < 4) against queries tx + 16 j (j <
// 2) of S^T and dP^T, and columns tx + 16 c of dK and dV.
template <int HD>
__global__ void __launch_bounds__(256) bwd_dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ Dsum,
    const int* __restrict__ lost, const int* __restrict__ qrange,
    const int* __restrict__ krange, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, float* __restrict__ dk,
    float* __restrict__ dv, int Tq, int Tk, int G, int window, float scale,
    Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
    Strides sdv) {
  constexpr int L = HD + 1, CP = HD / 16;
  extern __shared__ float fsm[];
  float* Ks = fsm;                 // [FK][L]
  float* Vs = Ks + FK * L;
  float* Qs = Vs + FK * L;         // [FS][L]
  float* Os = Qs + FS * L;         // dO
  float* Ps = Os + FS * L;         // P^T [FK][FLS]
  float* Ss = Ps + FK * FLS;       // dS^T
  float* ls = Ss + FK * FLS;       // [FS] lse, D, q_pos
  float* dsum = ls + FS;
  int* qps = reinterpret_cast<int*>(dsum + FS);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y * G, k0 = kt * FK;
  const int n_qt32 = (Tq + PREP_ROWS - 1) / PREP_ROWS;
  const Range kr{krange[2 * kt], krange[2 * kt + 1]};
  const float inv_tk = 1.f / (float)Tk;

  for (int idx = tid; idx < FK * HD; idx += 256) {
    const int j = idx / HD, d = idx % HD, kk = k0 + j;
    Ks[j * L + d] = kk < Tk ? k[b * sk.b + kvh * sk.h + kk * sk.t + d] : 0.f;
    Vs[j * L + d] = kk < Tk ? v[b * sv.b + kvh * sv.h + kk * sv.t + d] : 0.f;
  }
  int kp[4];
  bool kin[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k0 + ty + 16 * i;
    kin[i] = kk < Tk;
    kp[i] = kin[i] ? k_pos[kk] : 0;
  }
  float dk_acc[4][CP], dv_acc[4][CP];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CP; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int qt = 0; qt < n_qt32; ++qt) {
    const Range qr{qrange[2 * qt], qrange[2 * qt + 1]};
    const bool pos_ok = admits(qr, kr, window);
    for (int gg = 0; gg < G; ++gg) {
      const int hh = kvh * G + gg;
      const int64_t bh = (int64_t)b * H + hh;
      if (!pos_ok && !lost[bh * n_qt32 + qt]) continue;   // uniform
      const int q0 = qt * FS;
      __syncthreads();        // the previous item's tiles are consumed
      for (int idx = tid; idx < FS * HD; idx += 256) {
        const int r = idx / HD, d = idx % HD, qi = q0 + r;
        const bool in = qi < Tq;
        Qs[r * L + d] = in ? q[b * sq.b + hh * sq.h + qi * sq.t + d] : 0.f;
        Os[r * L + d] =
            in ? dout[b * sdo.b + hh * sdo.h + qi * sdo.t + d] : 0.f;
      }
      if (tid < FS) {
        const int qi = q0 + tid;
        const bool in = qi < Tq;
        ls[tid] = in ? lse[bh * Tq + qi] : 0.f;
        dsum[tid] = in ? Dsum[bh * Tq + qi] : 0.f;
        qps[tid] = in ? q_pos[qi] : 0;
      }
      __syncthreads();
      float s[4][2], dp[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kx[4], vx[4], qx[2], ox[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kx[i] = Ks[(ty + 16 * i) * L + d];
          vx[i] = Vs[(ty + 16 * i) * L + d];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          qx[j] = Qs[(tx + 16 * j) * L + d];
          ox[j] = Os[(tx + 16 * j) * L + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            s[i][j] = fmaf(kx[i], qx[j], s[i][j]);
            dp[i][j] = fmaf(vx[i], ox[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = tx + 16 * j;
          const float l = ls[col];
          float p = 0.f, ds = 0.f;
          if (kin[i] && q0 + col < Tq) {
            if (isinf(l)) {
              p = inv_tk;
            } else if (admissible(kp[i], qps[col], window)) {
              p = expf(s[i][j] * scale - l);
              ds = p * (dp[i][j] - dsum[col]);
            }
          }
          Ps[(ty + 16 * i) * FLS + col] = p;
          Ss[(ty + 16 * i) * FLS + col] = ds;
        }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < FS; ++r) {
        float ox[CP], qx[CP];
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          ox[c] = Os[r * L + tx + 16 * c];
          qx[c] = Qs[r * L + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = Ps[(ty + 16 * i) * FLS + r];
          const float ds = Ss[(ty + 16 * i) * FLS + r];
#pragma unroll
          for (int c = 0; c < CP; ++c) {
            dv_acc[i][c] = fmaf(p, ox[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(ds, qx[c], dk_acc[i][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k0 + ty + 16 * i;
    if (kk >= Tk) continue;
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      const int d = tx + 16 * c;
      dk[b * sdk.b + kvh * sdk.h + kk * sdk.t + d] = dk_acc[i][c] * scale;
      dv[b * sdv.b + kvh * sdv.h + kk * sdv.t + d] = dv_acc[i][c];
    }
  }
}

// dQ in f32: block (64 query rows, head, b), 256 threads; a thread holds
// rows ty + 16 i against keys tx + 16 j of each 32-key tile, and columns
// tx + 16 c of dQ.
template <int HD>
__global__ void __launch_bounds__(256) bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ Dsum,
    const int* __restrict__ qrange, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, float* __restrict__ dq, int Tq, int Tk,
    int G, int window, float scale, Strides sq, Strides sk, Strides sv,
    Strides sdo, Strides sdq) {
  constexpr int L = HD + 1, CP = HD / 16;
  extern __shared__ float fsm[];
  float* Qs = fsm;                 // [FK][L]
  float* Os = Qs + FK * L;         // dO
  float* Ks = Os + FK * L;         // [FS][L]
  float* Vs = Ks + FS * L;
  float* Ss = Vs + FS * L;         // dS [FK][FLS]
  int* kps = reinterpret_cast<int*>(Ss + 2 * FK * FLS);   // [FS]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, hk = h / G, q0 = qt * FK;
  const int64_t bh = (int64_t)b * H + h;
  const int n_kt = (Tk + FS - 1) / FS;

  for (int idx = tid; idx < FK * HD; idx += 256) {
    const int r = idx / HD, d = idx % HD, qi = q0 + r;
    const bool in = qi < Tq;
    Qs[r * L + d] = in ? q[b * sq.b + h * sq.h + qi * sq.t + d] : 0.f;
    Os[r * L + d] = in ? dout[b * sdo.b + h * sdo.h + qi * sdo.t + d] : 0.f;
  }
  int qp[4];
  float lr[4], dr[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    const bool in = qi < Tq;
    qp[i] = in ? q_pos[qi] : 0;
    lr[i] = in ? lse[bh * Tq + qi] : INFINITY;
    dr[i] = in ? Dsum[bh * Tq + qi] : 0.f;
    live[i] = !isinf(lr[i]);
  }
  const int n_qt32 = (Tq + PREP_ROWS - 1) / PREP_ROWS;
  Range qr{INT_MAX, INT_MIN};
  for (int x = q0 / PREP_ROWS; x < (q0 + FK) / PREP_ROWS && x < n_qt32; ++x) {
    qr.lo = min(qr.lo, qrange[2 * x]);
    qr.hi = max(qr.hi, qrange[2 * x + 1]);
  }
  float dq_acc[4][CP];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CP; ++c) dq_acc[i][c] = 0.f;

  for (int x = 0; x < n_kt; ++x) {
    const int k0 = x * FS;
    __syncthreads();          // the previous tile is consumed
    for (int idx = tid; idx < FS * HD; idx += 256) {
      const int j = idx / HD, d = idx % HD, kk = k0 + j;
      const bool in = kk < Tk;
      Ks[j * L + d] = in ? k[b * sk.b + hk * sk.h + kk * sk.t + d] : 0.f;
      Vs[j * L + d] = in ? v[b * sv.b + hk * sv.h + kk * sv.t + d] : 0.f;
    }
    if (tid < FS) kps[tid] = k0 + tid < Tk ? k_pos[k0 + tid] : 0;
    __syncthreads();
    Range kr{INT_MAX, INT_MIN};
    for (int j = 0; j < FS && k0 + j < Tk; ++j) {
      kr.lo = min(kr.lo, kps[j]);
      kr.hi = max(kr.hi, kps[j]);
    }
    if (!admits(qr, kr, window)) continue;   // uniform across the block
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qx[4], ox[4], kx[2], vx[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qx[i] = Qs[(ty + 16 * i) * L + d];
        ox[i] = Os[(ty + 16 * i) * L + d];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kx[j] = Ks[(tx + 16 * j) * L + d];
        vx[j] = Vs[(tx + 16 * j) * L + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qx[i], kx[j], s[i][j]);
          dp[i][j] = fmaf(ox[i], vx[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = tx + 16 * j;
        float ds = 0.f;
        if (live[i] && k0 + col < Tk && admissible(kps[col], qp[i], window)) {
          const float p = expf(s[i][j] * scale - lr[i]);
          ds = p * (dp[i][j] - dr[i]);
        }
        Ss[(ty + 16 * i) * FLS + col] = ds;
      }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < FS; ++j) {
      float kx[CP];
#pragma unroll
      for (int c = 0; c < CP; ++c) kx[c] = Ks[j * L + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = Ss[(ty + 16 * i) * FLS + j];
#pragma unroll
        for (int c = 0; c < CP; ++c) dq_acc[i][c] = fmaf(ds, kx[c],
                                                          dq_acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Tq) continue;
#pragma unroll
    for (int c = 0; c < CP; ++c)
      dq[b * sdq.b + h * sdq.h + qi * sdq.t + tx + 16 * c] =
          dq_acc[i][c] * scale;
  }
}

// ------------------------------------------------------------------ launch

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float* Dsum;
  int *lost, *qrange, *krange;
  const int *q_pos, *k_pos;
  int B, H, KV, Tq, Tk, window;
  float scale;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
};

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const int G = a.H / a.KV;
  const int n_qt32 = (a.Tq + PREP_ROWS - 1) / PREP_ROWS;
  const int n_kt64 = (a.Tk + KT - 1) / KT;
  const int n_prep = n_qt32 > n_kt64 ? n_qt32 : n_kt64;
  bwd_prep_kernel<T, HD><<<dim3(n_prep, a.H, a.B), 256, 0, st>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse,
      a.Dsum, a.lost, a.qrange, a.krange, a.q_pos, a.k_pos, a.Tq, a.Tk, a.so,
      a.sdo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    using Cf = BCfg<HD>;
    using bf16 = __nv_bfloat16;
    static unsigned long long done_kv = 0, done_q = 0;
    err = set_smem_once(bwd_dkdv_bf16_kernel<HD>, Cf::KV_SMEM, &done_kv);
    if (err != cudaSuccess) return err;
    err = set_smem_once(bwd_dq_bf16_kernel<HD>, Cf::Q_SMEM, &done_q);
    if (err != cudaSuccess) return err;
    bwd_dkdv_bf16_kernel<HD><<<dim3(n_kt64, a.KV, a.B), 128, Cf::KV_SMEM,
                               st>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        a.lse, a.Dsum, a.lost, a.qrange, a.krange, a.q_pos, a.k_pos,
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.Tq, a.Tk, G,
        a.window, a.scale, a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bwd_dq_bf16_kernel<HD><<<dim3((a.Tq + QT - 1) / QT, a.H, a.B), 128,
                             Cf::Q_SMEM, st>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        a.lse, a.Dsum, a.qrange, a.krange, a.q_pos, a.k_pos,
        static_cast<bf16*>(a.dq), a.Tq, a.Tk, G, a.window, a.scale, a.sq,
        a.sk, a.sv, a.sdo, a.sdq);
    return cudaGetLastError();
  } else {
    static unsigned long long done_kv = 0, done_q = 0;
    constexpr int smem = f32_smem_bytes<HD>();
    err = set_smem_once(bwd_dkdv_f32_kernel<HD>, smem, &done_kv);
    if (err != cudaSuccess) return err;
    err = set_smem_once(bwd_dq_f32_kernel<HD>, smem, &done_q);
    if (err != cudaSuccess) return err;
    bwd_dkdv_f32_kernel<HD><<<dim3(n_kt64, a.KV, a.B), 256, smem, st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.Dsum, a.lost, a.qrange, a.krange, a.q_pos, a.k_pos,
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Tq, a.Tk, G,
        a.window, a.scale, a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bwd_dq_f32_kernel<HD><<<dim3((a.Tq + FK - 1) / FK, a.H, a.B), 256, smem,
                            st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.Dsum, a.qrange, a.q_pos, a.k_pos,
        static_cast<float*>(a.dq), a.Tq, a.Tk, G, a.window, a.scale, a.sq,
        a.sk, a.sv, a.sdo, a.sdq);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a, cudaStream_t st) {
  switch (hd) {
    case 64: return launch<T, 64>(a, st);
    case 128: return launch<T, 128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq [B, H, Tq, hd]; k, v, dk, dv [B, KV, Tk, hd], each given by
// its element strides (8 x 4, in that order); lse [B, H, Tq] f32 contiguous
// from flash_attention_fwd (natural log, +inf for a row with no admissible
// key); q_pos [Tq], k_pos [Tk] int32 contiguous. Workspace: Dsum [B, H, Tq]
// f32; ints: lost [B, H, ceil(Tq/32)], qrange [2 ceil(Tq/32)], krange
// [2 ceil(Tk/64)]. Launches three kernels on `stream` (prep, dK/dV, dQ) and
// returns cudaGetLastError() after the last launch.
EXPORT int flash_attention_bwd(
    int dtype, int hd, const void* q, const void* k, const void* v,
    const void* o, const void* dout, const float* lse, void* dq, void* dk,
    void* dv, float* Dsum, int* lost, int* qrange, int* krange,
    const int* q_pos, const int* k_pos, int B, int H, int KV, int Tq, int Tk,
    int window, float scale, const int64_t* strides, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Tq <= 0 || Tk <= 0)
    return cudaErrorInvalidValue;
  Strides s[8];
  for (int i = 0; i < 8; ++i)
    s[i] = Strides{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2],
                   strides[4 * i + 3]};
  const Args a{q, k, v, o, dout, lse, dq, dk, dv, Dsum, lost, qrange,
               krange, q_pos, k_pos, B, H, KV, Tq, Tk, window, scale,
               s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_hd<float>(hd, a, st);
  if (dtype == kBFloat16) return dispatch_hd<__nv_bfloat16>(hd, a, st);
  return cudaErrorInvalidValue;
}
