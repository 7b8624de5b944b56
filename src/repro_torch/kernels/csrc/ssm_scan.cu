// Mamba2 SSD scan (scalar decay per head), chunked closed form, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssm_scan/kernel.py, function
// `ssm_scan` (body `_kernel`).
//
// What it computes, per (b, head), with the state S [hp, N] in f32:
//     S <- exp(dt_t A) S + dt_t x_t B_t^T,   y_t = S C_t + D x_t
// evaluated chunk by chunk as the model's `chunk_step` does. Within a chunk
// of L steps, with P_t = (dt_0 + ... + dt_t) A (inclusive, over the chunk
// only, so every exponent below is <= 0):
//     y_t = sum_{s<=t} exp(P_t - P_s) (C_t . B_s) dt_s x_s
//         + exp(P_t) S C_t + D x_t
//     S  <- exp(P_{L-1}) S + sum_s exp(P_{L-1} - P_s) dt_s x_s B_s^T.
// Unlike the TPU kernel, which starts from zeros and returns y, this one
// takes the initial state and returns the final one (prefill on top of a
// cache, decode after prefill). x, B and C are f32 or bf16 (one type), dt,
// A and D f32; the math is f32; y has x's type. D x is added here, once.
//
// Design.
//  * Grid (ceil(nh / 2), B): a block takes two heads of one batch row.
//    Bm and Cm are [B, T, N] (one group), so C B^T of a chunk does not
//    depend on the head: the block computes it once per chunk and both
//    heads apply their own decay exp(P_t - P_s) dt_s to it. Two heads,
//    because the grid must still fill the card: at the served shape
//    (B 8, nh 112) that is 448 blocks for 132 SMs at 2 blocks per SM,
//    1.7 waves; three heads give 304 blocks, 1.15 waves, idling most of
//    the second; four need 16 warps and more shared memory than two
//    blocks per SM may hold. A missing second head (odd nh) leaves its
//    warps idle.
//  * Four products per chunk, all on the tensor cores in 3xTF32
//    (mma.sync m16n8k8; each f32 operand split into TF32 hi + lo and
//    hi*hi + hi*lo + lo*hi summed in f32): C B^T [Q,N][N,Q], M x
//    [Q,Q][Q,hp], C S^T [Q,N][N,hp] and the state update (w x)^T B
//    [hp,Q][Q,N]. One TF32 product alone misses the f32 tolerance by two
//    orders of magnitude; 3xTF32 keeps the scalar kernel's accuracy.
//  * hp / 16 warps per head, warp w owning the state rows p in
//    [16 w, 16 w + 16) as mma accumulators in registers for the whole
//    sweep, and the same 16 columns of y. The accumulator layout of S is,
//    with the contraction index n permuted within each 8 (k q <-> n 2q,
//    k q + 4 <-> n 2q + 1), exactly the B fragment C S^T needs, so the
//    state never leaves registers; the same permutation turns C's and
//    B's fragment loads into 8-byte loads.
//  * The chunk is 32 steps. Stages of x, B, C and dt for chunk c + 1 are
//    loaded by 16-byte cp.async (4-byte for dt; bf16 converted on load)
//    while chunk c computes: two stages and the C B^T tile take ~80 KB,
//    so two blocks (16 warps) share an SM. A 64-step chunk would need
//    ~150 KB with two stages, one block per SM. Rows are padded (N + 8,
//    hp + 8, Q + 4 floats) so every fragment load is free of bank
//    conflicts.
//  * dt A's prefix sum is a 32-lane shuffle scan, one warp per head.
//  * Exponents stay differences within a chunk, exp(P_t - P_s) and
//    exp(P_{L-1} - P_s), all <= 0: never exp(P_t) exp(-P_s), whose second
//    factor overflows once a chunk's decay passes e^88.
//  * A ragged last chunk is zero-padded on load: a padded step has
//    x = B = C = 0 and dt = 0, which leaves P, y and S exactly as they
//    were, so nothing else is masked. Operands are read through their
//    strides (the model's [B, T, nh, hp] and [B, T, N] tensors), with no
//    copies; x, Bm and Cm need 16-byte-aligned bases and strides (the
//    wrapper raises otherwise).
//
// What bounds it on the H100: the recurrence moves x, y, B, C and dt once,
// 0.148 ms at the served shape (B 8, T 999, nh 112, hp = N = 64, f32) by
// bytes; its 4 flops per state element per step take 0.219 ms at the f32
// rate outside the tensor cores, and 3x that at the TF32 tensor rate,
// 0.089 ms. The chunked form does ~2x the recurrence's flops, ~28 M
// mma.sync in all. chip_smoke.py measures 0.520 ms there (phase 6, NVIDIA
// H100 80GB HBM3, 700 W; the earlier scalar kernel took 1.59 ms), 3.5x the
// bytes bound. The kernel is close to bound by instruction issue: ~2.8k
// SASS instructions per warp and chunk (tools/sass_mix.py) with four
// warps per scheduler, nearly half of them integer operations (the TF32
// splits and addresses); its mma.sync run at a third of the card's
// mma.sync TF32 rate (tools/mma_rate.cu).

#include <math.h>

#include "common.cuh"
#include "scan.cuh"

namespace {

constexpr int SQ = 32;   // chunk length: one step per lane in the scan
constexpr int SG = 2;    // heads per block

// Element strides of a 3-D operand [B, T, n] (n: N for B and C, nh for dt).
struct Strides3 {
  int64_t b, t, n;
};

template <int HP, int N>
struct SsdShape {
  static constexpr int WPH = HP / 16;        // warps per head
  static constexpr int NW = SG * WPH;
  static constexpr int NTH = 32 * NW;
  static constexpr int LDC = N + 8;          // B, C rows: 8 mod 32 words
  static constexpr int LDX = HP + 8;         // x rows: 8 mod 32
  static constexpr int LDG = SQ + 4;         // C B^T rows: 4 mod 32
  static constexpr int STAGE = 2 * SQ * LDC + SG * SQ * LDX + SG * SQ;
  static constexpr int SMEM_FLOATS = 2 * STAGE + SQ * LDG + 3 * SG * SQ;
};

template <typename T, int HP, int N>
__global__ void __launch_bounds__(SsdShape<HP, N>::NTH, 2) ssd_kernel(
    const T* __restrict__ x, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ D,
    const float* __restrict__ s0, T* __restrict__ y,
    float* __restrict__ s_out, float* __restrict__ states, int T_len, int nh,
    Strides sx, Strides3 sb, Strides3 sc, Strides3 sd, Strides sy) {
  using S_ = SsdShape<HP, N>;
  constexpr int WPH = S_::WPH, NW = S_::NW, NTH = S_::NTH;
  constexpr int LDC = S_::LDC, LDX = S_::LDX, LDG = S_::LDG;
  constexpr int STAGE = S_::STAGE, NTN = N / 8;
  static_assert(HP % 16 == 0 && N % 8 == 0 && SQ == 32, "tile shape");

  extern __shared__ __align__(16) float smem[];
  float* Gm = smem + 2 * STAGE;   // C B^T of the chunk [SQ][LDG]
  float* Ps = Gm + SQ * LDG;      // P_t per head
  float* eP = Ps + SG * SQ;       // exp(P_t)
  float* ws = eP + SG * SQ;       // exp(P_{L-1} - P_s) dt_s

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int h0 = blockIdx.x * SG, b = blockIdx.y;
  const int n_heads = min(SG, nh - h0);
  const int hl = warp / WPH, h = h0 + hl, p0 = 16 * (warp % WPH);
  const bool active = hl < n_heads;

  const T* Bb = Bm + b * sb.b;
  const T* Cb = Cm + b * sc.b;
  auto issue = [&](int c0, int st) {
    float* Cs = smem + st * STAGE;
    float* Bs = Cs + SQ * LDC;
    float* Xs = Bs + SQ * LDC;
    float* dts = Xs + SG * SQ * LDX;
    const int L = min(SQ, T_len - c0);
    load_tile<SQ, N, NTH>(Cs, LDC, Cb + c0 * sc.t, sc.t, L, tid);
    load_tile<SQ, N, NTH>(Bs, LDC, Bb + c0 * sb.t, sb.t, L, tid);
    for (int j = 0; j < n_heads; ++j)
      load_tile<SQ, HP, NTH>(Xs + j * SQ * LDX, LDX,
                             x + b * sx.b + (h0 + j) * sx.h + c0 * sx.t,
                             sx.t, L, tid);
    for (int i = tid; i < n_heads * SQ; i += NTH) {
      const int j = i / SQ, t = i % SQ;
      const bool in = t < L;
      cp_async4(dts + i,
                dt + b * sd.b + (h0 + j) * sd.n + (in ? (c0 + t) * sd.t : 0),
                in ? 4 : 0);
    }
    cp_async_commit();
  };

  // The state rows p0 + g (+ 8) of this warp's head, in the accumulator
  // layout of the state update: Sacc[j] holds columns 8 j + 2 q (+ 1).
  float Sacc[NTN][4];
  const int64_t sbase = ((int64_t)b * nh + h) * HP * N;
#pragma unroll
  for (int j = 0; j < NTN; ++j) {
    float2 lo = make_float2(0.f, 0.f), hi = lo;
    if (active && s0) {
      lo = *reinterpret_cast<const float2*>(s0 + sbase + (p0 + g) * N +
                                            8 * j + 2 * q);
      hi = *reinterpret_cast<const float2*>(s0 + sbase + (p0 + g + 8) * N +
                                            8 * j + 2 * q);
    }
    Sacc[j][0] = lo.x, Sacc[j][1] = lo.y, Sacc[j][2] = hi.x,
    Sacc[j][3] = hi.y;
  }
  const float Ah = active ? A[h] : 0.f, Dh = active ? D[h] : 0.f;

  issue(0, 0);
  for (int c0 = 0, st = 0; c0 < T_len; c0 += SQ, st ^= 1) {
    const int L = min(SQ, T_len - c0);
    cp_async_wait<0>();
    __syncthreads();  // chunk c landed; every warp is done with chunk c - 1
    if (c0 + SQ < T_len) issue(c0 + SQ, st ^ 1);
    const float* Cs = smem + st * STAGE;
    const float* Bs = Cs + SQ * LDC;
    const float* Xh = Bs + SQ * LDC + hl * SQ * LDX;
    const float* dth = Bs + SQ * LDC + SG * SQ * LDX + hl * SQ;

    // P_t = (dt_0 + ... + dt_t) A by a shuffle scan, one warp per head.
    if (active && warp % WPH == 0) {
      const float dtv = dth[lane];
      float p = dtv * Ah;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, p, o);
        if (lane >= o) p += v;
      }
      const float last = __shfl_sync(0xffffffffu, p, 31);
      Ps[hl * SQ + lane] = p;
      eP[hl * SQ + lane] = expf(p);
      ws[hl * SQ + lane] = expf(last - p) * dtv;
    }
    // C B^T on and below the diagonal, 16 x 8 tiles over the warps that
    // run no scan: rows 0-15 take columns 0-15 (2 tiles), rows 16-31
    // columns 0-31 (4). The three products of 3xTF32 go to three
    // accumulators, a chain of N / 8 k-steps each.
    const int gw = warp - warp / WPH - 1;   // rank among those warps
    for (int tile = gw; warp % WPH && tile < 6; tile += NW - SG) {
      const int i = tile < 2 ? 0 : 1, j = tile < 2 ? tile : tile - 2;
      float d[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
      float d2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NTN; ++kk) {
        Frag<4> a;
        Frag<2> bf;
        const float2 c0v = *reinterpret_cast<const float2*>(
            Cs + (16 * i + g) * LDC + 8 * kk + 2 * q);
        const float2 c1v = *reinterpret_cast<const float2*>(
            Cs + (16 * i + g + 8) * LDC + 8 * kk + 2 * q);
        const float2 bv = *reinterpret_cast<const float2*>(
            Bs + (8 * j + g) * LDC + 8 * kk + 2 * q);
        a.set(0, c0v.x), a.set(1, c1v.x), a.set(2, c0v.y), a.set(3, c1v.y);
        bf.set(0, bv.x), bf.set(1, bv.y);
        mma3_split(d, d1, d2, a, bf);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] += d1[e] + d2[e];
      store2(Gm + (16 * i + g) * LDG + 8 * j + 2 * q, d[0], d[1]);
      store2(Gm + (16 * i + g + 8) * LDG + 8 * j + 2 * q, d[2], d[3]);
    }
    __syncthreads();
    if (!active) continue;
    if (states) {  // the state this chunk starts from, for the backward
      float* sc_ = states + (sbase * ((T_len + SQ - 1) / SQ) +
                             (int64_t)(c0 / SQ) * HP * N);
#pragma unroll
      for (int j = 0; j < NTN; ++j) {
        store2(sc_ + (p0 + g) * N + 8 * j + 2 * q, Sacc[j][0], Sacc[j][1]);
        store2(sc_ + (p0 + g + 8) * N + 8 * j + 2 * q, Sacc[j][2],
               Sacc[j][3]);
      }
    }

    // Y[i][jj]: rows 16 i + g (+ 8), columns p0 + 8 jj + 2 q (+ 1).
    float Y[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) Y[i][jj][e] = 0.f;

    // Y = C S^T (the state as the chunk found it), then row t times
    // exp(P_t).
#pragma unroll
    for (int kk = 0; kk < NTN; ++kk) {
      Frag<2> sf0, sf1;
      sf0.set(0, Sacc[kk][0]), sf0.set(1, Sacc[kk][1]);
      sf1.set(0, Sacc[kk][2]), sf1.set(1, Sacc[kk][3]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        Frag<4> a;
        const float2 c0v = *reinterpret_cast<const float2*>(
            Cs + (16 * i + g) * LDC + 8 * kk + 2 * q);
        const float2 c1v = *reinterpret_cast<const float2*>(
            Cs + (16 * i + g + 8) * LDC + 8 * kk + 2 * q);
        a.set(0, c0v.x), a.set(1, c1v.x), a.set(2, c0v.y), a.set(3, c1v.y);
        mma3(Y[i][0], a, sf0);
        mma3(Y[i][1], a, sf1);
      }
    }
    const float* Ph = Ps + hl * SQ;
    float pt[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      pt[i][0] = Ph[16 * i + g], pt[i][1] = Ph[16 * i + g + 8];
      const float e0 = eP[hl * SQ + 16 * i + g];
      const float e1 = eP[hl * SQ + 16 * i + g + 8];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        Y[i][jj][0] *= e0, Y[i][jj][1] *= e0;
        Y[i][jj][2] *= e1, Y[i][jj][3] *= e1;
      }
    }

    // Y += M x, M[t][s] = (C B^T)[t][s] exp(P_t - P_s) dt_s for s <= t,
    // over the k-steps of 8 at or below each row tile's diagonal.
#pragma unroll
    for (int kk = 0; kk < SQ / 8; ++kk) {
      const int sa = 8 * kk + q, sb_ = sa + 4;
      Frag<2> xf[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        xf[jj].set(0, Xh[sa * LDX + p0 + 8 * jj + g]);
        xf[jj].set(1, Xh[sb_ * LDX + p0 + 8 * jj + g]);
      }
      const float psa = Ph[sa], psb = Ph[sb_];
      const float dta = dth[sa], dtb = dth[sb_];
#pragma unroll
      for (int i = kk / 2; i < 2; ++i) {
        const int t0 = 16 * i + g, t1 = t0 + 8;
        auto m = [&](int t, int s, float ptv, float psv, float dtv) {
          const float v = Gm[t * LDG + s] * expf(fminf(ptv - psv, 0.f)) * dtv;
          return s <= t ? v : 0.f;
        };
        Frag<4> a;
        a.set(0, m(t0, sa, pt[i][0], psa, dta));
        a.set(1, m(t1, sa, pt[i][1], psa, dta));
        a.set(2, m(t0, sb_, pt[i][0], psb, dtb));
        a.set(3, m(t1, sb_, pt[i][1], psb, dtb));
        mma3(Y[i][0], a, xf[0]);
        mma3(Y[i][1], a, xf[1]);
      }
    }

    // y = Y + D x for the chunk's real rows.
    T* yb = y + b * sy.b + h * sy.h;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = 16 * i + g + 8 * half;
        if (t >= L) continue;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int p = p0 + 8 * jj + 2 * q;
          const float2 xv = *reinterpret_cast<const float2*>(Xh + t * LDX + p);
          store2(yb + (int64_t)(c0 + t) * sy.t + p,
                 Y[i][jj][2 * half] + Dh * xv.x,
                 Y[i][jj][2 * half + 1] + Dh * xv.y);
        }
      }

    // S <- exp(P_{L-1}) S + sum_s (w_s x_s) B_s^T (padded steps: dt = 0,
    // so P_{SQ-1} = P_{L-1} and w_s = 0).
    const float dec = eP[hl * SQ + SQ - 1];
    const float* wh = ws + hl * SQ;
#pragma unroll
    for (int j = 0; j < NTN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) Sacc[j][e] *= dec;
#pragma unroll
    for (int kk = 0; kk < SQ / 8; ++kk) {
      const int sa = 8 * kk + q, sb_ = sa + 4;
      const float wa = wh[sa], wb = wh[sb_];
      Frag<4> a;
      a.set(0, wa * Xh[sa * LDX + p0 + g]);
      a.set(1, wa * Xh[sa * LDX + p0 + g + 8]);
      a.set(2, wb * Xh[sb_ * LDX + p0 + g]);
      a.set(3, wb * Xh[sb_ * LDX + p0 + g + 8]);
#pragma unroll
      for (int j = 0; j < NTN; ++j) {
        Frag<2> bf;
        bf.set(0, Bs[sa * LDC + 8 * j + g]);
        bf.set(1, Bs[sb_ * LDC + 8 * j + g]);
        mma3(Sacc[j], a, bf);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int j = 0; j < NTN; ++j) {
    store2(s_out + sbase + (p0 + g) * N + 8 * j + 2 * q, Sacc[j][0],
           Sacc[j][1]);
    store2(s_out + sbase + (p0 + g + 8) * N + 8 * j + 2 * q, Sacc[j][2],
           Sacc[j][3]);
  }
}

template <typename T, int HP, int N>
cudaError_t launch(const void* x, const void* Bm, const void* Cm,
                   const float* dt, const float* A, const float* D,
                   const float* s0, void* y, float* s_out, float* states,
                   int B, int T_len, int nh, Strides sx, Strides3 sb,
                   Strides3 sc, Strides3 sd, Strides sy,
                   cudaStream_t stream) {
  using S_ = SsdShape<HP, N>;
  constexpr int smem = S_::SMEM_FLOATS * (int)sizeof(float);
  static unsigned long long done = 0;
  cudaError_t err = set_smem_once(ssd_kernel<T, HP, N>, smem, &done);
  if (err != cudaSuccess) return err;
  ssd_kernel<T, HP, N><<<dim3((nh + SG - 1) / SG, B), S_::NTH, smem,
                         stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), dt, A, D, s0, static_cast<T*>(y), s_out,
      states, T_len, nh, sx, sb, sc, sd, sy);
  return cudaGetLastError();
}

template <typename T, int HP>
cudaError_t dispatch_n(int N, const void* x, const void* Bm, const void* Cm,
                       const float* dt, const float* A, const float* D,
                       const float* s0, void* y, float* s_out, float* states,
                       int B, int T_len, int nh, Strides sx, Strides3 sb,
                       Strides3 sc, Strides3 sd, Strides sy,
                       cudaStream_t stream) {
#define SSD_ARGS \
  x, Bm, Cm, dt, A, D, s0, y, s_out, states, B, T_len, nh, sx, sb, sc, sd, \
      sy, stream
  switch (N) {
    case 16:
      return launch<T, HP, 16>(SSD_ARGS);
    case 32:
      return launch<T, HP, 32>(SSD_ARGS);
    case 64:
      return launch<T, HP, 64>(SSD_ARGS);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int hp, int N, const void* x, const void* Bm,
                     const void* Cm, const float* dt, const float* A,
                     const float* D, const float* s0, void* y, float* s_out,
                     float* states, int B, int T_len, int nh, Strides sx,
                     Strides3 sb, Strides3 sc, Strides3 sd, Strides sy,
                     cudaStream_t stream) {
  switch (hp) {
    case 32:
      return dispatch_n<T, 32>(N, SSD_ARGS);
    case 64:
      return dispatch_n<T, 64>(N, SSD_ARGS);
    default:
      return cudaErrorInvalidValue;
  }
#undef SSD_ARGS
}

}  // namespace

// x [B, T, nh, hp] and y [B, T, nh, hp], each given by its element strides
// in (b, h, t, d) order; Bm and Cm [B, T, N] and dt [B, T, nh] by theirs in
// axis order; A, D [nh] f32 contiguous; s0 (may be null: zeros) and s_out
// [B, nh, hp, N] f32 contiguous; states (may be null: not written) [B, nh,
// ceil(T / 32), hp, N] f32 contiguous, the state each chunk starts from,
// which the backward (ssm_scan_bwd.cu) reads. x, y, Bm and Cm need a unit
// last stride, and x, Bm and Cm 16-byte-aligned bases and strides.
// Launches on `stream` and returns cudaGetLastError() after the launch.
EXPORT int ssm_scan_fwd(
    int dtype, int hp, int N, const void* x, const void* Bm, const void* Cm,
    const void* dt, const void* A, const void* D, const void* s0, void* y,
    void* s_out, void* states, int B, int T, int nh,
    int64_t sx_b, int64_t sx_h, int64_t sx_t, int64_t sx_d,
    int64_t sb_b, int64_t sb_t, int64_t sb_n,
    int64_t sc_b, int64_t sc_t, int64_t sc_n,
    int64_t sd_b, int64_t sd_t, int64_t sd_h,
    int64_t sy_b, int64_t sy_h, int64_t sy_t, int64_t sy_d, void* stream) {
  if (B <= 0 || T <= 0 || nh <= 0 || !dt || !A || !D || !s_out ||
      sx_d != 1 || sb_n != 1 || sc_n != 1 || sy_d != 1)
    return cudaErrorInvalidValue;
  const Strides sx{sx_b, sx_h, sx_t, sx_d}, sy{sy_b, sy_h, sy_t, sy_d};
  const Strides3 sb{sb_b, sb_t, sb_n}, sc{sc_b, sc_t, sc_n};
  const Strides3 sd{sd_b, sd_t, sd_h};
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  const float* s0f = static_cast<const float*>(s0);
  float* sof = static_cast<float*>(s_out);
  float* stf = static_cast<float*>(states);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch<float>(hp, N, x, Bm, Cm, dtf, Af, Df, s0f, y, sof, stf, B,
                           T, nh, sx, sb, sc, sd, sy, st);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(hp, N, x, Bm, Cm, dtf, Af, Df, s0f, y, sof,
                                   stf, B, T, nh, sx, sb, sc, sd, sy, st);
  return cudaErrorInvalidValue;
}
