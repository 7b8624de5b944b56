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
//  * Grid (nh, B): one block of 256 threads per (b, head). The TPU kernel's
//    sequential chunk axis becomes a loop inside the block; the state
//    lives in shared memory for the whole sweep and is read from s0 and
//    written to s_out once. The chunk is 64 steps (the TPU kernel's 128
//    would need ~180 KB of shared memory for one block; 64 fits two blocks
//    per SM in ~84 KB each, and the closed form is exact for any chunk).
//  * C B^T [Q, Q] does not depend on the head; like the TPU kernel, each
//    head's block computes it again. Sharing it across the heads of one b
//    is a later step.
//  * Each thread owns a 4 x 4 tile of the [64, 64] weights M[t][s]
//    (t = ty + 16 i, s = tx + 16 j), skipping the tiles above the
//    diagonal; y and the state update are register tiles over shared
//    memory too. Rows indexed across a warp have an odd stride, so the
//    loads are free of bank conflicts.
//  * A ragged last chunk is zero-padded on load: a padded step has
//    x = B = C = 0 and dt = 0, which leaves P, y and S exactly as they
//    were, so nothing else is masked. Operands are read through their
//    strides (the model's [B, T, nh, hp] and [B, T, N] tensors), with no
//    copies.
//  * f32 math is IEEE FMAs and expf on the CUDA cores, no TF32.
//
// What bounds it on the H100: the recurrence does 4 flops per state
// element per step and moves x, y, B, C and dt once, so at the served
// shape (B 8, T 999, nh 112, hp = N = 64, f32) its bound is 0.219 ms by
// f32 operations (0.148 ms by bytes). The chunked form does ~27 GFLOP
// there; chip_smoke.py measures this kernel at 1.60 ms (NVIDIA H100 80GB
// HBM3, 700 W), 7.3x the bound, its FMAs fed from shared memory at one
// load per two. The three products are the shape of a tensor-core GEMM;
// a 3xTF32 or bf16-operand version on wgmma is the next step.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int SQ = 64;     // chunk length
constexpr int SNT = 256;   // threads per block: 16 x 16

// Element strides of a 3-D operand [B, T, n] (n: N for B and C, nh for dt).
struct Strides3 {
  int64_t b, t, n;
};

template <int HP, int N>
constexpr int smem_floats() {
  return SQ * HP              // Xs: [SQ][HP]
         + 2 * SQ * (N + 1)   // Bs, Cs: [SQ][N + 1]
         + SQ * (SQ + 1)      // Ms: [SQ][SQ + 1]
         + HP * (N + 1)       // Ss: [HP][N + 1], the state
         + 4 * SQ;            // cum, dts, ecum, wts: [SQ]
}

template <typename T, int HP, int N>
__global__ void __launch_bounds__(SNT) ssd_kernel(
    const T* __restrict__ x, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ D,
    const float* __restrict__ s0, T* __restrict__ y,
    float* __restrict__ s_out, int T_len, int nh, Strides sx, Strides3 sb,
    Strides3 sc, Strides3 sd, Strides sy) {
  static_assert(HP % 16 == 0 && N % 16 == 0 && SQ == 64, "tile shape");
  constexpr int LN = N + 1, LM = SQ + 1;
  constexpr int PJ = HP / 16, NJ = N / 16;

  extern __shared__ float smem[];
  float* Xs = smem;
  float* Bs = Xs + SQ * HP;
  float* Cs = Bs + SQ * LN;
  float* Ms = Cs + SQ * LN;
  float* Ss = Ms + SQ * LM;
  float* cum = Ss + HP * LN;   // P_t
  float* dts = cum + SQ;       // dt_t
  float* ecum = dts + SQ;      // exp(P_t)
  float* wts = ecum + SQ;      // exp(P_{L-1} - P_s) dt_s

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const T* xb = x + b * sx.b + h * sx.h;
  const T* Bb = Bm + b * sb.b;
  const T* Cb = Cm + b * sc.b;
  const float* db = dt + b * sd.b + h * sd.n;
  T* yb = y + b * sy.b + h * sy.h;
  const float Ah = A[h], Dh = D[h];
  const int64_t sbase = ((int64_t)b * nh + h) * HP * N;

  for (int i = tid; i < HP * N; i += SNT)
    Ss[(i / N) * LN + i % N] = s0 ? s0[sbase + i] : 0.f;

  for (int c0 = 0; c0 < T_len; c0 += SQ) {
    const int L = min(SQ, T_len - c0);
    __syncthreads();  // the previous chunk's tiles are consumed
    for (int idx = tid; idx < SQ * HP; idx += SNT) {
      const int t = idx / HP, p = idx % HP;
      Xs[idx] = t < L ? to_float(xb[(int64_t)(c0 + t) * sx.t + p * sx.d])
                      : 0.f;
    }
    for (int idx = tid; idx < SQ * N; idx += SNT) {
      const int t = idx / N, n = idx % N;
      const bool in = t < L;
      const int64_t tt = c0 + t;
      Bs[t * LN + n] = in ? to_float(Bb[tt * sb.t + n * sb.n]) : 0.f;
      Cs[t * LN + n] = in ? to_float(Cb[tt * sc.t + n * sc.n]) : 0.f;
    }
    if (tid < SQ) dts[tid] = tid < L ? db[(int64_t)(c0 + tid) * sd.t] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float c = 0.f;
      for (int t = 0; t < SQ; ++t) {
        c += dts[t] * Ah;
        cum[t] = c;
      }
    }
    __syncthreads();
    // Padded steps have dt = 0, so P_{SQ-1} = P_{L-1}.
    if (tid < SQ) {
      ecum[tid] = expf(cum[tid]);
      wts[tid] = expf(cum[SQ - 1] - cum[tid]) * dts[tid];
    }
    // M[t][s] = exp(P_t - P_s) (C_t . B_s) dt_s for s <= t.
    {
      float m[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) m[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float ct[4], bs[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ct[i] = Cs[(ty + 16 * i) * LN + n];
          bs[i] = Bs[(tx + 16 * i) * LN + n];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j) m[i][j] = fmaf(ct[i], bs[j], m[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i, s = tx + 16 * j;
          Ms[t * LM + s] =
              s <= t ? expf(cum[t] - cum[s]) * m[i][j] * dts[s] : 0.f;
        }
    }
    __syncthreads();

    // y_t = sum_s M[t][s] x_s + exp(P_t) S C_t + D x_t
    {
      float acc[4][PJ], car[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = car[i][j] = 0.f;
#pragma unroll 4
      for (int s = 0; s < SQ; ++s) {
        float mt[4], xv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) mt[i] = Ms[(ty + 16 * i) * LM + s];
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = Xs[s * HP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(mt[i], xv[j], acc[i][j]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float ct[4], sv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) ct[i] = Cs[(ty + 16 * i) * LN + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) sv[j] = Ss[(tx + 16 * j) * LN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) car[i][j] = fmaf(ct[i], sv[j], car[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= L) continue;
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int p = tx + 16 * j;
          const float out = acc[i][j] + ecum[t] * car[i][j] +
                            Dh * Xs[t * HP + p];
          yb[(int64_t)(c0 + t) * sy.t + p * sy.d] = from_float<T>(out);
        }
      }
    }
    __syncthreads();  // every read of the state is done

    // S <- exp(P_{L-1}) S + sum_s (wts_s x_s) B_s^T; each thread its tile.
    {
      const float decay = ecum[SQ - 1];
      float acc[PJ][NJ];
#pragma unroll
      for (int i = 0; i < PJ; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          acc[i][j] = decay * Ss[(ty + 16 * i) * LN + tx + 16 * j];
#pragma unroll 4
      for (int s = 0; s < SQ; ++s) {
        const float w = wts[s];
        float xw[PJ], bv[NJ];
#pragma unroll
        for (int i = 0; i < PJ; ++i) xw[i] = w * Xs[s * HP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NJ; ++j) bv[j] = Bs[s * LN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < PJ; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(xw[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < PJ; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          Ss[(ty + 16 * i) * LN + tx + 16 * j] = acc[i][j];
    }
  }
  __syncthreads();
  for (int i = tid; i < HP * N; i += SNT)
    s_out[sbase + i] = Ss[(i / N) * LN + i % N];
}

template <typename T, int HP, int N>
cudaError_t launch(const void* x, const void* Bm, const void* Cm,
                   const float* dt, const float* A, const float* D,
                   const float* s0, void* y, float* s_out, int B, int T_len,
                   int nh, Strides sx, Strides3 sb, Strides3 sc, Strides3 sd,
                   Strides sy, cudaStream_t stream) {
  const int smem = smem_floats<HP, N>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, HP, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  ssd_kernel<T, HP, N><<<dim3(nh, B), SNT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), dt, A, D, s0, static_cast<T*>(y), s_out,
      T_len, nh, sx, sb, sc, sd, sy);
  return cudaGetLastError();
}

template <typename T, int HP>
cudaError_t dispatch_n(int N, const void* x, const void* Bm, const void* Cm,
                       const float* dt, const float* A, const float* D,
                       const float* s0, void* y, float* s_out, int B,
                       int T_len, int nh, Strides sx, Strides3 sb,
                       Strides3 sc, Strides3 sd, Strides sy,
                       cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<T, HP, 16>(x, Bm, Cm, dt, A, D, s0, y, s_out, B, T_len,
                               nh, sx, sb, sc, sd, sy, stream);
    case 32:
      return launch<T, HP, 32>(x, Bm, Cm, dt, A, D, s0, y, s_out, B, T_len,
                               nh, sx, sb, sc, sd, sy, stream);
    case 64:
      return launch<T, HP, 64>(x, Bm, Cm, dt, A, D, s0, y, s_out, B, T_len,
                               nh, sx, sb, sc, sd, sy, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int hp, int N, const void* x, const void* Bm,
                     const void* Cm, const float* dt, const float* A,
                     const float* D, const float* s0, void* y, float* s_out,
                     int B, int T_len, int nh, Strides sx, Strides3 sb,
                     Strides3 sc, Strides3 sd, Strides sy,
                     cudaStream_t stream) {
  switch (hp) {
    case 32:
      return dispatch_n<T, 32>(N, x, Bm, Cm, dt, A, D, s0, y, s_out, B, T_len,
                               nh, sx, sb, sc, sd, sy, stream);
    case 64:
      return dispatch_n<T, 64>(N, x, Bm, Cm, dt, A, D, s0, y, s_out, B, T_len,
                               nh, sx, sb, sc, sd, sy, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [B, T, nh, hp] and y [B, T, nh, hp], each given by its element strides
// in (b, h, t, d) order; Bm and Cm [B, T, N] and dt [B, T, nh] by theirs in
// axis order; A, D [nh] f32 contiguous; s0 (may be null: zeros) and s_out
// [B, nh, hp, N] f32 contiguous. Launches on `stream` and returns
// cudaGetLastError() after the launch.
EXPORT int ssm_scan_fwd(
    int dtype, int hp, int N, const void* x, const void* Bm, const void* Cm,
    const void* dt, const void* A, const void* D, const void* s0, void* y,
    void* s_out, int B, int T, int nh,
    int64_t sx_b, int64_t sx_h, int64_t sx_t, int64_t sx_d,
    int64_t sb_b, int64_t sb_t, int64_t sb_n,
    int64_t sc_b, int64_t sc_t, int64_t sc_n,
    int64_t sd_b, int64_t sd_t, int64_t sd_h,
    int64_t sy_b, int64_t sy_h, int64_t sy_t, int64_t sy_d, void* stream) {
  if (B <= 0 || T <= 0 || nh <= 0 || !dt || !A || !D || !s_out)
    return cudaErrorInvalidValue;
  const Strides sx{sx_b, sx_h, sx_t, sx_d}, sy{sy_b, sy_h, sy_t, sy_d};
  const Strides3 sb{sb_b, sb_t, sb_n}, sc{sc_b, sc_t, sc_n};
  const Strides3 sd{sd_b, sd_t, sd_h};
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  const float* s0f = static_cast<const float*>(s0);
  float* sof = static_cast<float*>(s_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch<float>(hp, N, x, Bm, Cm, dtf, Af, Df, s0f, y, sof, B, T,
                           nh, sx, sb, sc, sd, sy, st);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(hp, N, x, Bm, Cm, dtf, Af, Df, s0f, y, sof,
                                   B, T, nh, sx, sb, sc, sd, sy, st);
  return cudaErrorInvalidValue;
}
