// RWKV6 WKV recurrence (data-dependent per-channel decay), chunked closed
// form, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rwkv6_wkv/kernel.py, function
// `rwkv6_wkv` (body `_kernel`).
//
// What it computes, per (b, head), with the state S [hd, hd] in f32:
//     y_t = r_t (S + diag(u) k_t v_t^T),   S <- diag(exp(lw_t)) S + k_t v_t^T
// evaluated chunk by chunk as the model's `chunk_step` does. Within a chunk
// of L steps, with C[t] = lw_0 + ... + lw_{t-1} (C[0] = 0, cumulative over
// the chunk only, so every exponent below is <= 0):
//     y_t = sum_{s<t} A[t][s] v_s + (r_t . u k_t) v_t + (r_t exp(C[t])) S
//     A[t][s] = sum_c r_t[c] exp(C[t][c] - C[s+1][c]) k_s[c]
//     S  <- diag(exp(C[L])) S + sum_s (k_s exp(C[L] - C[s+1])) v_s^T.
// Unlike the TPU kernel, which starts from zeros and returns y, this one
// takes the initial state and returns the final one (prefill on top of a
// cache, decode after prefill). Inputs are f32 or bf16 (r, k, v and lw of
// one type); the math is f32; y has the inputs' type.
//
// Design.
//  * Grid (H, B): one block per (b, head), hd / 16 warps; warp w owns the
//    value columns v in [16 w, 16 w + 16): of y, and of the state, kept
//    transposed (S^T [v][c]) as mma accumulators in registers for the
//    whole sweep. With the channel index c permuted within each 8
//    (k q <-> c 2q, k q + 4 <-> c 2q + 1), that accumulator layout is the
//    B fragment of (r exp(C)) S, so the state never leaves registers.
//  * The TPU kernel keeps a [Q, Q, hd] decay tensor resident (1 MB at
//    Q = hd = 64); the first, scalar port computed that decay per (t, s,
//    channel) inside the channel sum, Q^2 hd / 2 exponentials per chunk.
//    Here the 32-step chunk is cut into two sub-chunks of 16 steps, and
//    for t in sub-chunk 1 and s in sub-chunk 0 (m = 16)
//        A[t][s] = sum_c (r_t[c] e^{C[t][c] - C[m][c]})
//                        (k_s[c] e^{C[m][c] - C[s+1][c]}),
//    both exponents <= 0, so exact and free of overflow: a product over
//    channels on the tensor cores. The two diagonal 16 x 16 blocks keep
//    explicit exponentials (strictly below the diagonal, the bonus
//    r (u k) on it): 2 x 136 pairs x hd, threads pairing row i with row
//    15 - i so every thread sums 17 pairs, each over 8 channels, joined
//    by shuffles.
//  * Every product (the off-diagonal block, A V, (r e^C) S and the state
//    update) runs on the tensor cores in 3xTF32 (mma.sync m16n8k8; each
//    f32 operand split into TF32 hi + lo, hi*hi + hi*lo + lo*hi summed in
//    f32). One TF32 product alone misses the f32 tolerance by two orders
//    of magnitude.
//  * Decays are kept as base-2 logarithms (lw log2 e), summed per channel
//    by two lanes of a warp (16 steps each, joined by a shuffle), and
//    raised by the special-function unit's ex2.approx.ftz (~2 ulp; a
//    result below 2^-126 flushes to 0, where it weighs nothing beside the
//    f32 tolerance): ~Q hd (1 + 1.5) + 2 x 136 hd exponentials per chunk,
//    ~22k at hd 64, where the scalar kernel took 66k for 32 steps.
//  * The chunk is 32 steps, and r, k, v and lw of chunk c + 1 are loaded
//    by 16-byte cp.async (bf16 converted on load) while chunk c computes:
//    two stages and the chunk's C, r e^C, k e^{C[L] - C}, A take ~107 KB,
//    so two blocks share an SM (a 64-step chunk would need ~210 KB and
//    one block of 4 warps per SM). Rows are padded (hd + 8, Q + 4
//    floats) so fragment loads are free of bank conflicts.
//  * A ragged last chunk is zero-padded on load: a padded step has
//    r = k = v = 0 and lw = 0, which leaves C, y and S exactly as they
//    were, so nothing else is masked. Operands are read through their
//    strides ([B, T, H, hd] with a unit last stride), with no copies;
//    r, k, v and lw need 16-byte-aligned bases and strides (the wrapper
//    raises otherwise).
//
// What bounds it on the H100: the recurrence moves 5 Q hd elements per
// chunk and (b, head) for ~4 Q hd^2 flops, so at the served shape (B 8,
// T 999, H 64, hd 64, f32) its bound is 0.200 ms, by bytes (its flops take
// 0.032 ms at the TF32 tensor rate, 3x that in 3xTF32). chip_smoke.py
// measures 0.590 ms there (phase 6, NVIDIA H100 80GB HBM3, 700 W; the
// earlier scalar kernel took 1.54 ms), 2.9x the bound. Four warps per
// block and two blocks per SM leave two warps per scheduler, too few to
// hide the latency of the diagonal blocks' exponentials and shuffles,
// which take the largest share of a chunk; the tensor cores are mostly
// idle.

#include <math.h>

#include "common.cuh"
#include "scan.cuh"

namespace {

constexpr int WQ = 32;    // chunk length
constexpr int SUB = 16;   // sub-chunk length
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct WkvShape {
  static constexpr int NW = HD / 16;       // warps
  static constexpr int NTH = 32 * NW;
  static constexpr int E = HD / 8;         // lanes per diagonal pair
  static constexpr int LD = HD + 8;        // [t][c] rows: 8 mod 32 words
  static constexpr int LDA = WQ + 4;       // A rows: 4 mod 32
  static constexpr int STAGE = 4 * WQ * LD;
  static constexpr int SMEM_FLOATS =
      2 * STAGE + (WQ + 1) * LD + 2 * WQ * LD + WQ * LDA + 2 * HD;
};

template <typename T, int HD>
__global__ void __launch_bounds__(WkvShape<HD>::NTH, 2) wkv_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ lw,
    const float* __restrict__ u, const float* __restrict__ s0,
    T* __restrict__ y, float* __restrict__ s_out, float* __restrict__ states,
    int T_len, int H, Strides sr, Strides sk, Strides sv, Strides sl,
    Strides sy) {
  using W_ = WkvShape<HD>;
  constexpr int NTH = W_::NTH, E = W_::E, LD = W_::LD;
  constexpr int LDA = W_::LDA, STAGE = W_::STAGE, NTN = HD / 8;
  static_assert(HD % 16 == 0 && WQ == 2 * SUB && NTH / E == 16,
                "tile shape");

  extern __shared__ __align__(16) float smem[];
  float* Cs = smem + 2 * STAGE;    // C[t] log2 e, t = 0..WQ [WQ + 1][LD]
  float* Rh = Cs + (WQ + 1) * LD;  // r_t exp(C[t])             [WQ][LD]
  float* Kh = Rh + WQ * LD;        // k_s exp(C[L] - C[s + 1])  [WQ][LD]
  float* As = Kh + WQ * LD;        // A[t][s], bonus on the diagonal
  float* dS = As + WQ * LDA;       // exp(C[L])                 [HD]
  float* us = dS + HD;             // u                         [HD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y, v0 = 16 * warp;
  const T* rb = r + b * sr.b + h * sr.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* lb = lw + b * sl.b + h * sl.h;
  T* yb = y + b * sy.b + h * sy.h;

  auto issue = [&](int c0, int st) {
    float* S = smem + st * STAGE;
    const int L = min(WQ, T_len - c0);
    load_tile<WQ, HD, NTH>(S, LD, rb + c0 * sr.t, sr.t, L, tid);
    load_tile<WQ, HD, NTH>(S + WQ * LD, LD, kb + c0 * sk.t, sk.t, L, tid);
    load_tile<WQ, HD, NTH>(S + 2 * WQ * LD, LD, vb + c0 * sv.t, sv.t, L,
                           tid);
    load_tile<WQ, HD, NTH>(S + 3 * WQ * LD, LD, lb + c0 * sl.t, sl.t, L,
                           tid);
    cp_async_commit();
  };

  // S^T rows v0 + g (+ 8), columns 8 j + 2 q (+ 1), in registers.
  float Sacc[NTN][4];
  const int64_t sbase = ((int64_t)b * H + h) * HD * HD;
#pragma unroll
  for (int j = 0; j < NTN; ++j) {
    const int c = 8 * j + 2 * q;
    Sacc[j][0] = s0 ? s0[sbase + c * HD + v0 + g] : 0.f;
    Sacc[j][1] = s0 ? s0[sbase + (c + 1) * HD + v0 + g] : 0.f;
    Sacc[j][2] = s0 ? s0[sbase + c * HD + v0 + g + 8] : 0.f;
    Sacc[j][3] = s0 ? s0[sbase + (c + 1) * HD + v0 + g + 8] : 0.f;
  }
  for (int c = tid; c < HD; c += NTH) us[c] = u[h * HD + c];
  // Above the diagonal of the two diagonal blocks A stays 0.
  for (int i = tid; i < WQ * SUB; i += NTH) {
    const int t = i / SUB, s = (t / SUB) * SUB + i % SUB;
    if (s > t) As[t * LDA + s] = 0.f;
  }

  // Diagonal blocks: this thread's row pair (16 ib + pr, 16 ib + 15 - pr)
  // and channels e + E cc.
  const int e = tid % E, slot = tid / E, ib = slot / 8, pr = slot % 8;
  const int tA = SUB * ib + pr, tB = SUB * ib + SUB - 1 - pr;

  issue(0, 0);
  for (int c0 = 0, st = 0; c0 < T_len; c0 += WQ, st ^= 1) {
    const int L = min(WQ, T_len - c0);
    cp_async_wait<0>();
    __syncthreads();  // chunk c landed; every warp is done with chunk c - 1
    if (c0 + WQ < T_len) issue(c0 + WQ, st ^ 1);
    if (states) {  // the state this chunk starts from, for the backward
      float* sc = states + (sbase * ((T_len + WQ - 1) / WQ) +
                            (int64_t)(c0 / WQ) * HD * HD);
#pragma unroll
      for (int j = 0; j < NTN; ++j) {
        const int c = 8 * j + 2 * q;
        sc[c * HD + v0 + g] = Sacc[j][0];
        sc[(c + 1) * HD + v0 + g] = Sacc[j][1];
        sc[c * HD + v0 + g + 8] = Sacc[j][2];
        sc[(c + 1) * HD + v0 + g + 8] = Sacc[j][3];
      }
    }
    const float* Rs = smem + st * STAGE;
    const float* Ks = Rs + WQ * LD;
    const float* Vs = Ks + WQ * LD;
    const float* Ls = Vs + WQ * LD;

    // C[t + 1][ch] = (lw_0 + ... + lw_t) log2 e: two lanes per channel,
    // 16 steps each, the second adding the first's total.
    {
      const int ch = 16 * warp + (lane & 15), half = lane >> 4;
      float part[SUB];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        acc += Ls[(SUB * half + i) * LD + ch] * kLog2e;
        part[i] = acc;
      }
      const float off = __shfl_sync(0xffffffffu, acc, lane & 15);
      if (half == 0) Cs[ch] = 0.f;
#pragma unroll
      for (int i = 0; i < SUB; ++i)
        Cs[(SUB * half + i + 1) * LD + ch] = half ? part[i] + off : part[i];
    }
    __syncthreads();

    // r e^{C[t]}, k e^{C[L] - C[s+1]} and e^{C[L]} (C[WQ] = C[L]: padded
    // steps have lw = 0).
    const float* CL = Cs + WQ * LD;
    for (int i = tid; i < WQ * HD; i += NTH) {
      const int t = i / HD, c = i % HD;
      Rh[t * LD + c] = Rs[t * LD + c] * fast_exp2(Cs[t * LD + c]);
      Kh[t * LD + c] =
          Ks[t * LD + c] * fast_exp2(CL[c] - Cs[(t + 1) * LD + c]);
    }
    for (int c = tid; c < HD; c += NTH) dS[c] = fast_exp2(CL[c]);

    // The off-diagonal block, rows 16..31, columns 8 warp .. + 7 (warps 0
    // and 1): (r_t e^{C[t] - C[16]}) (k_s e^{C[16] - C[s+1]})^T.
    if (warp < 2) {
      const float* Cm = Cs + SUB * LD;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      const int s = 8 * warp + g;
#pragma unroll
      for (int kk = 0; kk < NTN; ++kk) {
        const int c = 8 * kk + 2 * q;
        const float2 cm = *reinterpret_cast<const float2*>(Cm + c);
        Frag<4> a;
        Frag<2> bf;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = SUB + g + 8 * half;
          const float2 rv = *reinterpret_cast<const float2*>(Rs + t * LD + c);
          const float2 cv = *reinterpret_cast<const float2*>(Cs + t * LD + c);
          a.set(half, rv.x * fast_exp2(cv.x - cm.x));
          a.set(2 + half, rv.y * fast_exp2(cv.y - cm.y));
        }
        const float2 kv = *reinterpret_cast<const float2*>(Ks + s * LD + c);
        const float2 cs =
            *reinterpret_cast<const float2*>(Cs + (s + 1) * LD + c);
        bf.set(0, kv.x * fast_exp2(cm.x - cs.x));
        bf.set(1, kv.y * fast_exp2(cm.y - cs.y));
        mma3(d, a, bf);
      }
      store2(As + (SUB + g) * LDA + 8 * warp + 2 * q, d[0], d[1]);
      store2(As + (SUB + g + 8) * LDA + 8 * warp + 2 * q, d[2], d[3]);
    }

    // The diagonal blocks: 17 pairs per thread, for rows tA (s = 16 ib ..
    // tA) then tB (s = 16 ib .. tB), summed over channels e + E cc and
    // joined across the E lanes of the pair.
    {
      float rA[8], cA[8], rB[8], cB[8], uu[8];
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int c = e + E * cc;
        rA[cc] = Rs[tA * LD + c], cA[cc] = Cs[tA * LD + c];
        rB[cc] = Rs[tB * LD + c], cB[cc] = Cs[tB * LD + c];
        uu[cc] = us[c];
      }
#pragma unroll 1  // unrolled, it measured slower
      for (int j = 0; j <= SUB; ++j) {
        const bool first = j <= pr;
        const int t = first ? tA : tB;
        const int s = SUB * ib + (first ? j : j - pr - 1);
        float sum = 0.f;
        if (s == t) {
#pragma unroll
          for (int cc = 0; cc < 8; ++cc)
            sum = fmaf((first ? rA[cc] : rB[cc]) * uu[cc],
                       Ks[s * LD + e + E * cc], sum);
        } else {
#pragma unroll
          for (int cc = 0; cc < 8; ++cc) {
            const int c = e + E * cc;
            const float ct = first ? cA[cc] : cB[cc];
            sum = fmaf((first ? rA[cc] : rB[cc]) * Ks[s * LD + c],
                       fast_exp2(ct - Cs[(s + 1) * LD + c]), sum);
          }
        }
#pragma unroll
        for (int o = E / 2; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (e == 0) As[t * LDA + s] = sum;
      }
    }
    __syncthreads();

    // Y[i][jj]: rows 16 i + g (+ 8), columns v0 + 8 jj + 2 q (+ 1).
    float Y[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int x = 0; x < 4; ++x) Y[i][jj][x] = 0.f;

    // Y = (r e^C) S, the state as the chunk found it.
#pragma unroll
    for (int kk = 0; kk < NTN; ++kk) {
      Frag<2> sf0, sf1;
      sf0.set(0, Sacc[kk][0]), sf0.set(1, Sacc[kk][1]);
      sf1.set(0, Sacc[kk][2]), sf1.set(1, Sacc[kk][3]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        Frag<4> a;
        const float2 r0 = *reinterpret_cast<const float2*>(
            Rh + (16 * i + g) * LD + 8 * kk + 2 * q);
        const float2 r1 = *reinterpret_cast<const float2*>(
            Rh + (16 * i + g + 8) * LD + 8 * kk + 2 * q);
        a.set(0, r0.x), a.set(1, r1.x), a.set(2, r0.y), a.set(3, r1.y);
        mma3(Y[i][0], a, sf0);
        mma3(Y[i][1], a, sf1);
      }
    }
    // Y += A V over the k-steps at or below each row tile's diagonal.
#pragma unroll
    for (int kk = 0; kk < WQ / 8; ++kk) {
      const int sa = 8 * kk + q, sb = sa + 4;
      Frag<2> vf[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        vf[jj].set(0, Vs[sa * LD + v0 + 8 * jj + g]);
        vf[jj].set(1, Vs[sb * LD + v0 + 8 * jj + g]);
      }
#pragma unroll
      for (int i = kk / 2; i < 2; ++i) {
        Frag<4> a;
        a.set(0, As[(16 * i + g) * LDA + sa]);
        a.set(1, As[(16 * i + g + 8) * LDA + sa]);
        a.set(2, As[(16 * i + g) * LDA + sb]);
        a.set(3, As[(16 * i + g + 8) * LDA + sb]);
        mma3(Y[i][0], a, vf[0]);
        mma3(Y[i][1], a, vf[1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = 16 * i + g + 8 * half;
        if (t >= L) continue;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          store2(yb + (int64_t)(c0 + t) * sy.t + v0 + 8 * jj + 2 * q,
                 Y[i][jj][2 * half], Y[i][jj][2 * half + 1]);
      }

    // S^T <- S^T diag(e^{C[L]}) + V^T (k e^{C[L] - C[s+1]}).
#pragma unroll
    for (int j = 0; j < NTN; ++j) {
      const float2 dd =
          *reinterpret_cast<const float2*>(dS + 8 * j + 2 * q);
      Sacc[j][0] *= dd.x, Sacc[j][1] *= dd.y;
      Sacc[j][2] *= dd.x, Sacc[j][3] *= dd.y;
    }
#pragma unroll
    for (int kk = 0; kk < WQ / 8; ++kk) {
      const int sa = 8 * kk + q, sb = sa + 4;
      Frag<4> a;
      a.set(0, Vs[sa * LD + v0 + g]);
      a.set(1, Vs[sa * LD + v0 + g + 8]);
      a.set(2, Vs[sb * LD + v0 + g]);
      a.set(3, Vs[sb * LD + v0 + g + 8]);
#pragma unroll
      for (int j = 0; j < NTN; ++j) {
        Frag<2> bf;
        bf.set(0, Kh[sa * LD + 8 * j + g]);
        bf.set(1, Kh[sb * LD + 8 * j + g]);
        mma3(Sacc[j], a, bf);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NTN; ++j) {
    const int c = 8 * j + 2 * q;
    s_out[sbase + c * HD + v0 + g] = Sacc[j][0];
    s_out[sbase + (c + 1) * HD + v0 + g] = Sacc[j][1];
    s_out[sbase + c * HD + v0 + g + 8] = Sacc[j][2];
    s_out[sbase + (c + 1) * HD + v0 + g + 8] = Sacc[j][3];
  }
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* lw, const float* u, const float* s0, void* y,
                   float* s_out, float* states, int B, int T_len, int H,
                   Strides sr, Strides sk, Strides sv, Strides sl, Strides sy,
                   cudaStream_t stream) {
  using W_ = WkvShape<HD>;
  constexpr int smem = W_::SMEM_FLOATS * (int)sizeof(float);
  static unsigned long long done = 0;
  cudaError_t err = set_smem_once(wkv_kernel<T, HD>, smem, &done);
  if (err != cudaSuccess) return err;
  wkv_kernel<T, HD><<<dim3(H, B), W_::NTH, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(lw), u, s0,
      static_cast<T*>(y), s_out, states, T_len, H, sr, sk, sv, sl, sy);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* r, const void* k, const void* v,
                        const void* lw, const float* u, const float* s0,
                        void* y, float* s_out, float* states, int B,
                        int T_len, int H, Strides sr, Strides sk, Strides sv,
                        Strides sl, Strides sy, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(r, k, v, lw, u, s0, y, s_out, states, B, T_len, H,
                           sr, sk, sv, sl, sy, stream);
    case 64:
      return launch<T, 64>(r, k, v, lw, u, s0, y, s_out, states, B, T_len, H,
                           sr, sk, sv, sl, sy, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, lw [B, T, H, hd] and y [B, T, H, hd], each given by its element
// strides in (b, h, t, d) order, with a unit last stride; r, k, v and lw
// need 16-byte-aligned bases and strides. u [H, hd] f32 contiguous; s0 (may
// be null: zeros) and s_out [B, H, hd, hd] f32 contiguous; states (may be
// null: not written) [B, H, ceil(T / 32), hd, hd] f32 contiguous, the state
// each chunk starts from, which the backward (rwkv6_wkv_bwd.cu) reads.
// Launches on `stream` and returns cudaGetLastError() after the launch.
EXPORT int rwkv6_wkv_fwd(
    int dtype, int hd, const void* r, const void* k, const void* v,
    const void* lw, const void* u, const void* s0, void* y, void* s_out,
    void* states, int B, int T, int H,
    int64_t sr_b, int64_t sr_h, int64_t sr_t, int64_t sr_d,
    int64_t sk_b, int64_t sk_h, int64_t sk_t, int64_t sk_d,
    int64_t sv_b, int64_t sv_h, int64_t sv_t, int64_t sv_d,
    int64_t sl_b, int64_t sl_h, int64_t sl_t, int64_t sl_d,
    int64_t sy_b, int64_t sy_h, int64_t sy_t, int64_t sy_d, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || !u || !s_out || sr_d != 1 ||
      sk_d != 1 || sv_d != 1 || sl_d != 1 || sy_d != 1)
    return cudaErrorInvalidValue;
  const Strides sr{sr_b, sr_h, sr_t, sr_d}, sk{sk_b, sk_h, sk_t, sk_d};
  const Strides sv{sv_b, sv_h, sv_t, sv_d}, sl{sl_b, sl_h, sl_t, sl_d};
  const Strides sy{sy_b, sy_h, sy_t, sy_d};
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* sof = static_cast<float*>(s_out);
  float* stf = static_cast<float*>(states);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_hd<float>(hd, r, k, v, lw, uf, s0f, y, sof, stf, B, T, H,
                              sr, sk, sv, sl, sy, st);
  if (dtype == kBFloat16)
    return dispatch_hd<__nv_bfloat16>(hd, r, k, v, lw, uf, s0f, y, sof, stf,
                                      B, T, H, sr, sk, sv, sl, sy, st);
  return cudaErrorInvalidValue;
}
