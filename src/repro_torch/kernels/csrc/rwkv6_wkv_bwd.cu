// Backward of the RWKV6 WKV recurrence (rwkv6_wkv.cu), chunked, for Hopper
// (sm_90a).
//
// The backward of repro/kernels/rwkv6_wkv/kernel.py::rwkv6_wkv, for
// training: the reference differentiates its XLA `chunk_step` scan
// instead; the TPU kernel has no backward.
//
// What it computes, per (b, head), from the forward's y_t = r_t (S_{t-1} +
// diag(u) k_t v_t^T) and S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T (state
// [hd, hd] f32): given dy and d(final state), the gradients of r, k, v, lw,
// u and the initial state. Within a 32-step chunk, C[t] = lw_0 + ... +
// lw_{t-1} per channel (C[0] = 0), A[t][s] = sum_c r_t k_s e^{C[t] -
// C[s+1]} for s < t and r_t . u k_t on the diagonal, dA[t][s] = dy_t . v_s;
// S_in is the state the chunk starts from and Ge the gradient of the state
// it ends with (L = 32, padded steps included):
//     dv_s = sum_{t>=s} A[t][s] dy_t + Ge^T (k_s e^{C[L] - C[s+1]})
//     dr_t = sum_{s<t} dA[t][s] k_s e^{C[t]-C[s+1]} + dA[t][t] u k_t
//            + e^{C[t]} S_in dy_t
//     dk_s = sum_{t>s} dA[t][s] r_t e^{C[t]-C[s+1]} + dA[s][s] u r_s
//            + e^{C[L]-C[s+1]} Ge v_s
//     du = sum dA[t][t] r_t k_t,   G at the chunk's start = e^{C[L]} Ge +
//     sum_t (r_t e^{C[t]}) dy_t^T.
// The loss sees the cumulative decays only through r_t e^{C[t]}, k_s
// e^{-C[s+1]} and the boundary e^{C[L]}, so per channel
//     dC[j] = r_j (dr_j - bonus) - k_{j-1} (dk_{j-1} - bonus)
//             (+ sum_s k_s e^{C[L]-C[s+1]} Ge v_s + e^{C[L]} rowsum(Ge S_in)
//              at j = L),
// and dlw_i = sum_{j > i} dC[j], a reverse sum within the chunk.
//
// Design: one kernel sweeps the chunks from last to first, a second sums
// du over the batch; no float atomics, the same bits on every run.
//  * Grid (H, B): one block per (head, batch row). The state gradient G
//    lives in registers as mma accumulators for the whole sweep (8 per
//    thread at hd 64), updated once per chunk by G <- diag(e^{C[L]}) G +
//    (r e^C)^T dy. Nothing goes to device memory between the chunks (the
//    first kernels' `ge` workspace, 0.50 GiB at the training shape, and
//    its launch are gone). Each chunk copies G to shared memory once: Ge
//    v_s contracts over v, Ge^T k_s over c, and an accumulator can only be
//    read as an operand along one of them. S_in comes from the forward's
//    chunk states (saved under autograd, not recomputed).
//  * Every product runs on the tensor cores in 3xTF32 (mma.sync m16n8k8,
//    scan.cuh's split; one TF32 product misses the f32 tolerance ~25x,
//    tests/test_torch_scan_bwd.py shows it): dy v^T; dy S_in^T, v Ge^T,
//    (k e^{C[L]-C}) Ge, A^T dy and the update of G; and, as in the forward,
//    the decay between the two 16-step sub-chunks factorised at their
//    midpoint m = 16: for t >= m > s
//        A[t][s]  = sum_c (r_t e^{C[t]-C[m]}) (k_s e^{C[m]-C[s+1]}),
//        dr_t    += e^{C[t]-C[m]} sum_s dA[t][s] (k_s e^{C[m]-C[s+1]}),
//        dk_s    += e^{C[m]-C[s+1]} sum_t dA[t][s] (r_t e^{C[t]-C[m]}),
//    every exponent <= 0, so exact and free of overflow.
//  * The two diagonal 16 x 16 blocks keep explicit exponentials (the
//    special-function unit's ex2.approx on base-2 logarithms, as the
//    forward): A's and dr's from one exponential per (t, s, channel), by
//    threads that pair row i with row 15 - i (17 pairs each, 4 channels,
//    joined across 16 lanes); dk's by threads that pair columns the same
//    way. ~38 k exponentials per chunk at hd 64, where the first kernel
//    took ~96 k.
//  * 16 warps, one block per SM: S_in and Ge (37 KB at hd 64), the
//    double-buffered r, k, v, lw, dy (92 KB) and the chunk's decay factors
//    and products (69 KB) take 198 KB; two blocks would need 99 KB each,
//    and the inputs alone pass that double-buffered. The next chunk's r, k,
//    v, lw, dy load by 16-byte cp.async (bf16 converted on load) while this
//    one computes; S_in, kept once, loads after its last use and lands
//    during the next chunk's first phases. Rows are padded to 8 mod 32
//    words (hd + 8, Q + 8).
// Numerics (as the first kernels found necessary). Decays are base-2 logs
// summed per channel; every exponent is a difference within the chunk,
// <= 0; dlw is a reverse sum of dC within the chunk. A ragged last chunk is
// zero-padded on load: r = k = v = dy = 0 and lw = 0 leave every sum exact,
// and only rows t < L are written. Gradients come out in r's type.
//
// What bounds it on the H100: bytes. At the training shape (B 8, T 2048,
// H 64, hd 64, f32) it must read r, k, v, lw, dy and write dr, dk, dv, dlw
// once: 0.7237 ms at 3.35 TB/s; the stepwise backward's 10 flops per state
// element per step take less in 3xTF32. The chunk states it reads add
// 0.16 ms of bytes, which the bound leaves out. PERF.md holds the time
// measured on the card.

#include <math.h>

#include "common.cuh"
#include "scan.cuh"

namespace {

constexpr int Q = 32;      // chunk length, as the forward's
constexpr int SUB = 16;    // sub-chunk length
constexpr int NW = 16;     // warps per block
constexpr int NTH = 32 * NW;
constexpr int E = 16;      // lanes per diagonal row (or column) pair
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, in floats: two stages of the chunk's inputs, S_in, Ge,
// the decays (C in base-2 logs and three tables of exponentials), dA, A,
// dr and dk of the chunk, and small vectors.
template <int HD>
struct BwdShape {
  static constexpr int LD = HD + 8, LDQ = Q + 8;
  static constexpr int ST_R = 0, ST_K = Q * LD, ST_V = 2 * Q * LD;
  static constexpr int ST_L = 3 * Q * LD, ST_DY = 4 * Q * LD;
  static constexpr int STAGE = 5 * Q * LD;
  static constexpr int SIN = 2 * STAGE;       // S_in [HD][LD]
  static constexpr int GE = SIN + HD * LD;    // Ge   [HD][LD]
  static constexpr int CS = GE + HD * LD;     // C[t] log2 e [Q + 1][LD]
  static constexpr int EC = CS + (Q + 1) * LD;  // e^{C[t]}
  static constexpr int EL = EC + Q * LD;      // e^{C[L] - C[s+1]}
  static constexpr int EM = EL + Q * LD;      // s < m: e^{C[m]-C[s+1]};
                                              // t >= m: e^{C[t]-C[m]}
  static constexpr int DA = EM + Q * LD;      // dA [Q][LDQ]
  static constexpr int AM = DA + Q * LDQ;     // A  [Q][LDQ]
  static constexpr int DR = AM + Q * LDQ;     // dr [Q][LD]
  static constexpr int DK = DR + Q * LD;      // dk [Q][LD]
  static constexpr int US = DK + Q * LD;      // u [HD]
  static constexpr int ECL = US + HD;         // e^{C[L]} [HD]
  static constexpr int QP = ECL + HD;         // quarter sums of lw [4][HD]
  static constexpr int RQ = QP + 4 * HD;      // k e^{..} . Ge v [2][HD]
  static constexpr int RR = RQ + 2 * HD;      // rowsum(Ge S_in) [4][HD]
  static constexpr int FLOATS = RR + 4 * HD;
};

template <typename T, int HD>
__global__ void __launch_bounds__(NTH, 1) wkv_bwd_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ lw,
    const float* __restrict__ u, const float* __restrict__ states,
    const T* __restrict__ dy, const float* __restrict__ ds_out,
    T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
    T* __restrict__ dlw, float* __restrict__ ds_in,
    float* __restrict__ part_u, int T_len, int H, Strides sr, Strides sk,
    Strides sv, Strides sl, Strides sdy, Strides sdr) {
  using S_ = BwdShape<HD>;
  constexpr int LD = S_::LD, LDQ = S_::LDQ, NT8 = HD / 8, CPE = HD / E;
  // G tiles (16 x 8), per warp; the warps that sum lw.
  constexpr int TT = (HD / 16) * NT8, NTW = (TT + NW - 1) / NW;
  constexpr int NSUM = 4 * HD;
  static_assert(HD % 16 == 0 && NT8 % NTW == 0 && NSUM <= NTH &&
                    NSUM % 32 == 0 && 2 * 8 * E * 2 == NTH && Q == 2 * SUB,
                "tile shape");

  extern __shared__ __align__(16) float smem[];
  float* Sin = smem + S_::SIN;
  float* Ges = smem + S_::GE;
  float* Cs = smem + S_::CS;
  float* ECs = smem + S_::EC;
  float* ELs = smem + S_::EL;
  float* EMs = smem + S_::EM;
  float* DAs = smem + S_::DA;
  float* AMs = smem + S_::AM;
  float* DRs = smem + S_::DR;
  float* DKs = smem + S_::DK;
  float* US = smem + S_::US;
  float* ECL = smem + S_::ECL;
  float* QP = smem + S_::QP;
  float* RQ = smem + S_::RQ;
  float* RR = smem + S_::RR;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int nc = (T_len + Q - 1) / Q;
  const T* rb = r + b * sr.b + h * sr.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* lb = lw + b * sl.b + h * sl.h;
  const T* yb = dy + b * sdy.b + h * sdy.h;

  auto issue = [&](int c) {
    float* st = smem + (c & 1) * S_::STAGE;
    const int c0 = c * Q, L = min(Q, T_len - c0);
    load_tile<Q, HD, NTH>(st + S_::ST_R, LD, rb + c0 * sr.t, sr.t, L, tid);
    load_tile<Q, HD, NTH>(st + S_::ST_K, LD, kb + c0 * sk.t, sk.t, L, tid);
    load_tile<Q, HD, NTH>(st + S_::ST_V, LD, vb + c0 * sv.t, sv.t, L, tid);
    load_tile<Q, HD, NTH>(st + S_::ST_L, LD, lb + c0 * sl.t, sl.t, L, tid);
    load_tile<Q, HD, NTH>(st + S_::ST_DY, LD, yb + c0 * sdy.t, sdy.t, L,
                          tid);
    cp_async_commit();
  };
  auto issue_sin = [&](int c) {
    load_tile<HD, HD, NTH>(
        Sin, LD, states + (((int64_t)b * H + h) * nc + c) * HD * HD, HD, HD,
        tid);
    cp_async_commit();
  };

  // G rows (channels) gc0 + g (+ 8), columns (values) gv0 + 8 j + 2 q (+ 1).
  const bool owns = warp * NTW < TT;
  const int gc0 = 16 * ((warp * NTW) / NT8), gv0 = 8 * ((warp * NTW) % NT8);
  const int64_t gbase = ((int64_t)b * H + h) * HD * HD;
  float G[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    float2 lo = make_float2(0.f, 0.f), hi = lo;
    if (owns && ds_out) {
      lo = ld2(ds_out + gbase + (gc0 + g) * HD + gv0 + 8 * j + 2 * q);
      hi = ld2(ds_out + gbase + (gc0 + g + 8) * HD + gv0 + 8 * j + 2 * q);
    }
    G[j][0] = lo.x, G[j][1] = lo.y, G[j][2] = hi.x, G[j][3] = hi.y;
  }
  for (int c = tid; c < HD; c += NTH) US[c] = u[h * HD + c];
  // Above the diagonal of the two diagonal blocks A stays 0.
  for (int i = tid; i < Q * SUB; i += NTH) {
    const int t = i / SUB, s = (t / SUB) * SUB + i % SUB;
    if (s > t) AMs[t * LDQ + s] = 0.f;
  }
  float du_acc = 0.f;   // threads NSUM .. NSUM + HD - 1: channel tid - NSUM

  issue(nc - 1);
  issue_sin(nc - 1);
  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * Q, L = min(Q, T_len - c0);
    const float* stg = smem + (c & 1) * S_::STAGE;
    const float* Rs = stg + S_::ST_R;
    const float* Ks = stg + S_::ST_K;
    const float* Vs = stg + S_::ST_V;
    const float* Ls = stg + S_::ST_L;
    const float* Ys = stg + S_::ST_DY;
    cp_async_wait<1>();   // this chunk's stage has landed (S_in may not)
    if (owns) {
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        store2(Ges + (gc0 + g) * LD + gv0 + 8 * j + 2 * q, G[j][0], G[j][1]);
        store2(Ges + (gc0 + g + 8) * LD + gv0 + 8 * j + 2 * q, G[j][2],
               G[j][3]);
      }
    }
    __syncthreads();   // every warp is done with the previous chunk
    if (c > 0)
      issue(c - 1);
    else
      cp_async_commit();   // an empty group keeps the count

    // Phase 1. (a) C per channel, 8 steps a thread in four quarters, and
    // the exponentials of the chunk's decays.
    if (tid < NSUM) {
      const int ch = tid % HD, qt = tid / HD;
      float run[9];
      run[0] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        run[i + 1] = run[i] + Ls[(8 * qt + i) * LD + ch] * kLog2e;
      QP[qt * HD + ch] = run[8];
      named_barrier(1, NSUM);
      float off = 0.f, tot = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = QP[j * HD + ch];
        if (j < qt) off += p;
        tot += p;
      }
      const float cm = QP[ch] + QP[HD + ch];   // C[m]
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = 8 * qt + i;
        const float ct = off + run[i], cn = off + run[i + 1];
        Cs[t * LD + ch] = ct;
        ECs[t * LD + ch] = fast_exp2(ct);
        ELs[t * LD + ch] = fast_exp2(tot - cn);
        EMs[t * LD + ch] = fast_exp2(t < SUB ? cm - cn : ct - cm);
      }
      if (qt == 3) {
        Cs[Q * LD + ch] = tot;
        ECL[ch] = fast_exp2(tot);
      }
    } else {
      // (b) dA = dy v^T, 16 x 8 tiles on and below the diagonal, zero
      // above it.
      for (int job = warp - NSUM / 32; job < 6; job += NW - NSUM / 32) {
        const int i = job < 2 ? 0 : 1, jn = job < 2 ? job : job - 2;
        float d[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
        float d2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < NT8; ++kk) {
          Frag<4> a;
          Frag<2> bf;
          frag_a_perm(a, Ys + 16 * i * LD + 8 * kk, LD, g, q);
          frag_b_perm(bf, Vs + 8 * jn * LD + 8 * kk, LD, g, q);
          mma3_split(d, d1, d2, a, bf);
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) d[x] += d1[x] + d2[x];
        const int t0 = 16 * i + g, s = 8 * jn + 2 * q;
        store2(DAs + t0 * LDQ + s, s <= t0 ? d[0] : 0.f,
               s + 1 <= t0 ? d[1] : 0.f);
        store2(DAs + (t0 + 8) * LDQ + s, s <= t0 + 8 ? d[2] : 0.f,
               s + 1 <= t0 + 8 ? d[3] : 0.f);
      }
    }
    __syncthreads();

    // Phase 2. (c) A's block below the diagonal blocks (t >= m > s), the
    // last two warps: (r e^{C[t]-C[m]}) (k e^{C[m]-C[s+1]})^T.
    if (warp >= NW - 2) {
      const int jn = warp - (NW - 2), s = 8 * jn + g;
      float d[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
      float d2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NT8; ++kk) {
        const int cc = 8 * kk + 2 * q;
        Frag<4> a;
        Frag<2> bf;
        const float2 r0 = ld2(Rs + (SUB + g) * LD + cc);
        const float2 e0 = ld2(EMs + (SUB + g) * LD + cc);
        const float2 r1 = ld2(Rs + (SUB + g + 8) * LD + cc);
        const float2 e1 = ld2(EMs + (SUB + g + 8) * LD + cc);
        a.set(0, r0.x * e0.x), a.set(1, r1.x * e1.x);
        a.set(2, r0.y * e0.y), a.set(3, r1.y * e1.y);
        const float2 kv = ld2(Ks + s * LD + cc), ek = ld2(EMs + s * LD + cc);
        bf.set(0, kv.x * ek.x), bf.set(1, kv.y * ek.y);
        mma3_split(d, d1, d2, a, bf);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) d[x] += d1[x] + d2[x];
      store2(AMs + (SUB + g) * LDQ + 8 * jn + 2 * q, d[0], d[1]);
      store2(AMs + (SUB + g + 8) * LDQ + 8 * jn + 2 * q, d[2], d[3]);
    }
    if (tid < NTH / 2) {
      // (d) The diagonal blocks of A and of dr: rows tA = 16 sub + pr
      // (s = 16 sub .. tA), then tB = 16 sub + 15 - pr; channels e + E cc,
      // A's sum joined across the E lanes.
      const int e = tid % E, slot = tid / E, sub = slot / 8, pr = slot % 8;
      const int tA = SUB * sub + pr, tB = SUB * sub + SUB - 1 - pr;
      float rA[CPE], cA[CPE], rB[CPE], cB[CPE], acc[CPE];
#pragma unroll
      for (int cc = 0; cc < CPE; ++cc) {
        const int ch = e + E * cc;
        rA[cc] = Rs[tA * LD + ch], cA[cc] = Cs[tA * LD + ch];
        rB[cc] = Rs[tB * LD + ch], cB[cc] = Cs[tB * LD + ch];
        acc[cc] = 0.f;
      }
#pragma unroll 1
      for (int j = 0; j <= SUB; ++j) {
        const bool first = j <= pr;
        if (j == pr + 1) {
#pragma unroll
          for (int cc = 0; cc < CPE; ++cc) {
            DRs[tA * LD + e + E * cc] = acc[cc];
            acc[cc] = 0.f;
          }
        }
        const int t = first ? tA : tB;
        const int s = SUB * sub + (first ? j : j - pr - 1);
        float sum = 0.f;
        if (s == t) {
#pragma unroll
          for (int cc = 0; cc < CPE; ++cc) {
            const int ch = e + E * cc;
            sum = fmaf((first ? rA[cc] : rB[cc]) * US[ch], Ks[s * LD + ch],
                       sum);
          }
        } else {
          const float dats = DAs[t * LDQ + s];
#pragma unroll
          for (int cc = 0; cc < CPE; ++cc) {
            const int ch = e + E * cc;
            const float kx =
                Ks[s * LD + ch] *
                fast_exp2((first ? cA[cc] : cB[cc]) - Cs[(s + 1) * LD + ch]);
            sum = fmaf(first ? rA[cc] : rB[cc], kx, sum);
            acc[cc] = fmaf(dats, kx, acc[cc]);
          }
        }
#pragma unroll
        for (int o = E / 2; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (e == 0) AMs[t * LDQ + s] = sum;
      }
#pragma unroll
      for (int cc = 0; cc < CPE; ++cc) DRs[tB * LD + e + E * cc] = acc[cc];
    } else {
      // (e) The diagonal blocks of dk: columns sA = 16 sub + pr (t = sA + 1
      // .. 16 sub + 15), then sB = 16 sub + 15 - pr; 15 pairs a thread.
      const int tt = tid - NTH / 2, e = tt % E, slot = tt / E;
      const int sub = slot / 8, pr = slot % 8;
      const int sA = SUB * sub + pr, sB = SUB * sub + SUB - 1 - pr;
      const int nA = SUB - 1 - pr;
      float cA[CPE], cB[CPE], acc[CPE];
#pragma unroll
      for (int cc = 0; cc < CPE; ++cc) {
        const int ch = e + E * cc;
        cA[cc] = Cs[(sA + 1) * LD + ch], cB[cc] = Cs[(sB + 1) * LD + ch];
        acc[cc] = 0.f;
      }
#pragma unroll 1
      for (int j = 0; j < SUB - 1; ++j) {
        const bool first = j < nA;
        if (j == nA) {
#pragma unroll
          for (int cc = 0; cc < CPE; ++cc) {
            DKs[sA * LD + e + E * cc] = acc[cc];
            acc[cc] = 0.f;
          }
        }
        const int s = first ? sA : sB;
        const int t = first ? sA + 1 + j : sB + 1 + (j - nA);
        const float dats = DAs[t * LDQ + s];
#pragma unroll
        for (int cc = 0; cc < CPE; ++cc) {
          const int ch = e + E * cc;
          acc[cc] = fmaf(dats * Rs[t * LD + ch],
                         fast_exp2(Cs[t * LD + ch] -
                                   (first ? cA[cc] : cB[cc])),
                         acc[cc]);
        }
      }
#pragma unroll
      for (int cc = 0; cc < CPE; ++cc) {
        const int ch = e + E * cc;
        if (nA == SUB - 1) {   // sB has no pair
          DKs[sA * LD + ch] = acc[cc];
          DKs[sB * LD + ch] = 0.f;
        } else {
          DKs[sB * LD + ch] = acc[cc];
        }
      }
    }
    cp_async_wait<1>();   // this chunk's S_in has landed
    __syncthreads();

    // Phase 3, the products: dv, dr and dk by 16 x 8 tiles (kind 0, 1, 2;
    // row tile i, column tile jn).
    for (int job = warp; job < 6 * NT8; job += NW) {
      const int kind = job / (2 * NT8), i = (job / NT8) % 2, jn = job % NT8;
      const int r0 = 16 * i + g, r1 = r0 + 8, col = 8 * jn + 2 * q;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      T* out;
      if (kind == 0) {
        // dv = (k e^{C[L]-C[s+1]}) Ge + A^T dy.
#pragma unroll
        for (int kk = 0; kk < NT8; ++kk) {
          const int cc = 8 * kk + 2 * q;
          Frag<4> a;
          Frag<2> bf;
          const float2 k0 = ld2(Ks + r0 * LD + cc);
          const float2 e0 = ld2(ELs + r0 * LD + cc);
          const float2 k1 = ld2(Ks + r1 * LD + cc);
          const float2 e1 = ld2(ELs + r1 * LD + cc);
          a.set(0, k0.x * e0.x), a.set(1, k1.x * e1.x);
          a.set(2, k0.y * e0.y), a.set(3, k1.y * e1.y);
          frag_b_kmaj_perm(bf, Ges + 8 * kk * LD + 8 * jn, LD, g, q);
          mma3(acc, a, bf);
        }
#pragma unroll
        for (int kk = 0; kk < Q / 8; ++kk) {
          if (kk < 2 * i) continue;   // A[t][s] = 0 for t < s
          Frag<4> a;
          Frag<2> bf;
          frag_a_kmaj(a, AMs + 8 * kk * LDQ + 16 * i, LDQ, g, q);
          frag_b_kmaj(bf, Ys + 8 * kk * LD + 8 * jn, LD, g, q);
          mma3(acc, a, bf);
        }
        out = dv;
      } else if (kind == 1) {
        // dr = e^{C[t]} (dy S_in^T) + [t >= m] e^{C[t]-C[m]} (dA Km) + the
        // diagonal blocks' part + dA[t][t] u k_t.
        float t4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < NT8; ++kk) {
          Frag<4> a;
          Frag<2> bf;
          frag_a_perm(a, Ys + 16 * i * LD + 8 * kk, LD, g, q);
          frag_b_perm(bf, Sin + 8 * jn * LD + 8 * kk, LD, g, q);
          mma3(t4, a, bf);
        }
        const float2 x0 = ld2(ECs + r0 * LD + col);
        const float2 x1 = ld2(ECs + r1 * LD + col);
        acc[0] = x0.x * t4[0], acc[1] = x0.y * t4[1];
        acc[2] = x1.x * t4[2], acc[3] = x1.y * t4[3];
        if (i == 1) {
          float o4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < SUB / 8; ++kk) {
            const int sa = 8 * kk + 2 * q;
            Frag<4> a;
            Frag<2> bf;
            frag_a_perm(a, DAs + SUB * LDQ + 8 * kk, LDQ, g, q);
            bf.set(0, Ks[sa * LD + 8 * jn + g] * EMs[sa * LD + 8 * jn + g]);
            bf.set(1, Ks[(sa + 1) * LD + 8 * jn + g] *
                          EMs[(sa + 1) * LD + 8 * jn + g]);
            mma3(o4, a, bf);
          }
          const float2 m0 = ld2(EMs + r0 * LD + col);
          const float2 m1 = ld2(EMs + r1 * LD + col);
          acc[0] += m0.x * o4[0], acc[1] += m0.y * o4[1];
          acc[2] += m1.x * o4[2], acc[3] += m1.y * o4[3];
        }
        out = dr;
      } else {
        // dk = e^{C[L]-C[s+1]} (v Ge^T) + [s < m] e^{C[m]-C[s+1]} (dA^T Rm)
        // + the diagonal blocks' part + dA[s][s] u r_s.
        float t4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < NT8; ++kk) {
          Frag<4> a;
          Frag<2> bf;
          frag_a_perm(a, Vs + 16 * i * LD + 8 * kk, LD, g, q);
          frag_b_perm(bf, Ges + 8 * jn * LD + 8 * kk, LD, g, q);
          mma3(t4, a, bf);
        }
        const float2 l0 = ld2(ELs + r0 * LD + col);
        const float2 l1 = ld2(ELs + r1 * LD + col);
        const float2 k0 = ld2(Ks + r0 * LD + col), k1 = ld2(Ks + r1 * LD + col);
        acc[0] = l0.x * t4[0], acc[1] = l0.y * t4[1];
        acc[2] = l1.x * t4[2], acc[3] = l1.y * t4[3];
        // dC[L]'s sum_s k_s e^{C[L]-C[s+1]} Ge v_s, over this tile's rows.
        float px = k0.x * acc[0] + k1.x * acc[2];
        float py = k0.y * acc[1] + k1.y * acc[3];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          px += __shfl_xor_sync(0xffffffffu, px, o);
          py += __shfl_xor_sync(0xffffffffu, py, o);
        }
        if (g == 0) store2(RQ + i * HD + col, px, py);
        if (i == 0) {
          float o4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < SUB / 8; ++kk) {
            const int ta = SUB + 8 * kk + q, tb = ta + 4;
            Frag<4> a;
            Frag<2> bf;
            frag_a_kmaj(a, DAs + (SUB + 8 * kk) * LDQ, LDQ, g, q);
            bf.set(0, Rs[ta * LD + 8 * jn + g] * EMs[ta * LD + 8 * jn + g]);
            bf.set(1, Rs[tb * LD + 8 * jn + g] * EMs[tb * LD + 8 * jn + g]);
            mma3(o4, a, bf);
          }
          const float2 m0 = ld2(EMs + r0 * LD + col);
          const float2 m1 = ld2(EMs + r1 * LD + col);
          acc[0] += m0.x * o4[0], acc[1] += m0.y * o4[1];
          acc[2] += m1.x * o4[2], acc[3] += m1.y * o4[3];
        }
        out = dk;
      }
      if (kind > 0) {   // the diagonal blocks' part and the bonus
        float* part = kind == 1 ? DRs : DKs;
        const float* other = kind == 1 ? Ks : Rs;   // dr: k_t; dk: r_s
        const float2 uv = ld2(US + col);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rr = half ? r1 : r0;
          const float2 pd = ld2(part + rr * LD + col);
          const float2 ov = ld2(other + rr * LD + col);
          const float da = DAs[rr * LDQ + rr];
          acc[2 * half] += pd.x + da * uv.x * ov.x;
          acc[2 * half + 1] += pd.y + da * uv.y * ov.y;
          store2(part + rr * LD + col, acc[2 * half], acc[2 * half + 1]);
        }
      }
      out += b * sdr.b + h * sdr.h + col;
      if (r0 < L) store2(out + (int64_t)(c0 + r0) * sdr.t, acc[0], acc[1]);
      if (r1 < L) store2(out + (int64_t)(c0 + r1) * sdr.t, acc[2], acc[3]);
    }

    // (f) rowsum(Ge S_in), and the step of G back over the chunk, by the
    // warps that hold it.
    if (owns) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const float2 a = ld2(Sin + (gc0 + g) * LD + gv0 + 8 * j + 2 * q);
        const float2 a8 = ld2(Sin + (gc0 + g + 8) * LD + gv0 + 8 * j + 2 * q);
        s0 += G[j][0] * a.x + G[j][1] * a.y;
        s1 += G[j][2] * a8.x + G[j][3] * a8.y;
      }
      s0 = quad_sum(s0), s1 = quad_sum(s1);
      const int grp = ((warp * NTW) % NT8) / NTW;
      if (q == 0) RR[grp * HD + gc0 + g] = s0, RR[grp * HD + gc0 + g + 8] = s1;
      const float e0 = ECL[gc0 + g], e1 = ECL[gc0 + g + 8];
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        G[j][0] *= e0, G[j][1] *= e0;
        G[j][2] *= e1, G[j][3] *= e1;
      }
#pragma unroll
      for (int kk = 0; kk < Q / 8; ++kk) {
        const int ta = 8 * kk + q, tb = ta + 4;
        const int ca = gc0 + g, cb = ca + 8;
        Frag<4> a;
        a.set(0, Rs[ta * LD + ca] * ECs[ta * LD + ca]);
        a.set(1, Rs[ta * LD + cb] * ECs[ta * LD + cb]);
        a.set(2, Rs[tb * LD + ca] * ECs[tb * LD + ca]);
        a.set(3, Rs[tb * LD + cb] * ECs[tb * LD + cb]);
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          Frag<2> bf;
          frag_b_kmaj(bf, Ys + 8 * kk * LD + gv0 + 8 * j, LD, g, q);
          mma3(G[j], a, bf);
        }
      }
    }
    __syncthreads();
    if (c > 0)
      issue_sin(c - 1);   // lands during the next chunk's phases 1-2
    else
      cp_async_commit();

    // Phase 4: dlw, the reverse sum of dC per channel, in four quarters
    // of 8 steps (each quarter's own sum, then the later quarters'
    // totals); du's sum over the chunk.
    if (tid < NSUM) {
      const int ch = tid % HD, qt = tid / HD;
      const float uc = US[ch];
      float loc[8], acc = 0.f;
#pragma unroll
      for (int i = 7; i >= 0; --i) {
        const int j = 8 * qt + i + 1, s = j - 1;   // dC[j], then dlw_s
        float d;
        if (j < Q) {
          d = Rs[j * LD + ch] *
              (DRs[j * LD + ch] - DAs[j * LDQ + j] * uc * Ks[j * LD + ch]);
        } else {
          float rsum = 0.f;
#pragma unroll
          for (int w = 0; w < NT8 / NTW; ++w) rsum += RR[w * HD + ch];
          d = RQ[ch] + RQ[HD + ch] + ECL[ch] * rsum;
        }
        d -= Ks[s * LD + ch] *
             (DKs[s * LD + ch] - DAs[s * LDQ + s] * uc * Rs[s * LD + ch]);
        acc += d;
        loc[i] = acc;
      }
      QP[qt * HD + ch] = acc;
      named_barrier(1, NSUM);
      float off = 0.f;
#pragma unroll
      for (int j = 3; j > 0; --j)
        if (j > qt) off += QP[j * HD + ch];
      T* out = dlw + b * sdr.b + h * sdr.h + ch;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int s = 8 * qt + i;
        if (s < L)
          out[(int64_t)(c0 + s) * sdr.t] = from_float<T>(loc[i] + off);
      }
    } else if (tid < NSUM + HD) {
      const int ch = tid - NSUM;
      float a = 0.f;
#pragma unroll 8
      for (int t = 0; t < Q; ++t)
        a += DAs[t * LDQ + t] * Rs[t * LD + ch] * Ks[t * LD + ch];
      du_acc += a;
    }
  }

  if (owns) {
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      store2(ds_in + gbase + (gc0 + g) * HD + gv0 + 8 * j + 2 * q, G[j][0],
             G[j][1]);
      store2(ds_in + gbase + (gc0 + g + 8) * HD + gv0 + 8 * j + 2 * q,
             G[j][2], G[j][3]);
    }
  }
  if (tid >= NSUM && tid < NSUM + HD)
    part_u[((int64_t)b * H + h) * HD + tid - NSUM] = du_acc;
}

// du: the per-(b, head) partials summed over the batch in order.
__global__ void wkv_bwd_reduce_kernel(const float* __restrict__ part,
                                      float* __restrict__ du, int B, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = 0.f;
  for (int j = 0; j < B; ++j) a += part[(int64_t)j * n + i];
  du[i] = a;
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* lw, const float* u, const float* states,
                   const void* dy, const float* ds_out, void* dr, void* dk,
                   void* dv, void* dlw, float* du, float* ds_in,
                   float* part_u, int B, int T_len, int H, Strides sr,
                   Strides sk, Strides sv, Strides sl, Strides sdy,
                   Strides sdr, cudaStream_t stream) {
  constexpr int smem = BwdShape<HD>::FLOATS * (int)sizeof(float);
  static unsigned long long done = 0;
  cudaError_t err = set_smem_once(wkv_bwd_kernel<T, HD>, smem, &done);
  if (err != cudaSuccess) return err;
  wkv_bwd_kernel<T, HD><<<dim3(H, B), NTH, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(lw), u, states,
      static_cast<const T*>(dy), ds_out, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<T*>(dlw), ds_in,
      part_u, T_len, H, sr, sk, sv, sl, sdy, sdr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv_bwd_reduce_kernel<<<(H * HD + 127) / 128, 128, 0, stream>>>(
      part_u, du, B, H * HD);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* r, const void* k, const void* v,
                     const void* lw, const float* u, const float* states,
                     const void* dy, const float* ds_out, void* dr, void* dk,
                     void* dv, void* dlw, float* du, float* ds_in,
                     float* part_u, int B, int T_len, int H, Strides sr,
                     Strides sk, Strides sv, Strides sl, Strides sdy,
                     Strides sdr, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(r, k, v, lw, u, states, dy, ds_out, dr, dk, dv,
                           dlw, du, ds_in, part_u, B, T_len, H, sr, sk, sv,
                           sl, sdy, sdr, stream);
    case 64:
      return launch<T, 64>(r, k, v, lw, u, states, dy, ds_out, dr, dk, dv,
                           dlw, du, ds_in, part_u, B, T_len, H, sr, sk, sv,
                           sl, sdy, sdr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, lw, dy and the gradients dr, dk, dv, dlw [B, T, H, hd], each
// given by its element strides in (b, h, t, d) order with a unit last
// stride (the four gradients share sdr); r, k, v, lw and dy with
// 16-byte-aligned bases and strides. u [H, hd] f32; states (the forward's
// chunk states) [B, H, ceil(T / 32), hd, hd] f32 contiguous; ds_out (may
// be null: zeros) and ds_in [B, H, hd, hd] f32; du [H, hd] f32. Workspace:
// part_u [B, H, hd] f32. strides: sr sk sv sl sdy sdr, four each, on the
// host. Launches two kernels on `stream` and returns cudaGetLastError()
// after the last launch (or the first failure).
EXPORT int rwkv6_wkv_bwd(int dtype, int hd, const void* r, const void* k,
                         const void* v, const void* lw, const void* u,
                         const void* states, const void* dy,
                         const void* ds_out, void* dr, void* dk, void* dv,
                         void* dlw, void* du, void* ds_in, void* part_u,
                         int B, int T, int H, const int64_t* st,
                         void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || !u || !states || !ds_in || !part_u)
    return cudaErrorInvalidValue;
  for (int i = 3; i < 24; i += 4)
    if (st[i] != 1) return cudaErrorInvalidValue;
  const Strides sr{st[0], st[1], st[2], st[3]};
  const Strides sk{st[4], st[5], st[6], st[7]};
  const Strides sv{st[8], st[9], st[10], st[11]};
  const Strides sl{st[12], st[13], st[14], st[15]};
  const Strides sdy{st[16], st[17], st[18], st[19]};
  const Strides sdr{st[20], st[21], st[22], st[23]};
  const float* uf = static_cast<const float*>(u);
  const float* stf = static_cast<const float*>(states);
  const float* dso = static_cast<const float*>(ds_out);
  float* duf = static_cast<float*>(du);
  float* dsi = static_cast<float*>(ds_in);
  float* pu = static_cast<float*>(part_u);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch<float>(hd, r, k, v, lw, uf, stf, dy, dso, dr, dk, dv, dlw,
                           duf, dsi, pu, B, T, H, sr, sk, sv, sl, sdy, sdr,
                           s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(hd, r, k, v, lw, uf, stf, dy, dso, dr, dk,
                                   dv, dlw, duf, dsi, pu, B, T, H, sr, sk, sv,
                                   sl, sdy, sdr, s);
  return cudaErrorInvalidValue;
}
