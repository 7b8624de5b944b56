// Backward of the Mamba2 SSD scan (ssm_scan.cu), chunked, for Hopper
// (sm_90a).
//
// The backward of repro/kernels/ssm_scan/kernel.py::ssm_scan, for training:
// the reference differentiates its XLA `chunk_step` scan instead; the TPU
// kernel has no backward.
//
// What it computes, per (b, head), from the forward's S_t = a_t S_{t-1} +
// dt_t x_t B_t^T and y_t = S_t C_t + D x_t (a_t = exp(dt_t A), state [hp, N]
// f32): given dy and d(final state), the gradients of x, Bm, Cm, dt, A, D
// and the initial state. With G_t the gradient of S_t:
//     G_t = dy_t C_t^T + a_{t+1} G_{t+1},     dx_t = dt_t G_t B_t + D dy_t,
//     dB_t = sum_h dt_t G_t^T x_t,  dC_t = sum_h S_t^T dy_t,
//     dla_t = a_t <G_t, S_{t-1}>,  ddt_t = x_t . G_t B_t + A dla_t,
//     dA = sum_{b,t} dt_t dla_t,  dD = sum_{b,t} dy_t . x_t,  dS_in = a_0 G_0.
// Within a 32-step chunk (P_t = la_0 + ... + la_t, la = dt A; E[t][s] =
// exp(P_t - P_s) for s <= t), with S_in the state the chunk starts from and
// Ge the gradient of the state it ends with:
//     d(dt x)_s = sum_{t>=s} Mp[t][s] dy_t + E[L-1][s] Ge B_s,
//                 Mp = E (C B^T),  Wc = E dt_s (dy x^T),
//     dC_t = sum_h e^{P_t} S_in^T dy_t + sum_s Wc[t][s] B_s,
//     dB_s = sum_h E[L-1][s] dt_s Ge^T x_s + sum_t Wc[t][s] C_t,
//     G at the chunk's start = e^{P_{L-1}} Ge + sum_t e^{P_t} dy_t C_t^T.
//
// Design: one kernel sweeps the chunks from last to first, a second sums
// the per-block partials; no float atomics, the same bits on every run.
//  * Grid (ceil(nh / 2), B), as the forward's: a block takes two heads of
//    one batch row, so C B^T is computed once per chunk for both, and the
//    heads' dB and dC are summed in registers before they leave the block.
//  * The state gradient G of both heads lives in registers as mma
//    accumulators for the whole sweep (16 per thread), updated once per
//    chunk by G <- e^{P_{L-1}} G + (e^{P} dy)^T C. Nothing is written to
//    device memory between the chunks (the first kernels' `ge` workspace,
//    0.88 GiB at the training shape, and its launch are gone). Each chunk
//    copies G to shared memory once, because the products need it both
//    ways round: Ge B_s contracts over N, Ge^T x_s over hp, and an mma
//    accumulator can only be read as an operand along one of them.
//  * The chunk's S_in comes from the forward's chunk states (saved under
//    autograd, not recomputed).
//  * Every product runs on the tensor cores in 3xTF32 (mma.sync m16n8k8,
//    scan.cuh's split; one TF32 product misses the f32 tolerance ~30x,
//    tests/test_torch_scan_bwd.py shows it): C B^T and dy x^T; B Ge^T,
//    Mp^T dy (-> d(dt x), dx); x Ge, Wc^T C (-> dB); dy S_in, Wc B (-> dC);
//    and the update of G. The per-step dots (x_s . Ge B_s, C_t . S_in^T
//    dy_t, x_s . d(dt x)_s) are taken from the accumulators and summed
//    over the tiles through shared memory in a fixed order.
//  * 16 warps, one block per SM: the two heads' S_in and Ge (74 KB at
//    hp = N = 64), the double-buffered x, dy, B, C, dt (111 KB) and the
//    chunk's [Q, Q] matrices fill 228 KB. Two blocks of 8 warps would need
//    half that each, and S_in and Ge alone take two thirds of it. The
//    next chunk's x, dy, B, C, dt load by 16-byte cp.async (bf16 converted
//    on load) while this one computes; S_in, kept once, loads after its
//    last use and lands during the next chunk's first phases. Rows are
//    padded to 8 mod 32 words (N + 8, hp + 8, Q + 8).
//  * dB and dC, shared by the heads, go out as per-block partials [2, B,
//    ceil(nh / 2), T, N] f32; dA and dD as per-(b, head) partials; the
//    second kernel sums both in a fixed order.
// Numerics (as the first kernels found necessary). Every exponent
// is <= 0: P_t - P_s is summed from step s + 1 on (a warp's suffix scan;
// the difference of two chunk-long sums loses the small exponents under a
// strong decay), e^{P_t} and E[L-1][s]. dla_t is summed term by term, with
// no cancellation:
//     dla_t = e^{P_{L-1}} <Ge, S_in> + sum_{s<t} u_s + sum_{tau>=t} stY_tau
//           + sum_{s<t<=tau} Wc[tau][s] (C B^T)[tau][s],
// u_s = E[L-1][s] dt_s x_s . Ge B_s, stY_t = e^{P_t} C_t . S_in^T dy_t.
// (Summing dP over the chunk and differencing loses dA by ~1e-3 relative
// under a strong decay.) A ragged last chunk is zero-padded on load: x = B =
// C = dy = 0 and dt = 0 leave every sum exact, and only rows t < L are
// written. dx comes out in x's type, dB and dC in Bm's from the partials.
//
// What bounds it on the H100: operations. At the training shape (B 8,
// T 2048, nh 112, hp = N = 64, f32) the stepwise backward's 10 flops per
// state element per step take 0.4555 ms in 3xTF32 at 495 TFLOP/s; reading
// x, B, C, dt, dy and writing dx, dB, dC, dt once takes 0.4345 ms at
// 3.35 TB/s. The chunked form does ~2.5x the forward's products (~4.7 k
// mma.sync per block and chunk); the chunk states it reads and the
// partials it writes and sums add ~0.28 + 0.28 ms of bytes, which the
// bound leaves out. PERF.md holds the time measured on the card.

#include <math.h>

#include "common.cuh"
#include "scan.cuh"

namespace {

constexpr int Q = 32;     // chunk length, as the forward's
constexpr int SG = 2;     // heads per block
constexpr int NW = 16;    // warps per block
constexpr int NTH = 32 * NW;
constexpr unsigned FULL = 0xffffffffu;

// Element strides of a 3-D operand [B, T, n] (n: N for B and C, nh for dt).
struct Strides3 {
  int64_t b, t, n;
};

// Shared memory, in floats. Two stages of the chunk's inputs, then the
// heads' S_in and Ge, the chunk's [Q, Q] matrices, per-step vectors and
// the partial dots.
template <int HP, int N>
struct BwdShape {
  static constexpr int LDN = N + 8, LDP = HP + 8, LDQ = Q + 8;
  static constexpr int ST_C = 0;                    // C  [Q][LDN]
  static constexpr int ST_B = ST_C + Q * LDN;       // B  [Q][LDN]
  static constexpr int ST_X = ST_B + Q * LDN;       // x  [SG][Q][LDP]
  static constexpr int ST_DY = ST_X + SG * Q * LDP; // dy [SG][Q][LDP]
  static constexpr int ST_DT = ST_DY + SG * Q * LDP;  // dt [SG][Q]
  static constexpr int STAGE = ST_DT + SG * Q;
  static constexpr int SIN = 2 * STAGE;             // S_in [SG][HP][LDN]
  static constexpr int GE = SIN + SG * HP * LDN;    // Ge   [SG][HP][LDN]
  static constexpr int CB = GE + SG * HP * LDN;     // C B^T [Q][LDQ]
  static constexpr int MP = CB + Q * LDQ;           // Mp [SG][Q][LDQ]
  static constexpr int WC = MP + SG * Q * LDQ;      // dy x^T, then Wc
  static constexpr int XP = WC + SG * Q * LDQ;      // row prefix of Wc CB
  static constexpr int EP = XP + SG * Q * LDQ;      // e^{P_t} [SG][Q]
  static constexpr int ELS = EP + SG * Q;           // E[L-1][s] [SG][Q]
  static constexpr int DXD = ELS + SG * Q;          // dy_t . x_t [SG][Q]
  static constexpr int RU = DXD + SG * Q;           // x . Ge B [SG][8][Q]
  static constexpr int RD = RU + SG * 8 * Q;        // x . d(dt x)
  static constexpr int RS = RD + SG * 8 * Q;        // C . S_in^T dy
  static constexpr int RG = RS + SG * 8 * Q;        // <Ge, S_in> [NW]
  static constexpr int FLOATS = RG + NW;
};

template <typename T, int HP, int N>
__global__ void __launch_bounds__(NTH, 1) ssd_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ D,
    const float* __restrict__ states, const T* __restrict__ dy,
    const float* __restrict__ ds_out, T* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ ds_in,
    float* __restrict__ part_bc, float* __restrict__ part_ad, int T_len,
    int nh, Strides sx, Strides3 sb, Strides3 sc, Strides3 sd, Strides sdy,
    Strides sdx) {
  using S_ = BwdShape<HP, N>;
  constexpr int LDN = S_::LDN, LDP = S_::LDP, LDQ = S_::LDQ;
  constexpr int NTN = N / 8, NPP = HP / 16, NKP = HP / 8;
  // G tiles (16 x 8) per head, and per warp of the head's eight.
  constexpr int TT = NPP * NTN, NTW = (TT + 7) / 8;
  static_assert(HP % 16 == 0 && N % 16 == 0 && NTN <= 8 && NPP <= 8 &&
                    NTN % NTW == 0 && NW == 8 * SG,
                "tile shape");

  extern __shared__ __align__(16) float smem[];
  float* Sin = smem + S_::SIN;
  float* Ges = smem + S_::GE;
  float* CBs = smem + S_::CB;
  float* Mps = smem + S_::MP;
  float* Wcs = smem + S_::WC;
  float* Xps = smem + S_::XP;
  float* eP = smem + S_::EP;
  float* eLs = smem + S_::ELS;
  float* dxd = smem + S_::DXD;
  float* ru = smem + S_::RU;
  float* rd = smem + S_::RD;
  float* rs = smem + S_::RS;
  float* rg = smem + S_::RG;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int blk = blockIdx.x, nhp = gridDim.x, h0 = blk * SG, b = blockIdx.y;
  const int n_heads = min(SG, nh - h0);
  const int nc = (T_len + Q - 1) / Q;
  const int64_t part_half = (int64_t)gridDim.y * nhp * T_len * N;

  const T* Bb = Bm + b * sb.b;
  const T* Cb = Cm + b * sc.b;
  auto issue = [&](int c) {
    float* st = smem + (c & 1) * S_::STAGE;
    const int c0 = c * Q, L = min(Q, T_len - c0);
    load_tile<Q, N, NTH>(st + S_::ST_C, LDN, Cb + c0 * sc.t, sc.t, L, tid);
    load_tile<Q, N, NTH>(st + S_::ST_B, LDN, Bb + c0 * sb.t, sb.t, L, tid);
    for (int j = 0; j < n_heads; ++j) {
      load_tile<Q, HP, NTH>(st + S_::ST_X + j * Q * LDP, LDP,
                            x + b * sx.b + (h0 + j) * sx.h + c0 * sx.t,
                            sx.t, L, tid);
      load_tile<Q, HP, NTH>(st + S_::ST_DY + j * Q * LDP, LDP,
                            dy + b * sdy.b + (h0 + j) * sdy.h + c0 * sdy.t,
                            sdy.t, L, tid);
    }
    for (int i = tid; i < n_heads * Q; i += NTH) {
      const int j = i / Q, t = i % Q;
      const bool in = t < L;
      cp_async4(st + S_::ST_DT + i,
                dt + b * sd.b + (h0 + j) * sd.n + (in ? (c0 + t) * sd.t : 0),
                in ? 4 : 0);
    }
    cp_async_commit();
  };
  auto issue_sin = [&](int c) {
    for (int j = 0; j < n_heads; ++j)
      load_tile<HP, N, NTH>(
          Sin + j * HP * LDN, LDN,
          states + (((int64_t)b * nh + h0 + j) * nc + c) * HP * N, N, HP,
          tid);
    cp_async_commit();
  };

  // G of head hw: rows gp0 + g (+ 8), columns gn0 + 8 k + 2 q (+ 1).
  const int hw = warp / 8, wi = warp % 8;
  const bool owns = hw < n_heads && wi * NTW < TT;
  const int gp0 = 16 * ((wi * NTW) / NTN), gn0 = 8 * ((wi * NTW) % NTN);
  const int64_t gbase = ((int64_t)b * nh + h0 + hw) * HP * N;
  float G[NTW][4];
#pragma unroll
  for (int k = 0; k < NTW; ++k) {
    float2 lo = make_float2(0.f, 0.f), hi = lo;
    if (owns && ds_out) {
      lo = ld2(ds_out + gbase + (gp0 + g) * N + gn0 + 8 * k + 2 * q);
      hi = ld2(ds_out + gbase + (gp0 + g + 8) * N + gn0 + 8 * k + 2 * q);
    }
    G[k][0] = lo.x, G[k][1] = lo.y, G[k][2] = hi.x, G[k][3] = hi.y;
  }
  float acc_dA = 0.f, acc_dD = 0.f;   // warps < n_heads: step `lane`

  issue(nc - 1);
  issue_sin(nc - 1);
  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * Q, L = min(Q, T_len - c0);
    const float* stg = smem + (c & 1) * S_::STAGE;
    const float* Cs = stg + S_::ST_C;
    const float* Bs = stg + S_::ST_B;
    const float* Xs = stg + S_::ST_X;
    const float* DYs = stg + S_::ST_DY;
    const float* DTs = stg + S_::ST_DT;
    cp_async_wait<1>();   // this chunk's stage has landed (S_in may not)
    if (owns) {
      float* Gh = Ges + hw * HP * LDN;
#pragma unroll
      for (int k = 0; k < NTW; ++k) {
        store2(Gh + (gp0 + g) * LDN + gn0 + 8 * k + 2 * q, G[k][0], G[k][1]);
        store2(Gh + (gp0 + g + 8) * LDN + gn0 + 8 * k + 2 * q, G[k][2],
               G[k][3]);
      }
    }
    __syncthreads();   // every warp is done with the previous chunk
    if (c > 0)
      issue(c - 1);
    else
      cp_async_commit();   // an empty group keeps the count

    // Phase 1: P_t by a shuffle scan per head (the first warps); C B^T
    // and dy x^T of each head, 16 x 8 tiles on and below the diagonal
    // (rows 0-15 take columns 0-15, rows 16-31 columns 0-31), dealt from
    // the last warp down, each product's three TF32 terms in their own
    // accumulators so the chain of k-steps is a third as deep.
    if (warp < n_heads) {
      float p = DTs[warp * Q + lane] * __ldg(A + h0 + warp);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(FULL, p, o);
        if (lane >= o) p += v;
      }
      eP[warp * Q + lane] = expf(p);
    }
    for (int job = NW - 1 - warp; job < 6 * (1 + n_heads); job += NW) {
      const int tile = job % 6, hl = job / 6 - 1;
      const int i = tile < 2 ? 0 : 1, jn = tile < 2 ? tile : tile - 2;
      const bool cb = hl < 0;
      const float* Ap = cb ? Cs : DYs + hl * Q * LDP;
      const float* Bp = cb ? Bs : Xs + hl * Q * LDP;
      const int ld = cb ? LDN : LDP, nk = cb ? NTN : NKP;
      float d[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
      float d2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int kk = 0; kk < nk; ++kk) {
        Frag<4> a;
        Frag<2> bf;
        frag_a_perm(a, Ap + 16 * i * ld + 8 * kk, ld, g, q);
        frag_b_perm(bf, Bp + 8 * jn * ld + 8 * kk, ld, g, q);
        mma3_split(d, d1, d2, a, bf);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] += d1[e] + d2[e];
      float* out = cb ? CBs : Wcs + hl * Q * LDQ;
      store2(out + (16 * i + g) * LDQ + 8 * jn + 2 * q, d[0], d[1]);
      store2(out + (16 * i + g + 8) * LDQ + 8 * jn + 2 * q, d[2], d[3]);
    }
    __syncthreads();

    // Phase 2: one warp per row tau of a head, lane s: E[tau][s], Mp, Wc
    // and the exclusive prefix over s of Wc CB. A warp's rows go side by
    // side, so their shuffle chains overlap.
    {
      constexpr int R = SG * Q / NW;   // rows a warp
      float v[R], pw[R], dts[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = warp + NW * r, hl = row / Q, tau = row % Q;
        dts[r] = DTs[hl * Q + lane];
        const float la = dts[r] * __ldg(A + h0 + min(hl, n_heads - 1));
        // sum_{j = s+1 .. tau} la_j: la_{s+1} (masked to j <= tau), summed
        // from the end.
        v[r] = __shfl_down_sync(FULL, lane <= tau ? la : 0.f, 1);
        if (lane == 31) v[r] = 0.f;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float w = __shfl_down_sync(FULL, v[r], o);
          if (lane + o < 32) v[r] += w;
        }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = warp + NW * r, hl = row / Q, tau = row % Q;
        const bool in = lane <= tau, live = hl < n_heads;
        const float E = in ? expf(v[r]) : 0.f;
        const float cbv = CBs[tau * LDQ + lane];
        float* wrow = Wcs + (hl * Q + tau) * LDQ;
        const float dxv = wrow[lane];
        const float wc = in ? E * dts[r] * dxv : 0.f;
        pw[r] = in ? wc * cbv : 0.f;
        if (live) {
          Mps[(hl * Q + tau) * LDQ + lane] = in ? E * cbv : 0.f;
          wrow[lane] = wc;
          if (tau == Q - 1) eLs[hl * Q + lane] = E;
          if (lane == tau) dxd[hl * Q + tau] = dxv;
        }
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float w = __shfl_up_sync(FULL, pw[r], o);
          if (lane >= o) pw[r] += w;
        }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = warp + NW * r, hl = row / Q, tau = row % Q;
        const float ex = __shfl_up_sync(FULL, pw[r], 1);
        if (hl < n_heads)
          Xps[(hl * Q + tau) * LDQ + lane] = lane == 0 ? 0.f : ex;
      }
    }
    cp_async_wait<1>();   // this chunk's S_in has landed
    __syncthreads();

    // Phase 3, the products. (a) d(dt x) = E[L-1] (B Ge^T) + Mp^T dy, per
    // head, s-tile and 16 columns of p; then dx and the dots with x.
    for (int job = warp; job < n_heads * 2 * NPP; job += NW) {
      const int hl = job / (2 * NPP), i = (job / NPP) % 2, pp = job % NPP;
      const float* Gh = Ges + hl * HP * LDN;
      const float* Xh = Xs + hl * Q * LDP;
      const float* Yh = DYs + hl * Q * LDP;
      const float* Mh = Mps + hl * Q * LDQ;
      float acc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < NTN; ++kk) {
        Frag<4> a;
        frag_a_perm(a, Bs + 16 * i * LDN + 8 * kk, LDN, g, q);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          Frag<2> bf;
          frag_b_perm(bf, Gh + (16 * pp + 8 * jj) * LDN + 8 * kk, LDN, g, q);
          mma3(acc[jj], a, bf);
        }
      }
      const int s0 = 16 * i + g, s1 = s0 + 8;
      float u0 = 0.f, u1 = 0.f;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int p = 16 * pp + 8 * jj + 2 * q;
        const float2 xa = ld2(Xh + s0 * LDP + p), xb = ld2(Xh + s1 * LDP + p);
        u0 += xa.x * acc[jj][0] + xa.y * acc[jj][1];
        u1 += xb.x * acc[jj][2] + xb.y * acc[jj][3];
      }
      u0 = quad_sum(u0), u1 = quad_sum(u1);
      if (q == 0)
        ru[(hl * 8 + pp) * Q + s0] = u0, ru[(hl * 8 + pp) * Q + s1] = u1;
      const float e0 = eLs[hl * Q + s0], e1 = eLs[hl * Q + s1];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        acc[jj][0] *= e0, acc[jj][1] *= e0;
        acc[jj][2] *= e1, acc[jj][3] *= e1;
      }
#pragma unroll
      for (int kk = 0; kk < Q / 8; ++kk) {
        if (kk < 2 * i) continue;   // Mp[t][s] = 0 for t < s
        Frag<4> a;
        frag_a_kmaj(a, Mh + 8 * kk * LDQ + 16 * i, LDQ, g, q);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          Frag<2> bf;
          frag_b_kmaj(bf, Yh + 8 * kk * LDP + 16 * pp + 8 * jj, LDP, g, q);
          mma3(acc[jj], a, bf);
        }
      }
      const float* dth = DTs + hl * Q;
      const float Dv = __ldg(D + h0 + hl);
      T* dxb = dx + b * sdx.b + (h0 + hl) * sdx.h;
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int p = 16 * pp + 8 * jj + 2 * q;
        const float2 xa = ld2(Xh + s0 * LDP + p), xb = ld2(Xh + s1 * LDP + p);
        const float2 ya = ld2(Yh + s0 * LDP + p), yb = ld2(Yh + s1 * LDP + p);
        d0 += xa.x * acc[jj][0] + xa.y * acc[jj][1];
        d1 += xb.x * acc[jj][2] + xb.y * acc[jj][3];
        if (s0 < L)
          store2(dxb + (int64_t)(c0 + s0) * sdx.t + p,
                 dth[s0] * acc[jj][0] + Dv * ya.x,
                 dth[s0] * acc[jj][1] + Dv * ya.y);
        if (s1 < L)
          store2(dxb + (int64_t)(c0 + s1) * sdx.t + p,
                 dth[s1] * acc[jj][2] + Dv * yb.x,
                 dth[s1] * acc[jj][3] + Dv * yb.y);
      }
      d0 = quad_sum(d0), d1 = quad_sum(d1);
      if (q == 0)
        rd[(hl * 8 + pp) * Q + s0] = d0, rd[(hl * 8 + pp) * Q + s1] = d1;
    }

    // (b) dB (jobs < NTN) and dC, per row tile and 16 columns of n (two
    // tiles sharing the A fragments), summed over the block's heads in
    // registers.
    for (int job = warp; job < 2 * NTN; job += NW) {
      const bool isC = job >= NTN;
      const int i = (job % NTN) / (NTN / 2), n0 = 16 * (job % (NTN / 2));
      const int r0 = 16 * i + g, r1 = r0 + 8;
      float acc[2][4] = {};
      for (int hl = 0; hl < n_heads; ++hl) {
        const float* Wh = Wcs + hl * Q * LDQ;
        float t4[2][4] = {};
        // x Ge (dB) or dy S_in (dC), over p.
        const float* Ap = (isC ? DYs : Xs) + hl * Q * LDP + 16 * i * LDP;
        const float* Bp = (isC ? Sin : Ges) + hl * HP * LDN + n0;
#pragma unroll
        for (int kk = 0; kk < NKP; ++kk) {
          Frag<4> a;
          frag_a_perm(a, Ap + 8 * kk, LDP, g, q);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            Frag<2> bf;
            frag_b_kmaj_perm(bf, Bp + 8 * kk * LDN + 8 * jj, LDN, g, q);
            mma3(t4[jj], a, bf);
          }
        }
        float e0, e1;
        if (isC) {   // C_t . S_in^T dy_t over this job's columns
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int col = n0 + 8 * jj + 2 * q;
            const float2 ca = ld2(Cs + r0 * LDN + col);
            const float2 cb = ld2(Cs + r1 * LDN + col);
            const float st0 = quad_sum(ca.x * t4[jj][0] + ca.y * t4[jj][1]);
            const float st1 = quad_sum(cb.x * t4[jj][2] + cb.y * t4[jj][3]);
            const int slot = (hl * 8 + n0 / 8 + jj) * Q;
            if (q == 0) rs[slot + r0] = st0, rs[slot + r1] = st1;
          }
          e0 = eP[hl * Q + r0], e1 = eP[hl * Q + r1];
        } else {
          e0 = eLs[hl * Q + r0] * DTs[hl * Q + r0];
          e1 = eLs[hl * Q + r1] * DTs[hl * Q + r1];
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          acc[jj][0] += e0 * t4[jj][0], acc[jj][1] += e0 * t4[jj][1];
          acc[jj][2] += e1 * t4[jj][2], acc[jj][3] += e1 * t4[jj][3];
        }
        // + Wc B over s <= t (dC), + Wc^T C over t >= s (dB).
#pragma unroll
        for (int kk = 0; kk < Q / 8; ++kk) {
          if (isC ? kk > 2 * i + 1 : kk < 2 * i) continue;
          Frag<4> a;
          if (isC)
            frag_a_perm(a, Wh + 16 * i * LDQ + 8 * kk, LDQ, g, q);
          else
            frag_a_kmaj(a, Wh + 8 * kk * LDQ + 16 * i, LDQ, g, q);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            Frag<2> bf;
            if (isC)
              frag_b_kmaj_perm(bf, Bs + 8 * kk * LDN + n0 + 8 * jj, LDN, g,
                               q);
            else
              frag_b_kmaj(bf, Cs + 8 * kk * LDN + n0 + 8 * jj, LDN, g, q);
            mma3(acc[jj], a, bf);
          }
        }
      }
      float* out = part_bc + (isC ? part_half : 0) +
                   (((int64_t)b * nhp + blk) * T_len + c0) * N + n0 + 2 * q;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        if (r0 < L) store2(out + r0 * N + 8 * jj, acc[jj][0], acc[jj][1]);
        if (r1 < L) store2(out + r1 * N + 8 * jj, acc[jj][2], acc[jj][3]);
      }
    }

    // (c) <Ge, S_in> and the step of G back over the chunk, by the warps
    // that hold it.
    if (owns) {
      const float* Sh = Sin + hw * HP * LDN;
      float gs = 0.f;
#pragma unroll
      for (int k = 0; k < NTW; ++k) {
        const float2 a = ld2(Sh + (gp0 + g) * LDN + gn0 + 8 * k + 2 * q);
        const float2 a8 = ld2(Sh + (gp0 + g + 8) * LDN + gn0 + 8 * k + 2 * q);
        gs += G[k][0] * a.x + G[k][1] * a.y + G[k][2] * a8.x +
              G[k][3] * a8.y;
      }
      gs = warp_sum(gs);
      if (lane == 0) rg[warp] = gs;
      const float* ePh = eP + hw * Q;
      const float* Yh = DYs + hw * Q * LDP;
      const float eL = ePh[Q - 1];
#pragma unroll
      for (int k = 0; k < NTW; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) G[k][e] *= eL;
#pragma unroll
      for (int kk = 0; kk < Q / 8; ++kk) {
        const int ta = 8 * kk + q, tb = ta + 4;
        Frag<4> a;
        a.set(0, ePh[ta] * Yh[ta * LDP + gp0 + g]);
        a.set(1, ePh[ta] * Yh[ta * LDP + gp0 + g + 8]);
        a.set(2, ePh[tb] * Yh[tb * LDP + gp0 + g]);
        a.set(3, ePh[tb] * Yh[tb * LDP + gp0 + g + 8]);
#pragma unroll
        for (int k = 0; k < NTW; ++k) {
          Frag<2> bf;
          frag_b_kmaj(bf, Cs + 8 * kk * LDN + gn0 + 8 * k, LDN, g, q);
          mma3(G[k], a, bf);
        }
      }
    } else if (lane == 0) {
      rg[warp] = 0.f;
    }
    __syncthreads();
    if (c > 0)
      issue_sin(c - 1);   // lands during the next chunk's phases 1-2
    else
      cp_async_commit();

    // Phase 4: per head and step, dla from its terms, ddt, and the dA and
    // dD sums.
    if (warp < n_heads) {
      const int hl = warp, t = lane;
      float su = 0.f, sdd = 0.f, sy = 0.f, gsum = 0.f, R = 0.f;
#pragma unroll
      for (int pp = 0; pp < NPP; ++pp)
        su += ru[(hl * 8 + pp) * Q + t], sdd += rd[(hl * 8 + pp) * Q + t];
#pragma unroll
      for (int j = 0; j < NTN; ++j) sy += rs[(hl * 8 + j) * Q + t];
#pragma unroll
      for (int w = 0; w < 8; ++w) gsum += rg[hl * 8 + w];
      for (int tau = t; tau < Q; ++tau) R += Xps[(hl * Q + tau) * LDQ + t];
      const float dts = DTs[hl * Q + t];
      float pu = eLs[hl * Q + t] * dts * su;   // u_t
      float ps = eP[hl * Q + t] * sy;          // stY_t
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(FULL, pu, o);
        if (t >= o) pu += v;
        const float w = __shfl_down_sync(FULL, ps, o);
        if (t + o < 32) ps += w;
      }
      pu = __shfl_up_sync(FULL, pu, 1);
      if (t == 0) pu = 0.f;
      const float dla = eP[hl * Q + Q - 1] * gsum + pu + ps + R;
      if (t < L)
        ddt[((int64_t)b * T_len + c0 + t) * nh + h0 + hl] =
            sdd + __ldg(A + h0 + hl) * dla;
      acc_dA += dts * dla;
      acc_dD += dxd[hl * Q + t];
    }
  }

  if (owns) {
#pragma unroll
    for (int k = 0; k < NTW; ++k) {
      store2(ds_in + gbase + (gp0 + g) * N + gn0 + 8 * k + 2 * q, G[k][0],
             G[k][1]);
      store2(ds_in + gbase + (gp0 + g + 8) * N + gn0 + 8 * k + 2 * q,
             G[k][2], G[k][3]);
    }
  }
  if (warp < n_heads) {
    const float a = warp_sum(acc_dA), d = warp_sum(acc_dD);
    if (lane == 0) {
      part_ad[((int64_t)b * nh + h0 + warp) * 2] = a;
      part_ad[((int64_t)b * nh + h0 + warp) * 2 + 1] = d;
    }
  }
}

// dB and dC (grid.y 0 and 1): the blocks' partials summed over the head
// pairs in order, four elements a thread; dA and dD summed over the batch.
template <typename T>
__global__ void ssd_bwd_reduce_kernel(const float* __restrict__ part_bc,
                                      const float* __restrict__ part_ad,
                                      T* __restrict__ dB, T* __restrict__ dC,
                                      float* __restrict__ dA,
                                      float* __restrict__ dD, int B,
                                      int64_t TN, int nhp, int nh) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int which = blockIdx.y;
  if (i < B * TN / 4) {
    const int64_t e = 4 * i, bb = e / TN, r = e % TN;
    const float* p = part_bc + ((int64_t)which * B + bb) * nhp * TN + r;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < nhp; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(p + j * TN);
      s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
    }
    T* out = (which ? dC : dB) + e;
    store2(out, s.x, s.y);
    store2(out + 2, s.z, s.w);
  }
  if (which == 0 && i < nh) {
    float a = 0.f, d = 0.f;
    for (int bb = 0; bb < B; ++bb) {
      a += part_ad[((int64_t)bb * nh + i) * 2];
      d += part_ad[((int64_t)bb * nh + i) * 2 + 1];
    }
    dA[i] = a;
    dD[i] = d;
  }
}

template <typename T, int HP, int N>
cudaError_t launch(const void* x, const void* Bm, const void* Cm,
                   const float* dt, const float* A, const float* D,
                   const float* states, const void* dy, const float* ds_out,
                   void* dx, void* dB, void* dC, float* ddt, float* dA,
                   float* dD, float* ds_in, float* part_bc, float* part_ad,
                   int B, int T_len, int nh, Strides sx, Strides3 sb,
                   Strides3 sc, Strides3 sd, Strides sdy, Strides sdx,
                   cudaStream_t stream) {
  constexpr int smem = BwdShape<HP, N>::FLOATS * (int)sizeof(float);
  static unsigned long long done = 0;
  cudaError_t err = set_smem_once(ssd_bwd_kernel<T, HP, N>, smem, &done);
  if (err != cudaSuccess) return err;
  const int nhp = (nh + SG - 1) / SG;
  ssd_bwd_kernel<T, HP, N><<<dim3(nhp, B), NTH, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), dt, A, D, states, static_cast<const T*>(dy),
      ds_out, static_cast<T*>(dx), ddt, ds_in, part_bc, part_ad, T_len, nh,
      sx, sb, sc, sd, sdy, sdx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t TN = (int64_t)T_len * N;
  const int64_t work = B * TN / 4 > nh ? B * TN / 4 : nh;
  ssd_bwd_reduce_kernel<T><<<dim3((unsigned)((work + 255) / 256), 2), 256, 0,
                             stream>>>(
      part_bc, part_ad, static_cast<T*>(dB), static_cast<T*>(dC), dA, dD, B,
      TN, nhp, nh);
  return cudaGetLastError();
}

template <typename T, int HP>
cudaError_t dispatch_n(int N, const void* x, const void* Bm, const void* Cm,
                       const float* dt, const float* A, const float* D,
                       const float* states, const void* dy,
                       const float* ds_out, void* dx, void* dB, void* dC,
                       float* ddt, float* dA, float* dD, float* ds_in,
                       float* part_bc, float* part_ad, int B, int T_len,
                       int nh, Strides sx, Strides3 sb, Strides3 sc,
                       Strides3 sd, Strides sdy, Strides sdx,
                       cudaStream_t stream) {
#define SSD_BWD_ARGS                                                        \
  x, Bm, Cm, dt, A, D, states, dy, ds_out, dx, dB, dC, ddt, dA, dD, ds_in, \
      part_bc, part_ad, B, T_len, nh, sx, sb, sc, sd, sdy, sdx, stream
  switch (N) {
    case 16:
      return launch<T, HP, 16>(SSD_BWD_ARGS);
    case 32:
      return launch<T, HP, 32>(SSD_BWD_ARGS);
    case 64:
      return launch<T, HP, 64>(SSD_BWD_ARGS);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int hp, int N, const void* x, const void* Bm,
                     const void* Cm, const float* dt, const float* A,
                     const float* D, const float* states, const void* dy,
                     const float* ds_out, void* dx, void* dB, void* dC,
                     float* ddt, float* dA, float* dD, float* ds_in,
                     float* part_bc, float* part_ad, int B, int T_len, int nh,
                     Strides sx, Strides3 sb, Strides3 sc, Strides3 sd,
                     Strides sdy, Strides sdx, cudaStream_t stream) {
  switch (hp) {
    case 32:
      return dispatch_n<T, 32>(N, SSD_BWD_ARGS);
    case 64:
      return dispatch_n<T, 64>(N, SSD_BWD_ARGS);
    default:
      return cudaErrorInvalidValue;
  }
#undef SSD_BWD_ARGS
}

}  // namespace

// x, dy, dx [B, T, nh, hp] given by their element strides in (b, h, t, d)
// order; Bm, Cm [B, T, N] and dt [B, T, nh] by theirs in axis order; all
// with a unit last stride, and x, Bm, Cm, dy with 16-byte-aligned bases
// and strides. A, D [nh] f32; states (the forward's chunk states) [B, nh,
// ceil(T / 32), hp, N] f32 contiguous; ds_out (may be null: zeros) and
// ds_in [B, nh, hp, N] f32; dB, dC [B, T, N] and ddt [B, T, nh]
// contiguous; dA, dD [nh] f32. Workspace: part_bc [2, B, ceil(nh / 2), T,
// N] and part_ad [B, nh, 2] f32. strides: sx(4) sb(3) sc(3) sd(3) sdy(4)
// sdx(4), on the host. Launches two kernels on `stream` and returns
// cudaGetLastError() after the last launch (or the first failure).
EXPORT int ssm_scan_bwd(int dtype, int hp, int N, const void* x,
                        const void* Bm, const void* Cm, const void* dt,
                        const void* A, const void* D, const void* states,
                        const void* dy, const void* ds_out, void* dx,
                        void* dB, void* dC, void* ddt, void* dA, void* dD,
                        void* ds_in, void* part_bc, void* part_ad, int B,
                        int T, int nh, const int64_t* st, void* stream) {
  if (B <= 0 || T <= 0 || nh <= 0 || !dt || !A || !D || !states || !ds_in ||
      !part_bc || !part_ad || st[3] != 1 || st[6] != 1 || st[9] != 1 ||
      st[16] != 1 || st[20] != 1)
    return cudaErrorInvalidValue;
  const Strides sx{st[0], st[1], st[2], st[3]};
  const Strides3 sb{st[4], st[5], st[6]}, sc{st[7], st[8], st[9]};
  const Strides3 sd{st[10], st[11], st[12]};
  const Strides sdy{st[13], st[14], st[15], st[16]};
  const Strides sdx{st[17], st[18], st[19], st[20]};
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  const float* stf = static_cast<const float*>(states);
  const float* dso = static_cast<const float*>(ds_out);
  float* ddtf = static_cast<float*>(ddt);
  float* dAf = static_cast<float*>(dA);
  float* dDf = static_cast<float*>(dD);
  float* dsi = static_cast<float*>(ds_in);
  float* pbc = static_cast<float*>(part_bc);
  float* pad = static_cast<float*>(part_ad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch<float>(hp, N, x, Bm, Cm, dtf, Af, Df, stf, dy, dso, dx,
                           dB, dC, ddtf, dAf, dDf, dsi, pbc, pad, B, T, nh,
                           sx, sb, sc, sd, sdy, sdx, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(hp, N, x, Bm, Cm, dtf, Af, Df, stf, dy,
                                   dso, dx, dB, dC, ddtf, dAf, dDf, dsi, pbc,
                                   pad, B, T, nh, sx, sb, sc, sd, sdy, sdx, s);
  return cudaErrorInvalidValue;
}
