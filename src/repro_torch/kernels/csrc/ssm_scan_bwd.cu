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
// Within a 32-step chunk (P_t = la_0 + ... + la_t, la = dt A), with S_in
// the state the chunk starts from and Ge the gradient of the state it ends
// with, these are sums over pairs s <= t of exp(P_t - P_s) (C_t . B_s)
// terms plus the boundary terms through S_in and Ge, as the forward's
// closed form is.
//
// Design: three launches, no float atomics, the same bits on every run.
//  1. ssd_bwd_state_kernel, grid (nh, B): the reverse sweep of the state
//     gradient over the chunks, G <- exp(P_{L-1}) G + sum_t exp(P_t) dy_t
//     C_t^T, G in registers; it writes Ge of every chunk and dS_in. The
//     forward (ssm_scan.cu with a chunk-state output) wrote S_in of every
//     chunk, so every chunk now has both its boundaries.
//  2. ssd_bwd_chunk_kernel, grid (chunks, B): one block per chunk of a
//     batch row loops over all heads. Bm and Cm are shared by the heads, so
//     the block sums dBm and dCm over the heads in registers and writes
//     them once: no per-head partials, no atomics. C B^T is computed once
//     per chunk. Per head, scalar f32 products through shared memory: dy x^T,
//     S_in C, Ge B, S_in^T dy, Ge^T x, then dx, dt's two parts, and the
//     head's dA and dD partials of the chunk.
//  3. ssd_bwd_reduce_kernel: dA and dD summed over (b, chunk) in a fixed
//     order.
// Numerics. Every exponent is <= 0: exp(P_t - P_s) for s <= t, with P_t -
// P_s summed from step s + 1 on (the difference of two chunk-long sums
// loses the small exponents under a strong decay), exp(P_t) and
// exp(P_{L-1} - P_s). dla_t is summed term by term, with no cancellation:
//     dla_t = exp(P_{L-1}) <Ge, S_in> + sum_{s<t} u_s + sum_{tau>=t} stY_tau
//           + sum_{s<t<=tau} W[tau][s],
// u_s = exp(P_{L-1} - P_s) dt_s x_s . Ge B_s, stY_t = exp(P_t) dy_t . S_in
// C_t, W[t][s] = exp(P_t - P_s) dt_s (dy_t . x_s)(C_t . B_s). (Summing dP
// over the chunk and differencing loses dA by ~1e-3 relative under a
// strong decay, where dla is tiny beside the terms that cancel.) A ragged
// last chunk is zero-padded on load: x = B = C = dy = 0 and dt = 0 leave
// every sum exact, and only rows t < L are written.
//
// What bounds it on the H100: operations. At the training shape (B 8,
// T 2048, nh 112, hp = N = 64, f32) the stepwise backward's 10 flops per
// state element per step take 0.4555 ms in 3xTF32 at 495 TFLOP/s; reading
// x, B, C, dt, dy and writing dx, dB, dC, dt once takes 0.4345 ms at
// 3.35 TB/s. The 0.88 GiB of chunk states that this design reads add
// 0.2805 ms of bytes, which the bound leaves out: the gradient does not
// need them. chip_smoke.py phase 12 measures 22.44 ms (NVIDIA H100 80GB
// HBM3, 700 W), 2.0 % of the bound. This first kernel is
// scalar f32 through shared memory (~5 hp N + 3 Q (hp + N) multiply-adds
// per step and head, about two shared loads each) with one block of 8
// warps per SM (126 KB of shared memory at hp = N = 64): shared-memory
// bandwidth and latency bound it, and the tensor cores are idle.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int Q = 32;      // chunk length, as the forward's
constexpr int NTH = 256;

struct Strides3 {
  int64_t b, t, n;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pass 1: the state gradient's reverse sweep. ge[b, h, c] = the gradient of
// the state after chunk c; ds_in = that of the initial state.
template <typename T, int HP, int N>
__global__ void __launch_bounds__(NTH) ssd_bwd_state_kernel(
    const T* __restrict__ dy, const T* __restrict__ Cm,
    const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ ds_out, float* __restrict__ ge,
    float* __restrict__ ds_in, int T_len, int nh, int nc, Strides sdy,
    Strides3 sc, Strides3 sd) {
  constexpr int EL = HP * N / NTH;
  static_assert(HP * N % NTH == 0, "state shape");
  __shared__ float dys[Q * HP];
  __shared__ float Cs[Q * N];
  __shared__ float eP[Q];
  __shared__ float eL;
  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  const float Ah = A[h];
  const int64_t base = ((int64_t)b * nh + h) * nc * HP * N;
  float g[EL];
#pragma unroll
  for (int k = 0; k < EL; ++k)
    g[k] = ds_out ? ds_out[((int64_t)b * nh + h) * HP * N + tid + k * NTH]
                  : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * Q, L = min(Q, T_len - c0);
#pragma unroll
    for (int k = 0; k < EL; ++k)
      ge[base + (int64_t)c * HP * N + tid + k * NTH] = g[k];
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = tid; i < Q * HP; i += NTH) {
      const int t = i / HP, p = i % HP;
      dys[i] = t < L ? to_float(dy[b * sdy.b + h * sdy.h +
                                   (int64_t)(c0 + t) * sdy.t + p])
                     : 0.f;
    }
    for (int i = tid; i < Q * N; i += NTH) {
      const int t = i / N, n = i % N;
      Cs[i] = t < L ? to_float(Cm[b * sc.b + (int64_t)(c0 + t) * sc.t + n])
                    : 0.f;
    }
    if (tid < 32) {
      const float la =
          tid < L ? dt[b * sd.b + (int64_t)(c0 + tid) * sd.t + h * sd.n] * Ah
                  : 0.f;
      float p = la;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, p, o);
        if (tid >= o) p += v;
      }
      eP[tid] = expf(p);
      if (tid == 31) eL = expf(p);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < EL; ++k) {
      const int i = tid + k * NTH, p = i / N, n = i % N;
      float acc = 0.f;
#pragma unroll 8
      for (int t = 0; t < Q; ++t)
        acc += eP[t] * dys[t * HP + p] * Cs[t * N + n];
      g[k] = eL * g[k] + acc;
    }
  }
#pragma unroll
  for (int k = 0; k < EL; ++k)
    ds_in[((int64_t)b * nh + h) * HP * N + tid + k * NTH] = g[k];
}

template <int HP, int N>
struct ChunkShape {
  static constexpr int LDN = N + 1, LDP = HP + 1, LDQ = Q + 1;
  static constexpr int CS = 0;                     // C   [Q][LDN]
  static constexpr int BS = CS + Q * LDN;          // B   [Q][LDN]
  static constexpr int CB = BS + Q * LDN;          // C B^T [t][s]
  static constexpr int DX = CB + Q * LDQ;          // dy_t . x_s
  static constexpr int MP = DX + Q * LDQ;          // e^{P_t-P_s} CB
  static constexpr int WC = MP + Q * LDQ;          // e^{P_t-P_s} dt_s DX
  static constexpr int XS = WC + Q * LDQ;          // x   [Q][LDP]
  static constexpr int DY = XS + Q * LDP;          // dy  [Q][LDP]
  static constexpr int SC = DY + Q * LDP;          // S_in C_t [t][p]
  static constexpr int GB = SC + Q * LDP;          // Ge B_s   [s][p]
  static constexpr int DXT = GB + Q * LDP;         // d(dt_s x_s) [s][p]
  static constexpr int SIN = DXT + Q * LDP;        // S_in [HP][LDN]
  static constexpr int GE = SIN + HP * LDN;        // Ge   [HP][LDN]
  static constexpr int SDY = GE + HP * LDN;        // S_in^T dy_t [t][n]
  static constexpr int GX = SDY + Q * LDN;         // Ge^T x_s    [s][n]
  static constexpr int VEC = GX + Q * LDN;         // 8 vectors of Q
  static constexpr int FLOATS = VEC + 8 * Q + 32;
};

// Pass 2: every gradient of one chunk of one batch row, all heads.
template <typename T, int HP, int N>
__global__ void __launch_bounds__(NTH) ssd_bwd_chunk_kernel(
    const T* __restrict__ x, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ D,
    const float* __restrict__ states, const float* __restrict__ ge,
    const T* __restrict__ dy, T* __restrict__ dx, T* __restrict__ dB,
    T* __restrict__ dC, float* __restrict__ ddt, float* __restrict__ part,
    int T_len, int nh, int nc, Strides sx, Strides3 sb, Strides3 sc,
    Strides3 sd, Strides sdy, Strides sdx) {
  using S_ = ChunkShape<HP, N>;
  constexpr int LDN = S_::LDN, LDP = S_::LDP, LDQ = S_::LDQ;
  constexpr int NACC = Q * N / NTH;
  static_assert(Q * N % NTH == 0, "chunk shape");
  extern __shared__ float sm[];
  float* Cs = sm + S_::CS;
  float* Bs = sm + S_::BS;
  float* CB = sm + S_::CB;
  float* DXm = sm + S_::DX;
  float* Mp = sm + S_::MP;
  float* Wc = sm + S_::WC;
  float* xs = sm + S_::XS;
  float* dys = sm + S_::DY;
  float* SC = sm + S_::SC;
  float* GB = sm + S_::GB;
  float* DXT = sm + S_::DXT;
  float* Sin = sm + S_::SIN;
  float* Ge = sm + S_::GE;
  float* SdY = sm + S_::SDY;
  float* GX = sm + S_::GX;
  float* dts = sm + S_::VEC;       // dt_s
  float* la = dts + Q;             // dt_s A
  float* eP = la + Q;              // e^{P_t}
  float* eLs = eP + Q;             // e^{P_{L-1} - P_s}
  float* stY = eLs + Q;            // e^{P_t} dy_t . S_in C_t
  float* us = stY + Q;             // e^{P_{L-1}-P_s} dt_s x_s . Ge B_s
  float* Rv = us + Q;              // sum_{s<t<=tau} W[tau][s]
  float* dd = Rv + Q;              // x_s . d(dt_s x_s)
  float* red = dd + Q;             // block reduction scratch [32]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = blockIdx.x, b = blockIdx.y, c0 = c * Q;
  const int L = min(Q, T_len - c0);

  for (int i = tid; i < Q * N; i += NTH) {
    const int t = i / N, n = i % N;
    const bool in = t < L;
    Cs[t * LDN + n] =
        in ? to_float(Cm[b * sc.b + (int64_t)(c0 + t) * sc.t + n]) : 0.f;
    Bs[t * LDN + n] =
        in ? to_float(Bm[b * sb.b + (int64_t)(c0 + t) * sb.t + n]) : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < Q * Q; i += NTH) {
    const int t = i / Q, s = i % Q;
    float acc = 0.f;
#pragma unroll 8
    for (int n = 0; n < N; ++n) acc += Cs[t * LDN + n] * Bs[s * LDN + n];
    CB[t * LDQ + s] = acc;
  }
  float accB[NACC], accC[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) accB[k] = accC[k] = 0.f;

  for (int h = 0; h < nh; ++h) {
    __syncthreads();  // the previous head is done with shared memory
    const float Ah = A[h], Dh = D[h];
    const int64_t sbase = (((int64_t)b * nh + h) * nc + c) * HP * N;
    for (int i = tid; i < Q * HP; i += NTH) {
      const int t = i / HP, p = i % HP;
      const bool in = t < L;
      xs[t * LDP + p] =
          in ? to_float(x[b * sx.b + h * sx.h + (int64_t)(c0 + t) * sx.t + p])
             : 0.f;
      dys[t * LDP + p] =
          in ? to_float(
                   dy[b * sdy.b + h * sdy.h + (int64_t)(c0 + t) * sdy.t + p])
             : 0.f;
    }
    for (int i = tid; i < HP * N; i += NTH) {
      const int p = i / N, n = i % N;
      Sin[p * LDN + n] = states[sbase + i];
      Ge[p * LDN + n] = ge[sbase + i];
    }
    if (tid < Q) {
      const float d =
          tid < L ? dt[b * sd.b + (int64_t)(c0 + tid) * sd.t + h * sd.n] : 0.f;
      dts[tid] = d;
      la[tid] = d * Ah;
    }
    __syncthreads();

    // Products of the head's operands, and the block's two sums.
    if (warp == 0) {
      float p = la[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, p, o);
        if (lane >= o) p += v;
      }
      eP[lane] = expf(p);
    }
    for (int i = tid; i < Q * Q; i += NTH) {
      const int t = i / Q, s = i % Q;
      float acc = 0.f;
#pragma unroll 8
      for (int p = 0; p < HP; ++p) acc += dys[t * LDP + p] * xs[s * LDP + p];
      DXm[t * LDQ + s] = acc;
    }
    for (int i = tid; i < Q * HP; i += NTH) {
      const int t = i / HP, p = i % HP;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        a0 += Sin[p * LDN + n] * Cs[t * LDN + n];
        a1 += Ge[p * LDN + n] * Bs[t * LDN + n];
      }
      SC[t * LDP + p] = a0;
      GB[t * LDP + p] = a1;
    }
    for (int i = tid; i < Q * N; i += NTH) {
      const int t = i / N, n = i % N;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
      for (int p = 0; p < HP; ++p) {
        a0 += Sin[p * LDN + n] * dys[t * LDP + p];
        a1 += Ge[p * LDN + n] * xs[t * LDP + p];
      }
      SdY[t * LDN + n] = a0;
      GX[t * LDN + n] = a1;
    }
    float gs = 0.f, dsum = 0.f;
    for (int i = tid; i < HP * N; i += NTH) {
      const int p = i / N, n = i % N;
      gs += Ge[p * LDN + n] * Sin[p * LDN + n];
    }
    for (int i = tid; i < Q * HP; i += NTH) {
      const int t = i / HP, p = i % HP;
      dsum += dys[t * LDP + p] * xs[t * LDP + p];
    }
    gs = warp_sum(gs);
    dsum = warp_sum(dsum);
    if (lane == 0) red[warp] = gs, red[8 + warp] = dsum;
    __syncthreads();

    // The decays: exp(P_t - P_s), P_t - P_s summed from step s + 1 on.
    for (int i = tid; i < Q * Q; i += NTH) {
      const int t = i / Q, s = i % Q;
      float e = 0.f;
      if (s <= t) {
        float rel = 0.f;
        for (int j = s + 1; j <= t; ++j) rel += la[j];
        e = expf(rel);
      }
      Mp[t * LDQ + s] = e * CB[t * LDQ + s];
      Wc[t * LDQ + s] = e * dts[s] * DXm[t * LDQ + s];
      if (t == Q - 1) eLs[s] = e;
    }
    __syncthreads();
    const float gsum = [&] {
      float v = 0.f;
      for (int w = 0; w < NTH / 32; ++w) v += red[w];
      return v;
    }();

    // dx, the dB and dC sums, and the per-step terms of dla.
    for (int i = tid; i < Q * HP; i += NTH) {
      const int s = i / HP, p = i % HP;
      float acc = eLs[s] * GB[s * LDP + p];
      for (int t = s; t < Q; ++t) acc += Mp[t * LDQ + s] * dys[t * LDP + p];
      DXT[s * LDP + p] = acc;
      if (s < L)
        dx[b * sdx.b + h * sdx.h + (int64_t)(c0 + s) * sdx.t + p] =
            from_float<T>(dts[s] * acc + Dh * dys[s * LDP + p]);
    }
#pragma unroll
    for (int k = 0; k < NACC; ++k) {
      const int i = tid + k * NTH, t = i / N, n = i % N;
      float a0 = eP[t] * SdY[t * LDN + n];
      for (int s = 0; s <= t; ++s) a0 += Wc[t * LDQ + s] * Bs[s * LDN + n];
      accC[k] += a0;
      const int s = t;   // the same (row, n) as dB's row s
      float a1 = eLs[s] * dts[s] * GX[s * LDN + n];
      for (int tt = s; tt < Q; ++tt) a1 += Wc[tt * LDQ + s] * Cs[tt * LDN + n];
      accB[k] += a1;
    }
    if (tid < Q) {
      const int t = tid;
      float a = 0.f;
      for (int p = 0; p < HP; ++p) a += dys[t * LDP + p] * SC[t * LDP + p];
      stY[t] = eP[t] * a;
    } else if (tid < 2 * Q) {
      const int s = tid - Q;
      float a = 0.f;
      for (int p = 0; p < HP; ++p) a += xs[s * LDP + p] * GB[s * LDP + p];
      us[s] = eLs[s] * dts[s] * a;
    } else if (tid < 3 * Q) {
      const int t = tid - 2 * Q;
      float a = 0.f;
      for (int tau = t; tau < Q; ++tau)
        for (int s = 0; s < t; ++s)
          a += Wc[tau * LDQ + s] * CB[tau * LDQ + s];
      Rv[t] = a;
    }
    __syncthreads();
    for (int s = warp; s < Q; s += NTH / 32) {
      float a = 0.f;
      for (int p = lane; p < HP; p += 32)
        a += xs[s * LDP + p] * DXT[s * LDP + p];
      a = warp_sum(a);
      if (lane == 0) dd[s] = a;
    }
    __syncthreads();
    if (warp == 0) {
      const int t = lane;
      // sum_{s<t} u_s: an inclusive scan shifted by one lane.
      float pu = us[t];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, pu, o);
        if (lane >= o) pu += v;
      }
      pu = __shfl_up_sync(0xffffffffu, pu, 1);
      if (lane == 0) pu = 0.f;
      // sum_{tau>=t} stY_tau.
      float sy = stY[t];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, sy, o);
        if (lane + o < 32) sy += v;
      }
      const float dla = eP[Q - 1] * gsum + pu + sy + Rv[t];
      if (t < L)
        ddt[b * (int64_t)T_len * nh + (int64_t)(c0 + t) * nh + h] =
            dd[t] + Ah * dla;
      const float pa = warp_sum(dts[t] * dla);
      if (lane == 0) {
        float pd = 0.f;
        for (int w = 0; w < NTH / 32; ++w) pd += red[8 + w];
        const int64_t j = ((int64_t)b * nc + c) * nh + h;
        part[2 * j] = pa;
        part[2 * j + 1] = pd;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    const int i = tid + k * NTH, t = i / N, n = i % N;
    if (t < L) {
      const int64_t o = ((int64_t)b * T_len + c0 + t) * N + n;
      dB[o] = from_float<T>(accB[k]);
      dC[o] = from_float<T>(accC[k]);
    }
  }
}

// Pass 3: dA and dD, summed over (b, chunk) in order.
__global__ void ssd_bwd_reduce_kernel(const float* __restrict__ part,
                                      float* __restrict__ dA,
                                      float* __restrict__ dD, int rows,
                                      int nh) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= nh) return;
  float a = 0.f, d = 0.f;
  for (int j = 0; j < rows; ++j) {
    a += part[2 * ((int64_t)j * nh + h)];
    d += part[2 * ((int64_t)j * nh + h) + 1];
  }
  dA[h] = a;
  dD[h] = d;
}

template <typename T, int HP, int N>
cudaError_t launch(const void* x, const void* Bm, const void* Cm,
                   const float* dt, const float* A, const float* D,
                   const float* states, const void* dy, const float* ds_out,
                   void* dx, void* dB, void* dC, float* ddt, float* dA,
                   float* dD, float* ds_in, float* ge, float* part, int B,
                   int T_len, int nh, Strides sx, Strides3 sb, Strides3 sc,
                   Strides3 sd, Strides sdy, Strides sdx,
                   cudaStream_t stream) {
  const int nc = (T_len + Q - 1) / Q;
  ssd_bwd_state_kernel<T, HP, N><<<dim3(nh, B), NTH, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(Cm), dt, A, ds_out,
      ge, ds_in, T_len, nh, nc, sdy, sc, sd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int smem = ChunkShape<HP, N>::FLOATS * (int)sizeof(float);
  static unsigned long long done = 0;
  err = set_smem_once(ssd_bwd_chunk_kernel<T, HP, N>, smem, &done);
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<T, HP, N><<<dim3(nc, B), NTH, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), dt, A, D, states, ge,
      static_cast<const T*>(dy), static_cast<T*>(dx), static_cast<T*>(dB),
      static_cast<T*>(dC), ddt, part, T_len, nh, nc, sx, sb, sc, sd, sdy,
      sdx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_reduce_kernel<<<(nh + 127) / 128, 128, 0, stream>>>(
      part, dA, dD, B * nc, nh);
  return cudaGetLastError();
}

template <typename T, int HP>
cudaError_t dispatch_n(int N, const void* x, const void* Bm, const void* Cm,
                       const float* dt, const float* A, const float* D,
                       const float* states, const void* dy,
                       const float* ds_out, void* dx, void* dB, void* dC,
                       float* ddt, float* dA, float* dD, float* ds_in,
                       float* ge, float* part, int B, int T_len, int nh,
                       Strides sx, Strides3 sb, Strides3 sc, Strides3 sd,
                       Strides sdy, Strides sdx, cudaStream_t stream) {
#define SSD_BWD_ARGS                                                        \
  x, Bm, Cm, dt, A, D, states, dy, ds_out, dx, dB, dC, ddt, dA, dD, ds_in, \
      ge, part, B, T_len, nh, sx, sb, sc, sd, sdy, sdx, stream
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
                     float* ge, float* part, int B, int T_len, int nh,
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
// with a unit last stride. A, D [nh] f32; states (the forward's chunk
// states) [B, nh, ceil(T / 32), hp, N] f32 contiguous; ds_out (may be
// null: zeros) and ds_in [B, nh, hp, N] f32; dB, dC [B, T, N] and ddt
// [B, T, nh] contiguous; dA, dD [nh] f32. Workspace: ge like states, part
// [B, ceil(T / 32), nh, 2] f32. strides: sx(4) sb(3) sc(3) sd(3) sdy(4)
// sdx(4), on the host. Launches three kernels on `stream` and returns
// cudaGetLastError() after the last launch (or the first failure).
EXPORT int ssm_scan_bwd(int dtype, int hp, int N, const void* x,
                        const void* Bm, const void* Cm, const void* dt,
                        const void* A, const void* D, const void* states,
                        const void* dy, const void* ds_out, void* dx,
                        void* dB, void* dC, void* ddt, void* dA, void* dD,
                        void* ds_in, void* ge, void* part, int B, int T,
                        int nh, const int64_t* st, void* stream) {
  if (B <= 0 || T <= 0 || nh <= 0 || !dt || !A || !D || !states || !ds_in ||
      !ge || !part || st[3] != 1 || st[6] != 1 || st[9] != 1 ||
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
  float* gef = static_cast<float*>(ge);
  float* pf = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch<float>(hp, N, x, Bm, Cm, dtf, Af, Df, stf, dy, dso, dx,
                           dB, dC, ddtf, dAf, dDf, dsi, gef, pf, B, T, nh, sx,
                           sb, sc, sd, sdy, sdx, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(hp, N, x, Bm, Cm, dtf, Af, Df, stf, dy,
                                   dso, dx, dB, dC, ddtf, dAf, dDf, dsi, gef,
                                   pf, B, T, nh, sx, sb, sc, sd, sdy, sdx, s);
  return cudaErrorInvalidValue;
}
