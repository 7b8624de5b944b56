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
//     du = sum dA[t][t] r_t k_t,   dS_in = e^{C[L]} Ge + sum_t r_t e^{C[t]}
//     dy_t^T.
// The loss sees the cumulative decays only through r_t e^{C[t]}, k_s
// e^{-C[s+1]} and the boundary e^{C[L]}, so per channel
//     dC[j] = r_j (dr_j - bonus) - k_{j-1} (dk_{j-1} - bonus)
//             (+ sum_s k_s e^{C[L]-C[s+1]} Ge v_s + e^{C[L]} rowsum(Ge S_in)
//              at j = L),
// and dlw_i = sum_{j > i} dC[j], a reverse sum within the chunk.
//
// Design: three launches, no float atomics, the same bits on every run.
//  1. wkv_bwd_state_kernel, grid (H, B): the reverse sweep of the state
//     gradient, G <- e^{C[L]} G + sum_t (r_t e^{C[t]}) dy_t^T, in
//     registers; it writes Ge of every chunk and dS_in. The forward
//     (rwkv6_wkv.cu with a chunk-state output) wrote S_in of every chunk.
//  2. wkv_bwd_chunk_kernel, grid (chunks, H, B): every gradient of one
//     chunk of one head, scalar f32 through shared memory (~134 KB at
//     hd 64); u's partial per (b, chunk).
//  3. wkv_bwd_reduce_kernel: du summed over (b, chunk) in a fixed order.
// Numerics. Decays are natural-log sums per channel; every exponent is a
// difference within the chunk, <= 0 (expf, not the forward's ex2.approx).
// A ragged last chunk is zero-padded on load: r = k = v = dy = 0 and
// lw = 0 leave every sum exact, and only rows t < L are written.
//
// What bounds it on the H100: bytes. At the training shape (B 8, T 2048,
// H 64, hd 64, f32) it must read r, k, v, lw, dy and write dr, dk, dv, dlw
// once: 0.7237 ms at 3.35 TB/s; the stepwise backward's 10 flops per state
// element per step take less in 3xTF32. The 0.50 GiB of chunk states that
// this design reads add 0.1603 ms of bytes, which the bound leaves out:
// the gradient does not need them. chip_smoke.py phase 12 measures 17.70
// ms (NVIDIA H100 80GB HBM3, 700 W), 4.1 % of the bound. This first kernel
// is scalar f32 through shared memory (~3 hd^2 + 2 Q hd multiply-adds and
// ~1.5 Q hd expf per step and head) with one block of 8 warps per SM (134
// KB of shared memory at hd 64): shared-memory bandwidth and the
// exponentials bound it, and the tensor cores are idle.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int Q = 32;      // chunk length, as the forward's
constexpr int NTH = 256;

// Pass 1: the state gradient's reverse sweep. ge[b, h, c] = the gradient of
// the state after chunk c; ds_in = that of the initial state.
template <typename T, int HD>
__global__ void __launch_bounds__(NTH) wkv_bwd_state_kernel(
    const T* __restrict__ r, const T* __restrict__ lw,
    const T* __restrict__ dy, const float* __restrict__ ds_out,
    float* __restrict__ ge, float* __restrict__ ds_in, int T_len, int H,
    int nc, Strides sr, Strides sl, Strides sdy) {
  constexpr int EL = HD * HD / NTH;
  static_assert(HD * HD % NTH == 0 && HD <= NTH, "state shape");
  __shared__ float Rt[Q * HD];    // r_t e^{C[t]}
  __shared__ float dys[Q * HD];
  __shared__ float eCL[HD];
  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  const int64_t sb = ((int64_t)b * H + h) * HD * HD;
  const int64_t base = ((int64_t)b * H + h) * nc * HD * HD;
  float g[EL];
#pragma unroll
  for (int k = 0; k < EL; ++k)
    g[k] = ds_out ? ds_out[sb + tid + k * NTH] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * Q, L = min(Q, T_len - c0);
#pragma unroll
    for (int k = 0; k < EL; ++k)
      ge[base + (int64_t)c * HD * HD + tid + k * NTH] = g[k];
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = tid; i < Q * HD; i += NTH) {
      const int t = i / HD, d = i % HD;
      dys[i] = t < L ? to_float(dy[b * sdy.b + h * sdy.h +
                                   (int64_t)(c0 + t) * sdy.t + d])
                     : 0.f;
    }
    if (tid < HD) {
      float C = 0.f;
      for (int t = 0; t < Q; ++t) {
        const bool in = t < L;
        const int64_t o = (int64_t)(c0 + t);
        const float rv = in ? to_float(r[b * sr.b + h * sr.h + o * sr.t + tid])
                            : 0.f;
        Rt[t * HD + tid] = rv * expf(C);
        C += in ? to_float(lw[b * sl.b + h * sl.h + o * sl.t + tid]) : 0.f;
      }
      eCL[tid] = expf(C);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < EL; ++k) {
      const int i = tid + k * NTH, ch = i / HD, v = i % HD;
      float acc = 0.f;
#pragma unroll 8
      for (int t = 0; t < Q; ++t) acc += Rt[t * HD + ch] * dys[t * HD + v];
      g[k] = eCL[ch] * g[k] + acc;
    }
  }
#pragma unroll
  for (int k = 0; k < EL; ++k) ds_in[sb + tid + k * NTH] = g[k];
}

template <int HD>
struct ChunkShape {
  static constexpr int LD = HD + 1, LDQ = Q + 1;
  static constexpr int RS = 0;                 // r  [Q][LD]
  static constexpr int KS = RS + Q * LD;       // k
  static constexpr int VS = KS + Q * LD;       // v
  static constexpr int DY = VS + Q * LD;       // dy
  static constexpr int CX = DY + Q * LD;       // C  [Q + 1][LD]
  static constexpr int SIN = CX + (Q + 1) * LD;   // S_in [HD][LD]
  static constexpr int GE = SIN + HD * LD;        // Ge   [HD][LD]
  static constexpr int AM = GE + HD * LD;         // A  [Q][LDQ]
  static constexpr int DA = AM + Q * LDQ;         // dA [Q][LDQ]
  static constexpr int SDY = DA + Q * LDQ;        // S_in dy_t [t][c]
  static constexpr int GV = SDY + Q * LD;         // Ge v_s    [s][c]
  static constexpr int GKH = GV + Q * LD;         // Ge^T (k_s e^{..}) [s][v]
  static constexpr int ELS = GKH + Q * LD;        // e^{C[L] - C[s+1]} [s][c]
  static constexpr int DR = ELS + Q * LD;         // dr [t][c]
  static constexpr int DK = DR + Q * LD;          // dk [s][c]
  static constexpr int VEC = DK + Q * LD;         // u, e^{C[L]}, rowGS
  static constexpr int FLOATS = VEC + 3 * HD;
};

// Pass 2: every gradient of one chunk of one (b, head).
template <typename T, int HD>
__global__ void __launch_bounds__(NTH) wkv_bwd_chunk_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ lw,
    const float* __restrict__ u, const float* __restrict__ states,
    const float* __restrict__ ge, const T* __restrict__ dy,
    T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
    T* __restrict__ dlw, float* __restrict__ part, int T_len, int H, int nc,
    Strides sr, Strides sk, Strides sv, Strides sl, Strides sdy,
    Strides sdr) {
  using S_ = ChunkShape<HD>;
  constexpr int LD = S_::LD, LDQ = S_::LDQ;
  static_assert(2 * HD <= NTH, "head dim");
  extern __shared__ float sm[];
  float* rs = sm + S_::RS;
  float* ks = sm + S_::KS;
  float* vs = sm + S_::VS;
  float* dys = sm + S_::DY;
  float* Cx = sm + S_::CX;
  float* Sin = sm + S_::SIN;
  float* Ge = sm + S_::GE;
  float* Am = sm + S_::AM;
  float* dAm = sm + S_::DA;
  float* SdY = sm + S_::SDY;
  float* Gv = sm + S_::GV;
  float* GKh = sm + S_::GKH;
  float* ELs = sm + S_::ELS;
  float* drs = sm + S_::DR;
  float* dks = sm + S_::DK;
  float* us = sm + S_::VEC;
  float* eCL = us + HD;
  float* rowGS = eCL + HD;

  const int tid = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, c0 = c * Q;
  const int L = min(Q, T_len - c0);
  const int64_t sbase = (((int64_t)b * H + h) * nc + c) * HD * HD;

  for (int i = tid; i < Q * HD; i += NTH) {
    const int t = i / HD, d = i % HD;
    const bool in = t < L;
    const int64_t o = (int64_t)(c0 + t);
    rs[t * LD + d] =
        in ? to_float(r[b * sr.b + h * sr.h + o * sr.t + d]) : 0.f;
    ks[t * LD + d] =
        in ? to_float(k[b * sk.b + h * sk.h + o * sk.t + d]) : 0.f;
    vs[t * LD + d] =
        in ? to_float(v[b * sv.b + h * sv.h + o * sv.t + d]) : 0.f;
    dys[t * LD + d] =
        in ? to_float(dy[b * sdy.b + h * sdy.h + o * sdy.t + d]) : 0.f;
    Cx[(t + 1) * LD + d] =
        in ? to_float(lw[b * sl.b + h * sl.h + o * sl.t + d]) : 0.f;
  }
  for (int i = tid; i < HD * HD; i += NTH) {
    const int ch = i / HD, d = i % HD;
    Sin[ch * LD + d] = states[sbase + i];
    Ge[ch * LD + d] = ge[sbase + i];
  }
  for (int d = tid; d < HD; d += NTH) us[d] = u[h * HD + d];
  __syncthreads();

  // C per channel (exclusive sums), and the products that need no decay.
  if (tid < HD) {
    float C = 0.f;
    Cx[tid] = 0.f;
    for (int t = 1; t <= Q; ++t) {
      C += Cx[t * LD + tid];
      Cx[t * LD + tid] = C;
    }
    eCL[tid] = expf(C);
  }
  for (int i = tid; i < Q * Q; i += NTH) {
    const int t = i / Q, s = i % Q;
    float acc = 0.f;
    if (s <= t) {
#pragma unroll 8
      for (int d = 0; d < HD; ++d) acc += dys[t * LD + d] * vs[s * LD + d];
    }
    dAm[t * LDQ + s] = acc;
  }
  for (int i = tid; i < Q * HD; i += NTH) {
    const int t = i / HD, ch = i % HD;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      a0 += Sin[ch * LD + d] * dys[t * LD + d];
      a1 += Ge[ch * LD + d] * vs[t * LD + d];
    }
    SdY[t * LD + ch] = a0;
    Gv[t * LD + ch] = a1;
  }
  for (int ch = tid; ch < HD; ch += NTH) {
    float a = 0.f;
    for (int d = 0; d < HD; ++d) a += Ge[ch * LD + d] * Sin[ch * LD + d];
    rowGS[ch] = a;
  }
  __syncthreads();

  // A (with the bonus on its diagonal) and e^{C[L] - C[s+1]}.
  for (int i = tid; i < Q * HD; i += NTH) {
    const int s = i / HD, ch = i % HD;
    ELs[s * LD + ch] = expf(Cx[Q * LD + ch] - Cx[(s + 1) * LD + ch]);
  }
  for (int i = tid; i < Q * Q; i += NTH) {
    const int t = i / Q, s = i % Q;
    float acc = 0.f;
    if (s < t) {
      for (int ch = 0; ch < HD; ++ch)
        acc += rs[t * LD + ch] * ks[s * LD + ch] *
               expf(Cx[t * LD + ch] - Cx[(s + 1) * LD + ch]);
    } else if (s == t) {
      for (int ch = 0; ch < HD; ++ch)
        acc += rs[t * LD + ch] * us[ch] * ks[t * LD + ch];
    }
    Am[t * LDQ + s] = acc;
  }
  __syncthreads();

  // dr, dk and Ge^T (k e^{C[L] - C[s+1]}).
  for (int i = tid; i < Q * HD; i += NTH) {
    const int t = i / HD, ch = i % HD;
    const float ct = Cx[t * LD + ch];
    float a = dAm[t * LDQ + t] * us[ch] * ks[t * LD + ch] +
              expf(ct) * SdY[t * LD + ch];
    for (int s = 0; s < t; ++s)
      a += dAm[t * LDQ + s] * ks[s * LD + ch] *
           expf(ct - Cx[(s + 1) * LD + ch]);
    drs[t * LD + ch] = a;
    if (t < L)
      dr[b * sdr.b + h * sdr.h + (int64_t)(c0 + t) * sdr.t + ch] =
          from_float<T>(a);
  }
  for (int i = tid; i < Q * HD; i += NTH) {
    const int s = i / HD, ch = i % HD;
    const float cs = Cx[(s + 1) * LD + ch];
    float a = dAm[s * LDQ + s] * us[ch] * rs[s * LD + ch] +
              ELs[s * LD + ch] * Gv[s * LD + ch];
    for (int t = s + 1; t < Q; ++t)
      a += dAm[t * LDQ + s] * rs[t * LD + ch] * expf(Cx[t * LD + ch] - cs);
    dks[s * LD + ch] = a;
    if (s < L)
      dk[b * sdr.b + h * sdr.h + (int64_t)(c0 + s) * sdr.t + ch] =
          from_float<T>(a);
  }
  for (int i = tid; i < Q * HD; i += NTH) {
    const int s = i / HD, d = i % HD;
    float a = 0.f;
#pragma unroll 8
    for (int ch = 0; ch < HD; ++ch)
      a += Ge[ch * LD + d] * ks[s * LD + ch] * ELs[s * LD + ch];
    GKh[s * LD + d] = a;
  }
  __syncthreads();

  // dv; dlw per channel; u's partial.
  for (int i = tid; i < Q * HD; i += NTH) {
    const int s = i / HD, d = i % HD;
    float a = GKh[s * LD + d];
    for (int t = s; t < Q; ++t) a += Am[t * LDQ + s] * dys[t * LD + d];
    if (s < L)
      dv[b * sdr.b + h * sdr.h + (int64_t)(c0 + s) * sdr.t + d] =
          from_float<T>(a);
  }
  if (tid < HD) {
    const int ch = tid;
    const float uc = us[ch];
    float acc = eCL[ch] * rowGS[ch];
    for (int s = 0; s < Q; ++s)
      acc += ks[s * LD + ch] * ELs[s * LD + ch] * Gv[s * LD + ch];
    for (int j = Q; j >= 1; --j) {
      if (j < Q)
        acc += rs[j * LD + ch] *
               (drs[j * LD + ch] - dAm[j * LDQ + j] * uc * ks[j * LD + ch]);
      const int s = j - 1;
      acc -= ks[s * LD + ch] *
             (dks[s * LD + ch] - dAm[s * LDQ + s] * uc * rs[s * LD + ch]);
      if (s < L)
        dlw[b * sdr.b + h * sdr.h + (int64_t)(c0 + s) * sdr.t + ch] =
            from_float<T>(acc);
    }
  } else if (tid < 2 * HD) {
    const int ch = tid - HD;
    float a = 0.f;
    for (int t = 0; t < Q; ++t)
      a += dAm[t * LDQ + t] * rs[t * LD + ch] * ks[t * LD + ch];
    part[(((int64_t)b * nc + c) * H + h) * HD + ch] = a;
  }
}

// Pass 3: du, summed over (b, chunk) in order.
__global__ void wkv_bwd_reduce_kernel(const float* __restrict__ part,
                                      float* __restrict__ du, int rows,
                                      int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = 0.f;
  for (int j = 0; j < rows; ++j) a += part[(int64_t)j * n + i];
  du[i] = a;
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* lw, const float* u, const float* states,
                   const void* dy, const float* ds_out, void* dr, void* dk,
                   void* dv, void* dlw, float* du, float* ds_in, float* ge,
                   float* part, int B, int T_len, int H, Strides sr,
                   Strides sk, Strides sv, Strides sl, Strides sdy,
                   Strides sdr, cudaStream_t stream) {
  const int nc = (T_len + Q - 1) / Q;
  wkv_bwd_state_kernel<T, HD><<<dim3(H, B), NTH, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(lw),
      static_cast<const T*>(dy), ds_out, ge, ds_in, T_len, H, nc, sr, sl,
      sdy);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int smem = ChunkShape<HD>::FLOATS * (int)sizeof(float);
  static unsigned long long done = 0;
  err = set_smem_once(wkv_bwd_chunk_kernel<T, HD>, smem, &done);
  if (err != cudaSuccess) return err;
  wkv_bwd_chunk_kernel<T, HD><<<dim3(nc, H, B), NTH, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(lw), u, states, ge,
      static_cast<const T*>(dy), static_cast<T*>(dr), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<T*>(dlw), part, T_len, H, nc, sr, sk,
      sv, sl, sdy, sdr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv_bwd_reduce_kernel<<<(H * HD + 127) / 128, 128, 0, stream>>>(
      part, du, B * nc, H * HD);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* r, const void* k, const void* v,
                     const void* lw, const float* u, const float* states,
                     const void* dy, const float* ds_out, void* dr, void* dk,
                     void* dv, void* dlw, float* du, float* ds_in, float* ge,
                     float* part, int B, int T_len, int H, Strides sr,
                     Strides sk, Strides sv, Strides sl, Strides sdy,
                     Strides sdr, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(r, k, v, lw, u, states, dy, ds_out, dr, dk, dv,
                           dlw, du, ds_in, ge, part, B, T_len, H, sr, sk, sv,
                           sl, sdy, sdr, stream);
    case 64:
      return launch<T, 64>(r, k, v, lw, u, states, dy, ds_out, dr, dk, dv,
                           dlw, du, ds_in, ge, part, B, T_len, H, sr, sk, sv,
                           sl, sdy, sdr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, lw, dy and the gradients dr, dk, dv, dlw [B, T, H, hd], each
// given by its element strides in (b, h, t, d) order with a unit last
// stride (the four gradients share sdr). u [H, hd] f32; states (the
// forward's chunk states) [B, H, ceil(T / 32), hd, hd] f32 contiguous;
// ds_out (may be null: zeros) and ds_in [B, H, hd, hd] f32; du [H, hd]
// f32. Workspace: ge like states, part [B, ceil(T / 32), H, hd] f32.
// strides: sr sk sv sl sdy sdr, four each, on the host. Launches three
// kernels on `stream` and returns cudaGetLastError() after the last launch
// (or the first failure).
EXPORT int rwkv6_wkv_bwd(int dtype, int hd, const void* r, const void* k,
                         const void* v, const void* lw, const void* u,
                         const void* states, const void* dy,
                         const void* ds_out, void* dr, void* dk, void* dv,
                         void* dlw, void* du, void* ds_in, void* ge,
                         void* part, int B, int T, int H, const int64_t* st,
                         void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || !u || !states || !ds_in || !ge ||
      !part)
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
  float* gef = static_cast<float*>(ge);
  float* pf = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch<float>(hd, r, k, v, lw, uf, stf, dy, dso, dr, dk, dv, dlw,
                           duf, dsi, gef, pf, B, T, H, sr, sk, sv, sl, sdy,
                           sdr, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(hd, r, k, v, lw, uf, stf, dy, dso, dr, dk,
                                   dv, dlw, duf, dsi, gef, pf, B, T, H, sr,
                                   sk, sv, sl, sdy, sdr, s);
  return cudaErrorInvalidValue;
}
