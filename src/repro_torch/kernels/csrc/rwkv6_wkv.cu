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
//     y_t = sum_{s<t} (sum_c r_t[c] exp(C[t][c] - C[s+1][c]) k_s[c]) v_s
//         + (r_t . u k_t) v_t + (r_t exp(C[t])) S
//     S  <- diag(exp(C[L])) S + sum_s (k_s exp(C[L] - C[s+1])) v_s^T.
// Unlike the TPU kernel, which starts from zeros and returns y, this one
// takes the initial state and returns the final one (prefill on top of a
// cache, decode after prefill). Inputs are f32 or bf16 (r, k, v and lw of
// one type); the math is f32; y has the inputs' type.
//
// Design.
//  * Grid (H, B): one block of 256 threads per (b, head). The TPU kernel's
//    sequential chunk axis becomes a loop inside the block; the state
//    lives in shared memory for the whole sweep and is read from s0 and
//    written to s_out once.
//  * The TPU kernel keeps a [Q, Q, hd] decay tensor resident (1 MB at
//    Q = hd = 64), far over the 227 KB a block may have. Here the decay
//    exp(C[t] - C[s+1]) is computed per (t, s, channel) inside the loop
//    that sums over channels, and never stored. Each exponent is a
//    difference within one chunk, <= 0, so nothing overflows whatever the
//    decay; no factorisation exp(C[t]) exp(-C[s+1]) is used, whose second
//    factor overflows f32 once a chunk's decay passes e^88.
//  * Each thread owns a 4 x 4 tile of the [64, 64] intra-chunk weights
//    (t = ty + 16 i, s = tx + 16 j), skipping the tiles above the
//    diagonal; y and the state update are register tiles over shared
//    memory too. Rows indexed by t or s have an odd stride (hd + 1), so
//    the loads are free of bank conflicts. ~99 KB of shared memory at
//    hd = 64: two blocks per SM.
//  * A ragged last chunk is zero-padded on load: a padded step has
//    r = k = v = 0 and lw = 0, which leaves C, y and S exactly as they
//    were, so nothing else is masked. Operands are read through their
//    strides ([B, T, H, hd] with a unit last stride), with no copies.
//  * f32 math is IEEE FMAs and expf on the CUDA cores, no TF32.
//
// What bounds it on the H100: the recurrence moves 5 Q hd elements per
// chunk and (b, head) for ~4 Q hd^2 flops, so at the served shape (B 8,
// T 999, H 64, hd 64, f32) its bound is 0.200 ms, by bytes. The chunked
// form adds ~Q^2 hd / 2 decay exponentials and the intra-chunk products;
// chip_smoke.py measures this kernel at 1.55 ms there (NVIDIA H100 80GB
// HBM3, 700 W), 7.7x the bound, with the expf calls and shared-memory
// loads in the way. Sub-chunk factorisation relative to a point between
// s and t (exact and overflow-free) would turn most of the exponentials
// into products on the tensor cores; that is the next step.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int WQ = 64;     // chunk length
constexpr int WNT = 256;   // threads per block: 16 x 16

template <int HD>
constexpr int smem_floats() {
  return 2 * WQ * (HD + 1)      // Rs, Ks: [WQ][HD + 1]
         + WQ * HD              // Vs: [WQ][HD]
         + (WQ + 1) * (HD + 1)  // Cs: [WQ + 1][HD + 1], C[t] as above
         + HD * HD              // Ss: [HD][HD], the state
         + WQ * (WQ + 1)        // As: [WQ][WQ + 1], intra-chunk weights
         + HD;                  // us: [HD]
}

template <typename T, int HD>
__global__ void __launch_bounds__(WNT) wkv_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ lw,
    const float* __restrict__ u, const float* __restrict__ s0,
    T* __restrict__ y, float* __restrict__ s_out, int T_len, int H,
    Strides sr, Strides sk, Strides sv, Strides sl, Strides sy) {
  static_assert(HD % 16 == 0 && WQ == 64, "tile shape");
  constexpr int LD = HD + 1, LA = WQ + 1;
  constexpr int CJ = HD / 16;  // columns of v (and rows of S) per thread

  extern __shared__ float smem[];
  float* Rs = smem;
  float* Ks = Rs + WQ * LD;
  float* Vs = Ks + WQ * LD;
  float* Cs = Vs + WQ * HD;
  float* Ss = Cs + (WQ + 1) * LD;
  float* As = Ss + HD * HD;
  float* us = As + WQ * LA;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const T* rb = r + b * sr.b + h * sr.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* lb = lw + b * sl.b + h * sl.h;
  T* yb = y + b * sy.b + h * sy.h;
  const int64_t sbase = ((int64_t)b * H + h) * HD * HD;

  for (int i = tid; i < HD * HD; i += WNT)
    Ss[i] = s0 ? s0[sbase + i] : 0.f;
  for (int d = tid; d < HD; d += WNT) {
    us[d] = u[h * HD + d];
    Cs[d] = 0.f;  // C[0]; the loads below fill rows 1..WQ
  }

  for (int c0 = 0; c0 < T_len; c0 += WQ) {
    const int L = min(WQ, T_len - c0);
    __syncthreads();  // the previous chunk's tiles are consumed
    for (int idx = tid; idx < WQ * HD; idx += WNT) {
      const int t = idx / HD, d = idx % HD;
      float rx = 0.f, kx = 0.f, vx = 0.f, lx = 0.f;
      if (t < L) {
        const int64_t tt = c0 + t;
        rx = to_float(rb[tt * sr.t + d * sr.d]);
        kx = to_float(kb[tt * sk.t + d * sk.d]);
        vx = to_float(vb[tt * sv.t + d * sv.d]);
        lx = to_float(lb[tt * sl.t + d * sl.d]);
      }
      Rs[t * LD + d] = rx;
      Ks[t * LD + d] = kx;
      Vs[t * HD + d] = vx;
      Cs[(t + 1) * LD + d] = lx;
    }
    __syncthreads();
    // C[t + 1] = lw_0 + ... + lw_t, one thread per channel.
    for (int d = tid; d < HD; d += WNT) {
      float c = 0.f;
      for (int t = 1; t <= WQ; ++t) {
        c += Cs[t * LD + d];
        Cs[t * LD + d] = c;
      }
    }
    __syncthreads();

    // Intra-chunk weights A[t][s] (s < t), the bonus on the diagonal.
    {
      float a[4][4], bon[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bon[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
      }
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float rt[4], ct[4], kt[4], cs[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          rt[i] = Rs[(ty + 16 * i) * LD + d];
          ct[i] = Cs[(ty + 16 * i) * LD + d];       // C[t]
          kt[i] = Ks[(tx + 16 * i) * LD + d];
          cs[i] = Cs[(tx + 16 * i + 1) * LD + d];   // C[s + 1]
        }
        const float ud = us[d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // Used only where tx == ty, that is s == t.
          bon[i] = fmaf(rt[i] * ud, kt[i], bon[i]);
#pragma unroll
          for (int j = 0; j <= i; ++j) {
            // Below the diagonal tile s < t and the exponent is <= 0; on
            // it, pairs with s >= t are dropped below, and min(., 0)
            // keeps their exponentials finite.
            const float x = ct[i] - cs[j];
            const float e = expf(j < i ? x : fminf(x, 0.f));
            a[i][j] = fmaf(rt[i] * kt[j], e, a[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i, s = tx + 16 * j;
          As[t * LA + s] = s < t ? a[i][j] : (s == t ? bon[i] : 0.f);
        }
    }
    __syncthreads();

    // r_t <- r_t exp(C[t]) (reads the state), k_s <- k_s exp(C[L] - C[s+1])
    // (writes it). Padded rows have C[s + 1] = C[L] and k_s = 0.
    const float* CL = Cs + L * LD;
    for (int idx = tid; idx < WQ * HD; idx += WNT) {
      const int t = idx / HD, d = idx % HD;
      Rs[t * LD + d] *= expf(Cs[t * LD + d]);
      Ks[t * LD + d] *= expf(CL[d] - Cs[(t + 1) * LD + d]);
    }
    __syncthreads();

    // y_t = sum_s A[t][s] v_s + (r_t exp(C[t])) S
    {
      float acc[4][CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int s = 0; s < WQ; ++s) {
        float at[4], vv[CJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) at[i] = As[(ty + 16 * i) * LA + s];
#pragma unroll
        for (int j = 0; j < CJ; ++j) vv[j] = Vs[s * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(at[i], vv[j], acc[i][j]);
      }
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float rt[4], sv_[CJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) rt[i] = Rs[(ty + 16 * i) * LD + d];
#pragma unroll
        for (int j = 0; j < CJ; ++j) sv_[j] = Ss[d * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(rt[i], sv_[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= L) continue;
#pragma unroll
        for (int j = 0; j < CJ; ++j)
          yb[(int64_t)(c0 + t) * sy.t + (tx + 16 * j) * sy.d] =
              from_float<T>(acc[i][j]);
      }
    }
    __syncthreads();  // every read of the state is done

    // S <- diag(exp(C[L])) S + sum_s k_s' v_s^T; each thread its own tile.
    {
      float acc[CJ][CJ], dk[CJ];
#pragma unroll
      for (int i = 0; i < CJ; ++i) {
        dk[i] = expf(CL[ty + 16 * i]);
#pragma unroll
        for (int j = 0; j < CJ; ++j)
          acc[i][j] = dk[i] * Ss[(ty + 16 * i) * HD + tx + 16 * j];
      }
#pragma unroll 4
      for (int s = 0; s < WQ; ++s) {
        float kt[CJ], vv[CJ];
#pragma unroll
        for (int i = 0; i < CJ; ++i) kt[i] = Ks[s * LD + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < CJ; ++j) vv[j] = Vs[s * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < CJ; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(kt[i], vv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < CJ; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j)
          Ss[(ty + 16 * i) * HD + tx + 16 * j] = acc[i][j];
    }
  }
  __syncthreads();
  for (int i = tid; i < HD * HD; i += WNT) s_out[sbase + i] = Ss[i];
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* lw, const float* u, const float* s0, void* y,
                   float* s_out, int B, int T_len, int H, Strides sr,
                   Strides sk, Strides sv, Strides sl, Strides sy,
                   cudaStream_t stream) {
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  wkv_kernel<T, HD><<<dim3(H, B), WNT, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(lw), u, s0,
      static_cast<T*>(y), s_out, T_len, H, sr, sk, sv, sl, sy);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* r, const void* k, const void* v,
                        const void* lw, const float* u, const float* s0,
                        void* y, float* s_out, int B, int T_len, int H,
                        Strides sr, Strides sk, Strides sv, Strides sl,
                        Strides sy, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(r, k, v, lw, u, s0, y, s_out, B, T_len, H, sr, sk,
                           sv, sl, sy, stream);
    case 64:
      return launch<T, 64>(r, k, v, lw, u, s0, y, s_out, B, T_len, H, sr, sk,
                           sv, sl, sy, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, lw [B, T, H, hd] and y [B, T, H, hd], each given by its element
// strides in (b, h, t, d) order; u [H, hd] f32 contiguous; s0 (may be null:
// zeros) and s_out [B, H, hd, hd] f32 contiguous. Launches on `stream` and
// returns cudaGetLastError() after the launch.
EXPORT int rwkv6_wkv_fwd(
    int dtype, int hd, const void* r, const void* k, const void* v,
    const void* lw, const void* u, const void* s0, void* y, void* s_out,
    int B, int T, int H,
    int64_t sr_b, int64_t sr_h, int64_t sr_t, int64_t sr_d,
    int64_t sk_b, int64_t sk_h, int64_t sk_t, int64_t sk_d,
    int64_t sv_b, int64_t sv_h, int64_t sv_t, int64_t sv_d,
    int64_t sl_b, int64_t sl_h, int64_t sl_t, int64_t sl_d,
    int64_t sy_b, int64_t sy_h, int64_t sy_t, int64_t sy_d, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || !u || !s_out) return cudaErrorInvalidValue;
  const Strides sr{sr_b, sr_h, sr_t, sr_d}, sk{sk_b, sk_h, sk_t, sk_d};
  const Strides sv{sv_b, sv_h, sv_t, sv_d}, sl{sl_b, sl_h, sl_t, sl_d};
  const Strides sy{sy_b, sy_h, sy_t, sy_d};
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* sof = static_cast<float*>(s_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_hd<float>(hd, r, k, v, lw, uf, s0f, y, sof, B, T, H, sr,
                              sk, sv, sl, sy, st);
  if (dtype == kBFloat16)
    return dispatch_hd<__nv_bfloat16>(hd, r, k, v, lw, uf, s0f, y, sof, B, T,
                                      H, sr, sk, sv, sl, sy, st);
  return cudaErrorInvalidValue;
}
