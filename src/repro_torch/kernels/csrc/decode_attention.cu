// Flash decode: one query token per sequence attends to its KV cache in one
// pass, with an online softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py,
// function `decode_attention` (body `_kernel`).
//
// What it computes, per (b, kv): the G query heads of the group attend to
// the cache slots s with k_pos[s] <= pos. k_pos is the slot -> absolute
// position map, so ring caches and the 2**30 mark of an empty slot are
// masked by the same test. A masked slot gets the logit -1e30, as in the
// reference. m, l and the accumulator are f32; l is clamped at 1e-30; the
// output has the input's type.
//
// Design.
//  * Grid (n_split, KV, B): the cache is cut into n_split equal runs of
//    whole 64-slot tiles, one block per (run, KV group). The block loops
//    over its run's tiles; the TPU kernel's sequential grid axis becomes
//    that loop, which carries m and l in shared memory and the accumulator
//    in registers. With n_split > 1 each block writes its unnormalised
//    (m, l, acc) to an f32 workspace and a second kernel merges the runs
//    (flash-decoding); with n_split == 1 the block writes the output.
//  * The G heads of a group are packed together as in the reference, so
//    each K/V tile is read from device memory once for all G heads. G is
//    a runtime value (7 for qwen2-0.5b), up to 16.
//  * The cache is read through its strides: the model hands over its
//    [B, S, KV, hd] cache as a [B, KV, S, hd] view, with no transpose.
//  * Logits: one thread per (head, slot) pair, an hd-long dot from shared
//    memory (the K tile has an odd row stride, so the dots are free of
//    bank conflicts). Softmax update: one warp per head. P V: one thread
//    per (head, column) output, looping over the tile's slots.
//
// What bounds it on the H100: decode reads the whole cache once for ~2 G
// FLOPs per element, far below the card's ridge, so it is bound by bytes.
// A block's sweep is latency-bound (a tile is loaded, then scored, then
// accumulated, with barriers between), and B * KV is only 16 blocks at the
// main path's batch of 8, so the wrapper splits S until about two blocks
// per SM are in flight.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int DBK = 64;    // cache slots per tile
constexpr int DNT = 128;   // threads per block
constexpr int GMAX = 16;   // most query heads per KV group

template <int HD>
constexpr int smem_floats() {
  return GMAX * HD          // Qs: [G][HD]
       + DBK * (HD + 1)     // Ks: [DBK][HD + 1]
       + DBK * HD           // Vs: [DBK][HD]
       + GMAX * DBK;        // Ss: [G][DBK] logits, then probabilities
}

// One run's unnormalised state in the workspace: acc [G][HD], m [G], l [G].
template <int HD>
__host__ __device__ constexpr int part_floats(int G) { return G * (HD + 2); }

template <typename T, int HD>
__global__ void __launch_bounds__(DNT) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ ws,
    const int* __restrict__ k_pos, int pos, int S, int G, int split_len,
    float scale, Strides sq, Strides sk, Strides sv, Strides so) {
  static_assert(DBK == 64, "the softmax step gives each lane two slots");
  constexpr int LDK = HD + 1;
  constexpr int NACC = (GMAX * HD + DNT - 1) / DNT;

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + GMAX * HD;
  float* Vs = Ks + DBK * LDK;
  float* Ss = Vs + DBK * HD;
  __shared__ float m_s[GMAX], l_s[GMAX], a_s[GMAX];
  __shared__ int kpos_s[DBK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int k_begin = split * split_len;
  const int k_end = min(S, k_begin + split_len);
  const T* qb = q + b * sq.b + kvh * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  T* ob = o + b * so.b + kvh * so.h;
  const int n_out = G * HD;

  for (int idx = tid; idx < n_out; idx += DNT) {
    const int g = idx / HD, d = idx % HD;
    Qs[idx] = to_float(qb[g * sq.t + d * sq.d]);
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[NACC];
#pragma unroll
  for (int t = 0; t < NACC; ++t) acc[t] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += DBK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ss are consumed
    static_assert(DBK * HD % DNT == 0, "whole tile loads per thread");
#pragma unroll 8
    for (int it = 0; it < DBK * HD / DNT; ++it) {
      const int idx = tid + it * DNT;
      const int j = idx / HD, d = idx % HD;
      const int kk = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kk < k_end) {
        kx = to_float(kb[kk * sk.t + d * sk.d]);
        vx = to_float(vb[kk * sv.t + d * sv.d]);
      }
      Ks[j * LDK + d] = kx;
      Vs[j * HD + d] = vx;
    }
    if (tid < DBK) kpos_s[tid] = k0 + tid < k_end ? k_pos[k0 + tid] : 0;
    __syncthreads();

    for (int idx = tid; idx < G * DBK; idx += DNT) {
      const int g = idx / DBK, j = idx % DBK;
      float x;
      if (k0 + j >= k_end) {
        x = -INFINITY;
      } else {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d)
          dot = fmaf(Qs[g * HD + d], Ks[j * LDK + d], dot);
        x = kpos_s[j] <= pos ? dot * scale : kNegInf;
      }
      Ss[g * DBK + j] = x;
    }
    __syncthreads();

    for (int g = warp; g < G; g += DNT / 32) {
      const float x0 = Ss[g * DBK + lane], x1 = Ss[g * DBK + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      Ss[g * DBK + lane] = p0;
      Ss[g * DBK + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int t = 0; t < NACC; ++t) {
      const int idx = tid + t * DNT;
      if (idx < n_out) {
        const int g = idx / HD, d = idx % HD;
        float a = acc[t] * a_s[g];
#pragma unroll 8
        for (int j = 0; j < DBK; ++j)
          a = fmaf(Ss[g * DBK + j], Vs[j * HD + d], a);
        acc[t] = a;
      }
    }
  }
  __syncthreads();

  if (gridDim.x == 1) {
#pragma unroll
    for (int t = 0; t < NACC; ++t) {
      const int idx = tid + t * DNT;
      if (idx < n_out) {
        const int g = idx / HD, d = idx % HD;
        ob[g * so.t + d * so.d] =
            from_float<T>(acc[t] / fmaxf(l_s[g], 1e-30f));
      }
    }
    return;
  }
  float* part = ws + ((int64_t)(b * gridDim.y + kvh) * gridDim.x + split) *
                         part_floats<HD>(G);
#pragma unroll
  for (int t = 0; t < NACC; ++t) {
    const int idx = tid + t * DNT;
    if (idx < n_out) part[idx] = acc[t];
  }
  if (tid < G) {
    part[n_out + tid] = m_s[tid];
    part[n_out + G + tid] = l_s[tid];
  }
}

// Merge the n_split runs of one (head g, kv, b), one thread per output
// column: rescale each run by exp(m - M), M the largest m, and divide by
// the rescaled sum of l.
template <typename T, int HD>
__global__ void __launch_bounds__(HD) combine_kernel(
    const float* __restrict__ ws, T* __restrict__ o, int n_split,
    Strides so) {
  const int g = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int G = gridDim.x, stride = part_floats<HD>(G), n_out = G * HD;
  const float* base = ws + (int64_t)(b * gridDim.y + kvh) * n_split * stride;
  float M = -INFINITY;
  for (int s = 0; s < n_split; ++s)
    M = fmaxf(M, base[s * stride + n_out + g]);
  float L = 0.f, O = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float* part = base + s * stride;
    const float w = expf(part[n_out + g] - M);
    L = fmaf(part[n_out + G + g], w, L);
    O = fmaf(part[g * HD + d], w, O);
  }
  o[b * so.b + kvh * so.h + g * so.t + d * so.d] =
      from_float<T>(O / fmaxf(L, 1e-30f));
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* ws, const int* k_pos, int pos, int B, int KV, int G,
                   int S, int n_split, int split_len, float scale, Strides sq,
                   Strides sk, Strides sv, Strides so, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  decode_kernel<T, HD><<<dim3(n_split, KV, B), DNT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), ws, k_pos, pos, S, G,
      split_len, scale, sq, sk, sv, so);
  if ((err = cudaGetLastError()) != cudaSuccess || n_split == 1) return err;
  combine_kernel<T, HD><<<dim3(G, KV, B), HD, 0, stream>>>(
      ws, static_cast<T*>(o), n_split, so);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, float* ws, const int* k_pos, int pos, int B,
                        int KV, int G, int S, int n_split, int split_len,
                        float scale, Strides sq, Strides sk, Strides sv,
                        Strides so, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, ws, k_pos, pos, B, KV, G, S, n_split,
                           split_len, scale, sq, sk, sv, so, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, ws, k_pos, pos, B, KV, G, S, n_split,
                           split_len, scale, sq, sk, sv, so, stream);
    case 112:
      return launch<T, 112>(q, k, v, o, ws, k_pos, pos, B, KV, G, S, n_split,
                           split_len, scale, sq, sk, sv, so, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, ws, k_pos, pos, B, KV, G, S, n_split,
                            split_len, scale, sq, sk, sv, so, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, KV, G, hd], k and v [B, KV, S, hd], o [B, KV, G, hd], each given by
// its element strides; k_pos [S] int32, contiguous; pos the decode position.
// The cache is cut into n_split runs of split_len slots (a multiple of 64,
// n_split * split_len >= S > (n_split - 1) * split_len); with n_split > 1,
// ws holds B * KV * n_split * G * (hd + 2) floats of scratch.
// Launches on `stream` and returns cudaGetLastError() after the launches.
EXPORT int decode_attention_fwd(
    int dtype, int hd, const void* q, const void* k, const void* v, void* o,
    void* ws, const int* k_pos, int pos, int B, int KV, int G, int S,
    int n_split, int split_len, float scale,
    int64_t sq_b, int64_t sq_h, int64_t sq_t, int64_t sq_d,
    int64_t sk_b, int64_t sk_h, int64_t sk_t, int64_t sk_d,
    int64_t sv_b, int64_t sv_h, int64_t sv_t, int64_t sv_d,
    int64_t so_b, int64_t so_h, int64_t so_t, int64_t so_d, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || G > GMAX || S <= 0 || n_split <= 0 ||
      split_len <= 0 || split_len % DBK != 0 ||
      (int64_t)n_split * split_len < S ||
      (int64_t)(n_split - 1) * split_len >= S || (n_split > 1 && !ws))
    return cudaErrorInvalidValue;
  float* wsf = static_cast<float*>(ws);
  const Strides sq{sq_b, sq_h, sq_t, sq_d}, sk{sk_b, sk_h, sk_t, sk_d};
  const Strides sv{sv_b, sv_h, sv_t, sv_d}, so{so_b, so_h, so_t, so_d};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_hd<float>(hd, q, k, v, o, wsf, k_pos, pos, B, KV, G, S,
                              n_split, split_len, scale, sq, sk, sv, so, st);
  if (dtype == kBFloat16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, wsf, k_pos, pos, B, KV,
                                      G, S, n_split, split_len, scale, sq, sk,
                                      sv, so, st);
  return cudaErrorInvalidValue;
}
