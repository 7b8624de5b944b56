// Flash decode over a slice of head_dim: the pair of kernels that one rank
// of a mesh runs when the decode cache is split on head_dim, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py,
// function `decode_attention` (body `_kernel`), on the layout that the
// reference's sharding rule gives a decode cache under `prefer_hd`
// (repro/parallel/sharding.py `_cache_spec`): [L, B, S, KV, hd] split on hd
// over "model" where the KV heads do not divide that axis. A rank holds hl
// lanes of every head. A head's scores need all of its lanes, so the whole
// -head kernel (decode_attention.cu) cannot run there; the decode is cut in
// two around an all-reduce:
//
//  1. decode_scores_hd: s[b, kv, g, slot] = sum over this rank's lanes d of
//     q[b, kv, g, d] k[b, kv, slot, d], in f32, unscaled and unmasked. The
//     caller sums s over the ranks (an all-reduce in f32).
//  2. decode_softmax_pv_hd, on the summed scores: slot counts where
//     k_pos[slot] <= pos (ring slots and the 2**30 mark of an empty slot by
//     the same test), p = softmax(s * scale) over the counted slots in f32,
//     o = p v on this rank's lanes of v, in v's type. `scale` is the whole
//     head's 1 / sqrt(hd), not the slice's. A group with no counted slot
//     writes zeros, as the whole-head kernel does.
//
// What bounds it on the H100: bytes. Per (b, kv) group the pair reads the
// k and v slices once (hl lanes a slot) and writes and reads the f32 scores
// once each (G floats a slot); at qwen2-72b's per-rank decode_32k shape (B
// 8, KV 8, G 8, S 32,768, hl 8, bf16) that is 3.4e7 + 3.4e7 + 2 x 6.7e7
// bytes, ~0.06 ms at 3.35 TB/s, against ~1.07e9 bytes (~0.32 ms) for one
// rank's whole-head decode over a gathered cache. The products are ~2 G
// FLOPs a slot and lane, far below the card's ridge.
//
// Design: a simple first form, f32 arithmetic in both kernels.
//  * Scores: grid (KV, S / 256, B), 256 threads, one slot a thread: the
//    thread reads its slot's hl lanes in pieces of W lanes, W 8 where hl
//    is a multiple of 8 (16-byte loads in bf16), else 4 (8-byte loads in
//    bf16: 64 / 16 lanes for qwen2-0.5b and musicgen-medium on the 16-way
//    "model" axis), and forms all G dot products against q, which the
//    block holds in shared memory; each head's scores go out as one
//    coalesced row of 256 floats. KV is the fastest grid index, so the blocks that read the
//    neighbouring lanes of one [S, KV, hl] cache row run together and share
//    its 32-byte sectors in L2.
//  * Softmax and P V: the slots are cut into n_split runs of whole
//    128-slot tiles (about 8 runs per SM over all groups), one block of 256
//    threads per (run, kv, b). Per tile the block stages the masked, scaled
//    scores [G][128] and the v tile [128][hl] in shared memory (f32), one
//    warp per head updates the head's online softmax with warp shuffles,
//    and each thread accumulates up to 4 of the G x hl outputs over the
//    tile. With one run the block writes the output; otherwise each run
//    writes (acc, m, l) to an f32 workspace and a second kernel, one block
//    per (kv, b), merges the runs (rescaled by exp(m - M)).
// Operands are read through their strides (the cache's [B, S, KV, hl]
// shard handed over as a [B, KV, S, hl] view), with a unit last stride and
// rows aligned to a piece of W lanes (16 bytes, or 8 for bf16 with W 4).

#include <math.h>

#include "common.cuh"

namespace {

constexpr int NTH = 256;      // threads per block
constexpr int GMAX = 16;      // most query heads per KV group
constexpr int HLMAX = 64;     // most head_dim lanes a slice holds
constexpr int PTS = 128;      // slots per tile of the softmax kernel
constexpr int LDP = PTS + 1;  // padded score rows: heads on distinct banks
constexpr int MAX_SPLIT = 64; // most runs per (b, kv) group
constexpr int NACC = GMAX * HLMAX / NTH;   // outputs per thread

// W (8 or 4) consecutive elements from an address aligned to their
// bytes (at most 16), as f32.
template <int W>
__device__ __forceinline__ void loadw(const __nv_bfloat16* p, float* x) {
  __nv_bfloat162 h[W / 2];
  if constexpr (W == 8) {
    *reinterpret_cast<uint4*>(h) = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    *reinterpret_cast<uint2*>(h) = __ldg(reinterpret_cast<const uint2*>(p));
  }
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <int W>
__device__ __forceinline__ void loadw(const float* p, float* x) {
#pragma unroll
  for (int i = 0; i < W / 4; ++i) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p + 4 * i));
    x[4 * i] = a.x; x[4 * i + 1] = a.y; x[4 * i + 2] = a.z;
    x[4 * i + 3] = a.w;
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(NTH) scores_kernel(
    const T* __restrict__ q, const T* __restrict__ k, float* __restrict__ s,
    int S, int G, int HL, Strides sq, Strides sk, Strides ss) {
  __shared__ float Qs[GMAX * HLMAX];
  const int kvh = blockIdx.x, b = blockIdx.z, tid = threadIdx.x;
  const int slot = blockIdx.y * NTH + tid;
  const T* qb = q + b * sq.b + kvh * sq.h;
  for (int i = tid; i < G * HL; i += NTH)
    Qs[i] = to_float(qb[(i / HL) * sq.t + i % HL]);
  __syncthreads();
  if (slot >= S) return;

  float acc[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;
  const T* kr = k + b * sk.b + kvh * sk.h + slot * sk.t;
  for (int d0 = 0; d0 < HL; d0 += W) {
    float x[W];
    loadw<W>(kr + d0, x);
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) {
#pragma unroll
        for (int j = 0; j < W; ++j)
          acc[g] = fmaf(Qs[g * HL + d0 + j], x[j], acc[g]);
      }
  }
  float* sb = s + b * ss.b + kvh * ss.h + slot;
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < G) sb[g * ss.t] = acc[g];
}

// One run's state in the workspace: acc [G][HL], then m [G] and l [G].
__host__ __device__ __forceinline__ int part_floats(int G, int HL) {
  return G * HL + 2 * G;
}

template <typename T, int W>
__global__ void __launch_bounds__(NTH) softmax_pv_kernel(
    const float* __restrict__ s, const T* __restrict__ v, T* __restrict__ o,
    float* __restrict__ ws, const int* __restrict__ k_pos, int pos, int S,
    int G, int HL, int split_len, float scale, Strides ss, Strides sv,
    Strides so) {
  extern __shared__ float smem[];
  float* Ps = smem;              // [G][LDP]: scaled scores, then p
  float* Vs = Ps + GMAX * LDP;   // [PTS][HL]
  __shared__ float m_s[GMAX], l_s[GMAX], a_s[GMAX];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int KV = gridDim.y;
  const int s_begin = split * split_len;
  const int s_end = min(S, s_begin + split_len);
  const float* sb = s + b * ss.b + kvh * ss.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  const int n_out = G * HL, chunks = HL / W;

  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[NACC];
#pragma unroll
  for (int t = 0; t < NACC; ++t) acc[t] = 0.f;

  for (int s0 = s_begin; s0 < s_end; s0 += PTS) {
    __syncthreads();   // the previous tile's Ps, Vs and a_s are consumed
    for (int i = tid; i < G * PTS; i += NTH) {
      const int g = i / PTS, j = i % PTS, slot = s0 + j;
      float x = -INFINITY;   // past the run, or not admissible: weighs 0
      if (slot < s_end && k_pos[slot] <= pos) x = sb[g * ss.t + slot] * scale;
      Ps[g * LDP + j] = x;
    }
    for (int i = tid; i < PTS * chunks; i += NTH) {
      const int j = i / chunks, c = i % chunks, slot = s0 + j;
      float x[W] = {};
      if (slot < s_end) loadw<W>(vb + slot * sv.t + c * W, x);
#pragma unroll
      for (int e = 0; e < W; ++e) Vs[j * HL + c * W + e] = x[e];
    }
    __syncthreads();

    for (int g = warp; g < G; g += NTH / 32) {
      float x[PTS / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < PTS / 32; ++i) {
        x[i] = Ps[g * LDP + lane + 32 * i];
        mx = fmaxf(mx, x[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < PTS / 32; ++i) {
        const float p = x[i] == -INFINITY ? 0.f : expf(x[i] - m_new);
        Ps[g * LDP + lane + 32 * i] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int t = 0; t < NACC; ++t) {
      const int idx = tid + t * NTH;
      if (idx < n_out) {
        const int g = idx / HL, d = idx % HL;
        float a = acc[t] * a_s[g];
#pragma unroll 8
        for (int j = 0; j < PTS; ++j)
          a = fmaf(Ps[g * LDP + j], Vs[j * HL + d], a);
        acc[t] = a;
      }
    }
  }
  __syncthreads();

  if (gridDim.x == 1) {
    T* ob = o + b * so.b + kvh * so.h;
#pragma unroll
    for (int t = 0; t < NACC; ++t) {
      const int idx = tid + t * NTH;
      if (idx < n_out) {
        const int g = idx / HL, d = idx % HL;
        ob[g * so.t + d] =
            from_float<T>(m_s[g] == -INFINITY ? 0.f : acc[t] / l_s[g]);
      }
    }
    return;
  }
  float* part = ws + ((int64_t)(b * KV + kvh) * gridDim.x + split) *
                         part_floats(G, HL);
#pragma unroll
  for (int t = 0; t < NACC; ++t) {
    const int idx = tid + t * NTH;
    if (idx < n_out) part[idx] = acc[t];
  }
  if (tid < G) {
    part[n_out + tid] = m_s[tid];
    part[n_out + G + tid] = l_s[tid];
  }
}

// Merge the n_split runs of one (kv, b) group, a thread per output: each
// run rescaled by exp(m - M), M the largest m, over the rescaled sum of l;
// zeros where no run has an admissible slot.
template <typename T>
__global__ void __launch_bounds__(NTH) combine_kernel(
    const float* __restrict__ ws, T* __restrict__ o, int n_split, int G,
    int HL, Strides so) {
  const int kvh = blockIdx.x, b = blockIdx.y, KV = gridDim.x;
  const int n_out = G * HL, stride = part_floats(G, HL);
  const float* base = ws + (int64_t)(b * KV + kvh) * n_split * stride;
  T* ob = o + b * so.b + kvh * so.h;
  for (int idx = threadIdx.x; idx < n_out; idx += NTH) {
    const int g = idx / HL, d = idx % HL;
    float M = -INFINITY;
    for (int r = 0; r < n_split; ++r)
      M = fmaxf(M, base[r * stride + n_out + g]);
    float L = 0.f, O = 0.f;
    if (M != -INFINITY)
      for (int r = 0; r < n_split; ++r) {
        const float* part = base + r * stride;
        const float w = expf(part[n_out + g] - M);
        L = fmaf(part[n_out + G + g], w, L);
        O = fmaf(part[idx], w, O);
      }
    ob[g * so.t + d] = from_float<T>(M == -INFINITY ? 0.f : O / L);
  }
}

int pv_smem_bytes(int HL) { return (GMAX * LDP + PTS * HL) * 4; }

template <typename T>
cudaError_t launch_scores(const void* q, const void* k, float* s, int B,
                          int KV, int G, int S, int HL, Strides sq,
                          Strides sk, Strides ss, cudaStream_t stream) {
  const dim3 grid(KV, (S + NTH - 1) / NTH, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  if (HL % 8 == 0)
    scores_kernel<T, 8><<<grid, NTH, 0, stream>>>(qt, kt, s, S, G, HL, sq,
                                                  sk, ss);
  else
    scores_kernel<T, 4><<<grid, NTH, 0, stream>>>(qt, kt, s, S, G, HL, sq,
                                                  sk, ss);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_softmax_pv(const float* s, const void* v, void* o,
                              float* ws, const int* k_pos, int pos, int B,
                              int KV, int G, int S, int HL, int n_split,
                              int split_len, float scale, Strides ss,
                              Strides sv, Strides so, cudaStream_t stream) {
  const dim3 grid(n_split, KV, B);
  const T* vt = static_cast<const T*>(v);
  if (HL % 8 == 0)
    softmax_pv_kernel<T, 8><<<grid, NTH, pv_smem_bytes(HL), stream>>>(
        s, vt, static_cast<T*>(o), ws, k_pos, pos, S, G, HL, split_len,
        scale, ss, sv, so);
  else
    softmax_pv_kernel<T, 4><<<grid, NTH, pv_smem_bytes(HL), stream>>>(
        s, vt, static_cast<T*>(o), ws, k_pos, pos, S, G, HL, split_len,
        scale, ss, sv, so);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  combine_kernel<T><<<dim3(KV, B), NTH, 0, stream>>>(
      ws, static_cast<T*>(o), n_split, G, HL, so);
  return cudaGetLastError();
}

bool bad_sizes(int dtype, int B, int KV, int G, int S, int HL) {
  return B <= 0 || KV <= 0 || G <= 0 || G > GMAX || S <= 0 || HL <= 0 ||
         HL > HLMAX || HL % 4 != 0 || B > 65535 || KV > 65535 ||
         (S + NTH - 1) / NTH > 65535 ||
         (dtype != kFloat32 && dtype != kBFloat16);
}

}  // namespace

// q [B, KV, G, hl], k [B, KV, S, hl] (dtype: f32 or bf16), s [B, KV, G, S]
// f32, each given by its element strides (unit last strides; q's, k's rows
// aligned to a piece of W lanes, as above); hl a multiple of 4 up to 64,
// G <= 16. Writes the
// partial scores over these lanes into s. Launches one kernel on `stream`
// and returns cudaGetLastError().
EXPORT int decode_scores_hd_fwd(
    int dtype, const void* q, const void* k, void* s, int B, int KV, int G,
    int S, int hl, int64_t sq_b, int64_t sq_h, int64_t sq_t, int64_t sq_d,
    int64_t sk_b, int64_t sk_h, int64_t sk_t, int64_t sk_d, int64_t ss_b,
    int64_t ss_h, int64_t ss_t, int64_t ss_d, void* stream) {
  if (bad_sizes(dtype, B, KV, G, S, hl) || sq_d != 1 || sk_d != 1 ||
      ss_d != 1)
    return cudaErrorInvalidValue;
  const Strides sq{sq_b, sq_h, sq_t, sq_d}, sk{sk_b, sk_h, sk_t, sk_d};
  const Strides ss{ss_b, ss_h, ss_t, ss_d};
  float* sf = static_cast<float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch_scores<__nv_bfloat16>(q, k, sf, B, KV, G, S, hl, sq, sk, ss,
                                        st);
  return launch_scores<float>(q, k, sf, B, KV, G, S, hl, sq, sk, ss, st);
}

// s [B, KV, G, S] f32 (the scores summed over every slice), v [B, KV, S,
// hl] and o [B, KV, G, hl] of one dtype, each by its element strides (unit
// last strides; v's rows aligned to a piece of W lanes); k_pos [S] int32,
// contiguous; pos the decode position; scale the whole head's. The slots
// are cut into n_split runs of split_len slots (a multiple of 128,
// n_split * split_len >= S > (n_split - 1) * split_len, n_split <= 64);
// with n_split > 1, ws holds B * KV * n_split * (G * hl + 2 G) floats of
// scratch. Launches one kernel (two with n_split > 1) on `stream` and
// returns cudaGetLastError().
EXPORT int decode_softmax_pv_hd_fwd(
    int dtype, const void* s, const void* v, void* o, void* ws,
    const int* k_pos, int pos, int B, int KV, int G, int S, int hl,
    int n_split, int split_len, float scale, int64_t ss_b, int64_t ss_h,
    int64_t ss_t, int64_t ss_d, int64_t sv_b, int64_t sv_h, int64_t sv_t,
    int64_t sv_d, int64_t so_b, int64_t so_h, int64_t so_t, int64_t so_d,
    void* stream) {
  if (bad_sizes(dtype, B, KV, G, S, hl) || n_split <= 0 ||
      n_split > MAX_SPLIT || split_len <= 0 || split_len % PTS != 0 ||
      (int64_t)n_split * split_len < S ||
      (int64_t)(n_split - 1) * split_len >= S || (n_split > 1 && !ws) ||
      ss_d != 1 || sv_d != 1 || so_d != 1)
    return cudaErrorInvalidValue;
  const Strides ss{ss_b, ss_h, ss_t, ss_d}, sv{sv_b, sv_h, sv_t, sv_d};
  const Strides so{so_b, so_h, so_t, so_d};
  const float* sf = static_cast<const float*>(s);
  float* wsf = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch_softmax_pv<__nv_bfloat16>(sf, v, o, wsf, k_pos, pos, B, KV,
                                            G, S, hl, n_split, split_len,
                                            scale, ss, sv, so, st);
  return launch_softmax_pv<float>(sf, v, o, wsf, k_pos, pos, B, KV, G, S, hl,
                                  n_split, split_len, scale, ss, sv, so, st);
}
