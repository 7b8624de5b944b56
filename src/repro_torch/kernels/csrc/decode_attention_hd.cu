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
// rank's whole-head decode over a gathered cache. The softmax kernel reads
// 4 G + 2 hl = 48 bytes a slot there for 2 G hl = 128 flops: ~2.7 flops a
// byte, far below even the f32 ridge (~20), so the tensor cores would buy
// nothing; both kernels compute in f32 on the CUDA cores, which keeps one
// kernel for f32 and bf16 and the f32 checks at 2e-5.
//
// Scores (scores_kernel): grid (KV, S / 256, B), 256 threads, one slot a
// thread: the thread reads its slot's hl lanes in pieces of W lanes, W 8
// where hl is a multiple of 8 (16-byte loads in bf16), else 4 (8-byte
// loads in bf16: 64 / 16 lanes for qwen2-0.5b and musicgen-medium on the
// 16-way "model" axis), and forms all G dot products against q, which the
// block holds in shared memory; each head's scores go out as one coalesced
// row of 256 floats. KV is the fastest grid index, so the blocks that read
// the neighbouring lanes of one [S, KV, hl] cache row run together and
// share its 32-byte sectors in L2.
//
// Softmax and P V (softmax_pv_kernel), grid (KV, n_split, B), 4 warps:
//  * The slots are cut into n_split runs of whole 128-slot tiles (about 4
//    runs per SM over all groups, kernel.py `split`: 4 blocks of 128
//    threads fit an SM at 128 registers a thread, so the grid is one
//    wave), a block per (kv, run, b); KV is the fastest grid index, as
//    above.
//  * Bytes in flight: tiles arrive by cp.async copies into a ring of 4
//    stages, the next three tiles' copies in flight while one is used, one
//    block barrier per stage. A stage holds each head's scores for the
//    tile (contiguous f32, 16-byte copies where the rows allow, else 4
//    bytes), the v tile (hl lanes a slot at the cache's slot stride, in
//    16-byte copies, 8 for bf16 slices not a multiple of 8 lanes, kept in
//    v's type) and the tile's k_pos, read once a slot. At the shape above
//    a stage is 6.8 KB and a block keeps 20 KB in flight.
//  * Every warp works, with no barrier between softmax and P V: each warp
//    owns 32 of the tile's slots, which it takes in T steps of 32 / T
//    slots, T the power of 2 at or above G: lane t of a slot's T lanes
//    runs head t's online softmax over its own slots (m, l and hl <= 64
//    accumulators in registers) and reads only its slot's score of that
//    head and its v row. Score rows are padded so that the T lanes of a
//    slot hit distinct banks, v rows so that 8 (4) lanes' 16-byte (8-byte)
//    loads do. (A lane holding all G heads of its slot was slower: more
//    registers, fewer blocks, a longer merge.)
//  * scale * log2(e) is folded into one multiply, and p = 2**(x - m) is one
//    ex2.approx (exp2f's instruction, without exp2f's care for results
//    below 2**-126, which weigh nothing beside l >= 1): one exponential per
//    (head, admissible slot), none for a masked one (p = 0 by selection).
//    A lane's reference m moves only when a score passes it by more than
//    2**8 (exact either way: p and l share m), so after the first slots a
//    tile takes no rescale.
//  * The lanes of a head merge once per run, by warp shuffles, then the 4
//    warps' states through the drained ring. The merge of the runs is
//    folded in: each block writes its (acc, m, l) to an f32 workspace, and
//    the last block of a (b, kv) group to arrive, counted in a
//    wrapper-owned int32 buffer (one per device and stream, shared with
//    decode_attention.cu) that it resets to 0, merges the runs in one pass
//    over them and writes the output. One launch per call.
// Operands are read through their strides (the cache's [B, S, KV, hl]
// shard handed over as a [B, KV, S, hl] view), with a unit last stride and
// rows aligned to a piece of W lanes (16 bytes, or 8 for bf16 with W 4).

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int NTH = 256;      // threads per block of the scores kernel
constexpr int GMAX = 16;      // most query heads per KV group
constexpr int HLMAX = 64;     // most head_dim lanes a slice holds
constexpr int MAX_SPLIT = 64; // most runs per (b, kv) group
// The softmax and P V kernel.
constexpr int TILE = 128;     // slots per tile (a stage of the ring)
constexpr int PNT = 128;      // threads per block
constexpr int PW = PNT / 32;  // warps per block, 32 of a tile's slots each
constexpr int RING = 4;       // stages of the ring
constexpr float kRescale = 8.f;   // log2 units a score may pass m by

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

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

// The ring's layout for G heads of hl lanes, e-byte elements, cb-byte
// copies, 2**log_t lanes a slot: score rows of `lds` floats (padded where
// lanes of several slots read several rows: see the design note), v rows
// of `rv` bytes (rv / cb odd: the lanes of a quarter warp, 8-byte pieces a
// half warp, read distinct banks), then the tile's k_pos.
struct PvLayout {
  int lds, rv, v_off, kp_off, stage;
};

__host__ __device__ __forceinline__ PvLayout pv_layout(int G, int HL, int e,
                                                       int cb, int log_t) {
  PvLayout L;
  L.lds = TILE + (log_t == 0 ? 0 : imax(32 >> log_t, 4));
  const int r = HL * e;
  L.rv = (r / cb) % 2 ? r : r + cb;
  L.v_off = G * L.lds * 4;
  L.kp_off = L.v_off + TILE * L.rv;
  L.stage = L.kp_off + TILE * 4;
  return L;
}

// Dynamic shared memory of a launch: the ring, which the run's end reuses
// for the 4 warps' outputs.
__host__ __device__ __forceinline__ int pv_smem_bytes(int G, int HL, int e,
                                                      int cb, int log_t) {
  const int ring = RING * pv_layout(G, HL, e, cb, log_t).stage;
  return imax(ring, 4 * PW * G * HL);
}

// cp.async of N (4, 8 or 16) bytes global -> shared; the last N -
// src_bytes bytes are zero-filled.
template <int N>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src,
                                           int src_bytes) {
  if constexpr (N == 16) {
    cp_async16(dst, src, src_bytes);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(N), "r"(src_bytes)
                 : "memory");
  }
}

// One CB-byte piece of a v row in shared memory, as CB / sizeof(T) floats.
template <int CB>
__device__ __forceinline__ void lds_piece(const float* p, float* x) {
  static_assert(CB == 16, "f32 pieces are 16 bytes");
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}

__device__ __forceinline__ void bf16x2_f32(uint32_t u, float* x) {
  x[0] = __uint_as_float(u << 16);            // the lower-addressed lane
  x[1] = __uint_as_float(u & 0xffff0000u);
}

template <int CB>
__device__ __forceinline__ void lds_piece(const __nv_bfloat16* p, float* x) {
  if constexpr (CB == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    bf16x2_f32(u.x, x); bf16x2_f32(u.y, x + 2);
    bf16x2_f32(u.z, x + 4); bf16x2_f32(u.w, x + 6);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    bf16x2_f32(u.x, x); bf16x2_f32(u.y, x + 2);
  }
}

// Softmax and P V over one run of one (b, kv) group (the design note):
// CB the bytes of a v copy, HLC a bound of hl; 2**log_t lanes a slot, lane
// t of them on head t.
template <typename T, int CB, int HLC>
__global__ void __launch_bounds__(PNT, 4) softmax_pv_kernel(
    const float* __restrict__ s, const T* __restrict__ v, T* __restrict__ o,
    float* __restrict__ ws, int* __restrict__ counters,
    const int* __restrict__ k_pos, int pos, int S, int G, int HL,
    int split_len, int log_t, int s16, float scale_log2, Strides ss,
    Strides sv, Strides so) {
  constexpr int ES = sizeof(T);
  constexpr int CL = CB / ES;              // lanes of v a copy moves
  static_assert(HLC % CL == 0, "whole pieces");
  static_assert(TILE == PNT, "a thread copies one slot's v row and k_pos");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float wm[PW][GMAX], wl[PW][GMAX];
  __shared__ int is_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kvh = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int KV = gridDim.x, n_split = gridDim.y;
  const int n_team = 1 << log_t, spw = 32 >> log_t;
  const int j = lane & (spw - 1), t = lane >> (5 - log_t);
  const PvLayout L = pv_layout(G, HL, ES, CB, log_t);
  const int k_begin = split * split_len;
  const int k_end = min(S, k_begin + split_len);
  const int n_t = (k_end - k_begin + TILE - 1) / TILE;
  const int cpr = HL * ES / CB;              // copies a v row
  const bool kp16 = (reinterpret_cast<uintptr_t>(k_pos) & 15) == 0;
  // This thread's copies: score rows warp, warp + 4, ... at slots 4 lane
  // (16-byte copies) or every row at slot tid (4-byte ones); v row tid;
  // k_pos slots 4 tid (or tid).
  const float* s_src = s + b * ss.b + kvh * ss.h + k_begin;
  const unsigned char* v_src = reinterpret_cast<const unsigned char*>(
      v + b * sv.b + kvh * sv.h + (int64_t)(k_begin + tid) * sv.t);
  const int64_t v_tile = (int64_t)TILE * sv.t * ES;   // bytes a tile

  // Tile i of the run into stage i % RING, slots past the run's end
  // zero-filled; one commit group a tile (empty past the end).
  auto issue = [&](int i) {
    if (i < n_t) {
      unsigned char* st = smem + (i % RING) * L.stage;
      float* Sd = reinterpret_cast<float*>(st);
      const int left = k_end - k_begin - i * TILE;   // slots in the run
      const float* src = s_src + i * TILE;
      if (s16) {
        const int n = min(4, left - 4 * lane);
        for (int g = warp; g < G; g += PW)
          cp_async16(Sd + g * L.lds + 4 * lane,
                     n > 0 ? src + g * ss.t + 4 * lane : s,
                     n > 0 ? 4 * n : 0);
      } else {
        for (int g = 0; g < G; ++g)
          cp_async_n<4>(Sd + g * L.lds + tid,
                        tid < left ? src + g * ss.t + tid : s,
                        tid < left ? 4 : 0);
      }
      unsigned char* Vd = st + L.v_off + tid * L.rv;
      const unsigned char* vs = v_src + i * v_tile;
      for (int c = 0; c < cpr; ++c)
        cp_async_n<CB>(Vd + c * CB,
                       tid < left ? vs + c * CB
                                  : reinterpret_cast<const unsigned char*>(v),
                       tid < left ? CB : 0);
      int* Kd = reinterpret_cast<int*>(st + L.kp_off);
      const int* kp = k_pos + k_begin + i * TILE;
      if (kp16) {
        const int n = min(4, left - 4 * tid);
        if (tid < TILE / 4)
          cp_async16(Kd + 4 * tid, n > 0 ? kp + 4 * tid : k_pos,
                     n > 0 ? 4 * n : 0);
      } else {
        cp_async_n<4>(Kd + tid, tid < left ? kp + tid : k_pos,
                      tid < left ? 4 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll 1
  for (int i = 0; i < RING - 1; ++i) issue(i);

  // This lane's head t: m (log2 units), l and acc. Lanes past G read row
  // G - 1 and weigh 0.
  const bool head = t < G;
  const int row = min(t, G - 1) * L.lds + warp * 32 + j;
  float m = -INFINITY, l = 0.f, acc[HLC];
#pragma unroll
  for (int d = 0; d < HLC; ++d) acc[d] = 0.f;

  for (int i = 0; i < n_t; ++i) {
    cp_async_wait<RING - 2>();
    __syncthreads();      // tile i landed; stage (i - 1) % RING is free
    issue(i + RING - 1);
    const unsigned char* st = smem + (i % RING) * L.stage;
    const float* Ss = reinterpret_cast<const float*>(st) + row;
    const unsigned char* Vs = st + L.v_off;
    const int* Kp = reinterpret_cast<const int*>(st + L.kp_off);
    const int left = k_end - k_begin - i * TILE;
    for (int step = 0; step < n_team; ++step) {
      const int r = warp * 32 + step * spw + j;   // this lane's slot
      const bool adm = head && r < left && Kp[r] <= pos;
      const float x = Ss[step * spw] * scale_log2;
      const bool up = adm && x - m > kRescale;
      if (__any_sync(0xffffffffu, up)) {
        const float a = up ? fast_exp2(m - x) : 1.f;   // 0 from m = -inf
        l *= a;
#pragma unroll
        for (int d = 0; d < HLC; ++d) acc[d] *= a;
        m = up ? x : m;
      }
      const float p = adm ? fast_exp2(x - m) : 0.f;
      l += p;
      const T* vrow = reinterpret_cast<const T*>(Vs + r * L.rv);
#pragma unroll
      for (int c = 0; c < HLC / CL; ++c)
        if (c * CL < HL) {
          float vr[CL];
          lds_piece<CB>(vrow + c * CL, vr);
#pragma unroll
          for (int e = 0; e < CL; ++e)
            acc[c * CL + e] = fmaf(p, vr[e], acc[c * CL + e]);
        }
    }
  }
  cp_async_wait<0>();

  // The spw lanes of a head merge by shuffles, to their largest m; then
  // the 4 warps' states through the drained ring.
  {
    float M = m;
    for (int off = spw >> 1; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    const float f = m == -INFINITY ? 0.f : fast_exp2(m - M);
    l *= f;
#pragma unroll
    for (int d = 0; d < HLC; ++d) acc[d] *= f;
    m = M;
  }
  for (int off = spw >> 1; off > 0; off >>= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int c = 0; c < HLC / CL; ++c)
      if (c * CL < HL) {
#pragma unroll
        for (int e = 0; e < CL; ++e)
          acc[c * CL + e] +=
              __shfl_xor_sync(0xffffffffu, acc[c * CL + e], off);
      }
  }
  __syncthreads();        // every warp is past the ring
  float* Ow = reinterpret_cast<float*>(smem);   // [PW][G][HL]
  if (j == 0 && head) {
    float* dst = Ow + (warp * G + t) * HL;
#pragma unroll
    for (int d = 0; d < HLC; ++d)
      if (d < HL) dst[d] = acc[d];
    wm[warp][t] = m;
    wl[warp][t] = l;
  }
  __syncthreads();

  const int n_out = G * HL, stride = part_floats(G, HL);
  T* ob = o + b * so.b + kvh * so.h;
  float* base = ws + (int64_t)(b * KV + kvh) * n_split * stride;
  for (int idx = tid; idx < n_out; idx += PNT) {
    const int g = idx / HL, d = idx - g * HL;
    float M = wm[0][g];
#pragma unroll
    for (int w = 1; w < PW; ++w) M = fmaxf(M, wm[w][g]);
    float O = 0.f, Ls = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < PW; ++w) {
        const float f = fast_exp2(wm[w][g] - M);   // 0 from m = -inf
        O = fmaf(f, Ow[(w * G + g) * HL + d], O);
        Ls = fmaf(f, wl[w][g], Ls);
      }
    }
    if (n_split == 1) {
      // Ls >= 1 wherever a slot counts: the largest m's own slot gave 1
      ob[g * so.t + d] = from_float<T>(M == -INFINITY ? 0.f : O / Ls);
    } else {
      float* part = base + (int64_t)split * stride;
      part[idx] = O;
      if (d == 0) {
        part[n_out + g] = M;
        part[n_out + G + g] = Ls;
      }
    }
  }
  if (n_split == 1) return;

  // This run is published; the last run of the group to arrive merges
  // them all, each output in one pass over the runs (an online rescale:
  // every run's loads are independent of the sums, so they overlap).
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(&counters[b * KV + kvh], 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int idx = tid; idx < n_out; idx += PNT) {
    const int g = idx / HL;
    float M = -INFINITY, O = 0.f, Ls = 0.f;
#pragma unroll 8
    for (int r = 0; r < n_split; ++r) {
      const float* part = base + (int64_t)r * stride;
      const float mr = __ldcg(part + n_out + g);
      const float lr = __ldcg(part + n_out + G + g);
      const float ar = __ldcg(part + idx);
      if (mr > M) {          // the largest m so far moves: rescale
        const float f = fast_exp2(M - mr);   // 0 from M = -inf
        O *= f;
        Ls *= f;
        M = mr;
      }
      const float w = mr == -INFINITY ? 0.f : fast_exp2(mr - M);
      O = fmaf(w, ar, O);
      Ls = fmaf(w, lr, Ls);
    }
    // zeros where no run has an admissible slot
    ob[g * so.t + idx - g * HL] =
        from_float<T>(M == -INFINITY ? 0.f : O / Ls);
  }
  if (tid == 0) counters[b * KV + kvh] = 0;   // ready for the next call
}

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

// The softmax kernel's arguments as the entry point gets them.
struct PvArgs {
  const float* s;
  const void* v;
  void* o;
  float* ws;
  int* counters;
  const int* k_pos;
  int pos, B, KV, G, S, HL, n_split, split_len;
  float scale;
  Strides ss, sv, so;
  cudaStream_t stream;
};

template <typename T, int CB, int HLC>
cudaError_t launch_pv(const PvArgs& a) {
  constexpr int ES = sizeof(T);
  auto kernel = softmax_pv_kernel<T, CB, HLC>;
  // every launch of this instance fits the most: G 16, hl HLC and the
  // widest score rows (2 lanes a slot)
  static unsigned long long done = 0;
  cudaError_t err = set_smem_once(
      kernel, pv_smem_bytes(GMAX, HLC, ES, CB, 1), &done);
  if (err != cudaSuccess) return err;
  int log_t = 0;           // lanes a slot: a power of 2, at least G
  while (1 << log_t < a.G) ++log_t;
  const bool s16 = reinterpret_cast<uintptr_t>(a.s) % 16 == 0 &&
                   (a.B == 1 || a.ss.b % 4 == 0) &&
                   (a.KV == 1 || a.ss.h % 4 == 0) &&
                   (a.G == 1 || a.ss.t % 4 == 0);
  kernel<<<dim3(a.KV, a.n_split, a.B), PNT,
           pv_smem_bytes(a.G, a.HL, ES, CB, log_t), a.stream>>>(
      a.s, static_cast<const T*>(a.v), static_cast<T*>(a.o), a.ws,
      a.counters, a.k_pos, a.pos, a.S, a.G, a.HL, a.split_len, log_t, s16,
      a.scale * 1.4426950408889634f, a.ss, a.sv, a.so);
  return cudaGetLastError();
}

// HLC: hl rounded up to 4 (f32 only), 8, 16, 32 or 64 lanes; v copied in
// 16-byte pieces, 8-byte ones for bf16 slices not a multiple of 8 lanes.
cudaError_t launch_softmax_pv(int dtype, const PvArgs& a) {
  const int hl = a.HL;
  if (dtype == kFloat32) {
    if (hl <= 4) return launch_pv<float, 16, 4>(a);
    if (hl <= 8) return launch_pv<float, 16, 8>(a);
    if (hl <= 16) return launch_pv<float, 16, 16>(a);
    if (hl <= 32) return launch_pv<float, 16, 32>(a);
    return launch_pv<float, 16, 64>(a);
  }
  using bf16 = __nv_bfloat16;
  if (hl % 8 == 0) {
    if (hl <= 8) return launch_pv<bf16, 16, 8>(a);
    if (hl <= 16) return launch_pv<bf16, 16, 16>(a);
    if (hl <= 32) return launch_pv<bf16, 16, 32>(a);
    return launch_pv<bf16, 16, 64>(a);
  }
  if (hl <= 4) return launch_pv<bf16, 8, 4>(a);
  if (hl <= 16) return launch_pv<bf16, 8, 16>(a);
  if (hl <= 32) return launch_pv<bf16, 8, 32>(a);
  return launch_pv<bf16, 8, 64>(a);
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
// scratch and `counters` B * KV int32 zeros, which the kernel leaves zero
// and no launch on another stream may use meanwhile. Launches one kernel
// on `stream` and returns cudaGetLastError().
EXPORT int decode_softmax_pv_hd_fwd(
    int dtype, const void* s, const void* v, void* o, void* ws,
    void* counters, const int* k_pos, int pos, int B, int KV, int G, int S,
    int hl, int n_split, int split_len, float scale, int64_t ss_b,
    int64_t ss_h, int64_t ss_t, int64_t ss_d, int64_t sv_b, int64_t sv_h,
    int64_t sv_t, int64_t sv_d, int64_t so_b, int64_t so_h, int64_t so_t,
    int64_t so_d, void* stream) {
  if (bad_sizes(dtype, B, KV, G, S, hl) || n_split <= 0 ||
      n_split > MAX_SPLIT || split_len <= 0 || split_len % TILE != 0 ||
      (int64_t)n_split * split_len < S ||
      (int64_t)(n_split - 1) * split_len >= S ||
      (n_split > 1 && (!ws || !counters)) || ss_d != 1 || sv_d != 1 ||
      so_d != 1)
    return cudaErrorInvalidValue;
  const PvArgs a{static_cast<const float*>(s), v, o,
                 static_cast<float*>(ws), static_cast<int*>(counters), k_pos,
                 pos, B, KV, G, S, hl, n_split, split_len, scale,
                 Strides{ss_b, ss_h, ss_t, ss_d},
                 Strides{sv_b, sv_h, sv_t, sv_d},
                 Strides{so_b, so_h, so_t, so_d},
                 static_cast<cudaStream_t>(stream)};
  return launch_softmax_pv(dtype, a);
}
