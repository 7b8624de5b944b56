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
// output has the input's type. A group with no admissible slot (all of its
// logits -1e30, common once a mesh splits the cache on its slots) writes
// zeros, where the softmax would give the mean of v.
//
// Optionally it writes lse [B, KV, G] f32: the natural log of the sum of
// exp(scaled score) over the admissible slots, -inf for a group with none,
// so that partial results over disjoint slot ranges can be merged. The
// block that writes the output writes it: the single run, the last block
// of the folded merge (bf16), the combine kernel (f32).
//
// What bounds it on the H100: decode reads the whole cache once for ~2 G
// FLOPs per element, far below the card's ridge, so it is bound by bytes:
// the HBM's 3.35 TB/s, which only many copies in flight reach (Little's
// law: ~26 KB per SM at ~1 us of latency; one hd-112 tile of K+V is 28.7
// KB).
//
// Both kernels: grid (n_split, KV, B). The cache is cut into n_split equal
// runs of whole 64-slot tiles, one block per (run, KV group); the wrapper
// picks n_split from the total tile count B * KV * ceil(S / 64), aiming at
// about 8 runs per SM, so that every SM holds several blocks' tiles in
// flight and no block sweeps a long run alone. The G heads of a group are
// packed together, so each K/V tile is read once for all of them (G <=
// 16). The cache is read through its strides ([B, S, KV, hd] handed over
// as a [B, KV, S, hd] view).
//
// bf16 design (decode_bf16_kernel), 4 warps:
//  * Tiles arrive by 16-byte cp.async copies into a bf16 ring of 3 stages
//    in shared memory (never widened there): the next two tiles' copies
//    are in flight while one is used. One block barrier per stage. At hd
//    112 a block takes 97 KB, so 2 blocks share an SM with 4 tiles (115
//    KB) in flight.
//  * Each warp owns 16 of the tile's 64 slots and keeps its own online
//    softmax state in registers. Scores and P V run on the tensor cores
//    (mma.sync m16n8k16, bf16 in, f32 accumulate) with the G heads padded
//    to 16 rows: S = q K^T takes K's rows as stored (ldmatrix), P stays in
//    registers as the A operand, and V's rows are transposed on their way
//    to registers (ldmatrix.trans). Rows of the ring are padded by 16
//    bytes, so those loads are free of bank conflicts. The 4 warps' states
//    merge once per run, through the drained ring.
//  * The merge of the runs is folded in: each block writes its (O, m, l)
//    to an f32 workspace, and the last block of a (b, kv) group to arrive,
//    counted in a wrapper-owned int32 buffer (one per device and stream)
//    that it resets to 0, merges the runs and writes the output. One
//    launch per call.
//
// f32 design (decode_kernel + combine_kernel): tiles widened to f32 in
// shared memory, one thread per (head, slot) score and per (head, column)
// output, and a second kernel merging the runs. It exists for the 2e-5
// checks, not for speed.

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {


constexpr int DBK = 64;    // cache slots per tile
constexpr int DNT = 128;   // threads per block
constexpr int GMAX = 16;   // most query heads per KV group
constexpr float kLn2 = 0.6931471805599453f;   // the bf16 path's log2 -> ln

template <int HD>
constexpr int smem_floats() {
  return GMAX * HD          // Qs: [G][HD]
       + DBK * (HD + 1)     // Ks: [DBK][HD + 1]
       + DBK * HD           // Vs: [DBK][HD]
       + GMAX * DBK;        // Ss: [G][DBK] logits, then probabilities
}

// One run's unnormalised state in the workspace: acc [G][HD], m [G], l [G].
template <int HD>
__host__ __device__ constexpr int part_floats(int G) {
  return G * HD + ((2 * G + 3) & ~3);   // m, l padded to 16 bytes
}

template <typename T, int HD>
__global__ void __launch_bounds__(DNT) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    float* __restrict__ ws, const int* __restrict__ k_pos, int pos, int S,
    int G, int split_len, float scale, Strides sq, Strides sk, Strides sv,
    Strides so) {
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
        ob[g * so.t + d * so.d] = from_float<T>(
            m_s[g] <= kNegInf ? 0.f : acc[t] / fmaxf(l_s[g], 1e-30f));
      }
    }
    if (lse && tid < G)
      lse[(b * gridDim.y + kvh) * G + tid] =
          m_s[tid] <= kNegInf ? -INFINITY : m_s[tid] + logf(l_s[tid]);
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
// the rescaled sum of l (zeros where no run has an admissible slot).
template <typename T, int HD>
__global__ void __launch_bounds__(HD) combine_kernel(
    const float* __restrict__ ws, T* __restrict__ o, float* __restrict__ lse,
    int n_split, Strides so) {
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
  const bool empty = M <= kNegInf;
  o[b * so.b + kvh * so.h + g * so.t + d * so.d] =
      from_float<T>(empty ? 0.f : O / fmaxf(L, 1e-30f));
  if (lse && d == 0)
    lse[(b * gridDim.y + kvh) * G + g] = empty ? -INFINITY : M + logf(L);
}

// ---------------------------------------------------------------------------
// bf16: cp.async ring, tensor-core scores and P V per warp, folded merge.
// ---------------------------------------------------------------------------

constexpr int RING = 3;       // stages of the bf16 ring
constexpr int WSL = 16;       // slots per warp per tile
constexpr int MAX_SPLIT = 64; // most runs per (b, kv) group
static_assert(MAX_SPLIT <= 64, "the run merge gives each lane two runs");

template <int HD>
struct DCfg {
  static constexpr int C = HD / 8;        // 16-byte chunks per row
  // Rows padded by 16 bytes: the 8 rows an ldmatrix reads hit distinct
  // banks at every head dim.
  static constexpr int LD = HD + 8;
  static constexpr int TILE = DBK * LD;   // bf16 of one K or V tile
  static constexpr int KS = HD / 16;      // 16-deep steps of q K^T
  static constexpr int NT = HD / 8;       // 8-column tiles of O
  static constexpr int RING_BYTES = 2 * RING * TILE * 2;
  static_assert(4 * GMAX * HD * 4 <= RING_BYTES,
                "the warps' O fit in the drained ring");
  static_assert(2 * MAX_SPLIT * GMAX * 4 <= RING_BYTES,
                "the merge's m and l fit in the drained ring");
};

// Dynamic shared memory of the bf16 kernel: the K and V rings, their key
// positions, and q (G rows zero-padded to 16).
template <int HD>
constexpr int bf16_smem_bytes() {
  return DCfg<HD>::RING_BYTES + RING * DBK * 4 + GMAX * DCfg<HD>::LD * 2;
}

template <int HD>
__global__ void __launch_bounds__(DNT) decode_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, float* __restrict__ ws,
    int* __restrict__ counters, const int* __restrict__ k_pos, int pos,
    int S, int G, int split_len, float scale_log2, Strides sq, Strides sk,
    Strides sv, Strides so) {
  using D = DCfg<HD>;
  using bf16 = __nv_bfloat16;
  constexpr int C = D::C, LD = D::LD, KS = D::KS, NT = D::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + RING * D::TILE;
  int* kpos_s = reinterpret_cast<int*>(Vs + RING * D::TILE);
  bf16* Qs = reinterpret_cast<bf16*>(kpos_s + RING * DBK);
  __shared__ float wm[4][GMAX], wl[4][GMAX];
  __shared__ int is_last;
  // Once the sweep is over, the drained ring holds the 4 warps' O, then
  // the merge's per-run m and l.
  float* Ow = reinterpret_cast<float*>(smem_raw);
  float (*mw)[GMAX] = reinterpret_cast<float (*)[GMAX]>(smem_raw);
  float (*lw)[GMAX] = mw + MAX_SPLIT;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int kvh = blockIdx.y, b = blockIdx.z, KV = gridDim.y;
  const int k_begin = split * split_len;
  const int k_end = min(S, k_begin + split_len);
  const int n_t = (k_end - k_begin + DBK - 1) / DBK;
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;

  // Tile i of the run into stage i % RING: 16-byte copies, rows past the
  // run's end zero-filled; one commit group per tile (empty past the end).
  auto issue = [&](int i) {
    if (i < n_t) {
      const int st = i % RING, k0 = k_begin + i * DBK;
      bf16* kd = Ks + st * D::TILE;
      bf16* vd = Vs + st * D::TILE;
#pragma unroll 2
      for (int idx = tid; idx < DBK * C; idx += DNT) {
        const int j = idx / C, c = idx % C;
        const bool in = k0 + j < k_end;
        const int64_t row = in ? (int64_t)(k0 + j) : 0;
        cp_async16(kd + j * LD + c * 8, kb + row * sk.t + c * 8, in ? 16 : 0);
        cp_async16(vd + j * LD + c * 8, vb + row * sv.t + c * 8, in ? 16 : 0);
      }
      if (tid < DBK / 4) {
        const int kk = k0 + 4 * tid;
        const int bytes = max(0, min(4, k_end - kk)) * 4;
        cp_async16(kpos_s + st * DBK + 4 * tid, bytes ? k_pos + kk : k_pos,
                   bytes);
      }
    }
    cp_async_commit();
  };
  // q's G rows, and zeros up to 16, travel with the first tile.
  const bf16* qb = q + b * sq.b + kvh * sq.h;
  for (int idx = tid; idx < GMAX * C; idx += DNT) {
    const int r = idx / C, c = idx % C;
    cp_async16(Qs + r * LD + c * 8, r < G ? qb + r * sq.t + c * 8 : qb,
               r < G ? 16 : 0);
  }
#pragma unroll
  for (int i = 0; i < RING - 1; ++i) issue(i);

  // Each warp keeps the online softmax of its 16 slots per tile: rows g
  // and g + 8 (heads) of m, l and O in registers.
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  uint32_t qa[KS][4];

  for (int i = 0; i < n_t; ++i) {
    cp_async_wait<RING - 2>();
    __syncthreads();      // tile i landed; stage (i - 1) % RING is free
    issue(i + RING - 1);
    if (i == 0) {         // q's A fragments, heads g and g + 8
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const bf16* p = Qs + g * LD + 16 * kk + 2 * t;
        qa[kk][0] = *reinterpret_cast<const uint32_t*>(p);
        qa[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
        qa[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        qa[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
      }
    }
    const int st = i % RING, k0 = k_begin + i * DBK;
    const bf16* Kt = Ks + st * D::TILE + warp * WSL * LD;
    const bf16* Vt = Vs + st * D::TILE + warp * WSL * LD;
    const int* kp = kpos_s + st * DBK + warp * WSL;

    // S = q K^T over the warp's 16 slots (two 8-slot tiles); K's rows are
    // the col-major B operand as stored, read by ldmatrix.
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t bk[4];
      ldmatrix_x4(bk, Kt + (((lane >> 4) & 1) * 8 + (lane & 7)) * LD +
                          16 * kk + ((lane >> 3) & 1) * 8);
      mma_16816(s[0], qa[kk], bk[0], bk[1]);
      mma_16816(s[1], qa[kk], bk[2], bk[3]);
    }

    // Mask, online softmax per head row (a row lives in 4 adjacent lanes).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int slot = nt * 8 + 2 * t + (c & 1);
        float x = s[nt][c] * scale_log2;
        if (k0 + warp * WSL + slot >= k_end)
          x = -INFINITY;
        else if (kp[slot] > pos)
          x = kNegInf;
        s[nt][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      alpha[r] = fast_exp2(m_i[r] - m_new);
      m_i[r] = m_new;
    }
    // Once the row maxima settle, alpha is 1 and the rescale (exact
    // either way) is skipped for the whole warp.
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int r = 0; r < 2; ++r) l_i[r] *= alpha[r];   // this lane's share
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[nt][c] = fast_exp2(s[nt][c] - m_i[c >> 1]);
        l_i[c >> 1] += s[nt][c];
      }

    // O += P V: P (rounded to bf16) from the S registers in the A layout;
    // V's rows transposed by ldmatrix into the col-major B operand.
    const uint32_t pa[4] = {pack_bf16x2(s[0][0], s[0][1]),
                            pack_bf16x2(s[0][2], s[0][3]),
                            pack_bf16x2(s[1][0], s[1][1]),
                            pack_bf16x2(s[1][2], s[1][3])};
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, Vt + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                16 * np + (lane >> 4) * 8);
      mma_16816(acc[2 * np], pa, bv[0], bv[1]);
      mma_16816(acc[2 * np + 1], pa, bv[2], bv[3]);
    }
  }
  cp_async_wait<0>();

  // Merge the 4 warps through the drained ring.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (row < G) {
      float* dst = Ow + (warp * G + row) * HD + 2 * t;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      if (t == 0) {
        wm[warp][row] = m_i[r];
        wl[warp][row] = l_i[r];
      }
    }
  }
  __syncthreads();

  bf16* ob = o + b * so.b + kvh * so.h;
  const int stride = part_floats<HD>(G);
  float* base = ws + (int64_t)(b * KV + kvh) * n_split * stride;
  float* part = base + (int64_t)split * stride;
  for (int idx = tid; idx < G * C; idx += DNT) {
    const int gg = idx / C, cc = idx % C;
    const float M = fmaxf(fmaxf(wm[0][gg], wm[1][gg]),
                          fmaxf(wm[2][gg], wm[3][gg]));
    float r[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, L = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float f = exp2f(wm[w][gg] - M);
      L = fmaf(f, wl[w][gg], L);
      const float4* src =
          reinterpret_cast<const float4*>(Ow + (w * G + gg) * HD + cc * 8);
      const float4 a = src[0], c4 = src[1];
      r[0] = fmaf(f, a.x, r[0]);
      r[1] = fmaf(f, a.y, r[1]);
      r[2] = fmaf(f, a.z, r[2]);
      r[3] = fmaf(f, a.w, r[3]);
      r[4] = fmaf(f, c4.x, r[4]);
      r[5] = fmaf(f, c4.y, r[5]);
      r[6] = fmaf(f, c4.z, r[6]);
      r[7] = fmaf(f, c4.w, r[7]);
    }
    if (n_split == 1) {
      // M in log2 units; kNegInf only where every slot was masked
      const bool empty = M <= kNegInf;
      const float inv = empty ? 0.f : 1.f / fmaxf(L, 1e-30f);
      if (lse && cc == 0)
        lse[(b * KV + kvh) * G + gg] =
            empty ? -INFINITY : (M + log2f(L)) * kLn2;
      uint4 out;
      out.x = pack_bf16x2(r[0] * inv, r[1] * inv);
      out.y = pack_bf16x2(r[2] * inv, r[3] * inv);
      out.z = pack_bf16x2(r[4] * inv, r[5] * inv);
      out.w = pack_bf16x2(r[6] * inv, r[7] * inv);
      *reinterpret_cast<uint4*>(ob + gg * so.t + cc * 8) = out;
    } else {
      float4* dst = reinterpret_cast<float4*>(part + gg * HD + cc * 8);
      dst[0] = make_float4(r[0], r[1], r[2], r[3]);
      dst[1] = make_float4(r[4], r[5], r[6], r[7]);
      if (cc == 0) {
        part[G * HD + gg] = M;
        part[G * HD + G + gg] = L;
      }
    }
  }
  if (n_split == 1) return;

  // This run is published; the last run of the group to arrive merges
  // them all.
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(&counters[b * KV + kvh], 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int idx = tid; idx < n_split * G; idx += DNT) {
    const int s = idx / G, gg = idx % G;
    mw[s][gg] = __ldcg(base + (int64_t)s * stride + G * HD + gg);
    lw[s][gg] = __ldcg(base + (int64_t)s * stride + G * HD + G + gg);
  }
  __syncthreads();
  // Each run's weight in the output, a warp per head, a lane per run.
  for (int gg = warp; gg < G; gg += DNT / 32) {
    const bool on0 = lane < n_split, on1 = lane + 32 < n_split;
    const float m0 = on0 ? mw[lane][gg] : -INFINITY;
    const float m1 = on1 ? mw[lane + 32][gg] : -INFINITY;
    float M = fmaxf(m0, m1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    const bool empty = M <= kNegInf;   // no run has an admissible slot
    const float e0 = on0 && !empty ? exp2f(m0 - M) : 0.f;
    const float e1 = on1 && !empty ? exp2f(m1 - M) : 0.f;
    float Lsum = (on0 ? lw[lane][gg] * e0 : 0.f) +
                 (on1 ? lw[lane + 32][gg] * e1 : 0.f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      Lsum += __shfl_xor_sync(0xffffffffu, Lsum, off);
    const float inv = 1.f / fmaxf(Lsum, 1e-30f);
    if (lse && lane == 0)
      lse[(b * KV + kvh) * G + gg] =
          empty ? -INFINITY : (M + log2f(Lsum)) * kLn2;
    if (on0) mw[lane][gg] = e0 * inv;
    if (on1) mw[lane + 32][gg] = e1 * inv;
  }
  __syncthreads();
  for (int idx = tid; idx < G * C; idx += DNT) {
    const int gg = idx / C, cc = idx % C;
    float r[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) {
      const float w = mw[s][gg];
      const float4* src = reinterpret_cast<const float4*>(
          base + (int64_t)s * stride + gg * HD + cc * 8);
      const float4 a = __ldcg(src), c4 = __ldcg(src + 1);
      r[0] = fmaf(w, a.x, r[0]);
      r[1] = fmaf(w, a.y, r[1]);
      r[2] = fmaf(w, a.z, r[2]);
      r[3] = fmaf(w, a.w, r[3]);
      r[4] = fmaf(w, c4.x, r[4]);
      r[5] = fmaf(w, c4.y, r[5]);
      r[6] = fmaf(w, c4.z, r[6]);
      r[7] = fmaf(w, c4.w, r[7]);
    }
    uint4 out;
    out.x = pack_bf16x2(r[0], r[1]);
    out.y = pack_bf16x2(r[2], r[3]);
    out.z = pack_bf16x2(r[4], r[5]);
    out.w = pack_bf16x2(r[6], r[7]);
    *reinterpret_cast<uint4*>(ob + gg * so.t + cc * 8) = out;
  }
  if (tid == 0) counters[b * KV + kvh] = 0;   // ready for the next call
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, float* ws, int* counters,
                        const int* k_pos, int pos, int B, int KV, int G, int S,
                        int n_split, int split_len, float scale, Strides sq,
                        Strides sk, Strides sv, Strides so,
                        cudaStream_t stream) {
  static unsigned long long done = 0;
  cudaError_t err = set_smem_once(decode_bf16_kernel<HD>,
                                  bf16_smem_bytes<HD>(), &done);
  if (err != cudaSuccess) return err;
  decode_bf16_kernel<HD><<<dim3(n_split, KV, B), DNT, bf16_smem_bytes<HD>(),
                           stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, ws, counters, k_pos, pos, S, G, split_len,
      scale * 1.4426950408889634f, sq, sk, sv, so);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, float* ws, const int* k_pos, int pos,
                       int B, int KV, int G, int S, int n_split,
                       int split_len, float scale, Strides sq, Strides sk,
                       Strides sv, Strides so, cudaStream_t stream) {
  static unsigned long long done = 0;
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = set_smem_once(decode_kernel<float, HD>, smem, &done);
  if (err != cudaSuccess) return err;
  decode_kernel<float, HD><<<dim3(n_split, KV, B), DNT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, ws, k_pos,
      pos, S, G, split_len, scale, sq, sk, sv, so);
  if ((err = cudaGetLastError()) != cudaSuccess || n_split == 1) return err;
  combine_kernel<float, HD><<<dim3(G, KV, B), HD, 0, stream>>>(
      ws, static_cast<float*>(o), lse, n_split, so);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, float* lse, float* ws, int* counters,
                   const int* k_pos, int pos, int B, int KV, int G, int S,
                   int n_split, int split_len, float scale, Strides sq,
                   Strides sk, Strides sv, Strides so, cudaStream_t stream) {
  if (dtype == kBFloat16)
    return launch_bf16<HD>(q, k, v, o, lse, ws, counters, k_pos, pos, B, KV,
                           G, S, n_split, split_len, scale, sq, sk, sv, so,
                           stream);
  return launch_f32<HD>(q, k, v, o, lse, ws, k_pos, pos, B, KV, G, S, n_split,
                        split_len, scale, sq, sk, sv, so, stream);
}

}  // namespace

// q [B, KV, G, hd], k and v [B, KV, S, hd], o [B, KV, G, hd], each given by
// its element strides; lse null or [B, KV, G] f32, contiguous; k_pos [S]
// int32, contiguous; pos the decode position.
// The cache is cut into n_split runs of split_len slots (a multiple of 64,
// n_split * split_len >= S > (n_split - 1) * split_len, n_split <= 64);
// with n_split > 1, ws holds B * KV * n_split * (G * hd + 4 ceil(G / 2))
// floats of scratch, and for bf16 `counters` B * KV int32 zeros, which the
// kernel leaves zero and no launch on another stream may use meanwhile.
// Launches on `stream` (one kernel for bf16, a split and a merge kernel
// for f32) and returns cudaGetLastError().
EXPORT int decode_attention_fwd(
    int dtype, int hd, const void* q, const void* k, const void* v, void* o,
    void* lse, void* ws, void* counters, const int* k_pos, int pos, int B,
    int KV, int G, int S, int n_split, int split_len, float scale,
    int64_t sq_b, int64_t sq_h, int64_t sq_t, int64_t sq_d,
    int64_t sk_b, int64_t sk_h, int64_t sk_t, int64_t sk_d,
    int64_t sv_b, int64_t sv_h, int64_t sv_t, int64_t sv_d,
    int64_t so_b, int64_t so_h, int64_t so_t, int64_t so_d, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || G > GMAX || S <= 0 || n_split <= 0 ||
      n_split > MAX_SPLIT || split_len <= 0 || split_len % DBK != 0 ||
      (int64_t)n_split * split_len < S ||
      (int64_t)(n_split - 1) * split_len >= S ||
      (n_split > 1 && (!ws || (dtype == kBFloat16 && !counters))) ||
      (dtype != kFloat32 && dtype != kBFloat16))
    return cudaErrorInvalidValue;
  float* lsef = static_cast<float*>(lse);
  float* wsf = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  const Strides sq{sq_b, sq_h, sq_t, sq_d}, sk{sk_b, sk_h, sk_t, sk_d};
  const Strides sv{sv_b, sv_h, sv_t, sv_d}, so{so_b, so_h, so_t, so_d};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(dtype, q, k, v, o, lsef, wsf, cnt, k_pos, pos, B, KV,
                        G, S, n_split, split_len, scale, sq, sk, sv, so, st);
    case 64:
      return launch<64>(dtype, q, k, v, o, lsef, wsf, cnt, k_pos, pos, B, KV,
                        G, S, n_split, split_len, scale, sq, sk, sv, so, st);
    case 112:
      return launch<112>(dtype, q, k, v, o, lsef, wsf, cnt, k_pos, pos, B, KV,
                         G, S, n_split, split_len, scale, sq, sk, sv, so, st);
    case 128:
      return launch<128>(dtype, q, k, v, o, lsef, wsf, cnt, k_pos, pos, B, KV,
                         G, S, n_split, split_len, scale, sq, sk, sv, so, st);
    default:
      return cudaErrorInvalidValue;
  }
}
