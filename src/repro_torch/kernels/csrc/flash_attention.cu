// Flash attention for prefill: causal grouped-query attention with an
// online softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py,
// function `flash_attention` (body `_kernel`).
//
// What it computes, per (b, h): o = softmax(q k^T / sqrt(hd) + mask) v over
// the KV head h / G, where a key is admissible for a query when
// k_pos <= q_pos and, with window > 0, k_pos > q_pos - window. A key masked
// by position gets the logit -1e30 as in the reference, so a row with no
// admissible key averages v over all keys. m, l and the accumulator are f32;
// l is clamped at 1e-30; the output has the input's type.
//
// Design.
//  * Grid (ceil(Tq / BQ), H, B): one block per query tile of one head. The
//    TPU kernel's sequential K grid axis becomes a loop inside the block,
//    which carries m, l and the output accumulator in registers.
//  * Operands are read through their strides, so the model hands over its
//    [B, T, H|KV, hd] activations as [B, H|KV, T, hd] views with no copy,
//    and the output is written through its own strides.
//  * Tq and Tk may be any length: query rows past Tq are not stored and
//    keys past Tk are excluded outright (logit -inf).
//  * A K tile is skipped when every (query, key) pair in it is masked by
//    the causal/window bound, judged from the tile's position range. That
//    is exact for every row that has an admissible key; if some row has
//    none, the block runs the sweep again without skipping, so that row
//    gets the reference's uniform average.
//  * Two kernels share that structure (64-query x 64-key tiles):
//    - f32 inputs: scalar IEEE f32 FMAs on the CUDA cores (no TF32, which
//      the 2e-5 check forbids). 256 threads hold the 64 x 64 logit tile as
//      4 x 4 values each (rows ty + 16 i, columns tx + 16 j): a row lives
//      in 16 adjacent lanes and its max and sum are 4-step shuffles. Q and
//      K sit transposed in shared memory with an odd stride, free of bank
//      conflicts.
//    - bf16 inputs: the tensor cores, through mma.sync m16n8k16 with f32
//      accumulators. 4 warps own 16 query rows each; Q's fragments stay in
//      registers for the whole sweep, S = Q K^T lands in registers in the
//      accumulator layout, which is also the A-operand layout of P, so P V
//      runs from registers too (P rounded to bf16, as FlashAttention-2
//      does). Shared-memory rows are padded by 8 elements so the 32-bit
//      fragment loads are free of bank conflicts.
//
// What bounds it on the H100: at prefill lengths attention does ~T/2
// multiply-adds per byte it reads, far above the card's ~295 FLOP/byte
// ridge, so it is bound by operations. The bf16 kernel reaches the tensor
// cores through mma.sync; wgmma with TMA-fed, double-buffered tiles (so a
// tile's loads overlap the previous tile's products) is the next step. The
// f32 kernel is bound by the CUDA cores' ~67 TFLOP/s and is there for the
// f32 checks, not for speed.

#include <climits>
#include <math.h>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads per block
constexpr int LDS = BQ + 1;   // odd stride of the transposed Q/K tiles and P

template <int HD>
constexpr int smem_floats() {
  return HD * LDS      // Qs: [HD][LDS], Qs[d * LDS + r]
       + HD * LDS      // Ks: [HD][LDS], Ks[d * LDS + j]
       + BK * HD       // Vs: [BK][HD]
       + BK * LDS;     // Ps: [BK][LDS], Ps[j * LDS + r]
}

// Min and max over the 64 values held by threads 0..63 (warps 0 and 1);
// invalid entries pass INT_MAX / INT_MIN. Every thread must call it.
__device__ __forceinline__ void range64(int tid, bool valid, int x,
                                        int* red, int* lo, int* hi) {
  if (tid < 64) {
    int mn = __reduce_min_sync(0xffffffffu, valid ? x : INT_MAX);
    int mx = __reduce_max_sync(0xffffffffu, valid ? x : INT_MIN);
    if ((tid & 31) == 0) {
      red[tid >> 5] = mn;
      red[2 + (tid >> 5)] = mx;
    }
  }
  __syncthreads();
  *lo = min(red[0], red[1]);
  *hi = max(red[2], red[3]);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    int Tq, int Tk, int G, int window, float scale,
    Strides sq, Strides sk, Strides sv, Strides so) {
  static_assert(HD % 16 == 0 && BK * HD % NT == 0,
                "head dim must be a multiple of 16");
  constexpr int CP = HD / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + HD * LDS;
  float* Vs = Ks + HD * LDS;
  float* Ps = Vs + BK * HD;
  __shared__ int qpos_s[BQ];
  __shared__ int kpos_s[BK];
  __shared__ int red_s[4];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  T* ob = o + b * so.b + h * so.h;

  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    const int qi = q0 + r;
    Qs[d * LDS + r] = qi < Tq ? to_float(qb[qi * sq.t + d * sq.d]) : 0.f;
  }
  int qp_mine = 0;
  const bool q_valid = tid < BQ && q0 + tid < Tq;
  if (q_valid) qp_mine = q_pos[q0 + tid];
  if (tid < BQ) qpos_s[tid] = qp_mine;
  int qmin, qmax;
  range64(tid, q_valid, qp_mine, red_s, &qmin, &qmax);

  float acc[4][CP];
  float m_i[4], l_i[4];
  const int n_kt = (Tk + BK - 1) / BK;

  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m_i[i] = kNegInf;
      l_i[i] = 0.f;
#pragma unroll
      for (int c = 0; c < CP; ++c) acc[i][c] = 0.f;
    }

    for (int kt = 0; kt < n_kt; ++kt) {
      const int k0 = kt * BK;
      __syncthreads();  // the previous tile's Ks/Vs/Ps/red_s are consumed
      const bool k_valid = tid < BK && k0 + tid < Tk;
      int kp_mine = 0;
      if (k_valid) kp_mine = k_pos[k0 + tid];
      if (tid < BK) kpos_s[tid] = kp_mine;
      int kmin, kmax;
      range64(tid, k_valid, kp_mine, red_s, &kmin, &kmax);
      if (pass == 0 && (kmin > qmax ||
                        (window > 0 &&
                         (long long)kmax <= (long long)qmin - window)))
        continue;  // every pair in this tile is masked

#pragma unroll 8
      for (int it = 0; it < BK * HD / NT; ++it) {
        const int idx = tid + it * NT;
        const int j = idx / HD, d = idx % HD;
        const int kk = k0 + j;
        float kx = 0.f, vx = 0.f;
        if (kk < Tk) {
          kx = to_float(kb[kk * sk.t + d * sk.d]);
          vx = to_float(vb[kk * sv.t + d * sv.d]);
        }
        Ks[d * LDS + j] = kx;
        Vs[j * HD + d] = vx;
      }
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        float a[4], bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Qs[d * LDS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bk[j] = Ks[d * LDS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int qp = qpos_s[r];
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          float x = s[i][j] * scale;
          if (k0 + c >= Tk) {
            x = -INFINITY;
          } else {
            const int kp = kpos_s[c];
            const bool ok = kp <= qp && (window <= 0 || kp > qp - window);
            if (!ok) x = kNegInf;
          }
          s[i][j] = x;
          mx = fmaxf(mx, x);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_i[i], mx);
        const float alpha = expf(m_i[i] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(s[i][j] - m_new);
          rs += p;
          Ps[(tx + 16 * j) * LDS + r] = p;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, off);
        l_i[i] = l_i[i] * alpha + rs;
        m_i[i] = m_new;
#pragma unroll
        for (int c = 0; c < CP; ++c) acc[i][c] *= alpha;
      }
      __syncthreads();

#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        float pv[4], vv[CP];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = Ps[j * LDS + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < CP; ++c) vv[c] = Vs[j * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CP; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }

    // Only a row that met no admissible key still has m == -1e30.
    int lost = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (q0 + ty + 16 * i < Tq && m_i[i] <= kNegInf) lost = 1;
    if (!__syncthreads_or(lost)) break;
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Tq) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CP; ++c)
      ob[qi * so.t + (tx + 16 * c) * so.d] = from_float<T>(acc[i][c] / l);
  }
}

// ---------------------------------------------------------------------------
// bf16: the same algorithm on the tensor cores (mma.sync m16n8k16, f32
// accumulators). 4 warps, each owning 16 query rows of the 64-row tile.
// ---------------------------------------------------------------------------

constexpr int MNT = 128;     // threads per block (4 warps x 16 rows = BQ)

template <int HD>
constexpr int mma_smem_bytes() {
  return (BQ * (HD + 8)      // Qs: [BQ][HD + 8]  row-major, padded
          + BK * (HD + 8)    // Ks: [BK][HD + 8]
          + HD * (BK + 8))   // Vt: [HD][BK + 8]  V transposed
         * 2;
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two adjacent bf16 in shared memory as one 32-bit fragment register.
__device__ __forceinline__ uint32_t ld2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layout of m16n8k16 (PTX ISA), with g = lane / 4, t = lane % 4:
//   A regs: (row g, k 2t..2t+1), (row g+8, k 2t..), (row g, k 2t+8..),
//           (row g+8, k 2t+8..);   B regs: (k 2t..2t+1, col g), (k 2t+8.., col g)
//   C: c0,c1 = (row g, col 2t, 2t+1), c2,c3 = (row g+8, col 2t, 2t+1).
// The C layout of two adjacent 8-key tiles of S is the A layout of P for
// the 16 keys they span, so P never leaves the registers.
template <int HD>
__global__ void __launch_bounds__(MNT) flash_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    int Tq, int Tk, int G, int window, float scale,
    Strides sq, Strides sk, Strides sv, Strides so) {
  static_assert(HD % 16 == 0 && BQ == 4 * 16 && BK == 64, "tile shape");
  constexpr int LDQ = HD + 8, LDV = BK + 8;   // bf16 elements per smem row
  constexpr int KC = HD / 16;                 // k-chunks of Q K^T
  constexpr int NO = HD / 8;                  // 8-column tiles of O
  using bf16 = __nv_bfloat16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LDQ;
  bf16* Vt = Ks + BK * LDQ;
  __shared__ int qpos_s[BQ];
  __shared__ int kpos_s[BK];
  __shared__ int red_s[4];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + hk * sk.h;
  const bf16* vb = v + b * sv.b + hk * sv.h;
  bf16* ob = o + b * so.b + h * so.h;
  const bf16 zero = __float2bfloat16(0.f);

#pragma unroll 8
  for (int it = 0; it < BQ * HD / MNT; ++it) {
    const int idx = tid + it * MNT;
    const int r = idx / HD, d = idx % HD;
    const int qi = q0 + r;
    Qs[r * LDQ + d] = qi < Tq ? qb[qi * sq.t + d * sq.d] : zero;
  }
  int qp_mine = 0;
  const bool q_valid = tid < BQ && q0 + tid < Tq;
  if (q_valid) qp_mine = q_pos[q0 + tid];
  if (tid < BQ) qpos_s[tid] = qp_mine;
  int qmin, qmax;
  range64(tid, q_valid, qp_mine, red_s, &qmin, &qmax);  // syncs: Qs is ready

  const int r0 = warp * 16 + g;        // this thread's rows: r0 and r0 + 8
  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const bf16* p = Qs + r0 * LDQ + kc * 16 + 2 * t;
    qa[kc][0] = ld2(p);
    qa[kc][1] = ld2(p + 8 * LDQ);
    qa[kc][2] = ld2(p + 8);
    qa[kc][3] = ld2(p + 8 * LDQ + 8);
  }
  const int qp[2] = {qpos_s[r0], qpos_s[r0 + 8]};

  float acc[NO][4];
  float m_i[2], l_i[2];
  const int n_kt = (Tk + BK - 1) / BK;

  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_i[i] = kNegInf;
      l_i[i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

    for (int kt = 0; kt < n_kt; ++kt) {
      const int k0 = kt * BK;
      __syncthreads();  // the previous tile's Ks/Vt/red_s are consumed
      const bool k_valid = tid < BK && k0 + tid < Tk;
      int kp_mine = 0;
      if (k_valid) kp_mine = k_pos[k0 + tid];
      if (tid < BK) kpos_s[tid] = kp_mine;
      int kmin, kmax;
      range64(tid, k_valid, kp_mine, red_s, &kmin, &kmax);
      if (pass == 0 && (kmin > qmax ||
                        (window > 0 &&
                         (long long)kmax <= (long long)qmin - window)))
        continue;  // every pair in this tile is masked

#pragma unroll 8
      for (int it = 0; it < BK * HD / MNT; ++it) {
        const int idx = tid + it * MNT;
        const int j = idx / HD, d = idx % HD;
        const int kk = k0 + j;
        const bool in = kk < Tk;
        Ks[j * LDQ + d] = in ? kb[kk * sk.t + d * sk.d] : zero;
        Vt[d * LDV + j] = in ? vb[kk * sv.t + d * sv.d] : zero;
      }
      __syncthreads();

      // S = Q K^T: 8 tiles of 8 keys.
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          const bf16* p = Ks + (n * 8 + g) * LDQ + kc * 16 + 2 * t;
          mma_bf16(s[n], qa[kc], ld2(p), ld2(p + 8));
        }
      }

      // Mask, online softmax (rows r0 and r0 + 8 live in 4 adjacent lanes).
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = n * 8 + 2 * t + (c & 1), i = c >> 1;
          float x = s[n][c] * scale;
          if (k0 + key >= Tk) {
            x = -INFINITY;
          } else {
            const int kp = kpos_s[key];
            if (!(kp <= qp[i] && (window <= 0 || kp > qp[i] - window)))
              x = kNegInf;
          }
          s[n][c] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_i[i], mx[i]);
        alpha[i] = expf(m_i[i] - m_new);
        m_i[i] = m_new;
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[n][c] = expf(s[n][c] - m_i[c >> 1]);
          rs[c >> 1] += s[n][c];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        l_i[i] = l_i[i] * alpha[i] + rs[i];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // O += P V, P rounded to bf16 in the A layout.
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kc][0], s[2 * kc][1]),
            pack_bf16(s[2 * kc][2], s[2 * kc][3]),
            pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
            pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const bf16* p = Vt + (n * 8 + g) * LDV + kc * 16 + 2 * t;
          mma_bf16(acc[n], pa, ld2(p), ld2(p + 8));
        }
      }
    }

    int lost = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (q0 + r0 + 8 * i < Tq && m_i[i] <= kNegInf) lost = 1;
    if (!__syncthreads_or(lost)) break;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + 8 * i;
    if (qi >= Tq) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      bf16* out = ob + qi * so.t + (n * 8 + 2 * t) * so.d;
      out[0] = __float2bfloat16(acc[n][2 * i] / l);
      out[so.d] = __float2bfloat16(acc[n][2 * i + 1] / l);
    }
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       const int* q_pos, const int* k_pos, int B, int H,
                       int KV, int Tq, int Tk, int window, float scale,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       cudaStream_t stream) {
  const int smem = mma_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_mma_kernel<HD><<<grid, MNT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      q_pos, k_pos, Tq, Tk, H / KV, window, scale, sq, sk, sv, so);
  return cudaGetLastError();
}

// f32 goes to the scalar kernel, bf16 to the tensor-core one.
template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* q_pos, const int* k_pos, int B, int H, int KV,
                   int Tq, int Tk, int window, float scale, Strides sq,
                   Strides sk, Strides sv, Strides so, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_mma<HD>(q, k, v, o, q_pos, k_pos, B, H, KV, Tq, Tk, window,
                          scale, sq, sk, sv, so, stream);
  } else {
    const int smem = smem_floats<HD>() * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Tq + BQ - 1) / BQ, H, B);
    flash_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), q_pos, k_pos, Tq, Tk,
        H / KV, window, scale, sq, sk, sv, so);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, const int* q_pos, const int* k_pos, int B,
                        int H, int KV, int Tq, int Tk, int window, float scale,
                        Strides sq, Strides sk, Strides sv, Strides so,
                        cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, q_pos, k_pos, B, H, KV, Tq, Tk, window,
                           scale, sq, sk, sv, so, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, q_pos, k_pos, B, H, KV, Tq, Tk, window,
                           scale, sq, sk, sv, so, stream);
    case 112:
      return launch<T, 112>(q, k, v, o, q_pos, k_pos, B, H, KV, Tq, Tk, window,
                           scale, sq, sk, sv, so, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, q_pos, k_pos, B, H, KV, Tq, Tk,
                            window, scale, sq, sk, sv, so, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, H, Tq, hd], k and v [B, KV, Tk, hd], o [B, H, Tq, hd], each given by
// its element strides; q_pos [Tq] and k_pos [Tk] int32, contiguous.
// Launches on `stream` and returns cudaGetLastError() after the launch.
EXPORT int flash_attention_fwd(
    int dtype, int hd, const void* q, const void* k, const void* v, void* o,
    const int* q_pos, const int* k_pos, int B, int H, int KV, int Tq, int Tk,
    int window, float scale,
    int64_t sq_b, int64_t sq_h, int64_t sq_t, int64_t sq_d,
    int64_t sk_b, int64_t sk_h, int64_t sk_t, int64_t sk_d,
    int64_t sv_b, int64_t sv_h, int64_t sv_t, int64_t sv_d,
    int64_t so_b, int64_t so_h, int64_t so_t, int64_t so_d, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Tq <= 0 || Tk <= 0)
    return cudaErrorInvalidValue;
  const Strides sq{sq_b, sq_h, sq_t, sq_d}, sk{sk_b, sk_h, sk_t, sk_d};
  const Strides sv{sv_b, sv_h, sv_t, sv_d}, so{so_b, so_h, so_t, so_d};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_hd<float>(hd, q, k, v, o, q_pos, k_pos, B, H, KV, Tq, Tk,
                              window, scale, sq, sk, sv, so, st);
  if (dtype == kBFloat16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, q_pos, k_pos, B, H, KV,
                                      Tq, Tk, window, scale, sq, sk, sv, so,
                                      st);
  return cudaErrorInvalidValue;
}
