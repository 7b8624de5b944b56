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
// l is clamped at 1e-30; the output has the input's type. For training, an
// optional `lse` output takes each row's log-sum-exp m + log l in natural
// log (the wgmma kernel converts from its exp2 domain), +inf for a row with
// no admissible key; flash_attention_bwd.cu reads it.
//
// What bounds it on the H100: at prefill lengths attention does ~T/2
// multiply-adds per byte it reads, far above the card's ~295 FLOP/byte
// ridge, so it is bound by operations: the tensor cores' 989 TFLOP/s in
// bf16, reached only through wgmma fed from shared memory without stalls.
//
// Both kernels read the operands through their strides (the model hands
// over its [B, T, H|KV, hd] activations as [B, H|KV, T, hd] views), take
// any Tq and Tk (keys past Tk get the logit -inf, query rows past Tq are
// not stored), and skip a K tile whose every (query, key) pair is masked
// by the causal/window bound. That skip is exact for every row with an
// admissible key; if some row has none, the block sweeps again without
// skipping, so that row gets the reference's uniform average.
//
// bf16 design (flash_fwd_wgmma_kernel): a block of 3 warpgroups owns 128
// query rows of one head.
//  * Warpgroup 0 is the producer; one of its threads issues TMA loads
//    (tensor maps over the strided [B, H|KV, T, hd] views, built on the
//    host per call, 128-byte swizzle, out-of-range rows zero-filled). Q is
//    loaded once; K and V tiles of 128 keys stream through a ring of 3
//    stages (2 at hd > 64) guarded by full/empty mbarriers, so the next
//    tile is in flight while one is multiplied. The producer also finds
//    each tile's position range with warp reductions (no block barrier;
//    the positions are loaded a tile ahead), skips masked tiles, and flags
//    the tiles that straddle the diagonal, the window edge or the ragged
//    end: only those get per-element masks.
//  * Warpgroups 1 and 2 consume, 64 query rows each: S = Q K^T by wgmma
//    m64n128k16 with both operands in shared memory (K-major); the online
//    softmax in registers (exp2 of pre-scaled logits on the SFU; O is
//    rescaled only when a row maximum moved); P rounded to bf16 and kept
//    in registers as wgmma's A operand; O += P V by wgmma m64n64k16 with V
//    in its row layout (the transposed-B mode for 16-bit types; no
//    transpose on store). Accumulators are f32.
//  * Head dims are held in 64-column (128-byte) swizzle blocks, zero-padded
//    in shared memory: hd 112 to 128, hd 32 to 64. S = Q K^T runs only the
//    real 16-deep steps; P V runs whole 64-column products, so 14 % of its
//    products at hd 112 fall on zero columns and are dropped.
//  * Epilogue: O / l is staged in shared memory (rows padded by 16 bytes,
//    free of bank conflicts) and written with 16-byte stores into the
//    output's strided view.
//
// f32 design (flash_fwd_kernel): scalar IEEE f32 FMAs on the CUDA cores (no
// TF32, which the 2e-5 check forbids), 64 x 64 tiles, 256 threads holding
// 4 x 4 logits each. It is bound by the CUDA cores' ~67 TFLOP/s and exists
// for the f32 checks, not for speed.

#include <climits>
#include <math.h>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "tma.cuh"

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
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
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

  float* lse_b = lse ? lse + ((int64_t)b * gridDim.y + h) * Tq : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Tq) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CP; ++c)
      ob[qi * so.t + (tx + 16 * c) * so.d] = from_float<T>(acc[i][c] / l);
    if (lse_b && tx == 0)
      lse_b[qi] = m_i[i] <= kNegInf ? INFINITY : m_i[i] + logf(l_i[i]);
  }
}


// ---------------------------------------------------------------------------
// bf16 on Hopper: TMA ring + wgmma, warp-specialised (see the note above).
// ---------------------------------------------------------------------------

constexpr int WBQ = 128;      // query rows per block (two consumer warpgroups)
constexpr int WBK = 128;      // keys per tile
constexpr int WSTAGES = 3;    // most K/V ring stages
constexpr int WNT = 384;      // producer warpgroup + two consumer warpgroups
constexpr int SW = 128;       // bytes per swizzled row (64 bf16)

template <int HD>
struct WCfg {
  static constexpr int BK = WBK;
  // Ring stages: 3, or 2 where three tiles of 128 columns would not fit.
  static constexpr int STAGES = HD > 64 ? 2 : WSTAGES;
  static constexpr int NCB = (HD + 63) / 64;        // 64-column blocks
  static constexpr int Q_CB = WBQ * SW;             // bytes of one Q block
  static constexpr int T_CB = BK * SW;              // bytes of one K/V block
  static constexpr int Q_BYTES = NCB * Q_CB;
  static constexpr int T_BYTES = NCB * T_CB;        // one K or V tile
  static constexpr int O_LD = HD + 8;               // staging row (bf16)
  static constexpr int O_BYTES = 64 * O_LD * 2;     // per consumer warpgroup
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * T_BYTES;
  static constexpr int OFF_O = OFF_V + STAGES * T_BYTES;
  static constexpr int SMEM = OFF_O + 2 * O_BYTES + 1024;  // + alignment slack
};

struct WShared {              // the small, statically allocated part
  uint64_t full[WSTAGES], empty[WSTAGES], q_full, decide;
  int kpos[WSTAGES][WBK];     // the tile's key positions
  int tile[WSTAGES];          // tile index, -1 marks the end of a sweep
  int masked[WSTAGES];        // 1: the tile needs per-element masks
  int lost;                   // some row met no admissible key
};

template <int HD>
__global__ void __launch_bounds__(WNT, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, int Tq, int Tk, int G, int window,
    float scale_log2, Strides so) {
  using C = WCfg<HD>;
  using bf16 = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  __shared__ WShared sh;
  // Swizzle atoms must sit on 1024-byte boundaries.
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + C::OFF_K;
  unsigned char* Vs = smem + C::OFF_V;

  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  // Heavier causal tiles (later queries) are scheduled first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * WBQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&sh.full[s], 1);
      mbar_init(&sh.empty[s], 8);        // the 8 consumer warps
    }
    mbar_init(&sh.q_full, 1);
    mbar_init(&sh.decide, 8);
    sh.lost = 0;
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid >= 32) return;
    if (lane == 0) {         // Q first: it depends on nothing
      mbar_arrive_expect_tx(&sh.q_full, C::Q_BYTES);
      for (int cb = 0; cb < C::NCB; ++cb)
        tma_load_4d(Qs + cb * C::Q_CB, &tq, &sh.q_full, cb * 64, q0, h, b);
    }
    // The block's query positions and the first tile's key positions are
    // loaded together; each later tile's key positions one tile ahead, so
    // their latency hides behind the previous tile's issue.
    constexpr int BK = C::BK, PL = BK / 32;          // positions per lane
    int nxt[PL];
#pragma unroll
    for (int j = 0; j < PL; ++j)
      nxt[j] = lane + 32 * j < Tk ? k_pos[lane + 32 * j] : 0;
    int qmn = INT_MAX, qmx = INT_MIN;
#pragma unroll
    for (int r = lane; r < WBQ; r += 32)
      if (q0 + r < Tq) {
        const int p = q_pos[q0 + r];
        qmn = min(qmn, p);
        qmx = max(qmx, p);
      }
    qmn = __reduce_min_sync(0xffffffffu, qmn);
    qmx = __reduce_max_sync(0xffffffffu, qmx);
    const int n_kt = (Tk + BK - 1) / BK;
    int stage = 0;
    uint32_t phase = 0;
    for (int pass = 0; pass < 2; ++pass) {
      if (pass == 1) {
#pragma unroll
        for (int j = 0; j < PL; ++j)
          nxt[j] = lane + 32 * j < Tk ? k_pos[lane + 32 * j] : 0;
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BK;
        int cur[PL], lo = INT_MAX, hi = INT_MIN;
#pragma unroll
        for (int j = 0; j < PL; ++j) {
          cur[j] = nxt[j];
          if (k0 + lane + 32 * j < Tk) {
            lo = min(lo, cur[j]);
            hi = max(hi, cur[j]);
          }
          const int kn = k0 + BK + lane + 32 * j;
          if (kt + 1 < n_kt) nxt[j] = kn < Tk ? k_pos[kn] : 0;
        }
        const int kmn = __reduce_min_sync(0xffffffffu, lo);
        const int kmx = __reduce_max_sync(0xffffffffu, hi);
        if (pass == 0 &&
            (kmn > qmx ||
             (window > 0 && (long long)kmx <= (long long)qmn - window)))
          continue;  // every pair in this tile is masked
        const bool interior =
            k0 + BK <= Tk && kmx <= qmn &&
            (window <= 0 || (long long)kmn > (long long)qmx - window);
        mbar_wait(&sh.empty[stage], phase ^ 1);
#pragma unroll
        for (int j = 0; j < PL; ++j) sh.kpos[stage][lane + 32 * j] = cur[j];
        if (lane == 0) {
          sh.tile[stage] = kt;
          sh.masked[stage] = !interior;
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(&sh.full[stage], 2 * C::T_BYTES);
          unsigned char* kd = Ks + stage * C::T_BYTES;
          unsigned char* vd = Vs + stage * C::T_BYTES;
          for (int cb = 0; cb < C::NCB; ++cb) {
            tma_load_4d(kd + cb * C::T_CB, &tk, &sh.full[stage], cb * 64, k0,
                        hk, b);
            tma_load_4d(vd + cb * C::T_CB, &tv, &sh.full[stage], cb * 64, k0,
                        hk, b);
          }
        }
        if (++stage == C::STAGES) { stage = 0; phase ^= 1; }
      }
      // End of the sweep: a stage with no data.
      mbar_wait(&sh.empty[stage], phase ^ 1);
      if (lane == 0) {
        sh.tile[stage] = -1;
        mbar_arrive(&sh.full[stage]);
      }
      if (++stage == C::STAGES) { stage = 0; phase ^= 1; }
      if (pass == 0) {
        mbar_wait(&sh.decide, 0);
        if (!*static_cast<volatile int*>(&sh.lost)) break;
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;                     // consumer 0 or 1
  const int wtid = tid - 128 * wg;           // thread within the warpgroup
  const int g = lane >> 2, t = lane & 3;
  const int r0 = cw * 64 + (wtid >> 5) * 16 + g;   // rows r0 and r0 + 8
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    qp[i] = q0 + r0 + 8 * i < Tq ? q_pos[q0 + r0 + 8 * i] : 0;
  const uint32_t q_base = smem_u32(Qs) + cw * 64 * SW;
  const uint32_t k_base = smem_u32(Ks), v_base = smem_u32(Vs);

  constexpr int NO = C::NCB * 32;            // O accumulator registers
  float acc[NO];
  float m_i[2], l_i[2];
  int stage = 0;
  uint32_t phase = 0;
  mbar_wait(&sh.q_full, 0);

  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_i[i] = kNegInf;
      l_i[i] = 0.f;
    }
#pragma unroll
    for (int x = 0; x < NO; ++x) acc[x] = 0.f;

    for (;;) {
      mbar_wait(&sh.full[stage], phase);
      const int kt = sh.tile[stage];
      if (kt < 0) {
        if (lane == 0) mbar_arrive(&sh.empty[stage]);
        if (++stage == C::STAGES) { stage = 0; phase ^= 1; }
        break;
      }
      const uint32_t kst = k_base + stage * C::T_BYTES;
      const uint32_t vst = v_base + stage * C::T_BYTES;
      constexpr int BK = C::BK, NS = BK / 2;      // S registers
      float s[NS];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        const uint64_t da =
            sw128_desc(q_base + (kk >> 2) * C::Q_CB + off, 16, 1024);
        const uint64_t db =
            sw128_desc(kst + (kk >> 2) * C::T_CB + off, 16, 1024);
        wgmma_ss_m64n128(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NS>(s);
      float mx[2] = {-INFINITY, -INFINITY};
      if (sh.masked[stage]) {
        const int* kp = sh.kpos[stage];
#pragma unroll
        for (int x = 0; x < NS; ++x) {
          const int i = (x >> 1) & 1;
          const int col = 8 * (x >> 2) + 2 * t + (x & 1);
          float v = s[x] * scale_log2;
          if (kt * BK + col >= Tk) {
            v = -INFINITY;
          } else {
            const int p = kp[col];
            if (!(p <= qp[i] && (window <= 0 || p > qp[i] - window)))
              v = kNegInf;
          }
          s[x] = v;
          mx[i] = fmaxf(mx[i], v);
        }
      } else {
#pragma unroll
        for (int x = 0; x < NS; ++x) {
          s[x] *= scale_log2;
          mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_i[i], mx[i]);
        alpha[i] = fast_exp2(m_i[i] - m_new);
        m_i[i] = m_new;
      }
      // Once the row maxima settle, alpha is 1 and the rescale (exact
      // either way) is skipped for the whole warp.
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < 2; ++i) l_i[i] *= alpha[i];   // this lane's share
#pragma unroll
        for (int x = 0; x < NO; ++x) acc[x] *= alpha[(x >> 1) & 1];
      }
#pragma unroll
      for (int x = 0; x < NS; ++x) {
        const int i = (x >> 1) & 1;
        s[x] = fast_exp2(s[x] - m_i[i]);
        l_i[i] += s[x];
      }
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kc][r] = pack_bf16x2(s[8 * kc + 2 * r], s[8 * kc + 2 * r + 1]);
      wgmma_fence();
      fence_regs<NO>(acc);
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
        for (int cb = 0; cb < C::NCB; ++cb)
          wgmma_rs_m64n64_tb(acc + 32 * cb, pa[kc],
                             sw128_desc(vst + cb * C::T_CB + kc * 2048,
                                        C::T_CB, 1024),
                             1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NO>(acc);
      if (lane == 0) mbar_arrive(&sh.empty[stage]);
      if (++stage == C::STAGES) { stage = 0; phase ^= 1; }
    }

    if (pass == 0) {
      // Only a row that met no admissible key still has m == -1e30.
      bool lost = false;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        lost |= q0 + r0 + 8 * i < Tq && m_i[i] <= kNegInf;
      if (__any_sync(0xffffffffu, lost) && lane == 0) atomicOr(&sh.lost, 1);
      if (lane == 0) mbar_arrive(&sh.decide);
      mbar_wait(&sh.decide, 0);
      if (!*static_cast<volatile int*>(&sh.lost)) break;
    }
  }

  // Epilogue: O / l through shared memory, 16-byte stores.
  bf16* Os = reinterpret_cast<bf16*>(smem + C::OFF_O + cw * C::O_BYTES);
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_i[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = 1.f / fmaxf(l, 1e-30f);
    // m is in the exp2 domain of the pre-scaled logits: natural-log LSE.
    const int qi = q0 + r0 + 8 * i;
    if (lse && t == 0 && qi < Tq)
      lse[((int64_t)b * gridDim.y + h) * Tq + qi] =
          m_i[i] <= kNegInf ? INFINITY
                            : (m_i[i] + log2f(l)) * 0.6931471805599453f;
  }
  const int rl = r0 - cw * 64;               // row within the warpgroup
#pragma unroll
  for (int x = 0; x < NO; x += 2) {
    const int i = (x >> 1) & 1;
    const int col = 8 * (x >> 2) + 2 * t;
    if (col < HD)
      *reinterpret_cast<uint32_t*>(Os + (rl + 8 * i) * C::O_LD + col) =
          pack_bf16x2(acc[x] * inv[i], acc[x + 1] * inv[i]);
  }
  named_barrier(1 + cw, 128);
  constexpr int CH = HD / 8;                 // 16-byte chunks per row
  bf16* ob = o + b * so.b + h * so.h;
  for (int idx = wtid; idx < 64 * CH; idx += 128) {
    const int r = idx / CH, c = idx % CH;
    const int qi = q0 + cw * 64 + r;
    if (qi < Tq)
      *reinterpret_cast<uint4*>(ob + qi * so.t + c * 8) =
          *reinterpret_cast<const uint4*>(Os + r * C::O_LD + c * 8);
  }
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         float* lse, const int* q_pos, const int* k_pos, int B,
                         int H, int KV, int Tq, int Tk, int window,
                         float scale, Strides sq, Strides sk, Strides sv,
                         Strides so, cudaStream_t stream) {
  static unsigned long long done = 0;
  const int smem = WCfg<HD>::SMEM;
  cudaError_t err = set_smem_once(flash_fwd_wgmma_kernel<HD>, smem, &done);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, HD, Tq, H, B, sq, WBQ) ||
      !make_map(&tk, k, HD, Tk, KV, B, sk, WCfg<HD>::BK) ||
      !make_map(&tv, v, HD, Tk, KV, B, sv, WCfg<HD>::BK))
    return cudaErrorInvalidValue;
  dim3 grid((Tq + WBQ - 1) / WBQ, H, B);
  flash_fwd_wgmma_kernel<HD><<<grid, WNT, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, q_pos, k_pos, Tq, Tk,
      H / KV, window, scale * 1.4426950408889634f, so);
  return cudaGetLastError();
}

// f32 goes to the scalar kernel, bf16 to the wgmma one.
template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int* q_pos, const int* k_pos, int B,
                   int H, int KV, int Tq, int Tk, int window, float scale,
                   Strides sq, Strides sk, Strides sv, Strides so,
                   cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_wgmma<HD>(q, k, v, o, lse, q_pos, k_pos, B, H, KV, Tq, Tk,
                            window, scale, sq, sk, sv, so, stream);
  } else {
    static unsigned long long done = 0;
    const int smem = smem_floats<HD>() * (int)sizeof(float);
    cudaError_t err = set_smem_once(flash_fwd_kernel<T, HD>, smem, &done);
    if (err != cudaSuccess) return err;
    dim3 grid((Tq + BQ - 1) / BQ, H, B);
    flash_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, q_pos, k_pos, Tq,
        Tk, H / KV, window, scale, sq, sk, sv, so);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, float* lse, const int* q_pos,
                        const int* k_pos, int B, int H, int KV, int Tq, int Tk,
                        int window, float scale, Strides sq, Strides sk,
                        Strides sv, Strides so, cudaStream_t stream) {
#define FA_LAUNCH(HD)                                                        \
  launch<T, HD>(q, k, v, o, lse, q_pos, k_pos, B, H, KV, Tq, Tk, window,     \
                scale, sq, sk, sv, so, stream)
  switch (hd) {
    case 32: return FA_LAUNCH(32);
    case 64: return FA_LAUNCH(64);
    case 112: return FA_LAUNCH(112);
    case 128: return FA_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef FA_LAUNCH
}

}  // namespace

// q [B, H, Tq, hd], k and v [B, KV, Tk, hd], o [B, H, Tq, hd], each given by
// its element strides; q_pos [Tq] and k_pos [Tk] int32, contiguous. lse,
// when not null, receives each row's natural-log log-sum-exp of the scaled
// logits, [B, H, Tq] f32 contiguous, +inf for a row with no admissible key
// (the backward gives that row the uniform average's gradient); serving
// passes null. Launches on `stream` and returns cudaGetLastError() after the
// launch.
EXPORT int flash_attention_fwd(
    int dtype, int hd, const void* q, const void* k, const void* v, void* o,
    float* lse, const int* q_pos, const int* k_pos, int B, int H, int KV,
    int Tq, int Tk, int window, float scale,
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
    return dispatch_hd<float>(hd, q, k, v, o, lse, q_pos, k_pos, B, H, KV, Tq,
                              Tk, window, scale, sq, sk, sv, so, st);
  if (dtype == kBFloat16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, lse, q_pos, k_pos, B, H,
                                      KV, Tq, Tk, window, scale, sq, sk, sv,
                                      so, st);
  return cudaErrorInvalidValue;
}
