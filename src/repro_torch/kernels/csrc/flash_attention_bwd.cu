// Flash attention backward: dQ, dK and dV of causal grouped-query attention
// with an online softmax, for Hopper (sm_90a).
//
// Replaces: nothing on the TPU side. The reference trains by differentiating
// its XLA attention twin (repro/training/train_loop.py via jax.value_and_grad);
// none of its Pallas kernels has a backward. This is the backward of
// flash_attention.cu (which replaces repro/kernels/flash_attention/kernel.py,
// `flash_attention`), for the port's training path.
//
// What it computes, per (b, h), with s = q k^T / sqrt(hd) masked as the
// forward masks it (k_pos <= q_pos and, with window > 0, k_pos > q_pos -
// window; masked logits are the constant -1e30), P = exp(s - lse) from the
// forward's natural-log LSE and D = rowsum(dO * O):
//     dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),
//     dQ = dS K / sqrt(hd),  dK = dS^T Q / sqrt(hd),
// dK and dV summed over the G query heads of each KV head. A row with no
// admissible key (LSE +inf, the forward's mark) took the uniform average of
// v over all Tk keys: it gives every key dV += dO / Tk, and nothing to dQ or
// dK, since all its logits are the constant -1e30.
//
// What bounds it on the H100: five products of 2 * Tq * Tk * hd operations
// per head over the admitted (query, key) pairs, against reading q, k, v, o,
// dO once and writing dq, dk, dv once: at training lengths (T 2048) ~T/2
// operations per byte, far above the ~295 FLOP/byte ridge, so bf16 is bound
// by the tensor cores' 989 TFLOP/s. This design runs seven (S and dP are
// computed twice, see the dQ items below), so its own bound is 7/5 of that.
//
// Design (deterministic: no float atomics anywhere, every gradient element
// is summed by one thread in a fixed order, so two runs are bit-identical).
// Two launches:
//  1. bwd_prep_kernel: D = rowsum(dO * O) in f32 per query row, from the
//     bf16 O (16-byte loads, a lane group per row); per 32-row query chunk
//     whether a row of it is lost (LSE +inf), per (b, h); the min and max
//     position of each 32-row query chunk and each 64-key chunk, which the
//     main kernel reads to skip tiles whose every pair is masked.
//  2. bwd_wgmma_kernel (bf16): one list of work items, dK/dV items first,
//     then dQ items, each list longest first; one block per item.
//   - A dK/dV item is (128-key tile, KV head, b). It streams (query tile,
//     head of the group) items, query tiles outer, and keeps dK and dV of
//     its keys in registers over all G heads, so GQA needs neither atomics
//     nor a workspace. S^T = K Q^T and dP^T = V dO^T are wgmma products
//     with both operands in shared memory (K-major); P^T = exp(S^T - lse)
//     and dS^T = P^T (dP^T - D) are formed in registers and rounded to bf16
//     as wgmma's A operand (as the forward rounds P); dV += P^T dO and dK +=
//     dS^T Q read dO and Q in their row layout through the transposed-B
//     mode.
//   - A dQ item is (128-row query tile, head, b), streaming the admitted key
//     tiles: S = Q K^T and dP = dO V^T again (shared x shared), dS in
//     registers, dQ += dS K (transposed-B). The recomputation (7 products,
//     not 5) keeps dQ out of float atomics.
//   Both are warp-specialised like the forward: warpgroup 0 is a producer
//   whose one warp issues TMA loads (tensor maps over the strided [B,
//   heads, T, hd] views, 128-byte swizzle, rows past T zero-filled) into a
//   ring of 3 stages guarded by full/empty mbarriers, and writes each
//   stage's per-row values (lse * log2 e, D and positions for dK/dV; key
//   positions for dQ) beside it; it tests 32 tiles at a time for admission
//   (one lane each, from the prep's ranges, a ballot) and flags the tiles
//   that straddle the diagonal, the window edge, a ragged end or a lost
//   row: only those get per-element masks. Warpgroups 1 and 2 consume, 64
//   keys (dK/dV) or 64 query rows (dQ) each, with setmaxnreg 240 / 24
//   between consumers and producer. Accumulators are f32 in registers. The
//   elementwise part is branch-free (a masked tile and an unmasked one
//   each have their own loop), so the exponentials of many elements
//   overlap; a branch per element pair would serialise them.
//  Head dims: the forward's 32, 64, 112, 128, held as 64-column (128-byte)
//  swizzle blocks zero-padded in shared memory (hd 32 to 64, hd 112 to 128).
//  The products that contract over hd (S, dP) run only the real 16-deep
//  steps; the ones whose output columns are hd (dV, dK, dQ) run whole
//  padded widths: at hd 112, 16 of 128 columns (12.5 % of 3 of the 7
//  products) fall on zeros, at hd 32 half of them. Streamed tiles are 128
//  rows at a padded hd of 64 and 64 rows at 128, which keeps a consumer's
//  accumulators at 192 f32 registers (dK, dV: hd_p / 2 each; S^T, dP^T:
//  rows / 2 each). ptxas -v (printed by chip_smoke.py phase 2) reports no
//  spills in any instantiation at 240 consumer registers; at 232 the hd
//  128 one spilled 12 bytes.
//  Balance: each part of the list runs longest first (block index order:
//  key tile 0, which sees every causal query tile, first), so the block
//  scheduler, which hands the next block to the first SM that frees, does
//  list scheduling, and the short dQ items fill the SMs the long dK/dV
//  ones leave idle at the end. At the training shape (B 8, H 14, KV 2,
//  T 2048) the dK/dV part is 256 blocks; the block of key tile j walks
//  7 (16 - j) tile steps (112 down to 7), 15,232 in all, 115.4 per SM over
//  132 SMs; list scheduling longest first ends after 121 step-times
//  counting one step of set-up per block (tools/bwd_schedule.py); the
//  earlier mma.sync design's grid (one block per 64-key tile, key tile
//  fastest in index order) ends after 147.5 of the same step-times.
//  f32: scalar IEEE f32 FMAs on the CUDA cores (no TF32: the f32 checks hold
//  it at 2e-5), 16 x 16 threads over 64 x 32 tiles; it exists for the tight
//  checks, not for speed.
// Operands are read through their strides (unit last stride; the bf16 path
// needs 16-byte-aligned bases and strides, which TMA requires).

#include <climits>
#include <math.h>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "tma.cuh"

namespace {

constexpr int PREP_ROWS = 32;   // query rows per prep block and per lost flag
constexpr int KCH = 64;         // keys per position-range chunk
constexpr float kLog2e = 1.4426950408889634f;

// Position range [lo, hi] of a tile, INT_MAX / INT_MIN when it is empty.
struct Range {
  int lo, hi;
};

// Whether some (query, key) pair of a query range and a key range is
// admissible under the causal/window bound.
__device__ __forceinline__ bool admits(Range q, Range k, int window) {
  if (q.lo > q.hi || k.lo > k.hi) return false;
  if (k.lo > q.hi) return false;
  if (window > 0 && (long long)k.hi <= (long long)q.lo - window) return false;
  return true;
}

// Whether every (query, key) pair of the two ranges is admissible.
__device__ __forceinline__ bool all_admitted(Range q, Range k, int window) {
  return q.lo <= q.hi && k.lo <= k.hi && k.hi <= q.lo &&
         (window <= 0 || (long long)k.lo > (long long)q.hi - window);
}

__device__ __forceinline__ bool admissible(int kp, int qp, int window) {
  return kp <= qp && (window <= 0 || kp > qp - window);
}

// Union of the ranges of chunks [c0, c1) (clipped to n) of a prep range
// array laid out lo, hi, lo, hi, ...
__device__ __forceinline__ Range chunk_range(const int* ranges, int c0,
                                             int c1, int n) {
  Range r{INT_MAX, INT_MIN};
  for (int c = c0; c < c1 && c < n; ++c) {
    r.lo = min(r.lo, ranges[2 * c]);
    r.hi = max(r.hi, ranges[2 * c + 1]);
  }
  return r;
}

// ------------------------------------------------------------------- prep

// grid (max(#32-row query chunks, #64-key chunks), H, B), 256 threads: D
// and the lost flags of 32 query rows of (b, h); blocks of (h, b) = (0, 0)
// also record the position ranges of query chunk x and key chunk x.
template <typename T, int HD>
__global__ void __launch_bounds__(256) bwd_prep_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ Dsum,
    int* __restrict__ lost, int* __restrict__ qrange,
    int* __restrict__ krange, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, int Tq, int Tk, Strides so,
    Strides sdo) {
  const int x = blockIdx.x, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_qt = (Tq + PREP_ROWS - 1) / PREP_ROWS;
  const int n_kt = (Tk + KCH - 1) / KCH;
  if (h == 0 && b == 0 && warp == 0) {
    if (x < n_qt) {
      const int r = x * PREP_ROWS + lane;
      const bool in = r < Tq;
      const int p = in ? q_pos[r] : 0;
      const int lo = __reduce_min_sync(0xffffffffu, in ? p : INT_MAX);
      const int hi = __reduce_max_sync(0xffffffffu, in ? p : INT_MIN);
      if (lane == 0) {
        qrange[2 * x] = lo;
        qrange[2 * x + 1] = hi;
      }
    }
    if (x < n_kt) {
      int lo = INT_MAX, hi = INT_MIN;
      for (int j = lane; j < KCH; j += 32) {
        const int kk = x * KCH + j;
        if (kk < Tk) {
          lo = min(lo, k_pos[kk]);
          hi = max(hi, k_pos[kk]);
        }
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if (lane == 0) {
        krange[2 * x] = lo;
        krange[2 * x + 1] = hi;
      }
    }
  }
  if (x >= n_qt) return;       // uniform per block
  const int64_t bh = (int64_t)b * H + h;
  int my_lost = 0;
  if constexpr (sizeof(T) == 4) {
    // f32: 8 warps x 4 rows, lanes over the head dim: the order the f32
    // checks were set against (a row that sees one key has dP - D at the
    // f32 noise level, held to the plain version's).
    for (int rr = 0; rr < PREP_ROWS / 8; ++rr) {
      const int r = x * PREP_ROWS + warp * (PREP_ROWS / 8) + rr;
      if (r >= Tq) break;
      const T* orow = o + b * so.b + h * so.h + r * so.t;
      const T* drow = dout + b * sdo.b + h * sdo.h + r * sdo.t;
      float acc = 0.f;
#pragma unroll
      for (int d = lane; d < HD; d += 32)
        acc = fmaf(to_float(orow[d]), to_float(drow[d]), acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        Dsum[bh * Tq + r] = acc;
        if (isinf(lse[bh * Tq + r])) my_lost = 1;
      }
    }
  } else {
    // bf16: 8 warps x 4 rows. A row's 16-byte chunks go to a group of GS
    // lanes (the power of two that holds them), so a warp reads 32 / GS
    // rows at once.
    constexpr int VEC = 8, CH = HD / VEC;
    constexpr int GS = CH > 8 ? 16 : CH > 4 ? 8 : 4;
    constexpr int RW = PREP_ROWS / 8, RI = 32 / GS;
    const int c = lane % GS;
#pragma unroll
    for (int it = 0; it < (RW + RI - 1) / RI; ++it) {
      const int rr = it * RI + lane / GS;
      const int r = x * PREP_ROWS + warp * RW + rr;
      const bool in = rr < RW && r < Tq;
      float acc = 0.f;
      if (in && c < CH) {
        const uint4 ov = *reinterpret_cast<const uint4*>(
            o + b * so.b + h * so.h + r * so.t + c * VEC);
        const uint4 dv = *reinterpret_cast<const uint4*>(
            dout + b * sdo.b + h * sdo.h + r * sdo.t + c * VEC);
        const T* oe = reinterpret_cast<const T*>(&ov);
        const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc = fmaf(to_float(oe[e]), to_float(de[e]), acc);
      }
#pragma unroll
      for (int off = GS / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (in && c == 0) {
        Dsum[bh * Tq + r] = acc;
        if (isinf(lse[bh * Tq + r])) my_lost = 1;
      }
    }
  }
  const int any_lost = __syncthreads_or(my_lost);
  if (tid == 0) lost[bh * n_qt + x] = any_lost;
}

// ------------------------------------------------------------ bf16 kernels

constexpr int WNT = 384;        // producer warpgroup + two consumer warpgroups
constexpr int SW = 128;         // bytes per swizzled row (64 bf16)
constexpr int OWN = 128;        // keys of a dK/dV block; query rows of a dQ one
constexpr int STAGES = 3;       // ring stages
constexpr int MAX_BS = 128;     // most rows of a streamed tile

template <int HD>
struct BCfg {
  static constexpr int HDP = HD <= 64 ? 64 : 128;   // padded head dim
  static constexpr int NCB = HDP / 64;              // 64-column blocks
  static constexpr int KS = HD / 16;                // real 16-deep steps
  static constexpr int BS = HDP == 64 ? 128 : 64;   // rows of a streamed tile
  static constexpr int OWN_CB = OWN * SW;           // bytes of one own block
  static constexpr int STR_CB = BS * SW;            // ... of a streamed one
  static constexpr int OWN_BYTES = NCB * OWN_CB;    // one own tile
  static constexpr int STR_BYTES = NCB * STR_CB;    // one streamed tile
  static constexpr int OFF_RING = 2 * OWN_BYTES;    // stage s: 2 tiles
  static constexpr int SMEM =
      OFF_RING + STAGES * 2 * STR_BYTES + 1024;     // + alignment slack
};

struct BShared {                // the small, statically allocated part
  uint64_t full[STAGES], empty[STAGES], own_full;
  int tile[STAGES];             // streamed item, -1 marks the end
  int masked[STAGES];           // 1: the tile needs per-element masks
  float lse2[STAGES][MAX_BS];   // dK/dV: lse * log2 e per query (inf: lost)
  float dsum[STAGES][MAX_BS];   // dK/dV: D per query
  int pos[STAGES][MAX_BS];      // dK/dV: query positions; dQ: key positions
};

// The tensor maps of one backward call: Q and dO with boxes of a streamed
// tile's rows (dK/dV) and of OWN rows (dQ), K and V the other way round.
struct BwdMaps {
  CUtensorMap q_str, do_str, k_own, v_own, q_own, do_own, k_str, v_str;
};

struct BwdArgs {
  const float* lse;
  const float* Dsum;
  const int *lost, *qrange, *krange, *q_pos, *k_pos;
  __nv_bfloat16 *dq, *dk, *dv;
  int B, H, KV, Tq, Tk, window, n_kv;
  float scale;
  Strides sdq, sdk, sdv;
};

// wgmma by the width N of its output.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64) wgmma_ss_m64n64(d, da, db, scale_d);
  else wgmma_ss_m64n128(d, da, db, scale_d);
}
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_rs_m64n64_tb(d, a, db, scale_d);
  else wgmma_rs_m64n128_tb(d, a, db, scale_d);
}

// acc (64 x N) = A B^T over the first 16 * KS columns: A 64 rows of a
// swizzled own tile (a0: their first block), B the rows of a streamed tile
// (b0); blocks of 64 columns a_cb / b_cb bytes apart.
template <int HD, int N>
__device__ __forceinline__ void product_abt(float* acc, uint32_t a0, int a_cb,
                                            uint32_t b0, int b_cb) {
#pragma unroll
  for (int kk = 0; kk < BCfg<HD>::KS; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    wgmma_ss<N>(acc, sw128_desc(a0 + (kk >> 2) * a_cb + off, 16, 1024),
                sw128_desc(b0 + (kk >> 2) * b_cb + off, 16, 1024), kk > 0);
  }
}

// acc (64 x hd_p) += X B: X (64 x 16 * K16, bf16 pairs in registers in
// wgmma's A layout) times the 16 * K16 rows of a swizzled tile at b0
// (blocks of 64 columns b_cb bytes apart) in its row layout.
template <int HD, int K16>
__device__ __forceinline__ void product_xb(float* acc,
                                           const uint32_t (*x)[4],
                                           uint32_t b0, int b_cb) {
  constexpr int HDP = BCfg<HD>::HDP;
#pragma unroll
  for (int kc = 0; kc < K16; ++kc)
    wgmma_rs_tb<HDP>(acc, x[kc], sw128_desc(b0 + kc * 2048, b_cb, 1024), 1);
}

// Store a consumer's 64 x hd accumulator (rows row0.., scaled) as bf16 into
// a strided [T, hd] matrix; rows past T and padded columns are dropped.
template <int HD>
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, int64_t st,
                                           const float* acc, float scale,
                                           int row0, int T, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int x = 0; x < BCfg<HD>::HDP / 2; x += 2) {
    const int row = row0 + 8 * ((x >> 1) & 1);
    const int col = 8 * (x >> 2) + 2 * t;
    if (col < HD && row < T)
      *reinterpret_cast<uint32_t*>(dst + row * st + col) =
          pack_bf16x2(acc[x] * scale, acc[x + 1] * scale);
  }
}

__device__ __forceinline__ void init_barriers(BShared& sh) {
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(&sh.full[s], 1);
    mbar_init(&sh.empty[s], 8);        // the 8 consumer warps
  }
  mbar_init(&sh.own_full, 1);
  mbar_init_fence();
}

// One dK/dV work item (see the note): `blk` is its place in the list.
template <int HD>
__device__ __forceinline__ void dkdv_block(const BwdMaps& m, const BwdArgs& a,
                                           int blk, unsigned char* smem,
                                           BShared& sh) {
  using C = BCfg<HD>;
  constexpr int BS = C::BS;
  const CUtensorMap &tq = m.q_str, &tdo = m.do_str, &tk = m.k_own,
                    &tv = m.v_own;
  const float* __restrict__ lse = a.lse;
  const float* __restrict__ Dsum = a.Dsum;
  const int *__restrict__ lost = a.lost, *__restrict__ qrange = a.qrange,
            *__restrict__ krange = a.krange, *__restrict__ q_pos = a.q_pos,
            *__restrict__ k_pos = a.k_pos;
  const int B = a.B, H = a.H, KV = a.KV, Tq = a.Tq, Tk = a.Tk;
  const int window = a.window;
  const float scale = a.scale;
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + C::OWN_BYTES;
  unsigned char* ring = smem + C::OFF_RING;

  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  const int G = H / KV;
  // Longest first: key tile 0 sees every causal query tile.
  const int kt = blk / (KV * B), rem = blk % (KV * B);
  const int kvh = rem % KV, b = rem / KV, k0 = kt * OWN;

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid >= 32) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sh.own_full, 2 * C::OWN_BYTES);
      for (int cb = 0; cb < C::NCB; ++cb) {
        tma_load_4d(Ks + cb * C::OWN_CB, &tk, &sh.own_full, cb * 64, k0, kvh,
                    b);
        tma_load_4d(Vs + cb * C::OWN_CB, &tv, &sh.own_full, cb * 64, k0, kvh,
                    b);
      }
    }
    const int n_q32 = (Tq + PREP_ROWS - 1) / PREP_ROWS;
    const Range kr = chunk_range(krange, k0 / KCH, (k0 + OWN) / KCH,
                                 (Tk + KCH - 1) / KCH);
    const bool k_full = k0 + OWN <= Tk;
    const int n_items = (Tq + BS - 1) / BS * G;
    int stage = 0;
    uint32_t phase = 0;
    for (int base = 0; base < n_items; base += 32) {
      // Lane l decides item base + l: (query tile, head of the group).
      const int it = base + lane;
      bool take = false, plain = false;
      if (it < n_items) {
        const int x = it / G, hh = kvh * G + it % G;
        const int c0 = x * (BS / PREP_ROWS), c1 = c0 + BS / PREP_ROWS;
        const Range qr = chunk_range(qrange, c0, c1, n_q32);
        bool any_lost = false;
        for (int c = c0; c < c1 && c < n_q32; ++c)
          any_lost |= lost[((int64_t)b * H + hh) * n_q32 + c] != 0;
        take = any_lost || admits(qr, kr, window);
        plain = !any_lost && k_full && (x + 1) * BS <= Tq &&
                all_admitted(qr, kr, window);
      }
      uint32_t todo = __ballot_sync(0xffffffffu, take);
      const uint32_t plains = __ballot_sync(0xffffffffu, plain);
      while (todo) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        const int item = base + j, hh = kvh * G + item % G;
        const int q0 = item / G * BS;
        const int64_t bh = (int64_t)b * H + hh;
        mbar_wait(&sh.empty[stage], phase ^ 1);
        for (int r = lane; r < BS; r += 32) {
          const int qi = q0 + r;
          const bool in = qi < Tq;   // a row past Tq: dO is zero there
          sh.lse2[stage][r] = in ? lse[bh * Tq + qi] * kLog2e : INFINITY;
          sh.dsum[stage][r] = in ? Dsum[bh * Tq + qi] : 0.f;
          sh.pos[stage][r] = in ? q_pos[qi] : 0;
        }
        if (lane == 0) {
          sh.tile[stage] = item;
          sh.masked[stage] = !((plains >> j) & 1);
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(&sh.full[stage], 2 * C::STR_BYTES);
          unsigned char* qd = ring + stage * 2 * C::STR_BYTES;
          unsigned char* dd = qd + C::STR_BYTES;
          for (int cb = 0; cb < C::NCB; ++cb) {
            tma_load_4d(qd + cb * C::STR_CB, &tq, &sh.full[stage], cb * 64,
                        q0, hh, b);
            tma_load_4d(dd + cb * C::STR_CB, &tdo, &sh.full[stage], cb * 64,
                        q0, hh, b);
          }
        }
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
    // End of the sweep: a stage with no data.
    mbar_wait(&sh.empty[stage], phase ^ 1);
    if (lane == 0) {
      sh.tile[stage] = -1;
      mbar_arrive(&sh.full[stage]);
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1, wtid = tid - 128 * wg;
  const int t = lane & 3;
  const int r0 = cw * 64 + (wtid >> 5) * 16 + (lane >> 2);  // rows r0, r0+8
  int kp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kk = k0 + r0 + 8 * i;
    kp[i] = kk < Tk ? k_pos[kk] : 0;   // a key past Tk is never stored
  }
  const float scale_log2 = scale * kLog2e, inv_tk = 1.f / (float)Tk;
  const uint32_t k_base = smem_u32(Ks) + cw * 64 * SW;
  const uint32_t v_base = smem_u32(Vs) + cw * 64 * SW;
  const uint32_t ring_base = smem_u32(ring);

  constexpr int NO = C::HDP / 2, NS = BS / 2;
  float dk_acc[NO], dv_acc[NO];
#pragma unroll
  for (int x = 0; x < NO; ++x) dk_acc[x] = dv_acc[x] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  mbar_wait(&sh.own_full, 0);

  for (;;) {
    mbar_wait(&sh.full[stage], phase);
    if (sh.tile[stage] < 0) break;
    const uint32_t qst = ring_base + stage * 2 * C::STR_BYTES;
    const uint32_t dst = qst + C::STR_BYTES;
    // S^T = K Q^T and dP^T = V dO^T: rows = this warpgroup's 64 keys.
    float s[NS], dp[NS];
    wgmma_fence();
    product_abt<HD, BS>(s, k_base, C::OWN_CB, qst, C::STR_CB);
    product_abt<HD, BS>(dp, v_base, C::OWN_CB, dst, C::STR_CB);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NS>(s);
    fence_regs<NS>(dp);

    // P^T and dS^T, rounded to bf16 pairs in wgmma's A layout. Branch-free,
    // so the exponentials of many elements overlap: a lost column (lse +inf)
    // gets exp2(-inf) = 0, hence dS^T = 0, and then P^T = 1 / Tk.
    const float* l2 = sh.lse2[stage];
    const float* dd = sh.dsum[stage];
    const int* qp = sh.pos[stage];
    uint32_t pa[BS / 16][4], sa[BS / 16][4];
    if (sh.masked[stage]) {
#pragma unroll
      for (int x = 0; x < NS; x += 2) {
        const int i = (x >> 1) & 1, col = 8 * (x >> 2) + 2 * t;
        const float2 lv = *reinterpret_cast<const float2*>(l2 + col);
        const float2 dv2 = *reinterpret_cast<const float2*>(dd + col);
        const int2 pv = *reinterpret_cast<const int2*>(qp + col);
        const float lc[2] = {lv.x, lv.y}, dc[2] = {dv2.x, dv2.y};
        const int pc[2] = {pv.x, pv.y};
        float p[2], ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          p[c] = fast_exp2(fmaf(s[x + c], scale_log2, -lc[c]));
          if (!admissible(kp[i], pc[c], window)) p[c] = 0.f;
          ds[c] = p[c] * (dp[x + c] - dc[c]);
          if (lc[c] == INFINITY) p[c] = inv_tk;
        }
        pa[x >> 3][(x >> 1) & 3] = pack_bf16x2(p[0], p[1]);
        sa[x >> 3][(x >> 1) & 3] = pack_bf16x2(ds[0], ds[1]);
      }
    } else {
#pragma unroll
      for (int x = 0; x < NS; x += 2) {
        const int col = 8 * (x >> 2) + 2 * t;
        const float2 lv = *reinterpret_cast<const float2*>(l2 + col);
        const float2 dv2 = *reinterpret_cast<const float2*>(dd + col);
        const float p0 = fast_exp2(fmaf(s[x], scale_log2, -lv.x));
        const float p1 = fast_exp2(fmaf(s[x + 1], scale_log2, -lv.y));
        pa[x >> 3][(x >> 1) & 3] = pack_bf16x2(p0, p1);
        sa[x >> 3][(x >> 1) & 3] = pack_bf16x2(p0 * (dp[x] - dv2.x),
                                               p1 * (dp[x + 1] - dv2.y));
      }
    }

    // dV += P^T dO and dK += dS^T Q.
    wgmma_fence();
    fence_regs<NO>(dv_acc);
    fence_regs<NO>(dk_acc);
    product_xb<HD, BS / 16>(dv_acc, pa, dst, C::STR_CB);
    product_xb<HD, BS / 16>(dk_acc, sa, qst, C::STR_CB);
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags<BS / 16>(pa);
    fence_frags<BS / 16>(sa);
    fence_regs<NO>(dv_acc);
    fence_regs<NO>(dk_acc);
    if (lane == 0) mbar_arrive(&sh.empty[stage]);
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }

  store_tile<HD>(a.dk + b * a.sdk.b + kvh * a.sdk.h, a.sdk.t, dk_acc, scale,
                 k0 + r0, Tk, lane);
  store_tile<HD>(a.dv + b * a.sdv.b + kvh * a.sdv.h, a.sdv.t, dv_acc, 1.f,
                 k0 + r0, Tk, lane);
}

// One dQ work item: `blk` is its place in the dQ part of the list.
template <int HD>
__device__ __forceinline__ void dq_block(const BwdMaps& m, const BwdArgs& a,
                                         int blk, unsigned char* smem,
                                         BShared& sh) {
  using C = BCfg<HD>;
  constexpr int BS = C::BS;
  const CUtensorMap &tq = m.q_own, &tdo = m.do_own, &tk = m.k_str,
                    &tv = m.v_str;
  const float* __restrict__ lse = a.lse;
  const float* __restrict__ Dsum = a.Dsum;
  const int *__restrict__ qrange = a.qrange, *__restrict__ krange = a.krange,
            *__restrict__ q_pos = a.q_pos, *__restrict__ k_pos = a.k_pos;
  const int B = a.B, H = a.H, KV = a.KV, Tq = a.Tq, Tk = a.Tk;
  const int window = a.window;
  const float scale = a.scale;
  unsigned char* Qs = smem;
  unsigned char* Ds = smem + C::OWN_BYTES;
  unsigned char* ring = smem + C::OFF_RING;

  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  // Longest first: the last query tile sees the most causal key tiles.
  const int n_qt = (Tq + OWN - 1) / OWN;
  const int qt = n_qt - 1 - blk / (H * B), rem = blk % (H * B);
  const int h = rem % H, b = rem / H, hk = h / (H / KV), q0 = qt * OWN;

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid >= 32) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sh.own_full, 2 * C::OWN_BYTES);
      for (int cb = 0; cb < C::NCB; ++cb) {
        tma_load_4d(Qs + cb * C::OWN_CB, &tq, &sh.own_full, cb * 64, q0, h,
                    b);
        tma_load_4d(Ds + cb * C::OWN_CB, &tdo, &sh.own_full, cb * 64, q0, h,
                    b);
      }
    }
    const int n_k64 = (Tk + KCH - 1) / KCH;
    const Range qr = chunk_range(qrange, q0 / PREP_ROWS,
                                 (q0 + OWN) / PREP_ROWS,
                                 (Tq + PREP_ROWS - 1) / PREP_ROWS);
    const int n_kt = (Tk + BS - 1) / BS;
    int stage = 0;
    uint32_t phase = 0;
    for (int base = 0; base < n_kt; base += 32) {
      const int y = base + lane;
      bool take = false, plain = false;
      if (y < n_kt) {
        const Range kr = chunk_range(krange, y * (BS / KCH),
                                     (y + 1) * (BS / KCH), n_k64);
        take = admits(qr, kr, window);
        // A lost row or one past Tq has lse +inf, so P = 0 there unmasked.
        plain = (y + 1) * BS <= Tk && all_admitted(qr, kr, window);
      }
      uint32_t todo = __ballot_sync(0xffffffffu, take);
      const uint32_t plains = __ballot_sync(0xffffffffu, plain);
      while (todo) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        const int k0 = (base + j) * BS;
        mbar_wait(&sh.empty[stage], phase ^ 1);
        for (int r = lane; r < BS; r += 32)
          sh.pos[stage][r] = k0 + r < Tk ? k_pos[k0 + r] : INT_MAX;
        if (lane == 0) {
          sh.tile[stage] = base + j;
          sh.masked[stage] = !((plains >> j) & 1);
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(&sh.full[stage], 2 * C::STR_BYTES);
          unsigned char* kd = ring + stage * 2 * C::STR_BYTES;
          unsigned char* vd = kd + C::STR_BYTES;
          for (int cb = 0; cb < C::NCB; ++cb) {
            tma_load_4d(kd + cb * C::STR_CB, &tk, &sh.full[stage], cb * 64,
                        k0, hk, b);
            tma_load_4d(vd + cb * C::STR_CB, &tv, &sh.full[stage], cb * 64,
                        k0, hk, b);
          }
        }
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
    mbar_wait(&sh.empty[stage], phase ^ 1);
    if (lane == 0) {
      sh.tile[stage] = -1;
      mbar_arrive(&sh.full[stage]);
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1, wtid = tid - 128 * wg;
  const int t = lane & 3;
  const int r0 = cw * 64 + (wtid >> 5) * 16 + (lane >> 2);  // rows r0, r0+8
  const int64_t bh = (int64_t)b * H + h;
  // This thread's rows: position, lse * log2 e (+inf: lost or past Tq, so
  // P = 0 and the row gets no dQ), D.
  int qp[2];
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + 8 * i;
    const bool in = qi < Tq;
    qp[i] = in ? q_pos[qi] : 0;
    lr[i] = in ? lse[bh * Tq + qi] * kLog2e : INFINITY;
    dr[i] = in ? Dsum[bh * Tq + qi] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_base = smem_u32(Qs) + cw * 64 * SW;
  const uint32_t do_base = smem_u32(Ds) + cw * 64 * SW;
  const uint32_t ring_base = smem_u32(ring);

  constexpr int NO = C::HDP / 2, NS = BS / 2;
  float dq_acc[NO];
#pragma unroll
  for (int x = 0; x < NO; ++x) dq_acc[x] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  mbar_wait(&sh.own_full, 0);

  for (;;) {
    mbar_wait(&sh.full[stage], phase);
    if (sh.tile[stage] < 0) break;
    const uint32_t kst = ring_base + stage * 2 * C::STR_BYTES;
    const uint32_t vst = kst + C::STR_BYTES;
    float s[NS], dp[NS];
    wgmma_fence();
    product_abt<HD, BS>(s, q_base, C::OWN_CB, kst, C::STR_CB);
    product_abt<HD, BS>(dp, do_base, C::OWN_CB, vst, C::STR_CB);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NS>(s);
    fence_regs<NS>(dp);

    // dS in two branch-free loops (masked tiles and the rest), so the
    // exponentials of many elements overlap.
    const int* kps = sh.pos[stage];
    uint32_t sa[BS / 16][4];
    if (sh.masked[stage]) {
#pragma unroll
      for (int x = 0; x < NS; x += 2) {
        const int i = (x >> 1) & 1, col = 8 * (x >> 2) + 2 * t;
        const int2 kv = *reinterpret_cast<const int2*>(kps + col);
        const int kc2[2] = {kv.x, kv.y};
        float ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float p = fast_exp2(fmaf(s[x + c], scale_log2, -lr[i]));
          if (!admissible(kc2[c], qp[i], window)) p = 0.f;
          ds[c] = p * (dp[x + c] - dr[i]);
        }
        sa[x >> 3][(x >> 1) & 3] = pack_bf16x2(ds[0], ds[1]);
      }
    } else {
#pragma unroll
      for (int x = 0; x < NS; x += 2) {
        const int i = (x >> 1) & 1;
        sa[x >> 3][(x >> 1) & 3] = pack_bf16x2(
            fast_exp2(fmaf(s[x], scale_log2, -lr[i])) * (dp[x] - dr[i]),
            fast_exp2(fmaf(s[x + 1], scale_log2, -lr[i])) *
                (dp[x + 1] - dr[i]));
      }
    }
    wgmma_fence();
    fence_regs<NO>(dq_acc);
    product_xb<HD, BS / 16>(dq_acc, sa, kst, C::STR_CB);
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags<BS / 16>(sa);
    fence_regs<NO>(dq_acc);
    if (lane == 0) mbar_arrive(&sh.empty[stage]);
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }

  store_tile<HD>(a.dq + b * a.sdq.b + h * a.sdq.h, a.sdq.t, dq_acc, scale,
                 q0 + r0, Tq, lane);
}

// The dK/dV and dQ work items in one launch: blocks [0, n_kv) take the
// dK/dV items longest first, the rest the dQ items longest first, so the
// short dQ items fill the SMs that the long dK/dV ones leave idle at the
// end. The two parts share the block shape and the shared-memory layout.
template <int HD>
__global__ void __launch_bounds__(WNT, 1) bwd_wgmma_kernel(
    const __grid_constant__ BwdMaps maps, const BwdArgs args) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ BShared sh;
  // Swizzle atoms must sit on 1024-byte boundaries.
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  if (threadIdx.x == 0) init_barriers(sh);
  __syncthreads();
  if ((int)blockIdx.x < args.n_kv)
    dkdv_block<HD>(maps, args, blockIdx.x, smem, sh);
  else
    dq_block<HD>(maps, args, blockIdx.x - args.n_kv, smem, sh);
}


// ------------------------------------------------------------- f32 kernels

constexpr int FK = 64;        // keys per dK/dV block; query rows per dQ block
constexpr int FS = 32;        // rows of the streamed tiles
constexpr int FLS = FS + 1;   // odd row of the P^T / dS tiles

template <int HD>
constexpr int f32_smem_bytes() {
  return ((2 * FK + 2 * FS) * (HD + 1) + 2 * FK * FLS + 3 * FS) * 4;
}

// dK/dV in f32: block (64 keys, KV head, b), 256 threads (ty, tx) on 16 x
// 16; a thread holds keys ty + 16 i (i < 4) against queries tx + 16 j (j <
// 2) of S^T and dP^T, and columns tx + 16 c of dK and dV.
template <int HD>
__global__ void __launch_bounds__(256) bwd_dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ Dsum,
    const int* __restrict__ lost, const int* __restrict__ qrange,
    const int* __restrict__ krange, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, float* __restrict__ dk,
    float* __restrict__ dv, int Tq, int Tk, int G, int window, float scale,
    Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
    Strides sdv) {
  constexpr int L = HD + 1, CP = HD / 16;
  extern __shared__ float fsm[];
  float* Ks = fsm;                 // [FK][L]
  float* Vs = Ks + FK * L;
  float* Qs = Vs + FK * L;         // [FS][L]
  float* Os = Qs + FS * L;         // dO
  float* Ps = Os + FS * L;         // P^T [FK][FLS]
  float* Ss = Ps + FK * FLS;       // dS^T
  float* ls = Ss + FK * FLS;       // [FS] lse, D, q_pos
  float* dsum = ls + FS;
  int* qps = reinterpret_cast<int*>(dsum + FS);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y * G, k0 = kt * FK;
  const int n_qt32 = (Tq + PREP_ROWS - 1) / PREP_ROWS;
  const Range kr{krange[2 * kt], krange[2 * kt + 1]};
  const float inv_tk = 1.f / (float)Tk;

  for (int idx = tid; idx < FK * HD; idx += 256) {
    const int j = idx / HD, d = idx % HD, kk = k0 + j;
    Ks[j * L + d] = kk < Tk ? k[b * sk.b + kvh * sk.h + kk * sk.t + d] : 0.f;
    Vs[j * L + d] = kk < Tk ? v[b * sv.b + kvh * sv.h + kk * sv.t + d] : 0.f;
  }
  int kp[4];
  bool kin[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k0 + ty + 16 * i;
    kin[i] = kk < Tk;
    kp[i] = kin[i] ? k_pos[kk] : 0;
  }
  float dk_acc[4][CP], dv_acc[4][CP];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CP; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int qt = 0; qt < n_qt32; ++qt) {
    const Range qr{qrange[2 * qt], qrange[2 * qt + 1]};
    const bool pos_ok = admits(qr, kr, window);
    for (int gg = 0; gg < G; ++gg) {
      const int hh = kvh * G + gg;
      const int64_t bh = (int64_t)b * H + hh;
      if (!pos_ok && !lost[bh * n_qt32 + qt]) continue;   // uniform
      const int q0 = qt * FS;
      __syncthreads();        // the previous item's tiles are consumed
      for (int idx = tid; idx < FS * HD; idx += 256) {
        const int r = idx / HD, d = idx % HD, qi = q0 + r;
        const bool in = qi < Tq;
        Qs[r * L + d] = in ? q[b * sq.b + hh * sq.h + qi * sq.t + d] : 0.f;
        Os[r * L + d] =
            in ? dout[b * sdo.b + hh * sdo.h + qi * sdo.t + d] : 0.f;
      }
      if (tid < FS) {
        const int qi = q0 + tid;
        const bool in = qi < Tq;
        ls[tid] = in ? lse[bh * Tq + qi] : 0.f;
        dsum[tid] = in ? Dsum[bh * Tq + qi] : 0.f;
        qps[tid] = in ? q_pos[qi] : 0;
      }
      __syncthreads();
      float s[4][2], dp[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kx[4], vx[4], qx[2], ox[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kx[i] = Ks[(ty + 16 * i) * L + d];
          vx[i] = Vs[(ty + 16 * i) * L + d];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          qx[j] = Qs[(tx + 16 * j) * L + d];
          ox[j] = Os[(tx + 16 * j) * L + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            s[i][j] = fmaf(kx[i], qx[j], s[i][j]);
            dp[i][j] = fmaf(vx[i], ox[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = tx + 16 * j;
          const float l = ls[col];
          float p = 0.f, ds = 0.f;
          if (kin[i] && q0 + col < Tq) {
            if (isinf(l)) {
              p = inv_tk;
            } else if (admissible(kp[i], qps[col], window)) {
              p = expf(s[i][j] * scale - l);
              ds = p * (dp[i][j] - dsum[col]);
            }
          }
          Ps[(ty + 16 * i) * FLS + col] = p;
          Ss[(ty + 16 * i) * FLS + col] = ds;
        }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < FS; ++r) {
        float ox[CP], qx[CP];
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          ox[c] = Os[r * L + tx + 16 * c];
          qx[c] = Qs[r * L + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = Ps[(ty + 16 * i) * FLS + r];
          const float ds = Ss[(ty + 16 * i) * FLS + r];
#pragma unroll
          for (int c = 0; c < CP; ++c) {
            dv_acc[i][c] = fmaf(p, ox[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(ds, qx[c], dk_acc[i][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k0 + ty + 16 * i;
    if (kk >= Tk) continue;
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      const int d = tx + 16 * c;
      dk[b * sdk.b + kvh * sdk.h + kk * sdk.t + d] = dk_acc[i][c] * scale;
      dv[b * sdv.b + kvh * sdv.h + kk * sdv.t + d] = dv_acc[i][c];
    }
  }
}

// dQ in f32: block (64 query rows, head, b), 256 threads; a thread holds
// rows ty + 16 i against keys tx + 16 j of each 32-key tile, and columns
// tx + 16 c of dQ.
template <int HD>
__global__ void __launch_bounds__(256) bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ Dsum,
    const int* __restrict__ qrange, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, float* __restrict__ dq, int Tq, int Tk,
    int G, int window, float scale, Strides sq, Strides sk, Strides sv,
    Strides sdo, Strides sdq) {
  constexpr int L = HD + 1, CP = HD / 16;
  extern __shared__ float fsm[];
  float* Qs = fsm;                 // [FK][L]
  float* Os = Qs + FK * L;         // dO
  float* Ks = Os + FK * L;         // [FS][L]
  float* Vs = Ks + FS * L;
  float* Ss = Vs + FS * L;         // dS [FK][FLS]
  int* kps = reinterpret_cast<int*>(Ss + 2 * FK * FLS);   // [FS]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, hk = h / G, q0 = qt * FK;
  const int64_t bh = (int64_t)b * H + h;
  const int n_kt = (Tk + FS - 1) / FS;

  for (int idx = tid; idx < FK * HD; idx += 256) {
    const int r = idx / HD, d = idx % HD, qi = q0 + r;
    const bool in = qi < Tq;
    Qs[r * L + d] = in ? q[b * sq.b + h * sq.h + qi * sq.t + d] : 0.f;
    Os[r * L + d] = in ? dout[b * sdo.b + h * sdo.h + qi * sdo.t + d] : 0.f;
  }
  int qp[4];
  float lr[4], dr[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    const bool in = qi < Tq;
    qp[i] = in ? q_pos[qi] : 0;
    lr[i] = in ? lse[bh * Tq + qi] : INFINITY;
    dr[i] = in ? Dsum[bh * Tq + qi] : 0.f;
    live[i] = !isinf(lr[i]);
  }
  const int n_qt32 = (Tq + PREP_ROWS - 1) / PREP_ROWS;
  Range qr{INT_MAX, INT_MIN};
  for (int x = q0 / PREP_ROWS; x < (q0 + FK) / PREP_ROWS && x < n_qt32; ++x) {
    qr.lo = min(qr.lo, qrange[2 * x]);
    qr.hi = max(qr.hi, qrange[2 * x + 1]);
  }
  float dq_acc[4][CP];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CP; ++c) dq_acc[i][c] = 0.f;

  for (int x = 0; x < n_kt; ++x) {
    const int k0 = x * FS;
    __syncthreads();          // the previous tile is consumed
    for (int idx = tid; idx < FS * HD; idx += 256) {
      const int j = idx / HD, d = idx % HD, kk = k0 + j;
      const bool in = kk < Tk;
      Ks[j * L + d] = in ? k[b * sk.b + hk * sk.h + kk * sk.t + d] : 0.f;
      Vs[j * L + d] = in ? v[b * sv.b + hk * sv.h + kk * sv.t + d] : 0.f;
    }
    if (tid < FS) kps[tid] = k0 + tid < Tk ? k_pos[k0 + tid] : 0;
    __syncthreads();
    Range kr{INT_MAX, INT_MIN};
    for (int j = 0; j < FS && k0 + j < Tk; ++j) {
      kr.lo = min(kr.lo, kps[j]);
      kr.hi = max(kr.hi, kps[j]);
    }
    if (!admits(qr, kr, window)) continue;   // uniform across the block
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qx[4], ox[4], kx[2], vx[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qx[i] = Qs[(ty + 16 * i) * L + d];
        ox[i] = Os[(ty + 16 * i) * L + d];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kx[j] = Ks[(tx + 16 * j) * L + d];
        vx[j] = Vs[(tx + 16 * j) * L + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qx[i], kx[j], s[i][j]);
          dp[i][j] = fmaf(ox[i], vx[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = tx + 16 * j;
        float ds = 0.f;
        if (live[i] && k0 + col < Tk && admissible(kps[col], qp[i], window)) {
          const float p = expf(s[i][j] * scale - lr[i]);
          ds = p * (dp[i][j] - dr[i]);
        }
        Ss[(ty + 16 * i) * FLS + col] = ds;
      }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < FS; ++j) {
      float kx[CP];
#pragma unroll
      for (int c = 0; c < CP; ++c) kx[c] = Ks[j * L + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = Ss[(ty + 16 * i) * FLS + j];
#pragma unroll
        for (int c = 0; c < CP; ++c) dq_acc[i][c] = fmaf(ds, kx[c],
                                                          dq_acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Tq) continue;
#pragma unroll
    for (int c = 0; c < CP; ++c)
      dq[b * sdq.b + h * sdq.h + qi * sdq.t + tx + 16 * c] =
          dq_acc[i][c] * scale;
  }
}


// ------------------------------------------------------------------ launch

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float* Dsum;
  int *lost, *qrange, *krange;
  const int *q_pos, *k_pos;
  int B, H, KV, Tq, Tk, window;
  float scale;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
};

template <int HD>
cudaError_t launch_wgmma(const Args& a, cudaStream_t st) {
  using C = BCfg<HD>;
  using bf16 = __nv_bfloat16;
  static unsigned long long done = 0;
  cudaError_t err = set_smem_once(bwd_wgmma_kernel<HD>, C::SMEM, &done);
  if (err != cudaSuccess) return err;
  BwdMaps m;
  if (!make_map(&m.q_str, a.q, HD, a.Tq, a.H, a.B, a.sq, C::BS) ||
      !make_map(&m.do_str, a.dout, HD, a.Tq, a.H, a.B, a.sdo, C::BS) ||
      !make_map(&m.k_own, a.k, HD, a.Tk, a.KV, a.B, a.sk, OWN) ||
      !make_map(&m.v_own, a.v, HD, a.Tk, a.KV, a.B, a.sv, OWN) ||
      !make_map(&m.q_own, a.q, HD, a.Tq, a.H, a.B, a.sq, OWN) ||
      !make_map(&m.do_own, a.dout, HD, a.Tq, a.H, a.B, a.sdo, OWN) ||
      !make_map(&m.k_str, a.k, HD, a.Tk, a.KV, a.B, a.sk, C::BS) ||
      !make_map(&m.v_str, a.v, HD, a.Tk, a.KV, a.B, a.sv, C::BS))
    return cudaErrorInvalidValue;
  const int n_kv = (a.Tk + OWN - 1) / OWN * a.KV * a.B;
  const int n_q = (a.Tq + OWN - 1) / OWN * a.H * a.B;
  const BwdArgs args{a.lse, a.Dsum, a.lost, a.qrange, a.krange, a.q_pos,
                     a.k_pos, static_cast<bf16*>(a.dq),
                     static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.B,
                     a.H, a.KV, a.Tq, a.Tk, a.window, n_kv, a.scale, a.sdq,
                     a.sdk, a.sdv};
  bwd_wgmma_kernel<HD><<<n_kv + n_q, WNT, C::SMEM, st>>>(m, args);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const int G = a.H / a.KV;
  const int n_qt32 = (a.Tq + PREP_ROWS - 1) / PREP_ROWS;
  const int n_kt64 = (a.Tk + KCH - 1) / KCH;
  const int n_prep = n_qt32 > n_kt64 ? n_qt32 : n_kt64;
  bwd_prep_kernel<T, HD><<<dim3(n_prep, a.H, a.B), 256, 0, st>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse,
      a.Dsum, a.lost, a.qrange, a.krange, a.q_pos, a.k_pos, a.Tq, a.Tk, a.so,
      a.sdo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_wgmma<HD>(a, st);
  } else {
    static unsigned long long done_kv = 0, done_q = 0;
    constexpr int smem = f32_smem_bytes<HD>();
    err = set_smem_once(bwd_dkdv_f32_kernel<HD>, smem, &done_kv);
    if (err != cudaSuccess) return err;
    err = set_smem_once(bwd_dq_f32_kernel<HD>, smem, &done_q);
    if (err != cudaSuccess) return err;
    bwd_dkdv_f32_kernel<HD><<<dim3(n_kt64, a.KV, a.B), 256, smem, st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.Dsum, a.lost, a.qrange, a.krange, a.q_pos, a.k_pos,
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Tq, a.Tk, G,
        a.window, a.scale, a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bwd_dq_f32_kernel<HD><<<dim3((a.Tq + FK - 1) / FK, a.H, a.B), 256, smem,
                            st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.Dsum, a.qrange, a.q_pos, a.k_pos,
        static_cast<float*>(a.dq), a.Tq, a.Tk, G, a.window, a.scale, a.sq,
        a.sk, a.sv, a.sdo, a.sdq);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a, cudaStream_t st) {
  switch (hd) {
    case 32: return launch<T, 32>(a, st);
    case 64: return launch<T, 64>(a, st);
    case 112: return launch<T, 112>(a, st);
    case 128: return launch<T, 128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq [B, H, Tq, hd]; k, v, dk, dv [B, KV, Tk, hd], each given by
// its element strides (8 x 4, in that order); hd 32, 64, 112 or 128; lse
// [B, H, Tq] f32 contiguous from flash_attention_fwd (natural log, +inf for
// a row with no admissible key); q_pos [Tq], k_pos [Tk] int32 contiguous.
// Workspace: Dsum [B, H, Tq] f32; ints: lost [B, H, ceil(Tq/32)], qrange
// [2 ceil(Tq/32)], krange [2 ceil(Tk/64)]. Launches on `stream` the
// pre-pass, then (bf16) the dK/dV + dQ kernel or (f32) the dK/dV and dQ
// kernels, and returns cudaGetLastError() after the last launch.
EXPORT int flash_attention_bwd(
    int dtype, int hd, const void* q, const void* k, const void* v,
    const void* o, const void* dout, const float* lse, void* dq, void* dk,
    void* dv, float* Dsum, int* lost, int* qrange, int* krange,
    const int* q_pos, const int* k_pos, int B, int H, int KV, int Tq, int Tk,
    int window, float scale, const int64_t* strides, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Tq <= 0 || Tk <= 0)
    return cudaErrorInvalidValue;
  Strides s[8];
  for (int i = 0; i < 8; ++i)
    s[i] = Strides{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2],
                   strides[4 * i + 3]};
  const Args a{q, k, v, o, dout, lse, dq, dk, dv, Dsum, lost, qrange,
               krange, q_pos, k_pos, B, H, KV, Tq, Tk, window, scale,
               s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_hd<float>(hd, a, st);
  if (dtype == kBFloat16) return dispatch_hd<__nv_bfloat16>(hd, a, st);
  return cudaErrorInvalidValue;
}
