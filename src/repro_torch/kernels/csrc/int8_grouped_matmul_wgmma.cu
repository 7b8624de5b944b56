// Grouped int8 GEMM for the W8A8 experts on Hopper's warpgroup products:
// out[e] = a[e] @ b[e] for every expert e, int8 x int8 -> int32, for
// expert weights stored K-major (sm_90a).
//
// Not a port of a TPU kernel: the reference computes these products as XLA
// einsums (repro/models/moe.py, `_w8a8_ffn`). It takes the place of
// int8_grouped_matmul.cu (mma.sync, b N-major) on the served path; that
// kernel stays for b with a unit stride on N.
//
// What it computes: a [E, C, K] int8 with a unit stride on K (the experts'
// dispatched, quantised tokens), b [E, K, N] int8 with a unit stride on K
// (the expert weights, which the port stores K-major: see
// models/moe.py::moe_params), into out [E, C, N] int32 (contiguous). Sums
// in int32 are exact: |sum| <= K * 128^2 < 2^31 for K < 131072.
//
// The K-major rule. wgmma with s8 operands has no transpose modes: both
// shared-memory operands must be K-major. The reference's layout [d_in,
// d_out] with d_out contiguous is N-major for b, so the port keeps the same
// shape and values in a transposed storage (`.transpose(-1, -2)` of a
// contiguous [.., d_out, d_in]), whose stride on K is 1.
//
// The swap. The kernel computes out[e]^T = b[e]^T a[e]^T: the weights'
// output channels fill wgmma's 64-row M side (b[e]^T is [N, K],
// K-contiguous) and the tokens its n side (a[e] is [C, K], K-contiguous).
// A token tile is one wgmma width NT in {8, 16, 32, 64, 128, 208, 256}: a
// decode step's C = 1 costs one n8 tile, kimi-k2's prefill C = 208 is one
// n208 tile, llama4-scout's 624 three.
//
// What bounds it on the H100: every byte of b that holds a routed expert
// is read once, for 2 C operations a byte; the int8 tensor cores' ridge is
// 1,979 TOP/s over 3.35 TB/s, ~590 operations a byte, so a decode step (C =
// 1) and kimi-k2's prefill (C = 208) are bound by the bytes of b, and
// llama4-scout's prefill (C = 624) by the operations.
//
// The skip. An expert that received no token has all-zero rows of a (the
// MoE layer zero-fills its dispatch buffer, and 0 quantises to 0; silu(0)
// * 0 = 0 gives the same for the second product). Its output is exactly
// zero, so reading its weights is wasted: at a decode step of 8 requests
// kimi-k2 fills ~59 of 384 experts. Two small launches before the product:
//  1. flag_kernel, one block per (expert, 8 rows of a): whether the rows
//     hold a non-zero byte, reading 4 KB, then 16 KB a round, and stopping
//     at the first round that finds one. Rows of tokens stop after the
//     first 4 KB; only zero rows are read whole, so it reads at most E C K
//     bytes, and at a prefill where every expert holds tokens about the
//     zero rows past each expert's last token.
//  2. compact_kernel, one block: the list of work items (expert, 128
//     channels, token tile) of the token tiles with a non-zero row, expert
//     by expert, channel tile by channel tile, token tiles innermost (the
//     items that share a tile of b are neighbours, so it is read from
//     memory once), then the (expert, token tile) pairs with none.
//  3. gmm_kernel, persistent: one block per SM walks the list in strides of
//     the grid. A pair with no token costs its block only the zero stores
//     of its output rows (no byte of b is loaded), done before its first
//     product so they overlap the ring's first loads.
//
// The product (gmm_kernel): 3 warpgroups. Warpgroup 0's first thread is
// the producer: for each of its items it issues TMA loads of 128-byte k
// slices, b^T [128 channels x 128] and a [NT tokens x 128] (tensor maps
// over the strided views, 128-byte swizzle, ragged C, N and K zero-filled
// by TMA), into a ring of stages (4 at NT 208 and 256, up to 8 for small
// NT) guarded by full / empty mbarriers. Warpgroups 1 and 2 consume, 64
// channels each, 4 wgmma m64nNTk32 a stage, with the stage released one
// stage behind (wgmma_wait<1>) so the tensor cores never wait on the
// release; setmaxnreg 240 / 24 (an m64n208 tile is 104 int32 accumulators
// a thread, n256 128). The epilogue passes the channel-major accumulators
// through a padded shared-memory tile of 32 tokens x 64 channels per
// warpgroup (bank-conflict free both ways) so that every store to out,
// which is N-contiguous, is a 16-byte vector and a warp writes whole
// 256-byte rows. The producer runs ahead into the next item meanwhile.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "tma.cuh"

namespace {

constexpr int BM = 128;           // output channels per item (2 x 64)
constexpr int BK = 128;           // k bytes per stage: one 128-byte row
constexpr int THREADS = 384;      // producer warpgroup + two consumers
constexpr int RC = 8;             // rows of a per pre-pass flag
constexpr int FLAG_THREADS = 256;
constexpr int COMPACT_THREADS = 1024;
constexpr int EPI_TOK = 32;       // tokens per epilogue round
constexpr int EPI_PITCH = 68;     // int32 per staged token row: 64 + 4 pad
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_STAGES = 8;
constexpr int B_STAGE = BM * BK;  // bytes of b^T a stage (16 KB)
constexpr int WIDTHS[] = {8, 16, 32, 64, 128, 208, 256};   // token tiles

template <int NT>
struct Cfg {
  static constexpr int A_STAGE = NT * BK;        // bytes of a a stage
  static constexpr int STAGE = B_STAGE + A_STAGE;
  static constexpr int EPI = 2 * EPI_TOK * EPI_PITCH * 4;
  static constexpr int FIT = (SMEM_LIMIT - EPI - 1024 - 256) / STAGE;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int SMEM = STAGES * STAGE + EPI + 1024;  // + alignment
  static_assert(STAGE % 1024 == 0, "swizzle atoms must stay aligned");
  static_assert(STAGES >= 2, "ring too small");
};

// Token tile width for C rows of a: the fewest tiles of at most 256 rows,
// each as narrow as a supported wgmma width allows.
int tile_tokens(int C) {
  const int tiles = (C + 255) / 256;
  const int rows = (C + tiles - 1) / tiles;
  for (int w : WIDTHS)
    if (w >= rows) return w;
  return 256;
}

// Workspace layout in int32 words: flags [E * n_rc], counts [2], the live
// items [E * n_tt * n_ch] and the empty pairs [E * n_tt] (uint2 each).
struct Layout {
  int NT, n_rc, n_tt, n_ch;
  int64_t flags, counts, live, dead, words;
};

Layout layout(int E, int C, int N) {
  Layout l;
  l.NT = tile_tokens(C);
  l.n_rc = (C + RC - 1) / RC;
  l.n_tt = (C + l.NT - 1) / l.NT;
  l.n_ch = (N + BM - 1) / BM;
  l.flags = 0;
  l.counts = (int64_t)E * l.n_rc;
  l.live = (l.counts + 2 + 1) & ~(int64_t)1;      // uint2-aligned
  l.dead = l.live + 2 * (int64_t)E * l.n_tt * l.n_ch;
  l.words = l.dead + 2 * (int64_t)E * l.n_tt;
  return l;
}

// ------------------------------------------------------------------ pre-pass

// grid (n_rc, E): flags[e * n_rc + x] = whether rows [8x, 8x + 8) of a[e]
// hold a non-zero byte. The first round reads 4 KB (a 16-byte vector a
// thread), which settles a block of token rows; the later ones 16 KB (four
// vectors a thread). The block stops at the first round that finds one.
__global__ void __launch_bounds__(FLAG_THREADS)
    flag_kernel(const int8_t* __restrict__ a, int* __restrict__ flags, int C,
                int K, int64_t sa_e, int64_t sa_c) {
  const int x = blockIdx.x, e = blockIdx.y, tid = threadIdx.x;
  const int r0 = x * RC, rows = min(RC, C - r0), vk = K / 16;
  const int nv = rows * vk;
  const int8_t* base = a + e * sa_e + r0 * sa_c;
  auto load = [&](int v) {
    return v < nv ? __ldg(reinterpret_cast<const int4*>(
                        base + (v / vk) * sa_c + (v % vk) * 16))
                  : make_int4(0, 0, 0, 0);
  };
  const int4 q0 = load(tid);
  int found = __syncthreads_or(q0.x | q0.y | q0.z | q0.w);
  for (int v0 = FLAG_THREADS; !found && v0 < nv; v0 += 4 * FLAG_THREADS) {
    int4 q[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) q[u] = load(v0 + u * FLAG_THREADS + tid);
    int any = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) any |= q[u].x | q[u].y | q[u].z | q[u].w;
    found = __syncthreads_or(any);
  }
  if (tid == 0) flags[(int64_t)e * gridDim.x + x] = found;
}

// Exclusive prefix sum of v over the block (COMPACT_THREADS threads); the
// block's total in *total. Uses sums[32].
__device__ __forceinline__ int block_scan(int v, int* sums, int* total) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    sums[lane] = s;                     // inclusive over warps
  }
  __syncthreads();
  const int before = (warp ? sums[warp - 1] : 0) + x - v;
  *total = sums[31];
  __syncthreads();                      // sums is reused by the next call
  return before;
}

// Whether token tile tt of expert e has a flagged row.
__device__ __forceinline__ bool tile_live(const int* flags, int e, int tt,
                                          int n_rc, int rc_per_tt) {
  const int c0 = tt * rc_per_tt, c1 = min(c0 + rc_per_tt, n_rc);
  for (int c = c0; c < c1; ++c)
    if (flags[(int64_t)e * n_rc + c]) return true;
  return false;
}

// One block: the item list (see the note) from the flags. A live item is
// (e, channel tile << 16 | token tile), a pair with no token (e, token
// tile). counts = {live items, empty pairs}.
__global__ void __launch_bounds__(COMPACT_THREADS)
    compact_kernel(const int* __restrict__ flags, int* __restrict__ counts,
                   uint2* __restrict__ live, uint2* __restrict__ dead, int E,
                   int n_rc, int n_tt, int n_ch, int rc_per_tt) {
  __shared__ int sums[32];
  const int tid = threadIdx.x;
  int live_base = 0, dead_base = 0;
  for (int e0 = 0; e0 < E; e0 += COMPACT_THREADS) {
    const int e = e0 + tid;
    // The first 32 token tiles' verdicts in a mask; any later ones (C above
    // 8,192) are read again from the flags.
    uint32_t mask = 0;
    int n_live = 0;
    if (e < E)
      for (int tt = 0; tt < n_tt; ++tt) {
        const bool on = tile_live(flags, e, tt, n_rc, rc_per_tt);
        n_live += on;
        if (on && tt < 32) mask |= 1u << tt;
      }
    auto is_live = [&](int tt) {
      return tt < 32 ? (mask >> tt) & 1u
                     : tile_live(flags, e, tt, n_rc, rc_per_tt);
    };
    const int n_dead = e < E ? n_tt - n_live : 0;
    int live_total, dead_total;
    int at_live = live_base + block_scan(n_live * n_ch, sums, &live_total);
    int at_dead = dead_base + block_scan(n_dead, sums, &dead_total);
    if (e < E && n_live > 0)
      for (unsigned ch = 0; ch < (unsigned)n_ch; ++ch)
        for (int tt = 0; tt < n_tt; ++tt)
          if (is_live(tt)) live[at_live++] = make_uint2(e, ch << 16 | tt);
    if (e < E && n_dead > 0)
      for (int tt = 0; tt < n_tt; ++tt)
        if (!is_live(tt)) dead[at_dead++] = make_uint2(e, tt);
    live_base += live_total;
    dead_base += dead_total;
  }
  if (tid == 0) {
    counts[0] = live_base;
    counts[1] = dead_base;
  }
}

// ------------------------------------------------------------------ product

struct Params {
  const int* counts;
  const uint2* live;
  const uint2* dead;
  int32_t* out;
  int C, N, n_k;
  int64_t so_e, so_c;
};

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
    gmm_kernel(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb, const Params p) {
  using G = Cfg<NT>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[G::STAGES], empty[G::STAGES];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int32_t* epi = reinterpret_cast<int32_t*>(smem + G::STAGES * G::STAGE);

  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);          // the 8 consumer warps
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int n_live = p.counts[0], n_dead = p.counts[1];

  if (wg == 0) {
    // -------------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int i = blockIdx.x; i < n_live; i += gridDim.x) {
      const uint2 it = p.live[i];
      const int ch0 = (it.y >> 16) * BM, tok0 = (it.y & 0xFFFF) * NT;
      for (int kt = 0; kt < p.n_k; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + stage * G::STAGE;
        mbar_arrive_expect_tx(&full[stage], G::STAGE);
        tma_load_3d(st, &tb, &full[stage], kt * BK, ch0, it.x);
        tma_load_3d(st + B_STAGE, &ta, &full[stage], kt * BK, tok0, it.x);
        if (++stage == G::STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1, wtid = tid - 128 * wg, ctid = tid - 128;
  const int warp = wtid >> 5, g = lane >> 2, t = lane & 3;
  const int C = p.C, N = p.N;

  // Pairs with no token: zero rows of out, all N columns, both warpgroups.
  const int n4 = N / 4;
  for (int i = blockIdx.x; i < n_dead; i += gridDim.x) {
    const uint2 it = p.dead[i];
    const int tok0 = it.y * NT, rows = min(NT, C - tok0);
    int32_t* o = p.out + it.x * p.so_e + (int64_t)tok0 * p.so_c;
    for (int v = ctid; v < rows * n4; v += 256)
      *reinterpret_cast<int4*>(o + (v / n4) * p.so_c + (v % n4) * 4) =
          make_int4(0, 0, 0, 0);
  }

  constexpr int NA = NT / 2;
  int acc[NA];
#pragma unroll
  for (int x = 0; x < NA; ++x) acc[x] = 0;
  int32_t* buf = epi + cw * EPI_TOK * EPI_PITCH;
  const uint32_t ring = smem_u32(smem);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = blockIdx.x; i < n_live; i += gridDim.x) {
    const uint2 it = p.live[i];
    const int chw = (it.y >> 16) * BM + cw * 64, tok0 = (it.y & 0xFFFF) * NT;
    int prev = -1;
    for (int kt = 0; kt < p.n_k; ++kt) {
      mbar_wait(&full[stage], phase);
      const uint32_t sb = ring + stage * G::STAGE + cw * 64 * BK;
      const uint32_t sa = ring + stage * G::STAGE + B_STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_s8<NT>(acc, sw128_desc(sb + kk * 32, 16, 1024),
                     sw128_desc(sa + kk * 32, 16, 1024), kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();                  // the previous stage's products done
      fence_regs<NA>(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == G::STAGES) { stage = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
    fence_regs<NA>(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // Epilogue: acc[4j + 2i + c] is channel 16 warp + g + 8i, token 8j + 2t
    // + c. Rounds of 32 tokens: scatter into buf [token][channel], then 16-
    // byte vectors of 4 channels out to out[e, token, channels].
    int32_t* oe = p.out + it.x * p.so_e;
#pragma unroll
    for (int j0 = 0; j0 < NT / 8; j0 += EPI_TOK / 8) {
      named_barrier(1 + cw, 128);       // the last round's reads are done
#pragma unroll
      for (int jj = 0; jj < EPI_TOK / 8; ++jj) {
        if (j0 + jj < NT / 8) {
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              buf[(8 * jj + 2 * t + c) * EPI_PITCH + 16 * warp + g + 8 * i2] =
                  acc[4 * (j0 + jj) + 2 * i2 + c];
        }
      }
      named_barrier(1 + cw, 128);
      constexpr int kRound = EPI_TOK < NT ? EPI_TOK : NT;
      const int ntok = min(kRound, NT - 8 * j0);
#pragma unroll
      for (int v = wtid; v < kRound * 16; v += 128) {
        const int r = v >> 4, q = v & 15;
        const int tok = tok0 + 8 * j0 + r, ch = chw + 4 * q;
        if (r < ntok && tok < C && ch < N)
          *reinterpret_cast<int4*>(oe + (int64_t)tok * p.so_c + ch) =
              *reinterpret_cast<const int4*>(buf + r * EPI_PITCH + 4 * q);
      }
    }
  }
}

// A 3-D tensor map over the int8 view [E, rows, K] (K unit-stride; row and
// expert strides in bytes), boxes of 128 k x box_rows rows x 1 expert,
// 128-byte swizzle, out-of-range elements read as zero. A dimension of
// extent 1 never moves, so its stride is replaced by a valid one.
bool make_map_i8(CUtensorMap* map, const void* base, int K, int rows, int E,
                 int64_t s_row, int64_t s_e, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (!encode) return false;
  cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)rows, (cuuint64_t)E};
  cuuint64_t strides[2] = {rows > 1 ? (cuuint64_t)s_row : (cuuint64_t)K,
                           E > 1 ? (cuuint64_t)s_e : (cuuint64_t)K};
  cuuint32_t box[3] = {(cuuint32_t)BK, (cuuint32_t)box_rows, 1};
  cuuint32_t estr[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int& n = counts[dev & 63];
  if (!n) cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

struct Call {
  const void *a, *b;
  void* out;
  int* ws;
  int E, C, K, N;
  int64_t sa_e, sa_c, sb_e, sb_n, so_e, so_c;
};

cudaError_t prepass(const Call& c, const Layout& l, cudaStream_t st) {
  int* flags = c.ws + l.flags;
  flag_kernel<<<dim3(l.n_rc, c.E), FLAG_THREADS, 0, st>>>(
      static_cast<const int8_t*>(c.a), flags, c.C, c.K, c.sa_e, c.sa_c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  compact_kernel<<<1, COMPACT_THREADS, 0, st>>>(
      flags, c.ws + l.counts, reinterpret_cast<uint2*>(c.ws + l.live),
      reinterpret_cast<uint2*>(c.ws + l.dead), c.E, l.n_rc, l.n_tt, l.n_ch,
      l.NT / RC);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch(const Call& c, const Layout& l, cudaStream_t st) {
  using G = Cfg<NT>;
  static unsigned long long done = 0;
  cudaError_t err = set_smem_once(gmm_kernel<NT>, G::SMEM, &done);
  if (err != cudaSuccess) return err;
  CUtensorMap ta, tb;
  if (!make_map_i8(&ta, c.a, c.K, c.C, c.E, c.sa_c, c.sa_e, NT) ||
      !make_map_i8(&tb, c.b, c.K, c.N, c.E, c.sb_n, c.sb_e, BM))
    return cudaErrorInvalidValue;
  err = prepass(c, l, st);
  if (err != cudaSuccess) return err;
  const int64_t most = (int64_t)c.E * l.n_tt * l.n_ch + (int64_t)c.E * l.n_tt;
  const int grid = (int)(most < sm_count() ? most : sm_count());
  if (grid <= 0) return cudaErrorInvalidValue;
  const int* ws = c.ws;
  const Params p{ws + l.counts, reinterpret_cast<const uint2*>(ws + l.live),
                 reinterpret_cast<const uint2*>(ws + l.dead),
                 static_cast<int32_t*>(c.out), c.C, c.N, (c.K + BK - 1) / BK,
                 c.so_e, c.so_c};
  gmm_kernel<NT><<<grid, THREADS, G::SMEM, st>>>(ta, tb, p);
  return cudaGetLastError();
}

// Sizes the kernel takes: one grid row of flag blocks per expert, channel
// and token tiles that fit the item's 16-bit fields, exact int32 sums.
bool valid(int E, int C, int K, int N) {
  if (E <= 0 || E > 65535 || C <= 0 || K <= 0 || N <= 0 || K % 16 ||
      N % 16 || K >= 131072)
    return false;
  const Layout l = layout(E, C, N);
  return l.n_ch <= 65536 && l.n_tt <= 65536;
}

}  // namespace

// The plan of a call at (E, C, K, N): info[0] the int32 words of workspace
// it needs, info[1] where the two counts sit in it, info[2] the token tile
// width, info[3] the number of token tiles. Returns 0, or -1 for sizes the
// kernel does not take.
EXPORT int int8_grouped_matmul_wgmma_plan(int E, int C, int K, int N,
                                          int64_t* info) {
  if (!valid(E, C, K, N)) return -1;
  const Layout l = layout(E, C, N);
  info[0] = l.words;
  info[1] = l.counts;
  info[2] = l.NT;
  info[3] = l.n_tt;
  return 0;
}

// a [E, C, K] int8 with strides (sa_e, sa_c, 1), b [E, K, N] int8 with
// strides (sb_e, 1, sb_n), out [E, C, N] int32 with strides (so_e, so_c, 1);
// ws: int8_grouped_matmul_wgmma_plan's info[0] int32 words. K and N
// multiples of 16, bases 16-byte aligned and strides multiples of 16 bytes
// (the wrapper checks). Launches the pre-pass and the product on `stream`;
// with prepass_only, the pre-pass alone (for timing it). Returns a
// cudaError_t.
EXPORT int int8_grouped_matmul_wgmma(const void* a, const void* b, void* out,
                                     int* ws, int E, int C, int K, int N,
                                     int64_t sa_e, int64_t sa_c, int64_t sb_e,
                                     int64_t sb_n, int64_t so_e, int64_t so_c,
                                     int prepass_only, void* stream) {
  if (!valid(E, C, K, N) || so_c % 4) return cudaErrorInvalidValue;
  const Call c{a, b, out, ws, E, C, K, N, sa_e, sa_c, sb_e, sb_n, so_e, so_c};
  const Layout l = layout(E, C, N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (prepass_only) return prepass(c, l, st);
  switch (l.NT) {
    case 8: return launch<8>(c, l, st);
    case 16: return launch<16>(c, l, st);
    case 32: return launch<32>(c, l, st);
    case 64: return launch<64>(c, l, st);
    case 128: return launch<128>(c, l, st);
    case 208: return launch<208>(c, l, st);
    case 256: return launch<256>(c, l, st);
    default: return cudaErrorInvalidValue;
  }
}
