// Flash-attention backward for Hopper (sm_90a): bf16 in, f32 accumulate.
//
// Replaces the two TPU kernels launched by
// x2i_tpu/ops/flash_attention.py::_flash_backward:
//
//   * K3, _bwd_dq_kernel (:526-578): one program per (q tile, q head,
//     batch) recomputes s = q k^T, p = exp2(s - lse), dp = do v^T,
//     ds = p (dp - delta) scale, and writes dq = bf16(ds) k;
//   * K4, _bwd_dkv_kernel (:581-647): one program per (kv tile, kv head,
//     batch) works in the (BK, Sq) orientation, sums the GQA group inside
//     the program (:612-643) and writes dv = bf16(p)^T do and
//     dk = bf16(ds)^T q.
//
// lse is the forward's base-2 row logsumexp (flash_fwd.cu with an lse
// buffer), delta = sum(do * o) per row in f32, computed by the caller as
// in JAX (:677-678). Both kernels take the kv mask and the causal mask with
// the finite NEG_INF = -1e30 and skip no tile, so a row whose keys are all
// masked is treated as in the TPU kernels: lse = -1e30 and p = 1. do stays
// bf16 in every product, as the TPU kernels keep it in its storage type.
//
// The in-kernel rope variant (tables given) rounds as each TPU body does,
// and the two differ on purpose:
//   * K3 rotates the q tile in f32, folds scale * log2(e) in, rounds to
//     bf16 (:555-556), so p = exp2(s - lse) reuses the forward's recipe;
//     K is rotated once per launch into a bf16 scratch buffer
//     (rope_rows_kernel, as in the forward);
//   * K4 rotates its k tile and all of Q (once per launch, into a scratch
//     buffer, as _rotate_rows_to_scratch :493-516) WITHOUT the scale, and
//     applies scale * log2(e) to the f32 scores (:605-607, :626).
// dq and dk are cotangents of the rotated q and k; each is counter-rotated
// through the transpose of the rotation before it is written
// (_counter_rotate :519-523).
//
// What bounds them on an H100: at the FLUX training point (24 heads x
// 4608 x 128, batch 1) K3 does three S x S x D products, 6 S^2 D H =
// 3.9e11 FLOP (0.40 ms at the 989 TFLOP/s bf16 peak), and K4 four,
// 5.2e11 FLOP (0.53 ms), against about 170 MB of inputs and outputs: the
// tensor cores bound both. The 5.1e8 exp2 of each kernel are about 0.14 ms
// of the special-function units, so they have to run under the products.
// The 12 x 256 DiT's point (1, 12, 4608, 256) has the same FLOP.
//
// Design: two kernels, each with K1's skeleton (flash_fwd.cu), so that the
// gradients stay deterministic (no f32 atomics) and each keeps its TPU
// body's rounding points:
//   * a block is two consumer warpgroups and a producer warpgroup. The
//     producer keeps a ring of stages full by TMA through tensor maps over
//     the strided (B, H, S, D) views (hopper_mma.cuh), then gives its
//     registers back (setmaxnreg 24 / 240). `full` mbarriers count the
//     bytes as they land, `empty` ones the consumer threads that are done
//     with a stage;
//   * every product is wgmma.mma_async: the two score products read both
//     operands K-major from 128-byte-swizzled shared memory, the gradient
//     products take their A operand from the score registers, rounded to
//     bf16 where the TPU body casts it, and read their B tile as it lies,
//     through the descriptor's transpose bit (as K1 reads V);
//   * per stage a warpgroup queues the gradient products of the stage
//     before and the score products of this one (K4: once the former are
//     done), then computes p and ds of this stage while the other
//     warpgroup's products run: the two take turns at queueing through
//     named barriers, as in K1 (K3, and K4 up to D = 128);
//   * K3: one block per (128-row q tile, q head, batch); each warpgroup
//     owns 64 q rows, its q and do tiles stay in shared memory, the ring
//     brings (K tile, V tile) stages. Up to D = 128 the ring holds 4
//     stages of 64 kv rows (m64n64k16 scores); registers at D = 128: dq 64,
//     s 32, dp 32, ds 16. At D = 256 the resident q and do tiles take 128
//     KB of the 227, so the ring holds 3 stages of 32 kv rows (3 x 32 KB,
//     230,448 bytes of the 232,448 with the barriers and the slack) and
//     the scores are m64n32k16: dq 128, s 16, dp 16, ds 8. A stage comes
//     free when every product of the step after it is done, so with 2
//     stages the copy of tile j + 1 started at the end of step j, just
//     before its score products needed it: 1.132 against 0.702 ms at
//     (1, 12, 4608, 256) (NVIDIA H100 80GB HBM3, 700.00 W). Separate K and
//     V rings (V released after the scores, K after the dq product that
//     last reads it, the two waited on apart) took 2 stages to 1.028 ms,
//     but ran 5% slower than the one ring at 3 stages (0.741 / 0.704) and
//     4% slower at D = 128 (0.547 / 0.526);
//   * the masked K3 reads a tile's kv mask as warp ballots of bytes
//     loaded while its scores are in flight, as K1 does: a load per score
//     after the scores had kept the pad route at 0.882 ms whatever the
//     ring (0.558 with the ballots);
//   * K4: one block per (kv tile, kv head, batch), its K and V tiles
//     resident, the ring bringing (q tile, do tile, lse, delta) stages of
//     64 q rows over every (head of the group, q tile) pair. Up to D = 128
//     the block is 128 kv rows in 4 stages and each warpgroup owns 64 of
//     them, all D columns: dk 64, dv 64, s 32, dp 32, then p and ds as bf16
//     A operands (16 + 16) as s and dp die (at D = 128), with no round trip
//     of p or ds through shared memory;
//   * K4 at D = 256 (flash_bwd_dkv_roles_kernel): dk and dv of 64 rows
//     would be 256 registers a thread, over setmaxnreg's 240, so the block
//     is 64 kv rows (resident 64 KB) and its two warpgroups split the work
//     by role. Warpgroup 0 computes s^T = k q^T and p^T, and keeps all 256
//     columns of dv += bf16(p)^T do; warpgroup 1 computes dp^T = v do^T
//     and ds^T = p^T (dp^T - delta) scale, and keeps all 256 columns of
//     dk += bf16(ds)^T q (each gradient 128 registers, m64n256k16
//     products). JAX's ds takes the f32 p, so warpgroup 0 hands p^T over
//     in f32 through one of two 16 KB buffers in shared memory, each
//     thread of warpgroup 1 reading what the thread of its index in
//     warpgroup 0 wrote, under two named barriers a buffer (written,
//     read): 4 products' work a stage, as JAX's body. Each role is its own
//     body with its own fence / commit / wait sequence. The stages come in
//     two rings of 2 (231,488 bytes of the 232,448 in all): q tiles with
//     their lse rows and do tiles with their delta rows, each with its own
//     barriers, so that warpgroup 0's scores wait for the q tile alone and
//     warpgroup 1's dp for the do tile, and each tile goes back to the
//     producer as soon as its two products are done (a stage's gradient
//     products are queued before the next stage's score products). At
//     (1, 12, 4608, 256) on an H100 (PERF.md) that ran 0.867 ms
//     against 1.070 for both warpgroups on every row and half of the
//     columns (6 products' work); one (q, do) ring 0.883, and 1.11 with
//     each stage given back only after the next one's scores; 32-row
//     stages in rings of 4 1.02 (m64n32k16 scores read twice the shared
//     memory a product); warpgroup 1 computing s and p itself (5 products,
//     no exchange) 0.982; the dk product queued ahead of the dv or the
//     score product 0.99-1.06; the stages multicast to a cluster of two kv
//     blocks 1.78. A thread of warpgroup 1 holds dk's columns j and j + 128
//     of its rows, so with rope it counter-rotates dk in registers, as at
//     D = 128;
//   * K4 at a small grid (fewer blocks than the card has SMs: the LM's 2
//     kv heads x 512 tokens give 8) splits the (group x q tiles) loop over
//     a grid dimension; each split writes f32 partial dk and dv into a
//     scratch buffer that the wrapper allocates, and a second kernel sums
//     the splits in a fixed order, counter-rotates and rounds.
// Requires Sq and Skv to be multiples of 128, D in {64, 128, 256}, the
// last dim contiguous and the other strides multiples of 8 elements, lse
// and delta 16-byte aligned.
//
// The f32 instances (x2i_flash_bwd_dq_f32, x2i_flash_bwd_dkv_f32), which the
// TPU kernels' f32 inputs take (an f32 DiT's phase-2 training step), follow
// K1's f32 design (flash_fwd.cu): q, k, v and do rounded once per launch
// into a contiguous bf16 scratch buffer (round_rows_kernel,
// flash_common.cuh), the bodies above on it unchanged, lse and delta read in
// f32 as always, and dq, dk and dv written in f32 from the f32
// accumulators (K4's split sums its f32 partials and writes f32). The
// products' operands are the bf16 values of q, k, v, do, p and ds, as in the
// bf16 kernels, with f32 scores and sums; the TPU's f32 kernels round
// nothing. No rope inside: in f32 the TPU kernels' rounding of the rotated
// q and k is the identity, so the wrapper rotates outside and autograd
// carries the rotation's transpose, which is JAX's f32 function.

#include <type_traits>

#include "flash_common.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int kConsumers = 256;               // two consumer warpgroups
constexpr int kBlockThreads = kConsumers + 128;
constexpr int kRows = 64;                     // q rows of a K4 ring tile
constexpr int kQRows = 128;                   // q rows of a K3 block

// K3's ring at head dim D: kv rows of a tile and stages.
template <int D>
struct DqTiles {
  static constexpr int kv = D == 256 ? 32 : 64;
  static constexpr int stages = D == 256 ? 3 : 4;
};

// K4's tiles at head dim D: kv rows of a block and the ring's stages.
template <int D>
struct DkvTiles {
  static constexpr int block = D == 256 ? 64 : 128;
  static constexpr int stages = D == 256 ? 2 : 4;
};

struct BwdArgs {
  const bf16* q;                // (B, Hq, Sq, D), or rotated Q (K4, rope)
  const bf16* k;                // (B, Hk, Skv, D), or rotated K (K3, rope)
  const bf16* v;
  const bf16* dout;             // (B, Hq, Sq, D)
  const float* lse;             // (B, Hq, Sq) contiguous
  const float* delta;           // (B, Hq, Sq) contiguous
  void* dq;                     // (B, Hq, Sq, D), bf16 or f32 (OutT)
  void* dk;                     // (B, Hk, Skv, D), bf16 or f32 (OutT)
  void* dv;
  float* partial;               // K4 reduce: (2, splits, B, Hk, Skv, D) f32
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  const float* cos;
  const float* sin;
  long long tab_rs;
  const unsigned char* mask;
  long long mask_sb;
  int hq, group, sq, skv, causal, splits, per_split;
  float scale, scale_log2e;
};

// Shared memory of a block: two resident tiles of `rows` rows, the ring
// of `stages` stages of two `tile_rows`-row tiles and `extra` bytes each,
// the barriers, and the slack that aligns the tiles to the swizzle.
template <int D>
constexpr int smem_bytes(int rows, int stages, int tile_rows, int extra) {
  return 2 * rows * D * 2 + stages * (2 * tile_rows * D * 2 + extra) +
         2 * stages * static_cast<int>(sizeof(uint64_t)) + kSwizzleAtomBytes;
}

// The resident tiles, each ROWS rows of one (b, h) from row row0 on: the
// rows of `rope_src` rotated (no norm), times `post` and rounded with
// rope, else copied, into the tile at sa (generic address tile_a), and the
// rows of `src` copied into the tile at sb; by the consumer threads, then
// published to the tensor cores.
template <int D, int ROWS, bool ROPE>
__device__ __forceinline__ void load_resident(
    const bf16* rope_src, long long rope_ss, const bf16* src, long long ss,
    int row0, const BwdArgs& a, float post, unsigned char* tile_a,
    uint32_t sa, uint32_t sb, int tid) {
  cp_async_tile<D, ROWS, kConsumers>(src + row0 * ss, ss, sb, tid);
  if (ROPE) {
    const int lane = tid % 32;
#pragma unroll 4
    for (int r = tid / 32; r < ROWS; r += kConsumers / 32) {
      const int row = row0 + r;
      float y[D / 32];
      norm_rope_vals<D>(rope_src + row * rope_ss, y, a.cos + row * a.tab_rs,
                        a.sin + row * a.tab_rs, nullptr, 0.f, post, lane);
#pragma unroll
      for (int t = 0; t < D / 32; ++t)
        *reinterpret_cast<bf16*>(tile_a + swizzled_offset<ROWS>(
                                              r, lane + 32 * t)) =
            __float2bfloat16_rn(y[t]);
    }
  } else {
    cp_async_tile<D, ROWS, kConsumers>(rope_src + row0 * rope_ss, rope_ss,
                                       sa, tid);
  }
  cp_async_wait_all();
  fence_proxy_async();
  named_barrier_sync(3, kConsumers);
  fence_proxy_async();
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
}

// A special register read anew: a value derived from it after a long loop
// is computed there, and need not stay live across the loop.
__device__ __forceinline__ int read_tid() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(v));
  return v;
}

// x, as the compiler cannot see it: a descriptor derived from it inside a
// loop is made there, not kept across the loop with all its k steps.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  uint32_t y;
  asm volatile("mov.u32 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ int3 read_ctaid() {
  int3 v;
  asm volatile("mov.u32 %0, %%ctaid.x;\nmov.u32 %1, %%ctaid.y;\n"
               "mov.u32 %2, %%ctaid.z;\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z));
  return v;
}

// acc (64 x N) = A B^T over D, both K-major: the A tile's 64 rows at
// desc_a in a tile of AR rows, the B tile of N rows at desc_b.
template <int D, int AR, int N>
__device__ __forceinline__ void score_product(float (&acc)[N / 8][4],
                                              uint64_t desc_a,
                                              uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<N>(acc, desc_advance(desc_a, kmajor_kstep<AR>(kk)),
                desc_advance(desc_b, kmajor_kstep<N>(kk)), kk != 0);
}

// acc (64 x N) += A B over the R rows of a ring tile: A from registers, B
// the tile's N columns from `tile` (a 64-column block) on, as they lie
// (MN-major).
template <int N, int R>
__device__ __forceinline__ void grad_product(float (&acc)[N / 8][4],
                                             const uint32_t (&a)[R / 16][4],
                                             uint32_t tile) {
  const uint64_t desc =
      wgmma_desc(tile, R * kSwizzleRowBytes, kSwizzleAtomBytes);
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk)
    wgmma_rs<N>(acc, a[kk], desc_advance(desc, kk * 2 * kSwizzleAtomBytes));
}

// One thread: a ring stage's TMA copies, 64 columns at a time, of two
// tiles of R rows at sequence row `row`.
template <int D, int R>
__device__ __forceinline__ void tma_stage(const TileMap& m0,
                                          const TileMap& m1, uint32_t s0,
                                          uint32_t s1, int row, int h, int b,
                                          uint64_t* bar) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) {
    const uint32_t off = cb * R * kSwizzleRowBytes;
    tma_load_tile(m0, s0 + off, cb * 64, row, h, b, bar);
    tma_load_tile(m1, s1 + off, cb * 64, row, h, b, bar);
  }
}

// ------------------------------------------------------------------- K3

template <int D, bool ROPE, bool MASKED, typename OutT>
__global__ void __launch_bounds__(kBlockThreads, 1) flash_bwd_dq_kernel(
    const __grid_constant__ TileMap map_k,
    const __grid_constant__ TileMap map_v, BwdArgs a) {
  constexpr int KR = DqTiles<D>::kv, kStages = DqTiles<D>::stages;
  constexpr uint32_t kResBytes = kQRows * D * 2;
  constexpr uint32_t kTileBytes = KR * D * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + kSwizzleAtomBytes - 1) & ~(kSwizzleAtomBytes - 1);
  unsigned char* smem = smem_raw + (sQ - raw);
  const uint32_t sDO = sQ + kResBytes, sK = sDO + kResBytes;
  const uint32_t sV = sK + kStages * kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + 2 * kResBytes + 2 * kStages * kTileBytes);
  uint64_t* empty = full + kStages;

  // kConsumers consumer threads, then the producer's warpgroup
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, hkv = h / a.group;
  const int q0 = blockIdx.x * kQRows;
  const int n_tiles = a.skv / KR;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    setmaxnreg_dec<24>();
    // the producer: (K tile, V tile) stages, up to kStages ahead
    if (tid == kConsumers) {
#pragma unroll 1
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&empty[st], (t / kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[st], 2 * kTileBytes);
        tma_stage<D, KR>(map_k, map_v, sK + st * kTileBytes,
                         sV + st * kTileBytes, t * KR, hkv, b, &full[st]);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  // the q tile (rotated, scaled and rounded with rope) and the do tile
  load_resident<D, kQRows, ROPE>(a.q + b * a.q_sb + h * a.q_sh, a.q_ss,
                                 a.dout + b * a.do_sb + h * a.do_sh, a.do_ss,
                                 q0, a, a.scale_log2e, smem, sQ, sDO, tid);

  const int row_a = q0 + wg * 64 + warp * 16 + g, row_b = row_a + 8;
  const long long bh = static_cast<long long>(b) * a.hq + h;
  const float lse0 = a.lse[bh * a.sq + row_a];
  const float lse1 = a.lse[bh * a.sq + row_b];
  const float dl0 = a.delta[bh * a.sq + row_a];
  const float dl1 = a.delta[bh * a.sq + row_b];
  const unsigned char* mask =
      MASKED && a.mask != nullptr ? a.mask + b * a.mask_sb : nullptr;
  // The descriptor of this warpgroup's 64 rows of a resident tile, made
  // anew in every stage from the thread index read anew: descriptors kept
  // across the loop are kept with all their k steps, 128 registers at
  // D = 256.
  auto resident_desc = [&](uint32_t tile) {
    return wgmma_desc(tile + (read_tid() / 128) * 64 * kSwizzleRowBytes, 16,
                      kSwizzleAtomBytes);
  };

  float dq[D / 8][4], s[KR / 8][4], dp[KR / 8][4];
  uint32_t ds[KR / 16][4];
  zero(dq);

  // s = q k^T and dp = do v^T for kv tile t, queued and committed
  auto score_products = [&](int t) {
    const int st = t % kStages;
    mbar_wait(&full[st], (t / kStages) & 1);
    wgmma_fresh(s);
    wgmma_fresh(dp);
    wgmma_fence();
    score_product<D, kQRows, KR>(
        s, resident_desc(sQ),
        wgmma_desc(sK + st * kTileBytes, 16, kSwizzleAtomBytes));
    score_product<D, kQRows, KR>(
        dp, resident_desc(sDO),
        wgmma_desc(sV + st * kTileBytes, 16, kSwizzleAtomBytes));
    wgmma_commit();
  };
  // dq += bf16(ds) k for kv tile t, queued and committed
  auto dq_product = [&](int t) {
    wgmma_pin(dq);
    wgmma_fence();
    grad_product<D, KR>(dq, ds, sK + (t % kStages) * kTileBytes);
    wgmma_commit();
  };
  // The masked body's kv mask of a tile, loaded while its scores are in
  // flight: one key a lane in each 32, which ds_tile turns into ballots
  constexpr int kWords = KR / 32;
  bool kept[kWords];
  auto fetch_mask = [&](int t) {
    if (MASKED) {
#pragma unroll
      for (int c = 0; c < kWords; ++c)
        kept[c] = mask == nullptr || mask[t * KR + 32 * c + lane] != 0;
    }
  };
  // the scores of kv tile t -> ds = p (dp - delta) scale, in s; then ds
  // rounded to bf16, the A operand of the dq product
  auto ds_tile = [&](int t) {
    if (!ROPE) {
      // without rope the scale is not folded into q: the TPU's _logits
#pragma unroll
      for (int jj = 0; jj < KR / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] *= a.scale_log2e;
    }
    if (MASKED) {
      const int kv0 = t * KR;
      // bit 8 (jj % 4) + (e & 1) of w[jj / 4] is this thread's column
      // 8 jj + 2 t4 + (e & 1) of the tile
      uint32_t w[kWords];
      bool all = true;
#pragma unroll
      for (int c = 0; c < kWords; ++c) {
        const uint32_t word = __ballot_sync(0xffffffffu, kept[c]);
        all = all && word == ~0u;
        w[c] = word >> (2 * t4);
      }
      // a causal tile wholly at or below the warp's first row needs no test
      if (!all || (a.causal && kv0 + KR - 1 > row_a - g)) {
#pragma unroll
        for (int jj = 0; jj < KR / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kv0 + jj * 8 + t4 * 2 + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            const bool keep =
                ((w[jj >> 2] >> ((jj & 3) * 8 + (e & 1))) & 1u) &&
                (!a.causal || col <= row);
            if (!keep) s[jj][e] = kNegInf;
          }
      }
    }
#pragma unroll
    for (int jj = 0; jj < KR / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(s[jj][e] - (e < 2 ? lse0 : lse1));
        s[jj][e] = p * (dp[jj][e] - (e < 2 ? dl0 : dl1)) * a.scale;
      }
#pragma unroll
    for (int kk = 0; kk < KR / 16; ++kk)
      pack_a(ds[kk], s[2 * kk], s[2 * kk + 1]);
  };

  // Per kv tile a warpgroup queues the dq product of the tile before and
  // the score products of this one, then forms ds while the other
  // warpgroup's products run: named barrier 1 + wg opens warpgroup wg's
  // turn, and warpgroup 1 opens the first one. The last tile is peeled, so
  // that no product is queued under a condition.
  auto turn_wait = [&]() { named_barrier_sync(1 + wg, kConsumers); };
  auto turn_pass = [&]() { named_barrier_arrive(2 - wg, kConsumers); };
  if (wg == 1) named_barrier_arrive(1, kConsumers);
  turn_wait();
  score_products(0);
  turn_pass();
  fetch_mask(0);
  wgmma_wait<0>();
  wgmma_pin(s);
  wgmma_pin(dp);
  ds_tile(0);
#pragma unroll 1
  for (int j = 1; j < n_tiles; ++j) {
    turn_wait();
    dq_product(j - 1);
    score_products(j);
    turn_pass();
    fetch_mask(j);
    wgmma_wait<0>();
    wgmma_pin(dq);
    wgmma_pin(s);
    wgmma_pin(dp);
    wgmma_pin_a(ds);
    mbar_arrive(&empty[(j - 1) % kStages]);
    ds_tile(j);
  }
  dq_product(n_tiles - 1);
  wgmma_wait<0>();
  wgmma_pin(dq);
  wgmma_pin_a(ds);

  if (ROPE) counter_rotate<D>(dq, a.cos, a.sin, a.tab_rs, row_a, row_b, t4);
  store_rows<D>(static_cast<OutT*>(a.dq) + b * a.dq_sb + h * a.dq_sh, a.dq_ss,
                dq, row_a, row_b, t4);
}

// ------------------------------------------------------------------- K4

// Rows row_a and row_b of a C-fragment accumulator of N columns in f32,
// into rows of STRIDE floats.
template <int N, int STRIDE>
__device__ __forceinline__ void store_rows_f32(float* base,
                                               const float (*acc)[4],
                                               int row_a, int row_b, int t4) {
#pragma unroll
  for (int dn = 0; dn < N / 8; ++dn) {
    const int col = dn * 8 + t4 * 2;
    *reinterpret_cast<float2*>(base + row_a * STRIDE + col) =
        make_float2(acc[dn][0], acc[dn][1]);
    *reinterpret_cast<float2*>(base + row_b * STRIDE + col) =
        make_float2(acc[dn][2], acc[dn][3]);
  }
}

// The f32 partial sums of a K4 block's split, (2, splits, B, Hk, Skv, D):
// where rows of dk (which 0) or dv (which 1) of this block's (split, b,
// kv head) start.
template <int D>
__device__ __forceinline__ float* partial_rows(const BwdArgs& a, int3 blk,
                                               int which) {
  const int hk = blk.y, b = blk.z / a.splits, split = blk.z % a.splits;
  const long long half =
      static_cast<long long>(gridDim.z) * gridDim.y * a.skv * D;
  return a.partial + which * half +
         ((static_cast<long long>(split) * (gridDim.z / a.splits) + b) *
              gridDim.y + hk) * a.skv * D;
}

// K4's epilogue up to D = 128: dk and dv of the thread's rows,
// counter-rotated and written as OutT (bf16: rounded), or as f32 partial
// sums for the reduce kernel. It derives its rows and pointers from the
// indices read anew: at D = 128 the main loop has no register to spare for
// them.
template <int D, bool ROPE, typename OutT>
__device__ __forceinline__ void store_dkv(float (&dk)[D / 8][4],
                                          float (&dv)[D / 8][4],
                                          const BwdArgs& a) {
  constexpr int BR = DkvTiles<D>::block;
  const int tid = read_tid();
  const int3 blk = read_ctaid();
  const int lane = tid % 32, t4 = lane & 3, wg = tid / 128;
  const int hk = blk.y, b = blk.z / a.splits;
  const int row_a = blk.x * BR + wg * 64 + (tid % 128) / 32 * 16 +
                    (lane >> 2);
  const int row_b = row_a + 8;
  if (a.partial != nullptr) {
    store_rows_f32<D, D>(partial_rows<D>(a, blk, 0), dk, row_a, row_b, t4);
    store_rows_f32<D, D>(partial_rows<D>(a, blk, 1), dv, row_a, row_b, t4);
    return;
  }
  // dv first: its registers are free while dk is counter-rotated
  store_rows<D>(static_cast<OutT*>(a.dv) + b * a.dv_sb + hk * a.dv_sh,
                a.dv_ss, dv, row_a, row_b, t4);
  if (ROPE) counter_rotate<D>(dk, a.cos, a.sin, a.tab_rs, row_a, row_b, t4);
  store_rows<D>(static_cast<OutT*>(a.dk) + b * a.dk_sb + hk * a.dk_sh,
                a.dk_ss, dk, row_a, row_b, t4);
}

// One thread of K4's producer warpgroup up to D = 128: the (q tile, do
// tile, lse, delta) stages of the block's share, the n stages from
// `first` on of its (head of the group, q tile) pairs, each into ring slot
// t % STAGES once the consumers have freed it.
template <int D>
__device__ __forceinline__ void produce_dkv(
    const TileMap& map_q, const TileMap& map_do, const BwdArgs& a,
    uint32_t sQ, uint32_t sDO, uint32_t sL, uint32_t sDl, uint64_t* full,
    uint64_t* empty, int hk, int b, int first, int nq, int n) {
  constexpr int STAGES = DkvTiles<D>::stages;
  constexpr uint32_t kTileBytes = kRows * D * 2, kVecBytes = kRows * 4;
#pragma unroll 1
  for (int t = 0; t < n; ++t) {
    const int st = t % STAGES;
    if (t >= STAGES) mbar_wait(&empty[st], (t / STAGES - 1) & 1);
    mbar_arrive_expect_tx(&full[st], 2 * kTileBytes + 2 * kVecBytes);
    const int idx = first + t, h = hk * a.group + idx / nq;
    const int q_row = (idx % nq) * kRows;
    tma_stage<D, kRows>(map_q, map_do, sQ + st * kTileBytes,
                        sDO + st * kTileBytes, q_row, h, b, &full[st]);
    const long long r = (static_cast<long long>(b) * a.hq + h) * a.sq +
                        q_row;
    bulk_load(sL + st * kVecBytes, a.lse + r, kVecBytes, &full[st]);
    bulk_load(sDl + st * kVecBytes, a.delta + r, kVecBytes, &full[st]);
  }
}

// q column c of a stage is masked for kv row `row` where c < key(row) - the
// stage's first q row: every column when the kv mask drops the row, the
// columns before it under the causal mask, none otherwise.
__device__ __forceinline__ int masked_below(const BwdArgs& a,
                                            const unsigned char* mask,
                                            int row) {
  constexpr int kAll = 1 << 30, kNone = -(1 << 30);
  return mask != nullptr && !mask[row] ? kAll : a.causal ? row : kNone;
}

template <int D, bool ROPE, bool MASKED, typename OutT>
__global__ void __launch_bounds__(kBlockThreads, 1) flash_bwd_dkv_kernel(
    const __grid_constant__ TileMap map_q,
    const __grid_constant__ TileMap map_do, BwdArgs a) {
  static_assert(D <= 128, "D = 256 takes flash_bwd_dkv_roles_kernel");
  constexpr int BR = DkvTiles<D>::block, kStages = DkvTiles<D>::stages;
  constexpr uint32_t kResBytes = BR * D * 2;
  constexpr uint32_t kTileBytes = kRows * D * 2;
  constexpr uint32_t kVecBytes = kRows * 4;     // lse or delta of a stage
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + kSwizzleAtomBytes - 1) & ~(kSwizzleAtomBytes - 1);
  unsigned char* smem = smem_raw + (sK - raw);
  const uint32_t sV = sK + kResBytes, sQ = sV + kResBytes;
  const uint32_t sDO = sQ + kStages * kTileBytes;
  const uint32_t sL = sDO + kStages * kTileBytes;
  const uint32_t sDl = sL + kStages * kVecBytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + (sDl - sK) + kStages * kVecBytes);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const int hk = blockIdx.y, b = blockIdx.z / a.splits;
  const int split = blockIdx.z % a.splits;
  const int k0 = blockIdx.x * BR;
  // this block's share of the (head of the group, q tile) stages
  const int nq = a.sq / kRows, first = split * a.per_split;
  const int n = min(a.group * nq - first, a.per_split);

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    setmaxnreg_dec<24>();
    if (tid == kConsumers)
      produce_dkv<D>(map_q, map_do, a, sQ, sDO, sL, sDl, full, empty, hk, b,
                     first, nq, n);
    return;
  }

  setmaxnreg_inc<240>();
  // the k tile (rotated and rounded, no scale, with rope) and the v tile
  load_resident<D, BR, ROPE>(a.k + b * a.k_sb + hk * a.k_sh, a.k_ss,
                             a.v + b * a.v_sb + hk * a.v_sh, a.v_ss, k0, a,
                             1.f, smem, sK, sV, tid);

  int key_a = 0, key_b = 0;
  if (MASKED) {
    const int row_a = k0 + wg * 64 + warp * 16 + g;
    const unsigned char* mask =
        a.mask != nullptr ? a.mask + b * a.mask_sb : nullptr;
    key_a = masked_below(a, mask, row_a);
    key_b = masked_below(a, mask, row_a + 8);
  }
  // The descriptor of this warpgroup's 64 rows of a resident tile, made
  // anew in every stage from the thread index read anew: descriptors kept
  // across the loop are kept with all their k steps, and at D = 128 the
  // loop has no registers for them (ptxas spilled them).
  auto resident_desc = [&](uint32_t tile) {
    return wgmma_desc(tile + (read_tid() / 128) * 64 * kSwizzleRowBytes, 16,
                      kSwizzleAtomBytes);
  };

  float dk[D / 8][4], dv[D / 8][4], s[kRows / 8][4], dp[kRows / 8][4];
  uint32_t pa[kRows / 16][4], da[kRows / 16][4];
  zero(dk);
  zero(dv);

  // s^T = k q^T and dp^T = v do^T for stage t, queued and committed
  auto score_products = [&](int t) {
    const int st = t % kStages;
    mbar_wait(&full[st], (t / kStages) & 1);
    wgmma_fresh(s);
    wgmma_fresh(dp);
    wgmma_fence();
    score_product<D, BR, kRows>(
        s, resident_desc(sK),
        wgmma_desc(sQ + st * kTileBytes, 16, kSwizzleAtomBytes));
    score_product<D, BR, kRows>(
        dp, resident_desc(sV),
        wgmma_desc(sDO + st * kTileBytes, 16, kSwizzleAtomBytes));
    wgmma_commit();
  };
  // dv += bf16(p)^T do and dk += bf16(ds)^T q for stage t
  auto kv_products = [&](int t) {
    const int st = t % kStages;
    wgmma_pin(dk);
    wgmma_pin(dv);
    wgmma_fence();
    grad_product<D, kRows>(dv, pa, sDO + st * kTileBytes);
    grad_product<D, kRows>(dk, da, sQ + st * kTileBytes);
    wgmma_commit();
  };
  // the scores of stage t -> p^T = exp2(s^T scale log2(e) - lse[col]) and
  // ds^T = p^T (dp^T - delta[col]) scale, 16 columns at a time, each block
  // rounded to bf16 (the A operands of the dv and dk products) as soon as
  // it is formed
  auto p_ds_tile = [&](int t) {
    const int st = t % kStages;
    const uint32_t lse = sL + st * kVecBytes, delta = sDl + st * kVecBytes;
    const int q_row = MASKED ? ((first + t) % nq) * kRows : 0;
    const int lim_a = key_a - q_row, lim_b = key_b - q_row;
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
#pragma unroll
      for (int jj = 2 * kk; jj < 2 * kk + 2; ++jj) {
        const int c = jj * 8 + t4 * 2;
        const float2 l = ld_shared_f2(lse + c * 4);
        const float2 dl = ld_shared_f2(delta + c * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[jj][e] * a.scale_log2e;
          if (MASKED && c + (e & 1) < (e < 2 ? lim_a : lim_b)) x = kNegInf;
          const float p = fast_exp2(x - ((e & 1) ? l.y : l.x));
          s[jj][e] = p;
          dp[jj][e] = p * (dp[jj][e] - ((e & 1) ? dl.y : dl.x)) * a.scale;
        }
      }
      pack_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
      pack_a(da[kk], dp[2 * kk], dp[2 * kk + 1]);
    }
  };

  // Per stage, in its turn, a warpgroup queues the dv and dk products of
  // the stage before and, once they are done (their A operands and the
  // stage free), the score products of this one: dk, dv, s and dp with p
  // and ds beside them do not fit the 240 registers at D = 128 while both
  // groups of products are in flight (ptxas spilled and serialized the
  // pipeline). The tensor cores then take a warpgroup's four products in
  // a row, and its p and ds run under the other's. The last stage is
  // peeled, as in K3.
  auto turn_wait = [&]() { named_barrier_sync(1 + wg, kConsumers); };
  auto turn_pass = [&]() { named_barrier_arrive(2 - wg, kConsumers); };
  if (wg == 1) named_barrier_arrive(1, kConsumers);
  turn_wait();
  score_products(0);
  turn_pass();
  wgmma_wait<0>();
  wgmma_pin(s);
  wgmma_pin(dp);
  p_ds_tile(0);
#pragma unroll 1
  for (int t = 1; t < n; ++t) {
    turn_wait();
    kv_products(t - 1);
    wgmma_wait<0>();
    wgmma_pin(dk);
    wgmma_pin(dv);
    wgmma_pin_a(pa);
    wgmma_pin_a(da);
    mbar_arrive(&empty[(t - 1) % kStages]);
    score_products(t);
    turn_pass();
    wgmma_wait<0>();
    wgmma_pin(s);
    wgmma_pin(dp);
    p_ds_tile(t);
  }
  kv_products(n - 1);
  wgmma_wait<0>();
  wgmma_pin(dk);
  wgmma_pin(dv);
  wgmma_pin_a(pa);
  wgmma_pin_a(da);

  store_dkv<D, ROPE, OutT>(dk, dv, a);
}

// ------------------------------------------------ K4 at D = 256, by role

constexpr int kRoleRows = DkvTiles<256>::block;   // kv rows of a block
constexpr uint32_t kPBytes = kRoleRows * kRows * 4;  // f32 p^T of a stage
// named barriers of the p^T buffers: buffer i written (kPWritten + i) and
// read (kPRead + i), each by one warpgroup's arrival and the other's sync
constexpr int kPWritten = 4, kPRead = 6;

// Where the roles kernel's tiles lie in shared memory: K and V resident,
// the q ring (q tiles and lse rows) and the do ring (do tiles and delta
// rows), the two p^T buffers, and each ring's barriers.
struct RoleSmem {
  uint32_t k, v, q, dout, lse, delta, p;
  uint64_t* full_q;
  uint64_t* full_do;
  uint64_t* empty_q;
  uint64_t* empty_do;
};

// One thread of the roles kernel's producer warpgroup: the block's n
// stages, each a q tile with its lse rows into the q ring and a do tile
// with its delta rows into the do ring, each ring's slot once its readers
// have freed it.
__device__ __forceinline__ void produce_roles(
    const TileMap& map_q, const TileMap& map_do, const BwdArgs& a,
    const RoleSmem& m, int hk, int b, int first, int nq, int n) {
  constexpr int kStages = DkvTiles<256>::stages;
  constexpr uint32_t kTileBytes = kRows * 256 * 2, kVecBytes = kRows * 4;
#pragma unroll 1
  for (int t = 0; t < n; ++t) {
    const int st = t % kStages, phase = (t / kStages - 1) & 1;
    const int idx = first + t, h = hk * a.group + idx / nq;
    const int q_row = (idx % nq) * kRows;
    const long long r = (static_cast<long long>(b) * a.hq + h) * a.sq +
                        q_row;
    if (t >= kStages) mbar_wait(&m.empty_q[st], phase);
    mbar_arrive_expect_tx(&m.full_q[st], kTileBytes + kVecBytes);
#pragma unroll
    for (int cb = 0; cb < 4; ++cb)
      tma_load_tile(map_q, m.q + st * kTileBytes + cb * kRows *
                               kSwizzleRowBytes,
                    cb * 64, q_row, h, b, &m.full_q[st]);
    bulk_load(m.lse + st * kVecBytes, a.lse + r, kVecBytes, &m.full_q[st]);
    if (t >= kStages) mbar_wait(&m.empty_do[st], phase);
    mbar_arrive_expect_tx(&m.full_do[st], kTileBytes + kVecBytes);
#pragma unroll
    for (int cb = 0; cb < 4; ++cb)
      tma_load_tile(map_do, m.dout + st * kTileBytes + cb * kRows *
                                 kSwizzleRowBytes,
                    cb * 64, q_row, h, b, &m.full_do[st]);
    bulk_load(m.delta + st * kVecBytes, a.delta + r, kVecBytes,
              &m.full_do[st]);
  }
}

// A role's gradient (dk: which 0, dv: which 1) of the block's 64 kv rows,
// all 256 columns: as OutT (bf16: rounded) at its strides, dk
// counter-rotated with rope, or as f32 partial sums for the reduce kernel
// (which rotates them).
template <bool ROPE, typename OutT>
__device__ __forceinline__ void store_role(float (&acc)[32][4],
                                           const BwdArgs& a, int which) {
  const int tid = read_tid();
  const int3 blk = read_ctaid();
  const int lane = tid % 32, t4 = lane & 3;
  const int row_a = blk.x * kRoleRows + (tid % 128) / 32 * 16 + (lane >> 2);
  const int row_b = row_a + 8;
  if (a.partial != nullptr) {
    store_rows_f32<256, 256>(partial_rows<256>(a, blk, which), acc, row_a,
                             row_b, t4);
    return;
  }
  const int hk = blk.y, b = blk.z / a.splits;
  if (which == 0) {
    if (ROPE)
      counter_rotate<256>(acc, a.cos, a.sin, a.tab_rs, row_a, row_b, t4);
    store_rows<256>(static_cast<OutT*>(a.dk) + b * a.dk_sb + hk * a.dk_sh,
                    a.dk_ss, acc, row_a, row_b, t4);
  } else {
    store_rows<256>(static_cast<OutT*>(a.dv) + b * a.dv_sb + hk * a.dv_sh,
                    a.dv_ss, acc, row_a, row_b, t4);
  }
}

// Warpgroup 0 of the roles kernel, over the block's n stages: s^T = k q^T,
// p^T = exp2(s^T scale log2(e) - lse[col]) with the masks, p^T in f32 into
// buffer t % 2 for warpgroup 1, and dv += bf16(p)^T do over all 256
// columns. Per stage it queues the dv product of the stage before, then,
// once this stage's q tile has landed, the score product of this one; it
// gives each tile back as soon as its last product here is done, forms p^T
// while warpgroup 1's products run, and writes a buffer once warpgroup 1
// has read what it held.
template <bool MASKED, typename OutT>
__device__ __forceinline__ void dkv_p_role(const BwdArgs& a,
                                           const RoleSmem& m, int n,
                                           int first, int nq, int k0) {
  constexpr int D = 256, kStages = DkvTiles<D>::stages;
  constexpr uint32_t kTileBytes = kRows * D * 2, kVecBytes = kRows * 4;
  const int lane = threadIdx.x % 32, t4 = lane & 3;
  int key_a = 0, key_b = 0;
  if (MASKED) {
    const int row_a = k0 + threadIdx.x / 32 * 16 + (lane >> 2);
    const unsigned char* mask =
        a.mask != nullptr ? a.mask + (blockIdx.z / a.splits) * a.mask_sb
                          : nullptr;
    key_a = masked_below(a, mask, row_a);
    key_b = masked_below(a, mask, row_a + 8);
  }
  float dv[D / 8][4], s[kRows / 8][4];
  uint32_t pa[kRows / 16][4];
  zero(dv);

  // s^T for stage t, queued and committed
  auto score = [&](int t) {
    wgmma_fresh(s);
    wgmma_fence();
    score_product<D, kRoleRows, kRows>(
        s, wgmma_desc(opaque(m.k), 16, kSwizzleAtomBytes),
        wgmma_desc(m.q + (t % kStages) * kTileBytes, 16, kSwizzleAtomBytes));
    wgmma_commit();
  };
  // dv += bf16(p)^T do for stage t, queued and committed
  auto dv_product = [&](int t) {
    wgmma_pin(dv);
    wgmma_fence();
    grad_product<D, kRows>(dv, pa, m.dout + (t % kStages) * kTileBytes);
    wgmma_commit();
  };
  // the scores of stage t -> p^T, 8 columns at a time into the buffer (a
  // float4 a thread: conflict-free), then rounded to bf16, the A operand
  // of the dv product
  auto p_tile = [&](int t) {
    const uint32_t lse = m.lse + (t % kStages) * kVecBytes;
    const uint32_t out = m.p + (t & 1) * kPBytes + (threadIdx.x % 128) * 16;
    const int q_row = MASKED ? ((first + t) % nq) * kRows : 0;
    const int lim_a = key_a - q_row, lim_b = key_b - q_row;
#pragma unroll
    for (int jj = 0; jj < kRows / 8; ++jj) {
      const int c = jj * 8 + t4 * 2;
      const float2 l = ld_shared_f2(lse + c * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[jj][e] * a.scale_log2e;
        if (MASKED && c + (e & 1) < (e < 2 ? lim_a : lim_b)) x = kNegInf;
        s[jj][e] = fast_exp2(x - ((e & 1) ? l.y : l.x));
      }
      st_shared_f4(out + jj * 128 * 16, s[jj]);
    }
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
      pack_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
  };

  // stage t's slot and the phase its full barriers complete
  auto slot = [](int t) { return t % kStages; };
  auto phase = [](int t) { return (t / kStages) & 1; };
  mbar_wait(&m.full_q[0], 0);
  score(0);
  wgmma_wait<0>();
  wgmma_pin(s);
  mbar_arrive(&m.empty_q[0]);
  p_tile(0);
  named_barrier_arrive(kPWritten, kConsumers);
#pragma unroll 1
  for (int t = 1; t < n; ++t) {
    mbar_wait(&m.full_do[slot(t - 1)], phase(t - 1));
    dv_product(t - 1);
    mbar_wait(&m.full_q[slot(t)], phase(t));
    score(t);
    wgmma_wait<1>();
    wgmma_pin(dv);
    wgmma_pin_a(pa);
    mbar_arrive(&m.empty_do[slot(t - 1)]);
    wgmma_wait<0>();
    wgmma_pin(s);
    mbar_arrive(&m.empty_q[slot(t)]);
    if (t >= 2) named_barrier_sync(kPRead + (t & 1), kConsumers);
    p_tile(t);
    named_barrier_arrive(kPWritten + (t & 1), kConsumers);
  }
  mbar_wait(&m.full_do[slot(n - 1)], phase(n - 1));
  dv_product(n - 1);
  wgmma_wait<0>();
  wgmma_pin(dv);
  wgmma_pin_a(pa);
  // the reads of the last two buffers: each barrier ends as it began
  for (int t = max(n - 2, 0); t < n; ++t)
    named_barrier_sync(kPRead + (t & 1), kConsumers);
  store_role<false, OutT>(dv, a, 1);
}

// Warpgroup 1 of the roles kernel, over the block's n stages: dp^T = v
// do^T, ds^T = p^T (dp^T - delta[col]) scale with warpgroup 0's f32 p^T,
// and dk += bf16(ds)^T q over all 256 columns, counter-rotated with rope.
// Per stage it queues the dk product of the stage before and, once this
// stage's do tile has landed, the dp product of this one, as warpgroup 0
// does, then waits for p^T and forms ds^T.
template <bool ROPE, typename OutT>
__device__ __forceinline__ void dkv_ds_role(const BwdArgs& a,
                                            const RoleSmem& m, int n) {
  constexpr int D = 256, kStages = DkvTiles<D>::stages;
  constexpr uint32_t kTileBytes = kRows * D * 2, kVecBytes = kRows * 4;
  const int t4 = threadIdx.x % 4;
  float dk[D / 8][4], dp[kRows / 8][4];
  uint32_t da[kRows / 16][4];
  zero(dk);

  // dp^T for stage t, queued and committed
  auto dp_product = [&](int t) {
    wgmma_fresh(dp);
    wgmma_fence();
    score_product<D, kRoleRows, kRows>(
        dp, wgmma_desc(opaque(m.v), 16, kSwizzleAtomBytes),
        wgmma_desc(m.dout + (t % kStages) * kTileBytes, 16,
                   kSwizzleAtomBytes));
    wgmma_commit();
  };
  // dk += bf16(ds)^T q for stage t, queued and committed
  auto dk_product = [&](int t) {
    wgmma_pin(dk);
    wgmma_fence();
    grad_product<D, kRows>(dk, da, m.q + (t % kStages) * kTileBytes);
    wgmma_commit();
  };
  // dp^T of stage t and its p^T -> ds^T, rounded to bf16, the A operand of
  // the dk product; the buffer is given back as soon as it is read
  auto ds_tile = [&](int t) {
    const uint32_t delta = m.delta + (t % kStages) * kVecBytes;
    const uint32_t in = m.p + (t & 1) * kPBytes + (threadIdx.x % 128) * 16;
    named_barrier_sync(kPWritten + (t & 1), kConsumers);
#pragma unroll
    for (int jj = 0; jj < kRows / 8; ++jj) {
      const float2 dl = ld_shared_f2(delta + (jj * 8 + t4 * 2) * 4);
      const float4 p = ld_shared_f4(in + jj * 128 * 16);
      dp[jj][0] = p.x * (dp[jj][0] - dl.x) * a.scale;
      dp[jj][1] = p.y * (dp[jj][1] - dl.y) * a.scale;
      dp[jj][2] = p.z * (dp[jj][2] - dl.x) * a.scale;
      dp[jj][3] = p.w * (dp[jj][3] - dl.y) * a.scale;
    }
    named_barrier_arrive(kPRead + (t & 1), kConsumers);
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
      pack_a(da[kk], dp[2 * kk], dp[2 * kk + 1]);
  };

  auto slot = [](int t) { return t % kStages; };
  auto phase = [](int t) { return (t / kStages) & 1; };
  mbar_wait(&m.full_do[0], 0);
  dp_product(0);
  wgmma_wait<0>();
  wgmma_pin(dp);
  mbar_arrive(&m.empty_do[0]);
  ds_tile(0);
#pragma unroll 1
  for (int t = 1; t < n; ++t) {
    mbar_wait(&m.full_q[slot(t - 1)], phase(t - 1));
    dk_product(t - 1);
    mbar_wait(&m.full_do[slot(t)], phase(t));
    dp_product(t);
    wgmma_wait<1>();
    wgmma_pin(dk);
    wgmma_pin_a(da);
    mbar_arrive(&m.empty_q[slot(t - 1)]);
    wgmma_wait<0>();
    wgmma_pin(dp);
    mbar_arrive(&m.empty_do[slot(t)]);
    ds_tile(t);
  }
  mbar_wait(&m.full_q[slot(n - 1)], phase(n - 1));
  dk_product(n - 1);
  wgmma_wait<0>();
  wgmma_pin(dk);
  wgmma_pin_a(da);
  store_role<ROPE, OutT>(dk, a, 0);
}

// K4 at D = 256: one block per (64-row kv tile, kv head, batch x split),
// its producer in produce_roles, warpgroup 0 in dkv_p_role and warpgroup 1
// in dkv_ds_role.
template <bool ROPE, bool MASKED, typename OutT>
__global__ void __launch_bounds__(kBlockThreads, 1) flash_bwd_dkv_roles_kernel(
    const __grid_constant__ TileMap map_q,
    const __grid_constant__ TileMap map_do, BwdArgs a) {
  constexpr int D = 256, kStages = DkvTiles<D>::stages;
  constexpr uint32_t kResBytes = kRoleRows * D * 2;
  constexpr uint32_t kTileBytes = kRows * D * 2, kVecBytes = kRows * 4;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  RoleSmem m;
  m.k = (raw + kSwizzleAtomBytes - 1) & ~(kSwizzleAtomBytes - 1);
  unsigned char* smem = smem_raw + (m.k - raw);
  m.v = m.k + kResBytes;
  m.q = m.v + kResBytes;
  m.dout = m.q + kStages * kTileBytes;
  m.lse = m.dout + kStages * kTileBytes;
  m.delta = m.lse + kStages * kVecBytes;
  m.p = m.delta + kStages * kVecBytes;
  m.full_q = reinterpret_cast<uint64_t*>(smem + (m.p - m.k) + 2 * kPBytes);
  m.full_do = m.full_q + kStages;
  m.empty_q = m.full_do + kStages;
  m.empty_do = m.empty_q + kStages;

  const int tid = threadIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z / a.splits;
  const int split = blockIdx.z % a.splits;
  const int k0 = blockIdx.x * kRoleRows;
  const int nq = a.sq / kRows, first = split * a.per_split;
  const int n = min(a.group * nq - first, a.per_split);

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&m.full_q[st], 1);
      mbar_init(&m.full_do[st], 1);
      mbar_init(&m.empty_q[st], kConsumers);
      mbar_init(&m.empty_do[st], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    setmaxnreg_dec<24>();
    if (tid == kConsumers)
      produce_roles(map_q, map_do, a, m, hk, b, first, nq, n);
    return;
  }

  setmaxnreg_inc<240>();
  // the k tile (rotated and rounded, no scale, with rope) and the v tile,
  // by both warpgroups
  load_resident<D, kRoleRows, ROPE>(a.k + b * a.k_sb + hk * a.k_sh, a.k_ss,
                                    a.v + b * a.v_sb + hk * a.v_sh, a.v_ss,
                                    k0, a, 1.f, smem, m.k, m.v, tid);
  if (tid < 128)
    dkv_p_role<MASKED, OutT>(a, m, n, first, nq, k0);
  else
    dkv_ds_role<ROPE, OutT>(a, m, n);
}

__device__ __forceinline__ void put(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void put(float* p, float x) { *p = x; }

// K4's partial sums of its splits summed in split order, dk
// counter-rotated with rope, both written as OutT (bf16: rounded): one
// thread per row and column pair (j, j + D/2).
template <int D, typename OutT>
__global__ void __launch_bounds__(256) dkv_reduce_kernel(BwdArgs a, int hk,
                                                         long long rows) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= rows * (D / 2)) return;
  const int j = static_cast<int>(i % (D / 2));
  const long long r = i / (D / 2);            // ((b, h), s) over B Hk Skv
  const int s = static_cast<int>(r % a.skv);
  const int h = static_cast<int>((r / a.skv) % hk);
  const long long b = r / a.skv / hk;
  float k1 = 0.f, k2 = 0.f, v1 = 0.f, v2 = 0.f;
  for (int sp = 0; sp < a.splits; ++sp) {
    const float* pk = a.partial + (sp * rows + r) * D;
    const float* pv = pk + a.splits * rows * D;
    k1 += pk[j];
    k2 += pk[j + D / 2];
    v1 += pv[j];
    v2 += pv[j + D / 2];
  }
  if (a.cos != nullptr) {
    const float c = a.cos[s * a.tab_rs + j], sn = a.sin[s * a.tab_rs + j];
    const float g1 = k1;
    k1 = g1 * c + k2 * sn;
    k2 = k2 * c - g1 * sn;
  }
  OutT* dk = static_cast<OutT*>(a.dk) + b * a.dk_sb + h * a.dk_sh +
             s * a.dk_ss;
  OutT* dv = static_cast<OutT*>(a.dv) + b * a.dv_sb + h * a.dv_sh +
             s * a.dv_ss;
  put(dk + j, k1);
  put(dk + j + D / 2, k2);
  put(dv + j, v1);
  put(dv + j + D / 2, v2);
}

// ------------------------------------------------------------- launches

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, int smem,
                          const TileMap& m0, const TileMap& m1,
                          const BwdArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBlockThreads, smem, stream>>>(m0, m1, a);
  return cudaGetLastError();
}

// K3 (dq) or K4 (dk, dv) in the instance that the rope and the masks ask
// for. The f32 outputs (OutT float) have no rope instance.
template <int D, bool DQ, bool ROPE, typename OutT>
cudaError_t launch_masked(const TileMap& m0, const TileMap& m1,
                          const BwdArgs& a, dim3 grid, cudaStream_t stream) {
  const bool masked = a.mask != nullptr || a.causal;
  if constexpr (DQ) {
    auto k = masked ? &flash_bwd_dq_kernel<D, ROPE, true, OutT>
                    : &flash_bwd_dq_kernel<D, ROPE, false, OutT>;
    return launch_kernel(k, grid,
                         smem_bytes<D>(kQRows, DqTiles<D>::stages,
                                       DqTiles<D>::kv, 0),
                         m0, m1, a, stream);
  } else if constexpr (D == 256) {
    auto k = masked ? &flash_bwd_dkv_roles_kernel<ROPE, true, OutT>
                    : &flash_bwd_dkv_roles_kernel<ROPE, false, OutT>;
    return launch_kernel(k, grid,
                         smem_bytes<D>(kRoleRows, DkvTiles<D>::stages,
                                       kRows, 2 * kRows * 4) +
                             2 * kPBytes +
                             2 * DkvTiles<D>::stages * sizeof(uint64_t),
                         m0, m1, a, stream);
  } else {
    auto k = masked ? &flash_bwd_dkv_kernel<D, ROPE, true, OutT>
                    : &flash_bwd_dkv_kernel<D, ROPE, false, OutT>;
    return launch_kernel(k, grid,
                         smem_bytes<D>(DkvTiles<D>::block,
                                       DkvTiles<D>::stages, kRows,
                                       2 * kRows * 4),
                         m0, m1, a, stream);
  }
}

template <int D, bool DQ, typename OutT>
cudaError_t launch(const TileMap& m0, const TileMap& m1, const BwdArgs& a,
                   dim3 grid, cudaStream_t stream) {
  if constexpr (std::is_same<OutT, float>::value) {
    if (a.cos != nullptr) return cudaErrorInvalidValue;
    return launch_masked<D, DQ, false, OutT>(m0, m1, a, grid, stream);
  } else {
    return a.cos != nullptr
               ? launch_masked<D, DQ, true, OutT>(m0, m1, a, grid, stream)
               : launch_masked<D, DQ, false, OutT>(m0, m1, a, grid, stream);
  }
}

// Fill the arguments both entry points share; false on shapes the kernels
// do not take.
bool fill_args(BwdArgs& a, const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               const long long* st, const float* cos, const float* sin,
               long long tab_rs, const unsigned char* mask, long long mask_sb,
               int hq, int hk, int sq, int skv, int d, int causal,
               float scale, float scale_log2e) {
  if ((d != 64 && d != 128 && d != 256) || sq <= 0 || skv <= 0 ||
      sq % kQRows || skv % kQRows || hk <= 0 || hq % hk ||
      (cos != nullptr && sq != skv) ||
      reinterpret_cast<uintptr_t>(lse) % 16 ||
      reinterpret_cast<uintptr_t>(delta) % 16)
    return false;
  a = BwdArgs{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = lse;
  a.delta = delta;
  a.q_sb = st[0]; a.q_sh = st[1]; a.q_ss = st[2];
  a.k_sb = st[3]; a.k_sh = st[4]; a.k_ss = st[5];
  a.v_sb = st[6]; a.v_sh = st[7]; a.v_ss = st[8];
  a.do_sb = st[9]; a.do_sh = st[10]; a.do_ss = st[11];
  a.cos = cos;
  a.sin = sin;
  a.tab_rs = tab_rs;
  a.mask = mask;
  a.mask_sb = mask_sb;
  a.hq = hq;
  a.group = hq / hk;
  a.sq = sq;
  a.skv = skv;
  a.causal = causal;
  a.splits = 1;
  a.scale = scale;
  a.scale_log2e = scale_log2e;
  return true;
}

// x (B, H, S, D) at the strides in a -> rotated (no norm, no scale) into
// the contiguous bf16 scratch, which then stands for x.
cudaError_t rotate_into(const bf16*& x, long long& sb, long long& sh,
                        long long& ss, void* scratch, int batch, int heads,
                        int seq, int d, const BwdArgs& a,
                        cudaStream_t stream) {
  bf16* out = static_cast<bf16*>(scratch);
  const cudaError_t err = with_head_dim(d, [&](auto dim) {
    return launch_rope_rows<decltype(dim)::value>(
        x, out, sb, sh, ss, batch, heads, seq, a.cos, a.sin, a.tab_rs,
        nullptr, 0, 0.f, 1.f, stream);
  });
  x = out;
  ss = d;
  sh = static_cast<long long>(seq) * d;
  sb = sh * heads;
  return err;
}

// K3 on the arguments in `a` (q, k, v, do bf16), dq (OutT) at the (b, h, s)
// strides so[0..2].
template <typename OutT>
cudaError_t run_dq(BwdArgs& a, void* dq, const long long* so,
                   void* k_scratch, int batch, int hq, int hk, int sq,
                   int skv, int d, cudaStream_t stream) {
  a.dq = dq;
  a.dq_sb = so[0]; a.dq_sh = so[1]; a.dq_ss = so[2];
  cudaError_t err = cudaSuccess;
  if (a.cos != nullptr)
    // K rotated once per launch, no scale (K3 folds it into the q tile)
    err = rotate_into(a.k, a.k_sb, a.k_sh, a.k_ss, k_scratch, batch, hk, skv,
                      d, a, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid(sq / kQRows, hq, batch);
  return with_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    TileMap mk, mv;
    cudaError_t e = make_tile_map(&mk, a.k, a.k_sb, a.k_sh, a.k_ss, batch,
                                  hk, skv, d, DqTiles<D>::kv);
    if (e == cudaSuccess)
      e = make_tile_map(&mv, a.v, a.v_sb, a.v_sh, a.v_ss, batch, hk, skv, d,
                        DqTiles<D>::kv);
    if (e != cudaSuccess) return e;
    return launch<D, true, OutT>(mk, mv, a, grid, stream);
  });
}

// K4 on the arguments in `a`, dk and dv (OutT) at the (b, h, s) strides
// so[0..2] and so[3..5]; `splits` and `partial` as x2i_flash_bwd_dkv
// takes them.
template <typename OutT>
cudaError_t run_dkv(BwdArgs& a, void* dk, void* dv, const long long* so,
                    void* q_scratch, float* partial, int splits, int batch,
                    int hq, int hk, int sq, int skv, int d,
                    cudaStream_t stream) {
  // the (head of the group, q tile) stages of a block
  const int stages = a.group * (sq / kRows);
  a.splits = splits;
  a.per_split = (stages + splits - 1) / splits;
  if ((splits - 1) * a.per_split >= stages)        // an empty split
    return cudaErrorInvalidValue;
  // the splits' f32 partial sums, summed by dkv_reduce_kernel
  const bool reduce = splits > 1;
  a.partial = reduce ? partial : nullptr;
  a.dk = dk;
  a.dv = dv;
  a.dk_sb = so[0]; a.dk_sh = so[1]; a.dk_ss = so[2];
  a.dv_sb = so[3]; a.dv_sh = so[4]; a.dv_ss = so[5];
  cudaError_t err = cudaSuccess;
  if (a.cos != nullptr)
    // Q rotated once per launch, no scale (K4 scales the f32 scores)
    err = rotate_into(a.q, a.q_sb, a.q_sh, a.q_ss, q_scratch, batch, hq, sq,
                      d, a, stream);
  TileMap mq, mdo;
  if (err == cudaSuccess)
    err = make_tile_map(&mq, a.q, a.q_sb, a.q_sh, a.q_ss, batch, hq, sq, d,
                        kRows);
  if (err == cudaSuccess)
    err = make_tile_map(&mdo, a.dout, a.do_sb, a.do_sh, a.do_ss, batch, hq,
                        sq, d, kRows);
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(batch) * hk * skv;
  const unsigned blocks = static_cast<unsigned>((rows * (d / 2) + 255) / 256);
  return with_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    const dim3 grid(skv / DkvTiles<D>::block, hk, batch * splits);
    cudaError_t e = launch<D, false, OutT>(mq, mdo, a, grid, stream);
    if (e != cudaSuccess || !reduce) return e;
    dkv_reduce_kernel<D, OutT><<<blocks, 256, 0, stream>>>(a, hk, rows);
    return cudaGetLastError();
  });
}

// The f32 instances' inputs: q, k, v and do (f32, at the strides st[0..11])
// rounded into `scratch` (bf16, q, k, v, do in that order, each
// contiguous); rst[0..11] gets the buffer's strides and r[0..3] its four
// parts.
cudaError_t round_inputs(const float* q, const float* k, const float* v,
                         const float* dout, void* scratch,
                         const long long* st, long long* rst, bf16** r,
                         int batch, int hq, int hk, int sq, int skv, int d,
                         cudaStream_t stream) {
  const long long nq = static_cast<long long>(batch) * hq * sq * d;
  const long long nk = static_cast<long long>(batch) * hk * skv * d;
  r[0] = static_cast<bf16*>(scratch);
  r[1] = r[0] + nq;
  r[2] = r[1] + nk;
  r[3] = r[2] + nk;
  for (int i = 0; i < 12; ++i) rst[i] = st[i];
  const float* src[4] = {q, k, v, dout};
  const int heads[4] = {hq, hk, hk, hq}, seq[4] = {sq, skv, skv, sq};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = round_into(src[i], r[i], rst + 3 * i, batch,
                                       heads[i], seq[i], d, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Shared arguments of the entry points. q, do: (B, Hq, Sq, D) bf16; k, v:
// (B, Hk, Skv, D) bf16, with the strides in `st` (elements): q, k, v, do,
// then the outputs', each (b, h, s); last dims contiguous. lse, delta:
// (B, Hq, Sq) f32 contiguous, 16-byte aligned. cos/sin: (S, >= D/2) f32
// rows at tab_rs, or null (no rope). mask: (B, Skv) bytes at mask_sb, or
// null. Each returns the cudaError_t of its launches.

// K3: dq (B, Hq, Sq, D) bf16 at st[12..14]. With rope, k_scratch holds
// B*Hk*Skv*D bf16 for the rotated K.
extern "C" int x2i_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* k_scratch,
    const long long* st, const float* cos, const float* sin,
    long long tab_rs, const unsigned char* mask, long long mask_sb,
    int batch, int hq, int hk, int sq, int skv, int d, int causal,
    float scale, float scale_log2e, void* stream_ptr) {
  BwdArgs a;
  if (!fill_args(a, q, k, v, dout, lse, delta, st, cos, sin, tab_rs, mask,
                 mask_sb, hq, hk, sq, skv, d, causal, scale, scale_log2e) ||
      (cos != nullptr && k_scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run_dq<bf16>(
      a, dq, st + 12, k_scratch, batch, hq, hk, sq, skv, d,
      static_cast<cudaStream_t>(stream_ptr)));
}

// K4: dk, dv (B, Hk, Skv, D) bf16 at st[12..14] and st[15..17]. With rope,
// q_scratch holds B*Hq*Sq*D bf16 for the rotated Q. `splits` > 1 splits
// each block's (group x Sq/64) stages into that many shares, none empty,
// whose partial sums `partial` then holds: 2*splits*B*Hk*Skv*D f32.
extern "C" int x2i_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    void* q_scratch, float* partial, int splits, const long long* st,
    const float* cos, const float* sin, long long tab_rs,
    const unsigned char* mask, long long mask_sb, int batch, int hq, int hk,
    int sq, int skv, int d, int causal, float scale, float scale_log2e,
    void* stream_ptr) {
  BwdArgs a;
  if (!fill_args(a, q, k, v, dout, lse, delta, st, cos, sin, tab_rs, mask,
                 mask_sb, hq, hk, sq, skv, d, causal, scale, scale_log2e) ||
      (cos != nullptr && q_scratch == nullptr) || splits < 1 ||
      (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run_dkv<bf16>(
      a, dk, dv, st + 12, q_scratch, partial, splits, batch, hq, hk, sq, skv,
      d, static_cast<cudaStream_t>(stream_ptr)));
}

// K4's kv rows a block at head dim d: the wrapper sizes the split by them.
extern "C" int x2i_flash_bwd_dkv_block_rows(int d) {
  return d == 256 ? DkvTiles<256>::block : DkvTiles<128>::block;
}

// The f32 instances: q, k, v, do f32 at the strides in `st` as above
// (multiples of 4 elements, 16-byte aligned starts), the outputs f32 at
// st[12..]; no rope. scratch: (2*B*Hq*Sq + 2*B*Hk*Skv)*D bf16, the rounded
// q, k, v and do in that order, each contiguous. lse, delta, mask, splits
// and partial as above.

// K3 in f32: dq (B, Hq, Sq, D) f32 at st[12..14].
extern "C" int x2i_flash_bwd_dq_f32(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, float* dq, void* scratch,
    const long long* st, const unsigned char* mask, long long mask_sb,
    int batch, int hq, int hk, int sq, int skv, int d, int causal,
    float scale, float scale_log2e, void* stream_ptr) {
  BwdArgs a;
  if (!fill_args(a, q, k, v, dout, lse, delta, st, nullptr, nullptr, 0, mask,
                 mask_sb, hq, hk, sq, skv, d, causal, scale, scale_log2e) ||
      scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  long long rst[12];
  bf16* r[4];
  cudaError_t err = round_inputs(q, k, v, dout, scratch, st, rst, r, batch,
                                 hq, hk, sq, skv, d, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  fill_args(a, r[0], r[1], r[2], r[3], lse, delta, rst, nullptr, nullptr, 0,
            mask, mask_sb, hq, hk, sq, skv, d, causal, scale, scale_log2e);
  return static_cast<int>(run_dq<float>(a, dq, st + 12, nullptr, batch, hq,
                                        hk, sq, skv, d, stream));
}

// K4 in f32: dk, dv (B, Hk, Skv, D) f32 at st[12..14] and st[15..17].
extern "C" int x2i_flash_bwd_dkv_f32(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, float* dk, float* dv,
    void* scratch, float* partial, int splits, const long long* st,
    const unsigned char* mask, long long mask_sb, int batch, int hq, int hk,
    int sq, int skv, int d, int causal, float scale, float scale_log2e,
    void* stream_ptr) {
  BwdArgs a;
  if (!fill_args(a, q, k, v, dout, lse, delta, st, nullptr, nullptr, 0, mask,
                 mask_sb, hq, hk, sq, skv, d, causal, scale, scale_log2e) ||
      scratch == nullptr || splits < 1 || (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  long long rst[12];
  bf16* r[4];
  cudaError_t err = round_inputs(q, k, v, dout, scratch, st, rst, r, batch,
                                 hq, hk, sq, skv, d, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  fill_args(a, r[0], r[1], r[2], r[3], lse, delta, rst, nullptr, nullptr, 0,
            mask, mask_sb, hq, hk, sq, skv, d, causal, scale, scale_log2e);
  return static_cast<int>(run_dkv<float>(a, dk, dv, st + 12, nullptr,
                                         partial, splits, batch, hq, hk, sq,
                                         skv, d, stream));
}
