// Flash-attention forward for Hopper (sm_90a), bf16 in (or f32, rounded to
// bf16 on entry), f32 accumulate.
//
// Replaces the TPU kernel x2i_tpu/ops/flash_attention.py::_flash_kernel
// (launched by _flash_forward), both of its forward bodies:
//
//   * the pipelined inference body (:160-197): no row max, softmax as
//     exp2(clip(s, -100, 100)), o = sum(p v) / sum(p). With rope tables the
//     q tile gets the qk RMSNorm, the half-layout rotation and the folded
//     scale * log2(e) on load, rounded to bf16 (:146-156); K gets the norm
//     and the rotation, rounded to bf16 (:138-141). FLUX joint attention.
//   * the monolithic exact body (:199-221): kv mask and causal mask with
//     the finite NEG_INF = -1e30, GQA (q head h reads kv head h / group),
//     scale * log2(e) applied to the f32 scores. Here it runs as an online
//     (running-max) softmax over kv tiles, which equals the one-pass body
//     up to rounding. No kv tile is skipped, so a row whose keys are all
//     masked gives the mean of V over all keys, as the TPU body does.
//     Qwen2 LM prefill. With an lse buffer it also writes the base-2 row
//     logsumexp m + log2(l) in f32 (:220-221), the residual the backward
//     kernels (flash_bwd.cu) read: here m and l are the online softmax's
//     final running max and sum, so a fully masked row gives the one-pass
//     body's value, -1e30 + log2(Skv). The training forward always takes
//     this body, as return_lse forces pipeline_kc = 0 in JAX (:247-254).
//
// What bounds it on an H100: at the FLUX point (24 heads x 4608 x 128) the
// two products take 2.6e11 FLOP per launch against 113 MB of q, k, v, o:
// about 2300 FLOP per byte, far above the card's ~295, so the tensor cores
// bound it (0.26 ms at the 989 TFLOP/s bf16 data-sheet peak). The exp2 of
// the 5.1e8 scores alone is about 0.14 ms of the special-function units,
// so the softmax has to run under the products, not between them. The LM
// prefill (14 heads x 512 x 64) is too small to fill the card and is bound
// by launch latency.
//
// Design. The TPU body keeps all of K/V for a head in 16 MB of VMEM and
// rotates K once per (b, h) into scratch carried across its sequential
// grid. Neither exists here (1.2 MB each of K and V per head at 4608 x 128
// against 227 KB of shared memory; blocks run in no order). So:
//   * with rope tables, a first kernel normalizes and rotates K once per
//     (b, kv head) into a bf16 scratch buffer that the wrapper allocates,
//     the same single rotation the TPU kernel stores in VMEM scratch.
//     Rotating each K tile as it is staged instead would re-read the f32
//     tables once per q tile (about 4 GB of L2 traffic per launch);
//   * one block per (128-row q tile, q head, batch): two warpgroups of 64
//     q rows each, one block per SM. Both products are wgmma.mma_async
//     (hopper_mma.cuh): s = q k^T reads the q tile and the K tile from
//     128-byte-swizzled shared memory (m64n128k16, both K-major); o += p v
//     takes p from the score registers, rounded to bf16 where the TPU body
//     casts p before its PV matmul (:193, :217), and the V tile from
//     shared memory as it lies, kv rows x D, through the descriptor's
//     transpose bit. 128 q rows halve the L2 reads of K and V against 64;
//   * 128-row kv tiles in two rings of 3 stages, one of K tiles and one of
//     V tiles (at D = 128: q 32 KB + 3 x (32 + 32) KB of the 227 KB; D = 256
//     below), filled by TMA: one thread of a producer warpgroup starts
//     cp.async.bulk.tensor copies of 128 rows x 64 columns through tensor
//     maps that carry the (B, H, S, D) strides of K and V as they lie
//     (views of (B, S, H, D) storage included) and write the swizzle; it
//     runs up to three tiles ahead. Each stage of each ring has a `full`
//     mbarrier that counts the bytes as they land and an `empty` one that
//     counts the consumer threads done reading. K's stage is released as
//     soon as the score product that read it has completed, before the
//     softmax, V's after p v; the producer issues K of tile t before V of
//     tile t - 1, so K runs ahead of V by the softmax and p v of a tile.
//     The producer gives its registers back (setmaxnreg), the consumers
//     take 232 each (240 at D = 256). The consumers spend no instruction
//     on K and V; they load only their q tile (cp.async, or the rope
//     variant's rows by ordinary stores);
//   * the softmax runs under the tensor cores. A warpgroup queues the
//     scores of tile j and, behind them, p v of tile j - 1; once the scores
//     are there it does the softmax of tile j while p v of tile j - 1 is
//     still in flight: one score buffer, 64 + 64 + 32 registers for s, o
//     and p at D = 128. The two warpgroups take turns at queueing (two
//     named barriers), so that one's softmax falls under the other's
//     products; exp2 is one ex2.approx per score;
//   * the exact body keeps the online softmax: the mask tests exist only
//     in the instance that gets a mask or the causal flag, and there only
//     on tiles that reach above the diagonal or carry a kv mask; o is
//     rescaled (just before the next p v is queued, when the previous one
//     has left it) only when a row maximum of the warp moved. The kv mask
//     of a tile is one byte a lane per 32 keys, loaded while the tile's
//     scores are in flight and read as warp ballots (as K2 reads it): a
//     load per score, each waiting on L2 after the scores, had cost the
//     masked body some 5 us a tile at D = 64 (H100, 700 W);
//   * the grid instance comes from the caller (ops/flash_attention.py
//     fwd_instance, from the batch, heads, q rows, D and the card's SMs):
//     the two-warpgroup blocks of 128 q rows, one an SM; a grid whose
//     64-row blocks still fit in one wave (the LM prefill at 14 or 16
//     heads: 56 or 64 128-row blocks) the one-warpgroup instance, 64 q rows
//     a block, one an SM; and at D = 64 a grid whose 128-row blocks take
//     two waves and whose 64-row blocks fit one wave at three an SM
//     (InternViT-300M's 144 128-row blocks on 132 SMs, CLIP ViT-L/14's
//     192) the one-warpgroup instance built for
//     three blocks an SM (Tiles<64, 1, 3>): 64-row kv tiles in rings of 4
//     (q 8 KB + 4 x (8 + 8) KB, 74.9 KB with its barriers and slack, three
//     in the SM's 228 KB), 80 registers a thread at entry under
//     __launch_bounds__(256, 3), the producer keeps 24 and the consumers
//     take 136 (o 32, s 32 and p 16 of them). A block that shares out its
//     registers launches only where ptxas gave it exactly the entry count
//     its setmaxnreg pair is balanced for: with fewer, the consumers would
//     wait forever for registers the producer cannot free. Two warpgroups
//     at two blocks an SM (104 registers a consumer) spilled, had ptxas
//     serialize their products and ran 1.4x slower at InternViT's shape.
// Requires Sq and Skv to be multiples of 128, D in {64, 128, 256}, the last
// dim contiguous and the other strides multiples of 8 elements.
//
// Head dim 256 (a FLUX DiT of 12 heads x 256 at FLUX's width; the TPU
// kernel admits D = 256 as it does 64 and 128). Three things do not scale
// from D = 128 (Tiles below):
//   * shared memory: a 128-row q tile is 64 KB and a (K, V) stage of 128
//     rows 128 KB, so rings of 3 would need 448 KB of the 227. The kv
//     tile is 64 rows and each ring 2 stages: q 64 KB + 2 x (32 + 32) KB.
//     The split rings keep the copies ahead: K of tile j + 1 starts when
//     the score product of tile j - 1 is done, in the middle of tile j -
//     1's step, and V of tile j + 1 when p v of tile j - 1 is, a step
//     before p v of tile j + 1 is queued (one ring of (K, V) stages
//     started both only when p v of tile j - 1 was done, at the end of
//     step j, just before the score product of tile j + 1 needed K: their
//     latency was exposed, 0.76 against 0.50 ms at (1, 12, 4608, 256) on an
//     H100 at 700 W). Kv tiles of 80 rows (q 64 KB + 2 x (40 + 40)
//     KB, m64n80k16 scores, a last tile that overhangs Skv) ran level with
//     64 (within 1%) and spilled in the masked instances;
//   * registers: the o accumulator alone is 64 x 256 f32 over a warpgroup,
//     128 registers a thread. 64-row kv tiles keep s at 32 and p at 16, so
//     o, s and p in flight are 176 of the 240 that the consumers take
//     (setmaxnreg 240 / producer 24, as K2 has them);
//   * the products: s = q k^T is m64n64k16 (16 k steps over D) and
//     o += p v is m64n256k16 with p from registers and the V tile through
//     the transpose bit (wgmma_rs_bf16_n256<1>, hopper_mma.cuh).
// The rope pass reads the first 128 floats of each table row. The exact
// body writes the lse at every D: at D = 256 it is the training forward of
// the 12 x 256 DiT and a ring's pair forward.
//
// The f32 instance (x2i_flash_fwd_f32). The TPU kernel takes f32 q, k, v as
// they come (the CLIP scorer evaluates in f32, an f32 DiT trains in f32)
// and writes o, and with return_lse the lse, in f32. The tensor cores here
// take bf16, so a first kernel rounds q, k and v once per launch into a
// contiguous bf16 scratch buffer (round_rows_kernel, flash_common.cuh), the
// bodies above run on it unchanged and the epilogue writes the f32
// accumulator rows, divided by l, as they are; the exact body writes the
// f32 lse as it does for bf16. The products' operands are therefore the
// bf16 values of q, k, v and p, with f32 scores, softmax and sums: the
// bf16 bodies' precision, not the TPU's f32 products (a tf32 instance,
// wgmma k8 on f32 operands, would come closer at half the bf16 rate and
// twice the shared memory per tile; the bf16 rounding keeps one body for
// both dtypes). With the lse it takes no rope or qk norm (the f32 backward
// instances take none): a call that autograd records rotates first in f32,
// autograd carrying the rotation's transpose, which is JAX's f32 function
// (in f32 the TPU kernel's rounding of the rotated q and k to the input
// dtype is the identity). Always 128 q rows a block.
//
// The f32 rope-and-norm instance (x2i_flash_fwd_f32 with rope tables): the
// TPU kernel's f32 _flash_kernel with rope and qk_norm (JAX's f32 DiT at
// up to 8192 kv tokens hands both to the kernel under its fused glue, the
// rope alone without it). Its rounding points are the bf16 K1a's on the
// inputs rounded to bf16: q is rounded once a launch into the scratch
// (round_rows_kernel) and the ROPE bodies above normalize, rotate and
// scale it on load as they do in bf16; the f32 K rows are rounded to bf16
// as they are read, normalized, rotated and rounded again into the scratch
// in one pass (rope_rows_kernel<D, float>); V is rounded; the epilogue
// writes o in f32. So its o rounded to bf16 is the bf16 K1a's on the
// rounded q, k and v, bit for bit.

#include "flash_common.cuh"
#include "hopper_mma.cuh"

namespace {

// The tiles of an instance: head dim D, WGS consumer warpgroups of 64 q
// rows, built for MINB blocks an SM (see the header). kv rows per tile and
// stages in each of the K and V rings. With setmaxnreg (two consumer
// warpgroups, or more than one block an SM) the kernel starts with
// entry_regs a thread, the register file shared by MINB blocks of WGS + 1
// warpgroups in steps of 8; the producer's warpgroup keeps producer_regs
// and the consumers take what it gives back, consumer_regs each.
template <int D, int WGS, int MINB>
struct Tiles {
  static constexpr int kv = D == 256 ? 64 : MINB == 1 ? 128 : 64;
  static constexpr int stages = D == 256 ? 2 : MINB == 1 ? 3 : 4;
  static constexpr bool split_regs = WGS == 2 || MINB > 1;
  static constexpr int entry_regs = 65536 / (128 * (WGS + 1) * MINB) / 8 * 8;
  static constexpr int producer_regs = D == 256 || MINB > 1 ? 24 : 40;
  static constexpr int free_regs =
      (entry_regs + (entry_regs - producer_regs) / WGS) / 8 * 8;
  static constexpr int consumer_regs = free_regs < 240 ? free_regs : 240;
};

enum Body { kPipelined = 0, kExactBody = 1, kExactMasked = 2 };

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  void* o;                       // bf16, or f32 in the f32 instance
  float* lse;                    // (B, Hq, Sq) contiguous, or null
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  const float* cos;
  const float* sin;
  long long tab_rs;
  const float* qw;
  long long qw_rs;
  const unsigned char* mask;
  long long mask_sb;
  int group, sq, skv, causal;
  float scale_log2e, eps;
};

// Shared memory of one block: the q tile, the K ring, the V ring, their
// barriers, and the slack that aligns the tiles to the swizzle's 1024
// bytes.
template <int D, int WGS, int MINB>
constexpr int smem_bytes() {
  using T = Tiles<D, WGS, MINB>;
  return 64 * WGS * D * 2 + 2 * T::stages * T::kv * D * 2 +
         (4 * T::stages + 1) * static_cast<int>(sizeof(uint64_t)) +
         kSwizzleAtomBytes;
}

template <int D, int WGS, int MINB, bool ROPE, int BODY, typename OutT>
__global__ void __launch_bounds__(128 * WGS + 128, MINB) flash_fwd_kernel(
    const __grid_constant__ TileMap map_k,
    const __grid_constant__ TileMap map_v, Args a) {
  using T = Tiles<D, WGS, MINB>;
  constexpr int BQ = 64 * WGS, NT = 128 * WGS, BK = T::kv;
  constexpr int kStages = T::stages;
  constexpr bool EXACT = BODY != kPipelined, MASKED = BODY == kExactMasked;
  constexpr uint32_t kQBytes = BQ * D * 2, kTileBytes = BK * D * 2;
  static_assert(!T::split_regs ||
                    T::entry_regs - T::producer_regs >=
                        WGS * (T::consumer_regs - T::entry_regs),
                "the producer frees the registers the consumers take");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + kSwizzleAtomBytes - 1) & ~(kSwizzleAtomBytes - 1);
  unsigned char* smem = smem_raw + (sQ - raw);
  const uint32_t sK = sQ + kQBytes, sV = sK + kStages * kTileBytes;
  uint64_t* full_k =
      reinterpret_cast<uint64_t*>(smem + kQBytes + 2 * kStages * kTileBytes);
  uint64_t* empty_k = full_k + kStages;
  uint64_t* full_v = empty_k + kStages;
  uint64_t* empty_v = full_v + kStages;
  uint64_t* q_ready = empty_v + kStages;

  // NT consumer threads (WGS warpgroups), then the producer's warpgroup
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, hkv = h / a.group;
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = a.skv / BK;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full_k[st], 1);
      mbar_init(&empty_k[st], NT);
      mbar_init(&full_v[st], 1);
      mbar_init(&empty_v[st], NT);
    }
    mbar_init(q_ready, NT);
    mbar_init_fence();
  }
  __syncthreads();

  // The register file is shared out by warpgroup: the kernel starts with
  // entry_regs a thread, the producer hands back what it does not need
  // and the consumers take it. From here the two roles never meet again
  // (setmaxnreg needs that). (One consumer warpgroup alone on an SM and
  // the producer's have 255 registers a thread from the start.)
  if (tid >= NT) {
    if constexpr (T::split_regs) setmaxnreg_dec<T::producer_regs>();
    // The producer: one thread keeps the K and V rings full, up to
    // kStages tiles ahead of the consumers; a tile is one TMA copy per 64
    // columns, completing on its ring's `full`. K of tile t goes before V
    // of tile t - 1: K's stage comes free as soon as the score product
    // that read it is done, V's only after p v, so K runs ahead.
    if (tid == NT) {
      auto stage_in = [&](const TileMap& map, uint32_t ring, uint64_t* full,
                          uint64_t* empty, int t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&empty[st], (t / kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[st], kTileBytes);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb)
          tma_load_tile(map,
                        ring + st * kTileBytes + cb * BK * kSwizzleRowBytes,
                        cb * 64, t * BK, hkv, b, &full[st]);
      };
#pragma unroll 1
      for (int t = 0; t <= n_tiles; ++t) {
        if (t < n_tiles) stage_in(map_k, sK, full_k, empty_k, t);
        if (t > 0) stage_in(map_v, sV, full_v, empty_v, t - 1);
      }
    }
    return;
  }

  // The consumers bring in the q tile meanwhile.
  if constexpr (T::split_regs) setmaxnreg_inc<T::consumer_regs>();
  const bf16* qb = a.q + b * a.q_sb + h * a.q_sh;
  if (ROPE) {
    // 16 rows per warp, four in flight: a row is a chain of dependent
    // loads (the row, its table rows) and shuffles
    auto rope_q_rows = [&](auto norm) {
      constexpr bool kNorm = decltype(norm)::value;
#pragma unroll 4
      for (int r = tid / 32; r < BQ; r += NT / 32) {
        const int row = q0 + r;
        float y[D / 32];
        norm_rope_vals<D, kNorm>(
            qb + row * a.q_ss, y, a.cos + row * a.tab_rs,
            a.sin + row * a.tab_rs, kNorm ? a.qw + row * a.qw_rs : nullptr,
            a.eps, a.scale_log2e, lane);
#pragma unroll
        for (int t = 0; t < D / 32; ++t)
          *reinterpret_cast<bf16*>(smem + swizzled_offset<BQ>(
                                              r, lane + 32 * t)) =
              __float2bfloat16_rn(y[t]);
      }
    };
    if (a.qw != nullptr) {
      rope_q_rows(Flag<true>());
    } else {
      rope_q_rows(Flag<false>());
    }
    fence_proxy_async();
    mbar_arrive(q_ready);
  } else {
    cp_async_tile<D, BQ, NT>(qb + q0 * a.q_ss, a.q_ss, sQ, tid);
    cp_async_arrive(q_ready);
  }
  mbar_wait(q_ready, 0);
  fence_proxy_async();

  const uint64_t q_desc =
      wgmma_desc(sQ + wg * 64 * kSwizzleRowBytes, 16, kSwizzleAtomBytes);
  float o[D / 8][4], s[BK / 8][4];
  uint32_t p[BK / 16][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
#pragma unroll
  for (int jj = 0; jj < BK / 8; ++jj)
    s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  // the exact body's pending rescale of o, by exp2(m_old - m_new) per row
  float al0 = 1.f, al1 = 1.f;
  bool moved = false;
  const int row_a = q0 + wg * 64 + warp * 16 + g, row_b = row_a + 8;
  const unsigned char* mask =
      MASKED && a.mask != nullptr ? a.mask + b * a.mask_sb : nullptr;

  // s = q k^T for kv tile t, queued and committed
  auto qk_product = [&](int t) {
    const int st = t % kStages;
    mbar_wait(&full_k[st], (t / kStages) & 1);
    const uint64_t k_desc =
        wgmma_desc(sK + st * kTileBytes, 16, kSwizzleAtomBytes);
    wgmma_pin(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK>(s, desc_advance(q_desc, kmajor_kstep<BQ>(kk)),
                   desc_advance(k_desc, kmajor_kstep<BK>(kk)), kk != 0);
    wgmma_commit();
  };

  // o += p v for kv tile t, queued and committed; the exact body first
  // brings o to the row maxima that p was taken against
  auto pv_queue = [&](int t) {
    if (EXACT && moved) {
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        o[dn][0] *= al0;
        o[dn][1] *= al0;
        o[dn][2] *= al1;
        o[dn][3] *= al1;
      }
    }
    const int st = t % kStages;
    mbar_wait(&full_v[st], (t / kStages) & 1);
    const uint64_t v_desc = wgmma_desc(
        sV + st * kTileBytes, BK * kSwizzleRowBytes, kSwizzleAtomBytes);
    wgmma_pin(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D>(o, p[kk], desc_advance(v_desc, kk * 2 * kSwizzleAtomBytes));
    wgmma_commit();
  };

  // The masked body's kv mask of a tile, loaded while its scores are in
  // flight: one key a lane in each 32, which softmax_tile turns into
  // ballots
  constexpr int kWords = BK / 32;
  bool kept[kWords];
  auto fetch_mask = [&](int t) {
    if (MASKED) {
#pragma unroll
      for (int c = 0; c < kWords; ++c) {
        const int col = t * BK + 32 * c + lane;
        kept[c] = mask == nullptr || mask[col] != 0;
      }
    }
  };

  // the scores of kv tile t in s -> the unnormalized probabilities, in
  // place; the row sums l (and in the exact body the running maxima m)
  auto softmax_tile = [&](int t) {
    if (!ROPE) {
      // without rope the scale is not folded into q: the TPU's _logits
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] *= a.scale_log2e;
    }
    const int kv0 = t * BK;
    if (EXACT) {
      if (MASKED) {
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
        // a causal tile wholly at or below the warp's first row needs no
        // test
        if (!all || (a.causal && kv0 + BK - 1 > row_a - g)) {
#pragma unroll
          for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = kv0 + jj * 8 + t4 * 2 + (e & 1);
              const int row = e < 2 ? row_a : row_b;
              const bool keep = ((w[jj >> 2] >> ((jj & 3) * 8 + (e & 1))) &
                                 1u) &&
                                (!a.causal || col <= row);
              if (!keep) s[jj][e] = kNegInf;
            }
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
        mx0 = fmaxf(mx0, fmaxf(s[jj][0], s[jj][1]));
        mx1 = fmaxf(mx1, fmaxf(s[jj][2], s[jj][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // exp2(m - mx) is exactly 1 for a row whose maximum stayed: o and l
      // are rescaled only when a maximum of the warp's rows moved
      moved = __any_sync(0xffffffffu, mx0 != m0 || mx1 != m1);
      if (moved) {
        al0 = exp2f(m0 - mx0);
        al1 = exp2f(m1 - mx1);
        l0 *= al0;
        l1 *= al1;
        m0 = mx0;
        m1 = mx1;
      }
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
        s[jj][0] = fast_exp2(s[jj][0] - mx0);
        s[jj][1] = fast_exp2(s[jj][1] - mx0);
        s[jj][2] = fast_exp2(s[jj][2] - mx1);
        s[jj][3] = fast_exp2(s[jj][3] - mx1);
        l0 += s[jj][0] + s[jj][1];
        l1 += s[jj][2] + s[jj][3];
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[jj][e] = fast_exp2(fminf(fmaxf(s[jj][e], -100.f), 100.f));
        l0 += s[jj][0] + s[jj][1];
        l1 += s[jj][2] + s[jj][3];
      }
    }
  };

  // p rounded to bf16: the A operand of the PV product
  auto round_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      pack_a(p[kk], s[2 * kk], s[2 * kk + 1]);
  };

  // The schedule, per warpgroup: the scores of tile j and, behind them,
  // p v of tile j - 1 are queued on the tensor cores; as soon as the
  // scores are there K's stage is released and the softmax of tile j
  // runs while p v of tile j - 1 is still in flight (the TPU body's
  // pipeline, :185-195, with the two products in the other order); V's
  // stage of tile j - 1 is released when p v is done.
  // With two warpgroups, they take turns at queueing their products, so
  // that one's softmax falls under the other's products instead of both
  // leaving the tensor cores idle at once: named barrier 1 + wg opens
  // warpgroup wg's turn, and warpgroup 1 opens the first one.
  auto turn_wait = [&]() {
    if (WGS == 2) named_barrier_sync(1 + wg, NT);
  };
  auto turn_pass = [&]() {
    if (WGS == 2) named_barrier_arrive(2 - wg, NT);
  };
  if (WGS == 2 && wg == 1) named_barrier_arrive(1, NT);
  turn_wait();
  qk_product(0);
  turn_pass();
  fetch_mask(0);
  wgmma_wait<0>();
  wgmma_pin(s);
  mbar_arrive(&empty_k[0]);
  softmax_tile(0);
  round_p();
#pragma unroll 1
  for (int j = 1; j < n_tiles; ++j) {
    turn_wait();
    qk_product(j);
    pv_queue(j - 1);
    turn_pass();
    fetch_mask(j);
    wgmma_wait<1>();
    wgmma_pin(s);
    mbar_arrive(&empty_k[j % kStages]);
    softmax_tile(j);
    wgmma_wait<0>();
    wgmma_pin(o);
    wgmma_pin_a(p);
    mbar_arrive(&empty_v[(j - 1) % kStages]);
    round_p();
  }
  pv_queue(n_tiles - 1);
  wgmma_wait<0>();
  wgmma_pin(o);
  wgmma_pin_a(p);

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (EXACT && a.lse != nullptr && t4 == 0) {
    float* lse = a.lse + (static_cast<long long>(b) * gridDim.y + h) * a.sq;
    lse[row_a] = m0 + log2f(l0);
    lse[row_b] = m1 + log2f(l1);
  }
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    o[dn][0] /= l0;
    o[dn][1] /= l0;
    o[dn][2] /= l1;
    o[dn][3] /= l1;
  }
  store_rows<D>(static_cast<OutT*>(a.o) + b * a.o_sb + h * a.o_sh, a.o_ss, o,
                row_a, row_b, t4);
}

struct Maps {
  TileMap k, v;
};

// The kernel of an instance, made ready to launch: its shared memory
// allowed and, for more than one block an SM, the largest shared-memory
// carveout asked for. An instance that shares out its registers refuses
// to launch unless ptxas gave it the register count its setmaxnreg pair
// is balanced for (with fewer, the consumers would wait forever for the
// registers the producer cannot free).
template <int D, int WGS, int MINB, bool ROPE, int BODY, typename OutT>
cudaError_t prepare() {
  using T = Tiles<D, WGS, MINB>;
  auto kernel = flash_fwd_kernel<D, WGS, MINB, ROPE, BODY, OutT>;
  if (T::split_regs) {
    static const int regs = [&] {
      cudaFuncAttributes attr;
      return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess
                 ? attr.numRegs
                 : -1;
    }();
    if (regs != T::entry_regs) return cudaErrorInvalidConfiguration;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<D, WGS, MINB>());
  if (err == cudaSuccess && MINB > 1)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <int D, int WGS, int MINB, bool ROPE, int BODY, typename OutT>
cudaError_t launch_main(const Maps& m, const Args& a, int batch, int hq,
                        int sq, cudaStream_t stream) {
  cudaError_t err = prepare<D, WGS, MINB, ROPE, BODY, OutT>();
  if (err != cudaSuccess) return err;
  dim3 grid(sq / (64 * WGS), hq, batch);
  flash_fwd_kernel<D, WGS, MINB, ROPE, BODY, OutT>
      <<<grid, 128 * WGS + 128, smem_bytes<D, WGS, MINB>(), stream>>>(
          m.k, m.v, a);
  return cudaGetLastError();
}

template <int D, int WGS, int MINB, typename OutT, bool ROPE>
cudaError_t launch_body(const Maps& m, const Args& a, int batch, int hq,
                        int sq, int body, cudaStream_t stream) {
  if (body == kPipelined)
    return launch_main<D, WGS, MINB, ROPE, kPipelined, OutT>(m, a, batch, hq,
                                                             sq, stream);
  if (body == kExactBody)
    return launch_main<D, WGS, MINB, ROPE, kExactBody, OutT>(m, a, batch, hq,
                                                             sq, stream);
  return launch_main<D, WGS, MINB, ROPE, kExactMasked, OutT>(m, a, batch, hq,
                                                             sq, stream);
}

template <int D, int WGS, int MINB, typename OutT = bf16>
cudaError_t launch(const Maps& m, const Args& a, int batch, int hq, int sq,
                   bool rope, int body, cudaStream_t stream) {
  return rope ? launch_body<D, WGS, MINB, OutT, true>(m, a, batch, hq, sq,
                                                      body, stream)
              : launch_body<D, WGS, MINB, OutT, false>(m, a, batch, hq, sq,
                                                       body, stream);
}

template <int N>
using Int = std::integral_constant<int, N>;

// f(Int<D>, Int<WGS>, Int<MINB>) for a grid instance of the bf16 kernel
// (ops/flash_attention.py FWD_INSTANCES: the 128-row instance at every D,
// the 64-row one at 1 block an SM, and at D = 64 the 64-row one at 3
// blocks an SM): its cudaError_t, or cudaErrorInvalidValue for another.
template <typename F>
cudaError_t with_instance(int d, int wgs, int minb, F&& f) {
  if (wgs == 2 && minb == 1)
    return with_head_dim(
        d, [&](auto dim) { return f(dim, Int<2>(), Int<1>()); });
  if (wgs == 1 && minb == 1)
    return with_head_dim(
        d, [&](auto dim) { return f(dim, Int<1>(), Int<1>()); });
  if (d == 64 && wgs == 1 && minb == 3)
    return f(Int<64>(), Int<1>(), Int<3>());
  return cudaErrorInvalidValue;
}

// The shapes every instance takes.
bool bad_shapes(int hq, int hk, int sq, int skv, int d) {
  return (d != 64 && d != 128 && d != 256) || sq <= 0 || skv <= 0 ||
         sq % 128 || skv % 128 || hk <= 0 || hq % hk;
}

// The arguments of a launch without rope, norm or lse: q, k, v at the
// (b, h, s) strides st[0..8], o at st[9..11].
Args plain_args(const bf16* q, const bf16* k, const bf16* v, void* o,
                const long long* st, const unsigned char* mask,
                long long mask_sb, int hq, int hk, int sq, int skv,
                int causal, float scale_log2e) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.q_sb = st[0]; a.q_sh = st[1]; a.q_ss = st[2];
  a.k_sb = st[3]; a.k_sh = st[4]; a.k_ss = st[5];
  a.v_sb = st[6]; a.v_sh = st[7]; a.v_ss = st[8];
  a.o_sb = st[9]; a.o_sh = st[10]; a.o_ss = st[11];
  a.mask = mask;
  a.mask_sb = mask_sb;
  a.group = hq / hk;
  a.sq = sq;
  a.skv = skv;
  a.causal = causal;
  a.scale_log2e = scale_log2e;
  a.eps = 1e-6f;
  return a;
}

int body_of(int exact, const unsigned char* mask, int causal) {
  return !exact ? kPipelined
         : (mask != nullptr || causal) ? kExactMasked
                                       : kExactBody;
}

// K and V as the producer reads them, in tiles of kv rows.
cudaError_t make_maps(Maps* m, const Args& a, int batch, int hk, int skv,
                      int d, int kv) {
  cudaError_t err = make_tile_map(&m->k, a.k, a.k_sb, a.k_sh, a.k_ss, batch,
                                  hk, skv, d, kv);
  if (err != cudaSuccess) return err;
  return make_tile_map(&m->v, a.v, a.v_sb, a.v_sh, a.v_ss, batch, hk, skv, d,
                       kv);
}

// K (bf16, or f32 rounded to bf16 as it is read) at the (b, h, s) strides
// st[0..2], normalized with kw (or not) and rotated once per launch into
// the contiguous bf16 buffer ks (no scale: it is folded into the q tile),
// which becomes a's K.
template <typename T>
cudaError_t rope_k_into(const T* k, bf16* ks, const long long* st, Args* a,
                        int batch, int hk, int skv, int d, const float* kw,
                        long long kw_rs, cudaStream_t stream) {
  const cudaError_t err = with_head_dim(d, [&](auto dim) {
    return launch_rope_rows<decltype(dim)::value>(
        k, ks, st[0], st[1], st[2], batch, hk, skv, a->cos, a->sin,
        a->tab_rs, kw, kw_rs, a->eps, 1.f, stream);
  });
  a->k = ks;
  a->k_ss = d;
  a->k_sh = static_cast<long long>(skv) * d;
  a->k_sb = a->k_sh * hk;
  return err;
}

}  // namespace

// q, k, v, o: (B, H, S, D) bf16 with the strides in `st` (elements):
// q (b, h, s), k (b, h, s), v (b, h, s), o (b, h, s); the last dim is
// contiguous. lse: (B, Hq, Sq) f32 contiguous, or null; it needs the exact
// body. cos/sin: (Sq, >= D/2) f32 rows at tab_rs, or null (no rope).
// qw/kw: f32 qk-norm scales with row strides qw_rs/kw_rs (0 = one shared
// (D,) row), or null (no norm; rope only). k_scratch: B*Hk*Skv*D bf16 when
// rope is given. mask: (B, Skv) bytes at mask_sb, or null. wgs,
// blocks_per_sm: the grid instance (ops/flash_attention.py fwd_instance).
// Returns the cudaError_t of the launches.
extern "C" int x2i_flash_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    void* k_scratch, const long long* st, const float* cos, const float* sin,
    long long tab_rs, const float* qw, long long qw_rs, const float* kw,
    long long kw_rs, const unsigned char* mask, long long mask_sb, int batch,
    int hq, int hk, int sq, int skv, int d, int causal, int exact, int wgs,
    int blocks_per_sm, float scale_log2e, float eps, void* stream_ptr) {
  if (bad_shapes(hq, hk, sq, skv, d) ||
      (cos != nullptr && (k_scratch == nullptr || sq != skv)) ||
      (lse != nullptr && !exact) ||
      (!exact && (mask != nullptr || causal)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool rope = cos != nullptr;
  Args a = plain_args(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), o, st, mask, mask_sb, hq,
                      hk, sq, skv, causal, scale_log2e);
  a.lse = lse;
  a.cos = cos;
  a.sin = sin;
  a.tab_rs = tab_rs;
  a.qw = qw;
  a.qw_rs = qw_rs;
  a.eps = eps;
  cudaError_t err = cudaSuccess;
  if (rope) {
    // K normalized and rotated once per launch (no scale: it is folded
    // into the q tile)
    err = rope_k_into(a.k, static_cast<bf16*>(k_scratch), st + 3, &a, batch,
                      hk, skv, d, kw, kw_rs, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int body = body_of(exact, mask, causal);
  err = with_instance(d, wgs, blocks_per_sm, [&](auto dim, auto w, auto mb) {
    constexpr int D = decltype(dim)::value, WGS = decltype(w)::value,
                  MINB = decltype(mb)::value;
    // K and V as the producer reads them: K from the scratch under rope
    Maps m;
    cudaError_t e = make_maps(&m, a, batch, hk, skv, D,
                              Tiles<D, WGS, MINB>::kv);
    return e != cudaSuccess
               ? e
               : launch<D, WGS, MINB>(m, a, batch, hq, sq, rope, body, stream);
  });
  return static_cast<int>(err);
}

// The blocks of the bf16 grid instance (d, wgs, blocks_per_sm) that one SM
// holds at once, into *out: cudaOccupancyMaxActiveBlocksPerMultiprocessor
// of its exact masked kernel without rope, with its shared memory (the
// instance's bodies share their launch bounds and shared memory; they
// differ in registers only where one block takes the SM). Returns the
// cudaError_t.
extern "C" int x2i_flash_fwd_blocks_per_sm(int d, int wgs, int blocks_per_sm,
                                           int* out) {
  return static_cast<int>(
      with_instance(d, wgs, blocks_per_sm, [&](auto dim, auto w, auto mb) {
        constexpr int D = decltype(dim)::value, WGS = decltype(w)::value,
                      MINB = decltype(mb)::value;
        cudaError_t e = prepare<D, WGS, MINB, false, kExactMasked, bf16>();
        return e != cudaSuccess
                   ? e
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         out, flash_fwd_kernel<D, WGS, MINB, false,
                                               kExactMasked, bf16>,
                         128 * WGS + 128, smem_bytes<D, WGS, MINB>());
      }));
}

// The f32 instances: q, k, v, o (B, H, S, D) f32 with the strides in `st`,
// as above (multiples of 4 elements, 16-byte aligned starts). lse: (B, Hq,
// Sq) f32 contiguous, or null; it needs the exact body and takes no rope.
// scratch: (B*Hq*Sq + 2*B*Hk*Skv)*D bf16, the rounded q, k (under rope
// normalized and rotated) and v in that order, each contiguous. cos, sin,
// tab_rs, qw, qw_rs, kw, kw_rs, eps, mask, causal and exact as for
// x2i_flash_fwd: with rope tables the rope-and-norm instance.
extern "C" int x2i_flash_fwd_f32(
    const float* q, const float* k, const float* v, float* o, float* lse,
    void* scratch, const long long* st, const float* cos, const float* sin,
    long long tab_rs, const float* qw, long long qw_rs, const float* kw,
    long long kw_rs, const unsigned char* mask, long long mask_sb, int batch,
    int hq, int hk, int sq, int skv, int d, int causal, int exact,
    float scale_log2e, float eps, void* stream_ptr) {
  const bool rope = cos != nullptr;
  if (bad_shapes(hq, hk, sq, skv, d) || scratch == nullptr ||
      (lse != nullptr && (!exact || rope)) ||
      (!exact && (mask != nullptr || causal)) || (rope && sq != skv))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  bf16* rq = static_cast<bf16*>(scratch);
  bf16* rk = rq + static_cast<long long>(batch) * hq * sq * d;
  bf16* rv = rk + static_cast<long long>(batch) * hk * skv * d;
  long long rst[12];
  for (int i = 0; i < 12; ++i) rst[i] = st[i];
  cudaError_t err = round_into(q, rq, rst, batch, hq, sq, d, stream);
  if (err == cudaSuccess && !rope)
    err = round_into(k, rk, rst + 3, batch, hk, skv, d, stream);
  if (err == cudaSuccess)
    err = round_into(v, rv, rst + 6, batch, hk, skv, d, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a = plain_args(rq, rk, rv, o, rst, mask, mask_sb, hq, hk, sq, skv,
                      causal, scale_log2e);
  a.lse = lse;
  if (rope) {
    a.cos = cos;
    a.sin = sin;
    a.tab_rs = tab_rs;
    a.qw = qw;
    a.qw_rs = qw_rs;
    a.eps = eps;
    // the f32 K rows normalized, rotated and rounded in one pass
    err = rope_k_into(k, rk, st + 3, &a, batch, hk, skv, d, kw, kw_rs,
                      stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int body = body_of(exact, mask, causal);
  err = with_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    Maps m;
    cudaError_t e = make_maps(&m, a, batch, hk, skv, D, Tiles<D, 2, 1>::kv);
    return e != cudaSuccess ? e
                            : launch<D, 2, 1, float>(m, a, batch, hq, sq,
                                                     rope, body, stream);
  });
  return static_cast<int>(err);
}
