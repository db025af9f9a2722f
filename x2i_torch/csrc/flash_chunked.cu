// Chunked online-softmax flash-attention forward for Hopper (sm_90a), bf16
// in, f32 accumulate: the long-sequence kernel (more than 8192 kv tokens).
//
// Replaces the TPU kernel x2i_tpu/ops/flash_attention.py::
// _flash_chunked_kernel (launched by _flash_forward_chunked), whose grid
// (B, H, Sq/BQ, Skv/BK) walks the kv axis sequentially with the f32
// accumulator acc and the running max m and sum l of each q block in VMEM
// scratch. Here one thread block owns a q tile and loops over the kv tiles
// with acc, m and l in registers. Per kv tile, as the TPU body (:383-398):
//
//   s     = (q k^T in f32 from the bf16 product) * (scale * log2(e))
//   s     = kv mask, then causal mask (col <= row, diagonal aligned at row
//           0), with the finite NEG_INF = -1e30
//   m_new = max(m, rowmax(s));  alpha = exp2(m - m_new);  p = exp2(s - m_new)
//   l     = l * alpha + rowsum(p)
//   acc   = acc * alpha + (p rounded to bf16) v
//
// and at the end o = acc / l rounded to bf16 and lse = m + log2(l), base 2.
// m starts at NEG_INF (not -inf) and l at 0, as on the TPU. No rope and no
// qk norm inside: on this route both are applied outside the kernel.
//
// The causal block skip (:408, "j * block_k < (i + 1) * block_q") is the
// loop's upper bound: a q tile reads only the kv tiles that start at or
// below its last row, which halves the work of a long causal prefill. A
// skipped tile contributes exactly zero to a row that has a valid key. A
// row with no valid key (left padding) averages v over the keys of the
// tiles it visited, so its value depends on the tile sizes, here (128 x
// 128) as on the TPU (256 x 512): such rows carry no meaning in either.
//
// What bounds it on an H100: at the 2048^2 FLUX point (24 heads x 16896 x
// 128) the two products take 3.5e12 FLOP per launch against 415 MB of q, k,
// v, o, so the tensor cores bound it (3.5 ms at the 989 TFLOP/s bf16
// data-sheet peak); the exp2 of its 6.9e9 scores is about 1.8 ms of the
// special-function units, so the softmax has to run under the products.
// The 32k-token causal LM prefill (14 q heads on 2 kv heads x 32768 x 64)
// needs half of 3.8e12 FLOP; at D = 64 a score costs half the tensor work
// of one at D = 128 and the same exp2, so there the two are about even.
//
// Design: the exact body of the forward kernel K1 (flash_fwd.cu), with the
// block skip, any kv length and tiles that overhang the ends:
//   * one block per (128-row q tile, q head, batch): two consumer
//     warpgroups of 64 q rows each and a producer warpgroup; q tiles are
//     scheduled last-first, so that under the causal mask the longest
//     blocks start first. GQA: q head h reads kv head h / group;
//   * both products are wgmma.mma_async (hopper_mma.cuh): s = q k^T
//     (m64n128k16, q and K tiles K-major in 128-byte-swizzled shared
//     memory) and o += p v with p from the score registers, rounded to
//     bf16, and the V tile read as it lies through the transpose bit;
//   * the producer's one thread loads the q tile and then keeps a K ring
//     and a V ring of 3 stages of 128 kv rows each (D = 256: below) full by
//     TMA, through tensor maps that carry the (B, H, S, D) strides as they
//     lie (views of (B, S, H, D) storage included); K's stage is released
//     as soon as the score product that read it has completed, before the
//     softmax, V's after p v, and the producer stages K of tile t before V
//     of tile t - 1, as K1 does (flash_fwd.cu); it gives its registers
//     back (setmaxnreg 24) and the consumers take 240. At D = 128 the
//     block holds q 32 KB + 3 x (32 + 32) KB of the 227 KB. With 3
//     stages the split matters less than at D = 256 (below): against one
//     ring of (K, V) stages it ran the DiT's (1, 24, 16896, 128) level to
//     4% faster, the 32k LMs' prefills 2% (D = 64) and 6-8% (the 7B's,
//     D = 128) faster, and the odd case (2, 6, 640, 128) on (2, 2, 1152,
//     128), 17 us, 1-3% slower (NVIDIA H100 80GB HBM3, 700.00 W);
//   * the softmax of tile j runs while p v of tile j - 1 is in flight, and
//     the two warpgroups take turns at queueing their products (named
//     barriers), so that one's softmax falls under the other's products;
//     exp2 is one ex2.approx per score; o is rescaled only when a row
//     maximum of the warp moved;
//   * mask tests run only on the tiles that need them: the diagonal tiles
//     under the causal mask, tiles in which the kv mask drops a key, and a
//     last tile of 64 kv rows, which TMA fills with zeros past Skv. A warp
//     reads the kv mask of a tile as four ballots over four keys a lane,
//     so that a thread keeps the bits of its 32 columns in two registers
//     (32 byte loads would hold as many: the masked D = 128 instance
//     spilled); the causal mask and the end of Skv are one column limit
//     per row. The columns past Skv get NEG_INF like masked keys: to a row
//     with a valid key they add exactly nothing, and a row without one
//     carries no meaning (above);
//   * a last q tile of 64 rows is zero-filled past Sq in the same way and
//     writes only its own rows.
// Requires Sq and Skv to be multiples of 64, D in {64, 128, 256}, the last
// dim contiguous, the other strides multiples of 8 elements and 16-byte
// aligned bases; every offset is 64-bit.
//
// Head dim 256 (the 12 x 256 FLUX DiT at 2048^2), as K1 takes it
// (flash_fwd.cu): rings of 3 stages of 128-row kv tiles would need 384 KB
// of shared memory beside the 64 KB q tile, so the kv tile is 64 rows and
// each ring 2 stages (q 64 KB + 2 x (32 + 32) KB); o is 128 registers a
// thread, s 32 and p 16; s = q k^T is m64n64k16 and o += p v m64n256k16
// through the transpose bit. A tile's kv mask is then two ballots of two
// keys a lane. With 2 stages the split rings matter: K of tile j + 1 is
// copied once the score product of tile j - 1 is done, in the middle of
// step j - 1, V of tile j + 1 once p v of tile j - 1 is, a step before p v
// of tile j + 1 is queued. One ring of (K, V) stages started both copies
// only when p v of tile j - 1 was done, at the end of step j, just before
// the score product of tile j + 1 needed K: their latency was exposed,
// 7.33 against 4.28 ms at (1, 12, 16896, 256) (NVIDIA H100 80GB HBM3,
// 700.00 W), now under SDPA's 4.56.
// The lse epilogue is the same at every D (the forward of a 12 x 256 DiT
// under autograd above MAX_KV_SEQ, and a ring's pairs of more than 8192
// keys), and no tile overhangs Skv (a multiple of 64).
//
// The f32 instance (x2i_flash_chunked_f32), which the TPU kernel's f32
// inputs take (an f32 DiT above 8192 tokens: the 2048^2 image), is K1's f32
// design (flash_fwd.cu): q, k and v rounded once per launch into a
// contiguous bf16 scratch buffer (round_rows_kernel, flash_common.cuh), the
// body above on it unchanged, o written in f32 from the accumulators and
// the lse in f32 as before. At the 2048^2 point the scratch is 311 MB and
// the rounding pass reads 622 MB and writes 311 MB once, about 0.3 ms
// against the body's 3.5 ms bound. The norm and the rope stay outside, as
// on every K2 route.

#include "flash_common.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int kTileQ = 128;      // q rows per block: two warpgroups of 64
constexpr int kConsumers = 256;  // two consumer warpgroups

// kv rows per tile and stages in each of the K and V rings, by head dim
template <int D>
struct Tiles {
  static constexpr int kv = D == 256 ? 64 : 128;
  static constexpr int stages = D == 256 ? 2 : 3;
};

struct Args {
  void* o;                       // bf16, or f32 in the f32 instance
  float* lse;                    // (B, Hq, Sq) contiguous, or null
  long long o_sb, o_sh, o_ss;
  const unsigned char* mask;     // (B, Skv) bytes, or null
  long long mask_sb;
  int group, sq, skv, causal;
  float scale_log2e;
};

// Shared memory of one block: the q tile, the K ring, the V ring, their
// barriers, and the slack that aligns the tiles to the swizzle's 1024
// bytes.
template <int D>
constexpr int smem_bytes() {
  return kTileQ * D * 2 + 2 * Tiles<D>::stages * Tiles<D>::kv * D * 2 +
         (4 * Tiles<D>::stages + 1) * static_cast<int>(sizeof(uint64_t)) +
         kSwizzleAtomBytes;
}

template <int D, bool MASKED, typename OutT>
__global__ void __launch_bounds__(kConsumers + 128, 1) flash_chunked_kernel(
    const __grid_constant__ TileMap map_q,
    const __grid_constant__ TileMap map_k,
    const __grid_constant__ TileMap map_v, Args a) {
  constexpr int BQ = kTileQ, BK = Tiles<D>::kv, NT = kConsumers;
  constexpr int kStages = Tiles<D>::stages;
  constexpr uint32_t kQBytes = BQ * D * 2, kTileBytes = BK * D * 2;
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
  uint64_t* q_full = empty_v + kStages;

  // NT consumer threads (two warpgroups), then the producer's warpgroup
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, hkv = h / a.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  // the block skip: no kv tile that starts above the q tile's last row
  int n_tiles = (a.skv + BK - 1) / BK;
  if (MASKED && a.causal)
    n_tiles = min(n_tiles, (min(q0 + BQ, a.sq) - 1) / BK + 1);

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full_k[st], 1);
      mbar_init(&empty_k[st], NT);
      mbar_init(&full_v[st], 1);
      mbar_init(&empty_v[st], NT);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // The register file is shared out by warpgroup: the producer hands back
  // what it does not need and the consumers take it. From here the two
  // roles never meet again (setmaxnreg needs that).
  if (tid >= NT) {
    setmaxnreg_dec<24>();
    // The producer: one thread loads the q tile, then keeps the K and V
    // rings full, up to kStages tiles ahead of the consumers; a tile is
    // one TMA copy per 64 columns, completing on its ring's `full`. K of
    // tile t goes before V of tile t - 1: K's stage comes free as soon as
    // the score product that read it is done, V's only after p v, so K
    // runs ahead.
    if (tid == NT) {
      mbar_arrive_expect_tx(q_full, kQBytes);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb)
        tma_load_tile(map_q, sQ + cb * BQ * kSwizzleRowBytes, cb * 64, q0, h,
                      b, q_full);
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

  setmaxnreg_inc<240>();
  mbar_wait(q_full, 0);

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
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  // the pending rescale of o, by exp2(m_old - m_new) per row
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

  // o += p v for kv tile t, queued and committed, after bringing o to the
  // row maxima that p was taken against
  auto pv_queue = [&](int t) {
    if (moved) {
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

  // the scores of kv tile t in s -> the unnormalized probabilities, in
  // place; the running maxima m and the row sums l
  auto softmax_tile = [&](int t) {
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jj][e] *= a.scale_log2e;
    const int kv0 = t * BK;
    // In tile columns: the first column that rows row_a and row_b may not
    // see (the end of Skv, which a last tile of 64 rows overhangs, and
    // under the causal mask the row's own index + 1) ...
    int lim_a = a.skv - kv0, lim_b = lim_a;
    bool test = lim_a < BK;
    // ... and the kv mask's bits of this thread's even and odd columns:
    // bit kBit jj of keep<e> is its column 8 jj + 2 t4 + e
    constexpr int kKeys = BK / 32;       // keys a lane in the ballots
    constexpr int kBit = 8 / kKeys;      // bits of keep<e> per jj
    uint32_t keep0 = ~0u, keep1 = ~0u;
    if (MASKED) {
      if (a.causal) {
        lim_a = min(lim_a, row_a + 1 - kv0);
        lim_b = min(lim_b, row_b + 1 - kv0);
        // a tile wholly at or below the warp's first row needs no test
        test |= kv0 + BK - 1 > row_a - g;
      }
      if (mask != nullptr) {
        // the tile's BK keys as kKeys ballots of the warp, kKeys keys a
        // lane: bit l of w[i] is key kKeys l + i
        const int c = kv0 + kKeys * lane;
        uint32_t w[kKeys], all = ~0u;
#pragma unroll
        for (int i = 0; i < kKeys; ++i) {
          w[i] = __ballot_sync(0xffffffffu, c < a.skv && mask[c + i]);
          all &= w[i];
        }
        test |= all != ~0u;
        if constexpr (kKeys == 4) {
          keep0 = (t4 & 1 ? w[2] : w[0]) >> (t4 >> 1);
          keep1 = (t4 & 1 ? w[3] : w[1]) >> (t4 >> 1);
        } else {
          keep0 = w[0] >> t4;
          keep1 = w[1] >> t4;
        }
      }
    }
    if (test) {
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = jj * 8 + t4 * 2 + (e & 1);
          const uint32_t keep = (e & 1 ? keep1 : keep0) >> (kBit * jj);
          if (col >= (e < 2 ? lim_a : lim_b) || !(keep & 1u))
            s[jj][e] = kNegInf;
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
  };

  // p rounded to bf16: the A operand of the PV product
  auto round_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      pack_a(p[kk], s[2 * kk], s[2 * kk + 1]);
  };

  // The schedule, per warpgroup, as in K1: the scores of tile j and,
  // behind them, p v of tile j - 1 are queued on the tensor cores; as soon
  // as the scores are there K's stage is released and the softmax of tile
  // j runs while p v of tile j - 1 is still in flight; V's stage of tile
  // j - 1 is released when p v is done. The two warpgroups take turns at
  // queueing their products: named barrier 1 + wg opens warpgroup wg's
  // turn, and warpgroup 1 opens the first one.
  auto turn_wait = [&]() { named_barrier_sync(1 + wg, NT); };
  auto turn_pass = [&]() { named_barrier_arrive(2 - wg, NT); };
  if (wg == 1) named_barrier_arrive(1, NT);
  turn_wait();
  qk_product(0);
  turn_pass();
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

  // a warpgroup's 64 rows lie wholly inside Sq or wholly past it
  if (q0 + wg * 64 >= a.sq) return;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (a.lse != nullptr && t4 == 0) {
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
  TileMap q, k, v;
};

template <int D, bool MASKED, typename OutT>
cudaError_t launch(const Maps& m, const Args& a, int batch, int hq,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  auto kernel = flash_chunked_kernel<D, MASKED, OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + kTileQ - 1) / kTileQ, hq, batch);
  kernel<<<grid, kConsumers + 128, smem, stream>>>(m.q, m.k, m.v, a);
  return cudaGetLastError();
}

bool bad_shapes(int batch, int hq, int hk, int sq, int skv, int d) {
  return (d != 64 && d != 128 && d != 256) || sq <= 0 || skv <= 0 || sq % 64 ||
         skv % 64 || hk <= 0 || hq % hk || batch <= 0 || batch > 65535 ||
         hq > 65535;
}

// One launch on bf16 q, k, v at the strides st[0..8], o (OutT) at
// st[9..11].
template <typename OutT>
cudaError_t run(const void* q, const void* k, const void* v, void* o,
                float* lse, const long long* st, const unsigned char* mask,
                long long mask_sb, int batch, int hq, int hk, int sq, int skv,
                int d, int causal, float scale_log2e, cudaStream_t stream) {
  Args a;
  a.o = o;
  a.lse = lse;
  a.o_sb = st[9]; a.o_sh = st[10]; a.o_ss = st[11];
  a.mask = mask;
  a.mask_sb = mask_sb;
  a.group = hq / hk;
  a.sq = sq;
  a.skv = skv;
  a.causal = causal;
  a.scale_log2e = scale_log2e;
  Maps m;
  cudaError_t err = make_tile_map(&m.q, q, st[0], st[1], st[2], batch, hq, sq,
                                  d, kTileQ);
  const int box = d == 256 ? Tiles<256>::kv : Tiles<128>::kv;
  if (err == cudaSuccess)
    err = make_tile_map(&m.k, k, st[3], st[4], st[5], batch, hk, skv, d, box);
  if (err == cudaSuccess)
    err = make_tile_map(&m.v, v, st[6], st[7], st[8], batch, hk, skv, d, box);
  if (err != cudaSuccess) return err;
  const bool masked = mask != nullptr || causal != 0;
  return with_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return masked ? launch<D, true, OutT>(m, a, batch, hq, stream)
                  : launch<D, false, OutT>(m, a, batch, hq, stream);
  });
}

}  // namespace

// q, o: (B, Hq, Sq, D), k, v: (B, Hk, Skv, D) bf16 with the strides in
// `st` (elements): q (b, h, s), k (b, h, s), v (b, h, s), o (b, h, s); the
// last dim is contiguous. lse: (B, Hq, Sq) f32 contiguous, or null. mask:
// (B, Skv) bytes at mask_sb, or null. Returns the cudaError_t of the
// launch.
extern "C" int x2i_flash_chunked(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const long long* st, const unsigned char* mask, long long mask_sb,
    int batch, int hq, int hk, int sq, int skv, int d, int causal,
    float scale_log2e, void* stream_ptr) {
  if (bad_shapes(batch, hq, hk, sq, skv, d))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run<bf16>(q, k, v, o, lse, st, mask, mask_sb, batch,
                                    hq, hk, sq, skv, d, causal, scale_log2e,
                                    static_cast<cudaStream_t>(stream_ptr)));
}

// The f32 instance: q, k, v, o f32 at the strides in `st` as above
// (multiples of 4 elements, 16-byte aligned starts); the lse as above.
// scratch: (B*Hq*Sq + 2*B*Hk*Skv)*D bf16, the rounded q, k and v in that
// order, each contiguous.
extern "C" int x2i_flash_chunked_f32(
    const float* q, const float* k, const float* v, float* o, float* lse,
    void* scratch, const long long* st, const unsigned char* mask,
    long long mask_sb, int batch, int hq, int hk, int sq, int skv, int d,
    int causal, float scale_log2e, void* stream_ptr) {
  if (bad_shapes(batch, hq, hk, sq, skv, d) || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  bf16* rq = static_cast<bf16*>(scratch);
  bf16* rk = rq + static_cast<long long>(batch) * hq * sq * d;
  bf16* rv = rk + static_cast<long long>(batch) * hk * skv * d;
  long long rst[12];
  for (int i = 0; i < 12; ++i) rst[i] = st[i];
  cudaError_t err = round_into(q, rq, rst, batch, hq, sq, d, stream);
  if (err == cudaSuccess)
    err = round_into(k, rk, rst + 3, batch, hk, skv, d, stream);
  if (err == cudaSuccess)
    err = round_into(v, rv, rst + 6, batch, hk, skv, d, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(run<float>(rq, rk, rv, o, lse, rst, mask, mask_sb,
                                     batch, hq, hk, sq, skv, d, causal,
                                     scale_log2e, stream));
}
