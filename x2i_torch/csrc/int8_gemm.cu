// int8 x int8 -> int32 GEMM with the w8a8 epilogue, for sm_90a.
//
// Replaces the int8 products of the JAX package's w8a8 mode
// (x2i_tpu/ops/quant.py: the dot_general of w8a8_matmul at :43 and of
// w8a8_matmul_prequant at :94; XLA dots on the TPU, not Pallas). With the
// activation codes A (M, K) int8, row stride lda, and the weight codes
// B (N, ldb) int8 in the nn.Linear (out, in) layout, read from column koff
// on (so that a chunk of a wider weight is a K-slice, with no copy):
//
//   acc[m, n] = sum_k A[m, k] * B[n, koff + k]                (int32, exact)
//   out[m, n] = bf16(f32(acc) * a_scale[m] * scale[n])      (in that order)
//   out       = bf16(addend[m, n] + out)                    (optional)
//   out       = bf16(out + bias[n])                         (optional)
//
// the rounding points of quant.py:54-55 and :97 followed by QuantDense's
// bf16 chunk sum and bias add (:485-500). With acc_only the kernel writes
// the int32 accumulator instead (the function of torch._int_mm), which the
// checks use to hold it exact.
//
// What bounds it on an H100: at the DiT's shapes (M = 4608 tokens, K and
// N 3072..18432) it does 2MNK = 0.09-0.35 TOP per call against 30-80 MB
// of operands, so the int8 tensor-core rate (1979 TOP/s dense) bounds it;
// at M = 1..4 (the adaLN and timestep rows) reading the weight bounds it.
//
// Design: wgmma.mma_async m64n256k32 s8 x s8 -> s32 (hopper_mma.cuh), both
// operands K-major in 128-byte-swizzled shared memory, as 8-bit wgmma
// requires and as A and B already lie. A block computes a 128 x 256 output
// tile on two consumer warpgroups of 64 rows each. A producer warpgroup's
// one thread keeps a ring of 192 KB (4 stages) of 128-byte K steps (one
// swizzle row: the A rows and the B rows of the tile) in flight by TMA,
// through 2-d tensor maps over A and over B from column koff with K
// columns, so that bytes past M, N or K arrive as zeros: any M, any N that
// is a multiple of 8 and any K that is a multiple of 64. Blocks take their
// tiles 16 row tiles at a time, down the rows first, so that the tiles in
// flight share their operands in L2. The producer gives its registers back
// (setmaxnreg 24), the consumers take 240: the 64 x 256 s32 accumulator is 128 of them. A
// consumer keeps one K step's products in flight while it waits for the
// next stage, and each of its warps gives a stage back with one arrival.
// The epilogue stages the s32 tile in the ring's shared memory (rows
// padded by 32 bytes, free of bank conflicts), then each thread takes 8
// consecutive outputs of a row in each of its passes: the scales, the
// addend and the bias in the order above with __fmul_rn / __fadd_rn (no
// contraction into an FMA), and one 16-byte store. The epilogue is not
// overlapped with the next tile's loads (the block is not persistent), so
// its loads of the scales and the bias are all issued first, under the
// staging, and no pass waits on a load from memory.
//
// The first version of this file (mma.sync m16n8k32 on 128 x 128 tiles,
// cp.async, two blocks per SM) was slower at every shape of the main path
// but two of the M = 1 rows, where reading the weight bounds the call: it
// was level at 1 x 768 -> 3072 and 0.8 us faster at 1 x 256 -> 3072, one
// launch per DiT step each, and slower over the M = 1 and M = 4 rows taken
// together (PERF.md, NVIDIA H100 80GB HBM3). This kernel serves them all:
// no second kernel is kept for 0.8 us a step.
//
// The w4a8 GEMM (w4a8_gemm_kernel) is the same kernel with another source
// of its B stage. It replaces the int8 products of the JAX w4a8 mode
// (x2i_tpu/ops/quant.py::_w4a8_acc, :281-319, under w4a8_matmul and
// w4a8_matmul_prequant; XLA fusions on the TPU). The weight is int4 codes,
// half-split: byte j of row n of B (N, in/2) holds input j in its low
// nibble and input j + in/2 in its high nibble, and each code is
// multiplied by its (group, n) multiplier m in [1, 15] (mscale, int8
// (G, N), groups of g inputs), so the int8 operand is code x m, |.| <= 105
// and the int32 sum stays exact: 105 * 127 * 15360 < 2^31. A chunk of
// activations covers the inputs [koff, koff + K). The K loop runs over
// packed steps: 128 bytes of B at packed column P give the K step of
// inputs [P, P + 128) from the low nibbles and the K step of inputs
// [P + in/2, P + in/2 + 128) from the high nibbles, where either lies in
// the chunk; the two A tiles at P - koff and P + in/2 - koff meet one
// packed tile, so B's bytes from memory are halved. The producer brings
// the packed tile by TMA into the B stage of the first of its K steps;
// the consumers convert it there: each of their 256 threads takes one B
// row, reads a 16-byte chunk, writes the low codes back in place and the
// high codes into the B stage of the next K step, at the same swizzled
// offset (the conversion keeps every byte's place, so the 128-byte
// swizzle that TMA wrote stays right), with 4 bytes a 32-bit operation:
// (code + 8) x m per byte in one multiply (no carry: <= 225), then 8 m
// taken off each byte without borrows. A multiplier of 0 gives zero
// codes, which masks the columns outside the chunk. The converted stage
// is published to the tensor cores with fence.proxy.async and a named
// barrier of the 256 consumer threads, after the products of the K step
// before it were issued, so that the conversion runs while they are in
// flight; each row's multipliers are loaded a conversion ahead. The
// epilogue is the int8 GEMM's. What bounds it at the DiT's shapes: the
// int8 tensor-core rate bounds the int8 GEMM, but here the conversion's
// instructions do. On an H100 (PERF.md) it takes 1.9x the int8 GEMM's
// time at 4608 x 3072 -> 12288; with the conversion's loop emptied it
// takes the int8 GEMM's, so the ring and the pairing cost nothing, and
// with the arithmetic taken out of the loop 1.3x.
//
// The w4 dequantize kernel (w4_dequant_kernel) replaces the unpack and
// scale of x2i_tpu/ops/quant.py::_dequant_w4 (:153-160, over
// _unpack_int4), XLA on the TPU: row-interleaved codes (byte j of a row
// holds inputs 2j low and 2j + 1 high) times bf16(scale[g, n]), rounded
// once to bf16, into the (N, in) weight that cuBLAS then multiplies. It
// moves bytes only: a thread reads 4 packed bytes and writes 8 bf16.
//
// The two dequantize kernels of the straight-through backward
// (int8_dequant_kernel, w4a8_dequant_kernel) replace the dequantize of
// x2i_tpu/ops/quant.py's custom_vjp backwards, XLA on the TPU:
// _w8a8_bwd's (:77, shared by w8_matmul) qk.astype(x_dtype) *
// scale.astype(x_dtype), and _w4a8_bwd's (:359)
// _w4a8_weight_int8(pk, mscale).astype(x_dtype) * scale.astype(x_dtype).
// Each writes the (N, in) bf16 weight that cuBLAS then multiplies the
// output gradient by: dx = dy @ W. int8: code (N, in) times
// bf16(scale[n]); w4a8: the half-split int4 code times its (group, n)
// multiplier m (|code x m| <= 105, an exact integer) times bf16(scale[n]).
// Both factors are exact in bf16 and their product is exact in f32 (8 + 8
// significant bits), so one rounding to bf16 gives the bf16 product of
// PyTorch and of XLA bit for bit. Like w4_dequant_kernel they move bytes
// only (1 or 1/2 byte in, 2 out per weight): a thread reads 8 bytes of a
// row and writes 8 bf16 per 16-byte store, one store for int8, two for
// w4a8 (the low codes at the inputs j.. and the high ones at in/2 + j..).

#include "hopper_mma.cuh"

namespace {

struct Args {
  const int8_t* a;
  long long lda;
  const int8_t* b;
  long long ldb;
  const float* a_scale;
  const float* scale;
  const __nv_bfloat16* bias;
  const __nv_bfloat16* addend;
  long long ldd;
  void* out;
  long long ldo;
  int m, n, k;
  // w4a8 only: the multipliers (G, N), in/2, the group size and the first
  // input of the chunk
  const int8_t* mscale;
  int half, group, koff;
};

__device__ __forceinline__ float bf(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

constexpr int kRows = 128;              // output rows per block
constexpr int BN = 256;                 // output columns per block
constexpr int kStepBytes = 128;         // bytes of K per stage
constexpr int kRingBytes = 196608;      // the ring: 4 x 48 KB
constexpr int STAGES = kRingBytes / ((kRows + BN) * kStepBytes);
constexpr int kSmemBytes =
    kRingBytes + 2 * STAGES * static_cast<int>(sizeof(uint64_t)) +
    kSwizzleAtomBytes;
constexpr int kConsumers = 256;         // two consumer warpgroups
constexpr int kGroupRows = 16;          // row tiles per group of the order

// The K steps of a w4a8 chunk, in packed columns: the low nibbles of
// [lo_s, lo_e) and the high nibbles of [hi_s, hi_e) (each empty as 0, 0),
// walked in packed steps of 128 bytes from `first` to `last`.
struct PackedSteps {
  int lo_s, lo_e, hi_s, hi_e, first, last;

  __device__ explicit PackedSteps(const Args& p) {
    const int a = p.koff, b = p.koff + p.k, h = p.half;
    lo_s = a;
    lo_e = min(b, h);
    hi_s = max(a, h) - h;
    hi_e = b - h;
    if (lo_s >= lo_e) lo_s = lo_e = 0;
    if (hi_s >= hi_e) hi_s = hi_e = 0;
    // across in/2 the high part starts at 0 and the low part at koff, a
    // multiple of 128 (the wrapper checks it): no A tile starts before 0
    first = lo_s < lo_e && (hi_s >= hi_e || lo_s < hi_s) ? lo_s : hi_s;
    last = max(lo_e, hi_e);
  }
  __device__ bool lo(int P) const { return P < lo_e && P + 128 > lo_s; }
  __device__ bool hi(int P) const { return P < hi_e && P + 128 > hi_s; }
  __device__ int ksteps() const {
    int n = 0;
    for (int P = first; P < last; P += 128) n += lo(P) + hi(P);
    return n;
  }
};

// 4 packed low nibbles (one a byte) times m: (code + 8) m per byte in one
// multiply (at most 225: no carry), then 8 m (below 128) taken off each
// byte without borrows -> 4 int8 codes code x m.
__device__ __forceinline__ uint32_t nibbles_times(uint32_t nib, uint32_t m,
                                                  uint32_t m8) {
  const uint32_t x = (nib ^ 0x08080808u) * m;
  return ((x | 0x80808080u) - m8) ^ (~x & 0x80808080u);
}

template <bool ACC_ONLY, bool W4A8>
__device__ __forceinline__ void gemm_body(const CUtensorMap& map_a,
                                          const CUtensorMap& map_b,
                                          const Args& p) {
  constexpr uint32_t kABytes = kRows * kStepBytes;
  constexpr uint32_t kStageBytes = kABytes + BN * kStepBytes;
  // the epilogue's staging rows: BN s32 and 32 bytes of padding
  constexpr int kPitch = BN * 4 + 32;
  static_assert(STAGES >= 2 && 2 * 64 * kPitch <= kRingBytes, "ring");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + kSwizzleAtomBytes - 1) &
                        ~(kSwizzleAtomBytes - 1);
  unsigned char* smem = smem_raw + (ring - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRingBytes);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, wg = tid / 128;
  // The order of the tiles: kGroupRows row tiles at a time, down the rows
  // first, so that the blocks in flight share a few A and B tiles in L2
  // (in launch order row by row, a wave of the main shape re-reads all of
  // B, and A and B together overflow L2).
  const int linear = blockIdx.y * gridDim.x + blockIdx.x;
  const int per_group = kGroupRows * gridDim.x;
  const int first = linear / per_group * kGroupRows;
  const int rows = min(static_cast<int>(gridDim.y) - first, kGroupRows);
  const int m0 = (first + linear % per_group % rows) * kRows;
  const int n0 = linear % per_group / rows * BN;
  const PackedSteps steps(p);
  const int ksteps =
      W4A8 ? steps.ksteps() : (p.k + kStepBytes - 1) / kStepBytes;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers / 32);   // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // w4a8: the producer walks packed steps with more state, and gives back
  // fewer registers. setmaxnreg.inc takes only what the block's own
  // setmaxnreg.dec gave back (168 a thread to start with): 128 x (168 -
  // 40) = 256 x (232 - 168); a consumer asking for more waits forever.
  constexpr int kProducerRegs = W4A8 ? 40 : 24;
  constexpr int kConsumerRegs = W4A8 ? 232 : 240;
  if (tid >= kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    // The producer: one thread keeps the ring full, up to STAGES K steps
    // ahead of the consumers; a stage is the A box and the B box of one
    // K step, both completing on its `full`.
    if (tid == kConsumers && !W4A8) {
#pragma unroll 1
      for (int kt = 0; kt < ksteps; ++kt) {
        const int st = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[st], (kt / STAGES - 1) & 1);
        mbar_arrive_expect_tx(&full[st], kStageBytes);
        const uint32_t sa = ring + st * kStageBytes;
        tma_load_2d(map_a, sa, kt * kStepBytes, m0, &full[st]);
        tma_load_2d(map_b, sa + kABytes, kt * kStepBytes, n0, &full[st]);
      }
    } else if (tid == kConsumers) {
      // w4a8: a packed step takes the stages of its one or two K steps;
      // the packed tile lands in the B stage of the first, with its A
      int kt = 0;
#pragma unroll 1
      for (int P = steps.first; P < steps.last; P += kStepBytes) {
        const bool lo = steps.lo(P), hi = steps.hi(P);
        if (!lo && !hi) continue;
        for (int t = kt; t < kt + lo + hi; ++t)
          if (t >= STAGES)
            mbar_wait(&empty[t % STAGES], (t / STAGES - 1) & 1);
        const int st = kt % STAGES;
        const uint32_t sa = ring + st * kStageBytes;
        mbar_arrive_expect_tx(&full[st], kStageBytes);
        tma_load_2d(map_a, sa, lo ? P - p.koff : P + p.half - p.koff, m0,
                    &full[st]);
        tma_load_2d(map_b, sa + kABytes, P, n0, &full[st]);
        if (lo && hi) {
          const int st1 = (kt + 1) % STAGES;
          mbar_arrive_expect_tx(&full[st1], kABytes);
          tma_load_2d(map_a, ring + st1 * kStageBytes, P + p.half - p.koff,
                      m0, &full[st1]);
        }
        kt += lo + hi;
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  // w4a8: the next packed step to convert and its first K step
  int conv_p = steps.first, conv_k = 0;
  // The multipliers of thread tid's row (0 past N) for the low and the
  // high group of a packed column, loaded a conversion ahead: pre_grp is
  // the low group they belong to. A multiplier from memory takes longer
  // than the conversion it feeds; loaded at each chunk, they cost a
  // quarter of the kernel's time at the main shape.
  const int n_row = n0 + tid;
  const bool row_live = n_row < p.n;
  const int gh = W4A8 ? p.half / p.group : 0;
  auto load_m = [&](int grp, uint32_t& m_lo, uint32_t& m_hi) {
    m_lo = row_live ? static_cast<uint8_t>(__ldg(p.mscale + grp * p.n +
                                                 n_row))
                    : 0u;
    m_hi = row_live ? static_cast<uint8_t>(__ldg(p.mscale +
                                                 (gh + grp) * p.n + n_row))
                    : 0u;
  };
  int pre_grp = -1;
  uint32_t pre_lo = 0, pre_hi = 0;
  // Converts the packed step at conv_p, whose tile lies in the B stage of
  // K step conv_k: thread tid takes B row tid, 16 bytes at a time, the
  // low codes back in place, the high codes into the next K step's B
  // stage (in place when the step has no low part).
  auto convert = [&]() {
    while (!steps.lo(conv_p) && !steps.hi(conv_p)) conv_p += kStepBytes;
    const bool lo = steps.lo(conv_p), hi = steps.hi(conv_p);
    const int st = conv_k % STAGES;
    const int g16 = p.group / 16;
    int grp = conv_p / p.group, rem = conv_p / 16 % g16;
    uint32_t m_lo_g = pre_lo, m_hi_g = pre_hi;
    if (grp != pre_grp) load_m(grp, m_lo_g, m_hi_g);
    mbar_wait(&full[st], (conv_k / STAGES) & 1);
    unsigned char* src = smem + st * kStageBytes + kABytes + tid * kStepBytes;
    unsigned char* dst_hi =
        lo ? smem + (conv_k + 1) % STAGES * kStageBytes + kABytes +
                 tid * kStepBytes
           : src;
#pragma unroll
    for (int c = 0; c < kStepBytes / 16; ++c) {
      const int col = conv_p + 16 * c;
      const uint32_t m_lo =
          lo && col >= steps.lo_s && col < steps.lo_e ? m_lo_g : 0u;
      const uint32_t m_hi =
          hi && col >= steps.hi_s && col < steps.hi_e ? m_hi_g : 0u;
      const uint32_t off = (c ^ (tid & 7)) * 16;   // the 128-byte swizzle
      const uint4 w = *reinterpret_cast<const uint4*>(src + off);
      if (lo) {
        const uint32_t m8 = 8 * m_lo * 0x01010101u;
        *reinterpret_cast<uint4*>(src + off) = make_uint4(
            nibbles_times(w.x & 0x0F0F0F0Fu, m_lo, m8),
            nibbles_times(w.y & 0x0F0F0F0Fu, m_lo, m8),
            nibbles_times(w.z & 0x0F0F0F0Fu, m_lo, m8),
            nibbles_times(w.w & 0x0F0F0F0Fu, m_lo, m8));
      }
      if (hi) {
        const uint32_t m8 = 8 * m_hi * 0x01010101u;
        *reinterpret_cast<uint4*>(dst_hi + off) = make_uint4(
            nibbles_times(w.x >> 4 & 0x0F0F0F0Fu, m_hi, m8),
            nibbles_times(w.y >> 4 & 0x0F0F0F0Fu, m_hi, m8),
            nibbles_times(w.z >> 4 & 0x0F0F0F0Fu, m_hi, m8),
            nibbles_times(w.w >> 4 & 0x0F0F0F0Fu, m_hi, m8));
      }
      // groups of 16..112 bytes change inside the step; past in/2 (the
      // step's overhang, masked) there is no group to load
      if (++rem == g16 && c + 1 < kStepBytes / 16) {
        rem = 0;
        if (++grp < gh) load_m(grp, m_lo_g, m_hi_g);
      }
    }
    // the generic proxy's stores before the tensor cores' reads, then
    // every row of the stage before any warp's products
    fence_proxy_async();
    named_barrier_sync(1, kConsumers);
    conv_p += kStepBytes;
    conv_k += lo + hi;
    // the next step's multipliers, while this step's products run
    if (conv_p < steps.last) {
      pre_grp = conv_p / p.group;
      load_m(pre_grp, pre_lo, pre_hi);
    }
  };
  if constexpr (W4A8) convert();
  int acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
#pragma unroll 1
  for (int kt = 0; kt < ksteps; ++kt) {
    const int st = kt % STAGES;
    mbar_wait(&full[st], (kt / STAGES) & 1);
    const uint32_t sa = ring + st * kStageBytes;
    const uint64_t da =
        wgmma_desc(sa + wg * 64 * kSwizzleRowBytes, 16, kSwizzleAtomBytes);
    const uint64_t db = wgmma_desc(sa + kABytes, 16, kSwizzleAtomBytes);
    wgmma_pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStepBytes / 32; ++kk)
      wgmma_s8_n256(acc, desc_advance(da, kk * 32), desc_advance(db, kk * 32),
                    1);
    wgmma_commit();
    // the previous step's products are done: its stage goes back, where
    // a later step will refill it
    wgmma_wait<1>();
    wgmma_pin(acc);
    if (kt > 0 && kt - 1 + STAGES < ksteps && tid % 32 == 0)
      mbar_arrive(&empty[(kt - 1) % STAGES]);
    // w4a8: the next packed step, while this K step's products run
    if constexpr (W4A8)
      if (kt + 1 == conv_k && conv_k < ksteps) convert();
  }
  wgmma_wait<0>();
  wgmma_pin(acc);

  // The epilogue: 8 consecutive outputs a thread, a row's threads side by
  // side, kPasses rows apart. The scales and the bias of its columns and
  // the scales of its rows are loaded first, all at once, so that their
  // latency falls under the staging of the tile and no pass waits on a
  // load from memory.
  constexpr int kChunks = BN / 8, kRowsPerPass = 128 / kChunks;
  constexpr int kPasses = 64 / kRowsPerPass;
  const int c = (tid % 128) % kChunks, col = n0 + 8 * c;
  const int r0 = (tid % 128) / kChunks, row0 = m0 + wg * 64 + r0;
  const bool live = col < p.n;               // N % 8 == 0: all or nothing
  float sc[8], bias[8], as[kPasses];
  if (!ACC_ONLY && live) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      sc[e] = p.scale[col + e];
      bias[e] = p.bias ? bf(p.bias[col + e]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      const int row = row0 + i * kRowsPerPass;
      as[i] = row < p.m ? p.a_scale[row] : 0.f;
    }
  }

  // Both warpgroups have left the ring (every stage the producer filled
  // has been read): it becomes the staging area of the s32 tile.
  named_barrier_sync(1, kConsumers);
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  unsigned char* tile = smem + wg * 64 * kPitch;
  {
    const int r = warp * 16 + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int off = (8 * j + 2 * t4) * 4;
      *reinterpret_cast<int2*>(tile + r * kPitch + off) =
          make_int2(acc[j][0], acc[j][1]);
      *reinterpret_cast<int2*>(tile + (r + 8) * kPitch + off) =
          make_int2(acc[j][2], acc[j][3]);
    }
  }
  named_barrier_sync(2 + wg, 128);
  if (!live) return;
#pragma unroll 4
  for (int i = 0; i < kPasses; ++i) {
    const int rr = r0 + i * kRowsPerPass, row = m0 + wg * 64 + rr;
    if (row >= p.m) break;
    const int4 lo = *reinterpret_cast<const int4*>(tile + rr * kPitch + c * 32);
    const int4 hi =
        *reinterpret_cast<const int4*>(tile + rr * kPitch + c * 32 + 16);
    const long long at = static_cast<long long>(row) * p.ldo + col;
    if (ACC_ONLY) {
      int4* o = reinterpret_cast<int4*>(static_cast<int*>(p.out) + at);
      o[0] = lo;
      o[1] = hi;
      continue;
    }
    const int v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const __nv_bfloat16* add =
        p.addend ? p.addend + static_cast<long long>(row) * p.ldd + col
                 : nullptr;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      __nv_bfloat16 y = __float2bfloat16_rn(
          __fmul_rn(__fmul_rn(__int2float_rn(v[e]), as[i]), sc[e]));
      if (add) y = __float2bfloat16_rn(__fadd_rn(bf(add[e]), bf(y)));
      if (p.bias) y = __float2bfloat16_rn(__fadd_rn(bf(y), bias[e]));
      const uint32_t bits = __bfloat16_as_ushort(y);
      w[e / 2] = e % 2 ? w[e / 2] | bits << 16 : bits;
    }
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.out) + at) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <bool ACC_ONLY>
__global__ void __launch_bounds__(kConsumers + 128, 1) int8_gemm_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_b, Args p) {
  gemm_body<ACC_ONLY, false>(map_a, map_b, p);
}

template <bool ACC_ONLY>
__global__ void __launch_bounds__(kConsumers + 128, 1) w4a8_gemm_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_b, Args p) {
  gemm_body<ACC_ONLY, true>(map_a, map_b, p);
}

template <bool ACC_ONLY, bool W4A8>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  auto kernel =
      W4A8 ? w4a8_gemm_kernel<ACC_ONLY> : int8_gemm_kernel<ACC_ONLY>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap map_a, map_b;
  cudaError_t err =
      make_byte_matrix_map(&map_a, p.a, p.k, p.m, p.lda, kRows);
  // w4a8: the packed bytes, in/2 columns from the first
  if (err == cudaSuccess)
    err = make_byte_matrix_map(&map_b, p.b, W4A8 ? p.half : p.k, p.n, p.ldb,
                               BN);
  if (err != cudaSuccess) return err;
  dim3 grid((p.n + BN - 1) / BN, (p.m + kRows - 1) / kRows);
  kernel<<<grid, kConsumers + 128, kSmemBytes, stream>>>(map_a, map_b, p);
  return cudaGetLastError();
}

}  // namespace

// The wrapper (x2i_torch/ops/int8_gemm.py) checks types, shapes,
// alignment (16 bytes for a, b, lda, ldb and koff) and K % 64 == 0.
// Returns the cudaError_t of the launch.
extern "C" int x2i_int8_gemm(const void* a, long long lda, const void* b,
                             long long ldb, long long koff,
                             const void* a_scale, const void* scale,
                             const void* bias, const void* addend,
                             long long ldd, void* out, long long ldo, int m,
                             int n, int k, int acc_only, void* stream) {
  if (m < 1 || n < 8 || n % 8 || k < 64 || k % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.a = static_cast<const int8_t*>(a);
  p.lda = lda;
  p.b = static_cast<const int8_t*>(b) + koff;
  p.ldb = ldb;
  p.a_scale = static_cast<const float*>(a_scale);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.addend = static_cast<const __nv_bfloat16*>(addend);
  p.ldd = ldd;
  p.out = out;
  p.ldo = ldo;
  p.m = m;
  p.n = n;
  p.k = k;
  p.mscale = nullptr;
  p.half = p.group = p.koff = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(acc_only ? launch<true, false>(p, s)
                                   : launch<false, false>(p, s));
}

// The wrapper (x2i_torch/ops/int4_gemm.py) checks types, shapes and
// alignment: K, koff, in/2 and the group size multiples of 16, an even
// group count, koff a multiple of 128 for a chunk across in/2; a and b
// 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int x2i_w4a8_gemm(const void* a, long long lda, const void* b,
                             long long ldb, const void* mscale, int half,
                             int group, int koff, const void* a_scale,
                             const void* scale, const void* bias,
                             const void* addend, long long ldd, void* out,
                             long long ldo, int m, int n, int k,
                             int acc_only, void* stream) {
  if (m < 1 || n < 8 || n % 8 || k < 16 || k % 16 || half < 16 ||
      half % 16 || group < 16 || group % 16 || half % group ||
      (half / group) < 1 || koff < 0 || koff % 16 || koff + k > 2 * half ||
      (koff < half && koff + k > half && koff % 128))
    return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.a = static_cast<const int8_t*>(a);
  p.lda = lda;
  p.b = static_cast<const int8_t*>(b);
  p.ldb = ldb;
  p.a_scale = static_cast<const float*>(a_scale);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.addend = static_cast<const __nv_bfloat16*>(addend);
  p.ldd = ldd;
  p.out = out;
  p.ldo = ldo;
  p.m = m;
  p.n = n;
  p.k = k;
  p.mscale = static_cast<const int8_t*>(mscale);
  p.half = half;
  p.group = group;
  p.koff = koff;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(acc_only ? launch<true, true>(p, s)
                                   : launch<false, true>(p, s));
}

namespace {

// One thread: 4 packed bytes of a row (8 inputs) -> 8 bf16, each the code
// times the bf16 scale of its group, rounded once (a bf16 times a code of
// at most 4 bits is exact in f32), in one 16-byte store: a warp reads 128
// contiguous bytes and writes 512. `group` is even, so the two inputs of
// a byte share a group.
__global__ void __launch_bounds__(256) w4_dequant_kernel(
    const int8_t* __restrict__ pw, long long ldp,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int n,
    int half, int group) {
  const int per_row = half / 4;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(n) * per_row) return;
  const int row = static_cast<int>(idx / per_row);
  const int c = static_cast<int>(idx % per_row);
  const uint32_t w =
      __ldg(reinterpret_cast<const uint32_t*>(pw + row * ldp) + c);
  const int first = 8 * c;
  const bool one_group = first / group == (first + 7) / group;
  const float s0 = __bfloat162float(
      __float2bfloat16_rn(__ldg(scale + (first / group) * n + row)));
  uint32_t o[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int byte = (w >> (8 * b)) & 0xFF;
    const float s =
        one_group ? s0
                  : __bfloat162float(__float2bfloat16_rn(
                        __ldg(scale + ((first + 2 * b) / group) * n + row)));
    const float lo = static_cast<float>(((byte & 0xF) ^ 8) - 8);
    const float hi = static_cast<float>(((byte >> 4) ^ 8) - 8);
    o[b] = static_cast<uint32_t>(
               __bfloat16_as_ushort(__float2bfloat16_rn(lo * s))) |
           static_cast<uint32_t>(
               __bfloat16_as_ushort(__float2bfloat16_rn(hi * s)))
               << 16;
  }
  *reinterpret_cast<uint4*>(out + static_cast<long long>(row) * 2 * half +
                            first) = make_uint4(o[0], o[1], o[2], o[3]);
}

}  // namespace

// pw (n, half) packed with rows ldp bytes apart (16-byte aligned), scale
// (half * 2 / group, n) f32, out (n, 2 * half) bf16. Returns the
// cudaError_t of the launch.
extern "C" int x2i_w4_dequant(const void* pw, long long ldp,
                              const void* scale, void* out, int n, int half,
                              int group, void* stream) {
  if (n < 1 || half < 16 || half % 16 || group < 2 || group % 2 ||
      (2 * half) % group || ldp % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(n) * (half / 4);
  const unsigned blocks = static_cast<unsigned>((threads + 255) / 256);
  w4_dequant_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(pw), ldp, static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), n, half, group);
  return static_cast<int>(cudaGetLastError());
}

namespace {

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
             << 16;
}

// byte i (0..7) of the two words, as an unsigned value
__device__ __forceinline__ int byte_of(const uint2& w, int i) {
  return static_cast<int>(((i < 4 ? w.x : w.y) >> (8 * (i % 4))) & 0xFF);
}

// One thread: 8 int8 codes of a row -> 8 bf16, each code times the bf16
// scale of the row, rounded once, in one 16-byte store.
__global__ void __launch_bounds__(256) int8_dequant_kernel(
    const int8_t* __restrict__ q, long long ldq,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int n,
    int k) {
  const int per_row = k / 8;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(n) * per_row) return;
  const int row = static_cast<int>(idx / per_row);
  const int c = static_cast<int>(idx % per_row);
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(q + row * ldq) + c);
  const float s = __bfloat162float(__float2bfloat16_rn(__ldg(scale + row)));
  uint32_t o[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    // a byte sign-extended: (byte ^ 0x80) - 0x80
    const float lo = static_cast<float>((byte_of(w, 2 * b) ^ 0x80) - 0x80);
    const float hi =
        static_cast<float>((byte_of(w, 2 * b + 1) ^ 0x80) - 0x80);
    o[b] = bf16_pair(__fmul_rn(lo, s), __fmul_rn(hi, s));
  }
  *reinterpret_cast<uint4*>(out + static_cast<long long>(row) * k + 8 * c) =
      make_uint4(o[0], o[1], o[2], o[3]);
}

// One thread: 8 packed bytes of a row (packed columns j..j+7) -> the 8
// bf16 of the inputs j.. (low nibbles) and of the inputs in/2 + j.. (high
// nibbles), each code times its multiplier m[group, row] times the bf16
// scale of the row, rounded once, in two 16-byte stores.
__global__ void __launch_bounds__(256) w4a8_dequant_kernel(
    const int8_t* __restrict__ pw, long long ldp,
    const int8_t* __restrict__ mscale, const float* __restrict__ scale,
    __nv_bfloat16* __restrict__ out, int n, int half, int group) {
  const int per_row = half / 8;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(n) * per_row) return;
  const int row = static_cast<int>(idx / per_row);
  const int c = static_cast<int>(idx % per_row);
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(pw + row * ldp) + c);
  const float s = __bfloat162float(__float2bfloat16_rn(__ldg(scale + row)));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int in0 = 8 * c + h * half;
    const bool one_group = in0 / group == (in0 + 7) / group;
    const int m0 = __ldg(mscale + static_cast<long long>(in0 / group) * n +
                         row);
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int b = byte_of(w, i);
      const int code = (((h ? b >> 4 : b) & 0xF) ^ 8) - 8;
      const int m =
          one_group ? m0
                    : __ldg(mscale +
                            static_cast<long long>((in0 + i) / group) * n +
                            row);
      v[i] = __fmul_rn(static_cast<float>(code * m), s);
    }
    *reinterpret_cast<uint4*>(out + static_cast<long long>(row) * 2 * half +
                              in0) =
        make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                   bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
  }
}

unsigned blocks_of(long long threads) {
  return static_cast<unsigned>((threads + 255) / 256);
}

}  // namespace

// q (n, k) int8 with rows ldq bytes apart, scale (n,) f32, out (n, k) bf16;
// k, ldq and q's address multiples of 8. Returns the cudaError_t of the
// launch.
extern "C" int x2i_int8_dequant(const void* q, long long ldq,
                                const void* scale, void* out, int n, int k,
                                void* stream) {
  if (n < 1 || k < 8 || k % 8 || ldq % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  int8_dequant_kernel<<<blocks_of(static_cast<long long>(n) * (k / 8)), 256,
                        0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), ldq, static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), n, k);
  return static_cast<int>(cudaGetLastError());
}

// pw (n, half) half-split packed with rows ldp bytes apart, mscale
// (2 * half / group, n) int8, scale (n,) f32, out (n, 2 * half) bf16;
// half, ldp and pw's address multiples of 8. Returns the cudaError_t of
// the launch.
extern "C" int x2i_w4a8_dequant(const void* pw, long long ldp,
                                const void* mscale, const void* scale,
                                void* out, int n, int half, int group,
                                void* stream) {
  if (n < 1 || half < 8 || half % 8 || ldp % 8 || group < 1 ||
      (2 * half) % group)
    return static_cast<int>(cudaErrorInvalidValue);
  w4a8_dequant_kernel<<<blocks_of(static_cast<long long>(n) * (half / 8)),
                        256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(pw), ldp,
      static_cast<const int8_t*>(mscale), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), n, half, group);
  return static_cast<int>(cudaGetLastError());
}
