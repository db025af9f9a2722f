// int8 x int8 -> int32 GEMM with the w8a8 epilogue, the w4a8 GEMM, the
// weight-only modes' dequantizing bf16 GEMM and the dequantize kernels,
// for sm_90a.
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
// bf16 chunk sum and bias add (:485-500). An f32 layer (an f32 DiT) takes
// the f32 instance of the epilogue: the same steps, each rounded once in
// f32 (JAX rescales in f32 and returns out_dtype f32, quant.py:43-52 and
// :94-98, and QuantDense adds the chunks and the bias in f32), with an f32
// addend and bias, so that it is bit for bit the plain version: the int32
// sums are exact. It writes twice the bf16 output's bytes. With the
// int32 output the kernel writes the accumulator instead (the function of
// torch._int_mm), which the checks use to hold it exact.
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
// with the arithmetic taken out of the loop 1.3x. Two redesigns were built
// and timed against it and are not kept (x2i_torch/tools/w4a8_variants.cu,
// timed by x2i_torch/tools/gemm_variants.py; PERF.md): a converter
// warpgroup that issues no wgmma (one warpgroup of 56 registers converts
// too slowly), and the same with an unsigned
// B operand (code + 8) x m and an exact correction of the sums in the
// epilogue (its M N K / g multiply-adds on the CUDA cores cost more than
// the arithmetic they save).
//
// The dequantizing GEMM (dequant_gemm_kernel) is the weight-only modes'
// product, the counterpart of x2i_tpu/ops/quant.py::w8_matmul (:102-111)
// and w4_matmul (:163-169, over _dequant_w4), whose XLA fusions
// dequantize the weight into the dot's operand: out = bf16(x @ W^T), then
// bf16(out + bias), with x (M, K) bf16 and W (N, K) from the layer's own
// buffers: w8 int8 codes (N, K) with per-row scales, w4 packed codes
// (N, K/2), row-interleaved, with (K / g, N) group scales. Each weight is
// bf16_rn(f32(code) * f32(bf16(scale))), the weight the dequantize
// kernels write, bit for bit (the scale is in the operand, never in the
// epilogue, as JAX rounds). What bounds it on an H100: at the DiT's shapes
// the bf16 tensor-core rate (989 TFLOP/s), and at M = 1..4 reading the
// codes. Design: a block computes the transposed tile out^T of 128 weight
// rows by 256 tokens with wgmma m64n256k16, the weight as the register A
// operand of each of the two consumer warpgroups (64 rows each) and x as
// the 128-byte-swizzled B operand. A producer thread keeps a ring of five
// x tiles (256 tokens x 64 inputs) and a ring of three raw code tiles
// (128 rows x 128 bytes: two K steps of w8, four of w4) in flight by TMA.
// Each consumer thread converts its own A fragments (rows g and g + 8 of
// its warp's 16; inputs 2 t4, 2 t4 + 1 and 2 t4 + 8, 2 t4 + 9 of each
// block of 16) straight from the raw tile into registers, for the next
// K step while the current one's products run: w8 by one byte permute and
// one fma a code (code + 128 in the mantissa of f32 32768 + u, minus
// 32896 s, exact) and one f32 -> bf16x2 rounding a pair; w4 by one byte
// permute and one lop3 a pair (bf16 128 + u, u = nibble ^ 8), one bf16x2
// fma (- 136, exact) and one bf16x2 multiply by the scale, rounded once.
// With the weight on the side of 128 rows, a block converts half the
// weight rows per product that a B-stage conversion (256 rows) would, and
// the converted weight never goes through shared memory. The epilogue
// stages the f32 tile transposed (token rows of 128 outputs) in the x ring
// and stores 8 consecutive outputs a thread. A dump mode writes the
// converted weight (N, K) instead of the product, which the checks hold
// bit for bit against the dequantize kernels. Trial builds on the card
// that converted into B stages in shared memory on a warpgroup of their
// own (as the w4a8 GEMM's lever a), or shared the x tiles between the two
// blocks of a cluster by TMA multicast, were slower.
//
// The w4 dequantize kernel (w4_dequant_kernel) replaces the unpack and
// scale of x2i_tpu/ops/quant.py::_dequant_w4 (:153-160, over
// _unpack_int4), XLA on the TPU: row-interleaved codes (byte j of a row
// holds inputs 2j low and 2j + 1 high) times bf16(scale[g, n]), rounded
// once to bf16, into the (N, in) weight that cuBLAS then multiplies. It
// moves bytes only: a thread reads 4 packed bytes and writes 8 bf16.
// Its f32 instance, and the int8 dequantize kernel's (int8_dequant_kernel
// below), are the weight-only modes' product for an f32 DiT (JAX's
// w8_matmul and w4_matmul dequantize to an f32 x's dtype, :102-111 and
// :153-169): f32(code) * scale[g, n] (w4) or * scale[n] (w8), rounded once
// in f32, the weight that F.linear then multiplies in f32. They write
// twice the bf16 weight's bytes; the dequantizing GEMM keeps bf16 x.
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
  const void* bias;     // (N,): bf16, or f32 with an f32 output
  const void* addend;   // (M, N) rows ldd apart: as the bias
  long long ldd;
  void* out;
  long long ldo;
  int m, n, k;
  // w4a8 only: the multipliers (G, N), in/2, the group size and the first
  // input of the chunk
  const int8_t* mscale;
  int half, group, koff;
  // the dequantizing GEMM: 1 writes the converted weight (N, K) instead of
  // the product
  int dump;
};

__device__ __forceinline__ float bf(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// What the GEMM writes: the bf16 or the f32 output (the w8a8 epilogue in
// that dtype), or the int32 accumulator.
enum Out { kOutBf16, kOutF32, kOutS32 };

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

template <int OUT, bool W4A8>
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
  if (OUT != kOutS32 && live) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      sc[e] = p.scale[col + e];
      if constexpr (OUT == kOutF32)
        bias[e] = p.bias ? static_cast<const float*>(p.bias)[col + e] : 0.f;
      else
        bias[e] = p.bias ? bf(static_cast<const __nv_bfloat16*>(p.bias)
                                  [col + e])
                         : 0.f;
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
    if constexpr (OUT == kOutS32) {
      int4* o = reinterpret_cast<int4*>(static_cast<int*>(p.out) + at);
      o[0] = lo;
      o[1] = hi;
      continue;
    }
    const int v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const long long add_at = static_cast<long long>(row) * p.ldd + col;
    if constexpr (OUT == kOutF32) {
      // every step rounded once in f32, in the plain version's order;
      // the addend's 8 values in two 16-byte loads (the wrapper checks
      // its alignment)
      float y[8], add[8] = {};
      if (p.addend) {
        const float4* a4 = reinterpret_cast<const float4*>(
            static_cast<const float*>(p.addend) + add_at);
        const float4 d0 = a4[0], d1 = a4[1];
        add[0] = d0.x, add[1] = d0.y, add[2] = d0.z, add[3] = d0.w;
        add[4] = d1.x, add[5] = d1.y, add[6] = d1.z, add[7] = d1.w;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        y[e] = __fmul_rn(__fmul_rn(__int2float_rn(v[e]), as[i]), sc[e]);
        if (p.addend) y[e] = __fadd_rn(add[e], y[e]);
        if (p.bias) y[e] = __fadd_rn(y[e], bias[e]);
      }
      float4* o = reinterpret_cast<float4*>(static_cast<float*>(p.out) + at);
      o[0] = make_float4(y[0], y[1], y[2], y[3]);
      o[1] = make_float4(y[4], y[5], y[6], y[7]);
      continue;
    }
    const __nv_bfloat16* add =
        p.addend ? static_cast<const __nv_bfloat16*>(p.addend) + add_at
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

template <int OUT>
__global__ void __launch_bounds__(kConsumers + 128, 1) int8_gemm_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_b, Args p) {
  gemm_body<OUT, false>(map_a, map_b, p);
}

template <int OUT>
__global__ void __launch_bounds__(kConsumers + 128, 1) w4a8_gemm_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_b, Args p) {
  gemm_body<OUT, true>(map_a, map_b, p);
}

template <int OUT, bool W4A8>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  auto kernel = W4A8 ? w4a8_gemm_kernel<OUT> : int8_gemm_kernel<OUT>;
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

template <bool W4A8>
cudaError_t launch_out(const Args& p, int out, cudaStream_t stream) {
  return out == kOutBf16  ? launch<kOutBf16, W4A8>(p, stream)
         : out == kOutF32 ? launch<kOutF32, W4A8>(p, stream)
                          : launch<kOutS32, W4A8>(p, stream);
}

}  // namespace

// `out_kind` is what it writes (Out): 0 bf16 (bias and addend bf16), 1 f32
// (bias and addend f32), 2 the int32 accumulator. The wrapper
// (x2i_torch/ops/int8_gemm.py) checks types, shapes, alignment (16 bytes
// for a, b, lda, ldb and koff, and for an f32 addend's rows) and
// K % 64 == 0. Returns the cudaError_t of the launch.
extern "C" int x2i_int8_gemm(const void* a, long long lda, const void* b,
                             long long ldb, long long koff,
                             const void* a_scale, const void* scale,
                             const void* bias, const void* addend,
                             long long ldd, void* out, long long ldo, int m,
                             int n, int k, int out_kind, void* stream) {
  if (m < 1 || n < 8 || n % 8 || k < 64 || k % 64 || out_kind < kOutBf16 ||
      out_kind > kOutS32)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.a = static_cast<const int8_t*>(a);
  p.lda = lda;
  p.b = static_cast<const int8_t*>(b) + koff;
  p.ldb = ldb;
  p.a_scale = static_cast<const float*>(a_scale);
  p.scale = static_cast<const float*>(scale);
  p.bias = bias;
  p.addend = addend;
  p.ldd = ldd;
  p.out = out;
  p.ldo = ldo;
  p.m = m;
  p.n = n;
  p.k = k;
  p.mscale = nullptr;
  p.half = p.group = p.koff = 0;
  return static_cast<int>(
      launch_out<false>(p, out_kind, static_cast<cudaStream_t>(stream)));
}

// `out_kind` as for x2i_int8_gemm. The wrapper (x2i_torch/ops/int4_gemm.py)
// checks types, shapes and alignment: K, koff, in/2 and the group size
// multiples of 16, an even group count, koff a multiple of 128 for a chunk
// across in/2; a and b 16-byte aligned. Returns the cudaError_t of the
// launch.
extern "C" int x2i_w4a8_gemm(const void* a, long long lda, const void* b,
                             long long ldb, const void* mscale, int half,
                             int group, int koff, const void* a_scale,
                             const void* scale, const void* bias,
                             const void* addend, long long ldd, void* out,
                             long long ldo, int m, int n, int k,
                             int out_kind, void* stream) {
  if (out_kind < kOutBf16 || out_kind > kOutS32 || m < 1 || n < 8 ||
      n % 8 || k < 16 || k % 16 || half < 16 ||
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
  p.bias = bias;
  p.addend = addend;
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
  return static_cast<int>(
      launch_out<true>(p, out_kind, static_cast<cudaStream_t>(stream)));
}

namespace {

// ------------------------------------------------- the dequantizing GEMM

// A block computes the transposed tile out^T of 128 weight rows (outputs,
// two consumer warpgroups of 64) by 256 tokens: the weight is the register
// A operand of wgmma m64n256k16 (bf16, f32 sums), converted by the
// consumers themselves from raw code tiles, and x the shared B operand.
constexpr int kDqRows = 128;            // weight rows (outputs) per block
constexpr int kDqTokens = 256;          // tokens per block
constexpr int kDqXStages = 5;           // x tiles: 256 tokens x 64 inputs
constexpr int kDqRawStages = 3;         // raw tiles: 128 rows x 128 bytes
constexpr uint32_t kDqXBytes = kDqTokens * kStepBytes;
constexpr uint32_t kDqRawBytes = kDqRows * kStepBytes;
constexpr int kDqRawOffset = kDqXStages * kDqXBytes;
constexpr int kDqRingBytes = kDqRawOffset + kDqRawStages * kDqRawBytes;
constexpr int kDqSmemBytes =
    kDqRingBytes + 2 * (kDqXStages + kDqRawStages) *
                       static_cast<int>(sizeof(uint64_t)) +
    kSwizzleAtomBytes;
// the epilogue stages the tile transposed, a token's 128 f32 outputs a
// row: 16 bytes of padding make the transposing writes free of bank
// conflicts
constexpr int kDqPitch = kDqRows * 4 + 16;
static_assert(kDqTokens * kDqPitch <= kDqRawOffset, "epilogue staging");
static_assert(kDqSmemBytes <= 232448, "shared memory");

__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Two f32 -> bf16x2 (lo in the low half), each rounded to nearest even.
__device__ __forceinline__ uint32_t bf16x2_of(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// w8: two int8 codes (the low 16 bits of `pair`) -> bf16x2 code x s. A
// code's byte u = code + 128 lands in the mantissa of f32 32768 + u (one
// byte permute); one fma with c = -32896 s (exact: 9 + 8 significant bits)
// gives code x s exactly, and the conversion rounds it once, as the int8
// dequantize kernel does.
__device__ __forceinline__ uint32_t w8_pair(uint32_t pair, float s, float c) {
  const uint32_t x = pair ^ 0x8080u;
  return bf16x2_of(
      fmaf(__uint_as_float(__byte_perm(x, 0x47000000u, 0x7504)), s, c),
      fmaf(__uint_as_float(__byte_perm(x, 0x47000000u, 0x7514)), s, c));
}

// w4: byte `i` of the packed word w (inputs 2j low, 2j + 1 high) -> bf16x2
// code x s, s2 the bf16 scale in both halves. The two nibbles n, brought
// to bits 0-3 and 16-19 by one byte permute, go as u = n ^ 8 into the
// mantissas of bf16 128 + u by one lop3 ((t & mask) ^ 8s | exponents);
// 128 + u - 136 = code exactly, and the product by s is rounded once:
// bf16_rn(f32(code) * f32(s)), as the w4 dequantize kernel writes it.
__device__ __forceinline__ uint32_t w4_pair(uint32_t w, int i, uint32_t s2) {
  const uint32_t t = __byte_perm(w, w >> 4, i | (4 + i) << 8);
  uint32_t h;
  // bits of the mask 0x000F000F: t ^ 0x00080008; the others 0x43004300
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n"
      : "=r"(h)
      : "r"(t), "r"(0x000F000Fu), "r"(0x43084308u));
  return bf16x2_mul(bf16x2_fma(h, 0x3F803F80u, 0xC308C308u), s2);
}

template <bool W4>
__global__ void __launch_bounds__(kConsumers + 128, 1) dequant_gemm_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_b, Args p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + kSwizzleAtomBytes - 1) &
                        ~(kSwizzleAtomBytes - 1);
  unsigned char* smem = smem_raw + (ring - raw);
  uint64_t* x_full = reinterpret_cast<uint64_t*>(smem + kDqRingBytes);
  uint64_t* x_empty = x_full + kDqXStages;
  uint64_t* raw_full = x_empty + kDqXStages;
  uint64_t* raw_empty = raw_full + kDqRawStages;

  const int tid = threadIdx.x, wg = tid / 128;
  // the tile: kGroupRows token tiles at a time, down the tokens first, so
  // that the blocks in flight share a few x and weight tiles in L2
  const int linear = blockIdx.y * gridDim.x + blockIdx.x;
  const int per_group = kGroupRows * gridDim.x;
  const int first = linear / per_group * kGroupRows;
  const int rows = min(static_cast<int>(gridDim.y) - first, kGroupRows);
  const int m0 = (first + linear % per_group % rows) * kDqTokens;
  const int n0 = linear % per_group / rows * kDqRows;
  // K steps of 64 inputs; a raw tile is 128 bytes of each weight row: two
  // K steps of w8, four of w4
  constexpr int kPer = W4 ? 4 : 2;
  const int ksteps = p.k / 64;
  const int nraw = (ksteps + kPer - 1) / kPer;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kDqXStages; ++i) {
      mbar_init(&x_full[i], 1);
      mbar_init(&x_empty[i], kConsumers / 32);
    }
#pragma unroll
    for (int i = 0; i < kDqRawStages; ++i) {
      mbar_init(&raw_full[i], 1);
      mbar_init(&raw_empty[i], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    setmaxnreg_dec<24>();
    // The producer: one thread keeps the x ring full, and the raw ring a
    // raw tile ahead of the K step the x tiles have reached (the consumers
    // convert a K step ahead of their products).
    if (tid == kConsumers) {
      int r_next = 0;
#pragma unroll 1
      for (int t = 0; t < ksteps; ++t) {
        while (r_next < nraw && r_next <= t / kPer + 1) {
          const int i = r_next % kDqRawStages;
          if (r_next >= kDqRawStages)
            mbar_wait(&raw_empty[i], (r_next / kDqRawStages - 1) & 1);
          mbar_arrive_expect_tx(&raw_full[i], kDqRawBytes);
          tma_load_2d(map_b, ring + kDqRawOffset + i * kDqRawBytes,
                      r_next * kStepBytes, n0, &raw_full[i]);
          ++r_next;
        }
        const int st = t % kDqXStages;
        if (t >= kDqXStages)
          mbar_wait(&x_empty[st], (t / kDqXStages - 1) & 1);
        mbar_arrive_expect_tx(&x_full[st], kDqXBytes);
        tma_load_2d(map_x, ring + st * kDqXBytes, t * kStepBytes, m0,
                    &x_full[st]);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  // the thread's weight rows in the tile (the A fragment's rows g, g + 8)
  const int ra = wg * 64 + warp * 16 + g, rb = ra + 8;
  const int na = n0 + ra, nb = n0 + rb;
  // the rows' scales: w8 one a row for the tile; w4 one a group, carried
  // in sa2 / sb2 for group sg and loaded ahead for the next K step's first
  float sa = 0.f, sb = 0.f;
  uint32_t sa2 = 0u, sb2 = 0u, pa = 0u, pb = 0u;
  int sg = -1, pg = -1;
  auto bf16_scale = [](float s) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(s)));
  };
  auto load_scale = [&](int grp, int n) {
    return n < p.n ? __ldg(p.scale + static_cast<long long>(grp) * p.n + n)
                   : 0.f;
  };
  if (!W4) {
    sa = __uint_as_float(bf16_scale(load_scale(0, na)) << 16);
    sb = __uint_as_float(bf16_scale(load_scale(0, nb)) << 16);
  }

  // K step t's A fragments into a[k16 block][4]: rows ra, rb at inputs
  // (2 t4, 2 t4 + 1) and (2 t4 + 8, 2 t4 + 9) of each block of 16, read
  // from the raw tile at the 128-byte swizzle's places (TMA wrote it with
  // it). The raw tile goes back after its last K step is converted.
  auto convert = [&](int t, uint32_t(&a)[4][4]) {
    const int r = t / kPer, part = t % kPer, rs = r % kDqRawStages;
    if (part == 0) mbar_wait(&raw_full[rs], (r / kDqRawStages) & 1);
    const unsigned char* tile = smem + kDqRawOffset + rs * kDqRawBytes;
    const unsigned char* row_a = tile + ra * kStepBytes;
    const unsigned char* row_b = tile + rb * kStepBytes;
    const int swa = ra & 7, swb = rb & 7;
    if constexpr (W4) {
      // the next K step's first group, loaded while this one converts
      if (t + 1 < ksteps) {
        const int ng = 64 * (t + 1) / p.group;
        if (ng != pg && ng != sg) {
          pg = ng;
          pa = __float_as_uint(load_scale(ng, na));
          pb = __float_as_uint(load_scale(ng, nb));
        }
      }
      // the groups of the K step's blocks of 16: one division a K step
      int grp = 64 * t / p.group, bound = (grp + 1) * p.group;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (64 * t + 16 * b >= bound) {
          ++grp;
          bound += p.group;
        }
        if (grp != sg) {
          const bool ahead = grp == pg;
          const uint32_t ba =
              bf16_scale(ahead ? __uint_as_float(pa) : load_scale(grp, na));
          const uint32_t bb =
              bf16_scale(ahead ? __uint_as_float(pb) : load_scale(grp, nb));
          sa2 = ba | ba << 16;
          sb2 = bb | bb << 16;
          sg = grp;
        }
        // 8 packed bytes of a block: chunk 2 part + b / 2, half b % 2
        const int c = 2 * part + (b >> 1), off = 8 * (b & 1);
        const uint2 va = *reinterpret_cast<const uint2*>(
            row_a + ((c ^ swa) * 16) + off);
        const uint2 vb = *reinterpret_cast<const uint2*>(
            row_b + ((c ^ swb) * 16) + off);
        a[b][0] = w4_pair(va.x, t4, sa2);
        a[b][1] = w4_pair(vb.x, t4, sb2);
        a[b][2] = w4_pair(va.y, t4, sa2);
        a[b][3] = w4_pair(vb.y, t4, sb2);
      }
    } else {
      const float ca = __fmul_rn(-32896.f, sa), cb = __fmul_rn(-32896.f, sb);
      const int sh = 16 * (t4 & 1), word = 4 * (t4 >> 1);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        // 16 codes of a block: chunk 4 part + b; the thread's pairs are
        // bytes 2 t4 (word t4 / 2) and 2 t4 + 8 (word 2 + t4 / 2)
        const int c = 4 * part + b;
        const unsigned char* qa = row_a + ((c ^ swa) * 16) + word;
        const unsigned char* qb = row_b + ((c ^ swb) * 16) + word;
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(qa) >> sh;
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(qa + 8) >> sh;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(qb) >> sh;
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(qb + 8) >> sh;
        a[b][0] = w8_pair(a0, sa, ca);
        a[b][1] = w8_pair(b0, sb, cb);
        a[b][2] = w8_pair(a1, sa, ca);
        a[b][3] = w8_pair(b1, sb, cb);
      }
    }
    if (part == kPer - 1 || t + 1 == ksteps) {
      __syncwarp();
      if (lane == 0 && r + kDqRawStages < nraw) mbar_arrive(&raw_empty[rs]);
    }
  };
  // x tile t goes back, where a later K step refills it
  auto release_x = [&](int t) {
    if (lane == 0 && t + kDqXStages < ksteps)
      mbar_arrive(&x_empty[t % kDqXStages]);
  };

  uint32_t fa[4][4], fb[4][4];
  if (p.dump) {
    // the converted weight (N, K) instead of the product
#pragma unroll 1
    for (int t = 0; t < ksteps; ++t) {
      mbar_wait(&x_full[t % kDqXStages], (t / kDqXStages) & 1);
      convert(t, fa);
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = 64 * t + 16 * b + 2 * t4;
        if (na < p.n) {
          *reinterpret_cast<uint32_t*>(out + na * p.ldo + col) = fa[b][0];
          *reinterpret_cast<uint32_t*>(out + na * p.ldo + col + 8) = fa[b][2];
        }
        if (nb < p.n) {
          *reinterpret_cast<uint32_t*>(out + nb * p.ldo + col) = fa[b][1];
          *reinterpret_cast<uint32_t*>(out + nb * p.ldo + col + 8) = fa[b][3];
        }
      }
      __syncwarp();
      release_x(t);
    }
    return;
  }

  float acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // K step t on the fragments in cur: its products queued, the previous
  // step's awaited (its x tile goes back, its fragments in nxt are free),
  // then the next step's fragments converted into nxt while these run
  auto step = [&](int t, uint32_t(&cur)[4][4], uint32_t(&nxt)[4][4]) {
    mbar_wait(&x_full[t % kDqXStages], (t / kDqXStages) & 1);
    const uint64_t db =
        wgmma_desc(ring + (t % kDqXStages) * kDqXBytes, 16, kSwizzleAtomBytes);
    wgmma_pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_bf16_n256(acc, cur[kk], desc_advance(db, kk * 32));
    wgmma_commit();
    wgmma_wait<1>();
    wgmma_pin(acc);
    wgmma_pin_a(nxt);
    if (t > 0) release_x(t - 1);
    if (t + 1 < ksteps) convert(t + 1, nxt);
  };
  convert(0, fa);
#pragma unroll 1
  for (int t = 0; t < ksteps; t += 2) {
    step(t, fa, fb);
    if (t + 1 < ksteps) step(t + 1, fb, fa);
  }
  wgmma_wait<0>();
  wgmma_pin(acc);
  wgmma_pin_a(fa);
  wgmma_pin_a(fb);

  // The epilogue: the tile staged transposed (token rows of 128 outputs) in
  // the x ring, then 8 consecutive outputs of a token a thread: bf16, the
  // bias added in bf16, one 16-byte store.
  named_barrier_sync(1, kConsumers);
  {
    const int col = wg * 64 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int tok = 8 * j + 2 * t4;
      float* r0 = reinterpret_cast<float*>(smem + tok * kDqPitch) + col;
      float* r1 = reinterpret_cast<float*>(smem + (tok + 1) * kDqPitch) + col;
      r0[0] = acc[j][0];
      r1[0] = acc[j][1];
      r0[8] = acc[j][2];
      r1[8] = acc[j][3];
    }
  }
  named_barrier_sync(1, kConsumers);
  constexpr int kChunks = kDqRows / 8, kTokPerPass = kConsumers / kChunks;
  const int c = tid % kChunks, n = n0 + 8 * c;
  // N % 8 == 0: a thread's outputs are all or none past N
  const int tok_end = n < p.n ? min(kDqTokens, p.m - m0) : 0;
  float bias[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    bias[e] = p.bias && n < p.n
                  ? bf(static_cast<const __nv_bfloat16*>(p.bias)[n + e])
                  : 0.f;
#pragma unroll 4
  for (int tok = tid / kChunks; tok < tok_end; tok += kTokPerPass) {
    const int m = m0 + tok;
    const float4 lo = *reinterpret_cast<const float4*>(
        smem + tok * kDqPitch + 32 * c);
    const float4 hi = *reinterpret_cast<const float4*>(
        smem + tok * kDqPitch + 32 * c + 16);
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      __nv_bfloat16 y = __float2bfloat16_rn(v[e]);
      if (p.bias) y = __float2bfloat16_rn(__fadd_rn(bf(y), bias[e]));
      const uint32_t bits = __bfloat16_as_ushort(y);
      w[e / 2] = e % 2 ? w[e / 2] | bits << 16 : bits;
    }
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.out) +
                              static_cast<long long>(m) * p.ldo + n) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <bool W4>
cudaError_t launch_dequant(const Args& p, cudaStream_t stream) {
  auto kernel = dequant_gemm_kernel<W4>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  // x: bf16, 2 bytes an input; the codes: K bytes a row (w8), K / 2 (w4)
  CUtensorMap map_x, map_b;
  cudaError_t err = make_byte_matrix_map(&map_x, p.a, 2LL * p.k, p.m,
                                         2LL * p.lda, kDqTokens);
  if (err == cudaSuccess)
    err = make_byte_matrix_map(&map_b, p.b, W4 ? p.k / 2 : p.k, p.n, p.ldb,
                               kDqRows);
  if (err != cudaSuccess) return err;
  dim3 grid((p.n + kDqRows - 1) / kDqRows,
            p.dump ? 1 : (p.m + kDqTokens - 1) / kDqTokens);
  kernel<<<grid, kConsumers + 128, kDqSmemBytes, stream>>>(map_x, map_b, p);
  return cudaGetLastError();
}

}  // namespace

// The dequantizing GEMM: x (m, k) bf16 with rows ldx elements apart times
// the weight of `codes` (w4: packed (n, k/2), row-interleaved; w8: int8
// (n, k); rows ldc bytes apart) and `scale` f32 (w4: (k / group, n); w8:
// (n,)), plus the bf16 bias (n,) if given, into out (m, n) bf16 (ldo
// elements a row); with dump, the converted weight into out (n, k) instead.
// The wrapper (x2i_torch/ops/int4_gemm.py) checks types, shapes and
// alignment: N % 8, K % 64 (w4: the group size % 16), 16-byte aligned
// starts and strides of x and the codes. Returns the cudaError_t of the
// launch.
extern "C" int x2i_dequant_gemm(const void* x, long long ldx,
                                const void* codes, long long ldc,
                                const void* scale, int group,
                                const void* bias, void* out, long long ldo,
                                int m, int n, int k, int w4, int dump,
                                void* stream) {
  if (m < 1 || n < 8 || n % 8 || k < 64 || k % 64 ||
      (w4 && (group < 16 || group % 16 || k % group)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args p{};
  p.a = static_cast<const int8_t*>(x);
  p.lda = ldx;
  p.b = static_cast<const int8_t*>(codes);
  p.ldb = ldc;
  p.scale = static_cast<const float*>(scale);
  p.bias = bias;
  p.out = out;
  p.ldo = ldo;
  p.m = m;
  p.n = n;
  p.k = k;
  p.group = w4 ? group : k;
  p.dump = dump;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(w4 ? launch_dequant<true>(p, s)
                             : launch_dequant<false>(p, s));
}

namespace {

// The scale a weight of an F32 (else bf16) output is multiplied by: the
// f32 scale as it is, or rounded to bf16 (JAX casts it to the weight's
// dtype first).
template <bool F32>
__device__ __forceinline__ float weight_scale(float s) {
  return F32 ? s : __bfloat162float(__float2bfloat16_rn(s));
}

// 8 f32 values to out (16-byte aligned): two 16-byte stores.
__device__ __forceinline__ void store8(float* out, const float (&v)[8]) {
  float4* o = reinterpret_cast<float4*>(out);
  o[0] = make_float4(v[0], v[1], v[2], v[3]);
  o[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// One thread: 4 packed bytes of a row (8 inputs) -> 8 bf16, each the code
// times the bf16 scale of its group, rounded once (a bf16 times a code of
// at most 4 bits is exact in f32), in one 16-byte store: a warp reads 128
// contiguous bytes and writes 512. `group` is even, so the two inputs of
// a byte share a group. F32: 8 f32, each f32(code) times the f32 scale
// rounded once (w4 in f32, JAX's _dequant_w4 to an f32 x), in two stores.
template <bool F32>
__global__ void __launch_bounds__(256) w4_dequant_kernel(
    const int8_t* __restrict__ pw, long long ldp,
    const float* __restrict__ scale, void* __restrict__ out, int n,
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
  const float s0 =
      weight_scale<F32>(__ldg(scale + (first / group) * n + row));
  const long long at = static_cast<long long>(row) * 2 * half + first;
  float v[8];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int byte = (w >> (8 * b)) & 0xFF;
    const float s =
        one_group
            ? s0
            : weight_scale<F32>(
                  __ldg(scale + ((first + 2 * b) / group) * n + row));
    v[2 * b] = __fmul_rn(static_cast<float>(((byte & 0xF) ^ 8) - 8), s);
    v[2 * b + 1] = __fmul_rn(static_cast<float>(((byte >> 4) ^ 8) - 8), s);
  }
  if constexpr (F32) {
    store8(static_cast<float*>(out) + at, v);
  } else {
    uint32_t o[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      o[b] = static_cast<uint32_t>(
                 __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * b]))) |
             static_cast<uint32_t>(
                 __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * b + 1])))
                 << 16;
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + at) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace

// pw (n, half) packed with rows ldp bytes apart (16-byte aligned), scale
// (half * 2 / group, n) f32, out (n, 2 * half) bf16, or f32 with `f32`.
// Returns the cudaError_t of the launch.
extern "C" int x2i_w4_dequant(const void* pw, long long ldp,
                              const void* scale, void* out, int n, int half,
                              int group, int f32, void* stream) {
  if (n < 1 || half < 16 || half % 16 || group < 2 || group % 2 ||
      (2 * half) % group || ldp % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(n) * (half / 4);
  const unsigned blocks = static_cast<unsigned>((threads + 255) / 256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* q = static_cast<const int8_t*>(pw);
  const float* sc = static_cast<const float*>(scale);
  if (f32)
    w4_dequant_kernel<true><<<blocks, 256, 0, st>>>(q, ldp, sc, out, n, half,
                                                    group);
  else
    w4_dequant_kernel<false><<<blocks, 256, 0, st>>>(q, ldp, sc, out, n,
                                                     half, group);
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
// scale of the row, rounded once, in one 16-byte store; F32: 8 f32, each
// f32(code) times the f32 scale rounded once (w8 in f32, JAX's w8_matmul
// to an f32 x), in two.
template <bool F32>
__global__ void __launch_bounds__(256) int8_dequant_kernel(
    const int8_t* __restrict__ q, long long ldq,
    const float* __restrict__ scale, void* __restrict__ out, int n,
    int k) {
  const int per_row = k / 8;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(n) * per_row) return;
  const int row = static_cast<int>(idx / per_row);
  const int c = static_cast<int>(idx % per_row);
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(q + row * ldq) + c);
  const float s = weight_scale<F32>(__ldg(scale + row));
  const long long at = static_cast<long long>(row) * k + 8 * c;
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)   // a byte sign-extended: (byte ^ 0x80) - 0x80
    v[i] = __fmul_rn(static_cast<float>((byte_of(w, i) ^ 0x80) - 0x80), s);
  if constexpr (F32) {
    store8(static_cast<float*>(out) + at, v);
  } else {
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + at) =
        make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                   bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
  }
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

// q (n, k) int8 with rows ldq bytes apart, scale (n,) f32, out (n, k) bf16,
// or f32 with `f32`; k, ldq and q's address multiples of 8. Returns the
// cudaError_t of the launch.
extern "C" int x2i_int8_dequant(const void* q, long long ldq,
                                const void* scale, void* out, int n, int k,
                                int f32, void* stream) {
  if (n < 1 || k < 8 || k % 8 || ldq % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = blocks_of(static_cast<long long>(n) * (k / 8));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* codes = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  if (f32)
    int8_dequant_kernel<true><<<blocks, 256, 0, st>>>(codes, ldq, sc, out, n,
                                                      k);
  else
    int8_dequant_kernel<false><<<blocks, 256, 0, st>>>(codes, ldq, sc, out,
                                                       n, k);
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
