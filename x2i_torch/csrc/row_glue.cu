// The row glue kernels of the DiT for sm_90a: K5 (LayerNorm + AdaLN
// modulate), K6 (K5's LayerNorm + modulate, then per-row int8
// quantization), K7 (tanh-gelu + per-row int8 quantization) and K8 (the
// per-row int8 quantization alone), on bf16 rows and on f32 rows.
//
// Replaces, in the JAX package's x2i_tpu/ops/fused_glue.py (all launched
// through _rows_call, :118):
//   * K5 _ln_mod_kernel (:84-89): for a row x of D bf16 and its batch's
//     shift and scale rows,
//       mean = sum(x) / D, var = sum((x - mean)^2) / D       (f32)
//       y = bf16((x - mean) * rsqrt(var + eps))
//       out = bf16(bf16(y * bf16(1 + scale)) + shift);
//   * K6 _ln_mod_quant_kernel (:62-67): K5's out (one definition in both
//     packages, _ln_modulate :47-59), then _row_quantize (:38-44):
//       a = max(max|out|, 1e-6) / 127                (f32, IEEE division)
//       codes = clip(round_half_even(out / a), -127, 127)  (int8), a (f32);
//   * K7 _gelu_quant_kernel (:70-75): g = bf16(gelu_tanh(x)), then the
//     same quantization of g;
//   * K8 _quant_kernel (:78-81): the same quantization of x;
//   * K8's two halves, for a row split over the members of a tensor axis
//     (the row-split layers under shard_activations, where XLA quantizes
//     the whole row of JAX's w8a8_matmul, x2i_tpu/ops/quant.py:39-42, over
//     sharded features): the row absmax alone, max|x| (f32), and the
//     quantization at a given absmax (the members' maximum), the same
//     a = max(amax, 1e-6) / 127 and codes, so that the members' codes are
//     the whole row's K8 codes.
// The rounding points are those of the plain versions beside the wrappers
// (x2i_torch/ops/fused_glue.py): each bf16 rounding as PyTorch's bf16
// arithmetic rounds (the f32 result, rounded to nearest even), products and
// sums with __fmul_rn / __fadd_rn so that nothing contracts into an FMA.
//
// What bounds them on an H100: bytes, with K6's and K7's instructions
// close behind. Each reads its bf16 rows once and writes them once (bf16
// for K5; int8 and one f32 per row for K6, K7, K8): at 4608 rows 17 us for
// K5, 13 us for K6 and K8 (D = 3072) and 51 us for K7 (D = 12288) at 3.35
// TB/s. K5 issues about 18 instructions per element, K6 31, K7 30 and K8
// 13 (PERF.md, from the SASS), which for K6 and K7 takes about as long
// again on 132 SMs. So the design keeps enough row bytes in flight on every
// SM, enough warps to hide K7's arithmetic, few instructions per element,
// and few of them on the special-function and conversion pipe (16 per
// clock per SM).
//
// Design, every kernel:
//   * persistent blocks: as many as fit on the card, each walking a
//     contiguous span of rows, so that the loads of a block's next rows are
//     in flight while its current row is reduced;
//   * the row lives in registers between its passes, loaded with 16-byte
//     accesses (neighbouring threads on neighbouring 16 bytes), and leaves
//     with stores of 8 or 16 contiguous bytes a thread;
//   * reductions are warp shuffles; K7 exchanges its warps' maxima once.
// K5, K6 and K8 at D = 3072: one body (warp_rows_body), one warp per row,
// 12 chunks of 8 values a lane, a block of eight warps. K5 and K6 stage
// their batch's bf16(1 + scale) and shift rows (12 KB) in shared memory
// once, and again only where a span crosses into the next batch (the
// modulation rows are (B, D), strided as chunk(6) gives them); K8 compiles
// the LayerNorm and the staging out. A register double buffer keeps the
// next row in flight: a warp issues the next row's loads before the
// current row's sums. The LayerNorm + modulate is one function
// (ln_modulate) for K5 and K6, which leaves the modulated row packed as
// bf16 in the registers that held x: K6 is bit for bit K8 after K5. At
// eight warps an SM (254 registers a thread) K6 is held by instructions
// more than by bytes, so the modulate's bf16 products and sums are bf16x2
// instructions, and its codes leave in 8-byte stores. (For
// K5 a per-warp ring of two 6 KB rows in shared memory filled by 1-d
// cp.async.bulk on an mbarrier ran level with the register double buffer,
// within 1.2% at every row count of the DiT on an NVIDIA H100 80GB HBM3 at
// 700 W (PERF.md), and was dropped.)
// K7 (D = 12288): two warpgroups per row, 48 values a thread (three pairs
// of 16-byte chunks, so that each thread's 16 codes are contiguous); one
// thread keeps a ring of two 24 KB rows in shared memory full with 1-d
// cp.async.bulk copies on mbarriers, so row i + 1 is in flight while row i
// is reduced and quantized, and four blocks (32 warps) fit on an SM. K7
// issues about 30 instructions per element (PERF.md), so it needs the
// warps more than a deeper ring: one warpgroup per row with a ring of
// three rows (72 KB, two blocks an SM) was slower on an H100. Its identity
// instance is K8 at D = 12288.
// The quantization epilogue, shared by K6, K7 and K8: the values are
// rounded to bf16 and kept packed in registers, the max pass
// (max.xorsign.abs on bf16 pairs) and the quantize pass read the same
// registers. The quotient g / a is Markstein's correction on a reciprocal
// computed once per row,
//   r = RN(1 / a); q0 = RN(g r); e = g - q0 a (exact, FMA); q = RN(q0 + e r),
// which is RN(g / a) for r the correctly rounded reciprocal and no
// underflow (K8 is held bit for bit against the plain quantization, ties
// included). Then the sum with 1.5 * 2^23, whose low byte is the code
// rounded half to even (|q| < 2^22), and __byte_perm packs four codes a
// word. No clamp to [-127, 127] is needed: |g| <= max|g| and a = RN(max|g|
// / 127) (or |g| < 1e-6 where the floor holds), so |g / a| <= 127 (1 +
// 2^-24) and rounds to at most 127. Per element K7 keeps two operations on
// the special-function pipe, the gelu's exp and division (ex2 and rcp,
// approximate, flushing subnormals: their inputs are never subnormal, and
// an output that would be is a gelu value of about 1e-38, which rounds to
// code 0); K6 and K8 none.
// Other widths (any D that is a multiple of 8) take a generic instance:
// K5 and K6 a warp per row that reads its row from memory once per pass
// (the same two pieces, ln_chunk and the quantization epilogue), K7 and K8
// a group of 1-256 threads per row (the wrapper's quant_instance chooses
// it from D: 8 threads, four rows a warp, for the 64-wide rows of the
// x_embedder's input; a block for the 4096-wide rows of the
// context_embedder's) that reads its row once for the max and once for
// the codes.
// K5-K8 on f32 rows (an f32 DiT's glue; JAX's _rows_call takes any float
// dtype, and its rounding to x's dtype is then the identity): K5's y =
// (x - mean) rsqrt(var + eps) in f32, out = y * (1 + scale) + shift, each
// product and sum rounded once in f32, as PyTorch's f32 `*` and `+`; K6
// the quantization of that out, K7 of the f32 gelu, K8 of x. The
// quantization epilogue is the bf16 one's on four f32 values a 16-byte
// chunk (codes4). They move twice the bf16 rows' bytes.
// Every f32 kernel is f32_rows_kernel: a group of threads a row (the
// wrapper's f32_instance: one 16-byte chunk a thread up to a block of 256
// a row, then 4 or 16 chunks a thread held in registers), the group's sums
// and max through shuffles and, past a warp, shared memory; a row wider
// than 16 chunks a thread (D above 16384) reads the rest again from memory
// in each pass, from L2. K5 and K6 share its group and order of sums, so K6
// is bit for bit K8 after K5 at every width. K5 reads its rows and writes
// its output with the streaming (evict-first) hint: at 4608 rows x 3072 on
// an H100 that took it from 0.0469 to 0.0453 ms (PERF.md). The
// group's next row loaded while this row is reduced and written (the bf16
// K5's double buffer) ran level or slower at the DiT's row counts, four
// blocks an SM and 128 threads a row level, and a warp a row holding a
// 3072-wide row (24 chunks a lane, 150 registers, one block of eight warps
// an SM) 0.0590 ms: all dropped. K6 as K5's bf16 warp body with the
// quantization after it was slower at the DiT's 4096 and 4608 rows x 3072
// than f32_rows_kernel at a block a row, and was dropped.
// K7 on f32 rows keeps the bf16 K7's x / (1 + exp(-2u)) form, but with the
// accurate expf and an IEEE division: no bf16 rounding absorbs the
// approximate ex2 and rcp's ulps there, and .ftz would flush subnormal
// values.

#include "hopper_mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// ------------------------------------------------------------- helpers

// The two bf16 values of a packed word, as f32: the low half is the
// element at the lower address.
__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// Two f32 rounded to nearest even bf16, packed (lo at the lower address).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The rows of a (B, S, D) view with strides sxb and sxs (elements), the
// last dim contiguous.
struct Rows {
  const bf16* x;
  long long sxb, sxs;
  int s;
  __device__ __forceinline__ const bf16* row(int r) const {
    const int b = r / s;
    return x + b * sxb + (r - b * s) * sxs;
  }
};

// Every kernel's arguments.
struct RowArgs {
  Rows x;
  const bf16* shift;  // K5, K6: (B, D) rows at batch stride seb
  const bf16* scale;
  long long seb;
  void* out;  // (B * S, D), contiguous: bf16 (K5) or int8 codes
  float* a;   // K6, K7, K8: (B * S) f32 row scales (the absmax alone: it)
  const float* amax;  // K8 at a given absmax: (B * S) f32
  int rows, d;
  float eps;
  int lanes;  // generic K7 / K8: threads per row, a power of two to 256
};

// This block's contiguous span [r0, r1) of `rows` rows (in 32-bit
// arithmetic where the products fit: a 64-bit division is a long call,
// in the way of a kernel over a few rows).
__device__ __forceinline__ void block_span(int rows, int& r0, int& r1) {
  const unsigned n = rows, b = blockIdx.x, g = gridDim.x;
  if (static_cast<unsigned long long>(n) * g <= 0xFFFFFFFFull) {
    r0 = static_cast<int>(n * b / g);
    r1 = static_cast<int>(n * (b + 1) / g);
  } else {
    r0 = static_cast<int>(static_cast<unsigned long long>(n) * b / g);
    r1 = static_cast<int>(static_cast<unsigned long long>(n) * (b + 1) / g);
  }
}

// -------------------------------------------------------- quantization

// The running max of |values| over bf16 pairs: max(|m|, |g|) per half (its
// sign is not |.|'s: take the magnitude at the end, with row_amax).
__device__ __forceinline__ uint32_t absmax2(uint32_t m, uint32_t g) {
  uint32_t d;
  asm("max.xorsign.abs.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(m), "r"(g));
  return d;
}

__device__ __forceinline__ uint32_t absmax8(uint32_t m, const uint4& v) {
  return absmax2(absmax2(absmax2(absmax2(m, v.x), v.y), v.z), v.w);
}

__device__ __forceinline__ float row_amax(uint32_t m) {
  return fmaxf(fabsf(lo_f(m)), fabsf(hi_f(m)));
}

// The f32 image of v / a rounded to an integer: its low byte is the int8
// code round_half_even(v / a), in [-127, 127] for |v| <= 127 a.
__device__ __forceinline__ uint32_t code_bits(float v, float a, float r) {
  const float q0 = __fmul_rn(v, r);
  const float e = fmaf(-q0, a, v);
  return __float_as_uint(__fadd_rn(fmaf(e, r, q0), 12582912.0f));  // 1.5*2^23
}

// Four codes of two packed words, one per byte.
__device__ __forceinline__ uint32_t code_word(uint32_t w0, uint32_t w1,
                                              float a, float r) {
  const uint32_t c01 = __byte_perm(code_bits(lo_f(w0), a, r),
                                   code_bits(hi_f(w0), a, r), 0x0040);
  const uint32_t c23 = __byte_perm(code_bits(lo_f(w1), a, r),
                                   code_bits(hi_f(w1), a, r), 0x0040);
  return __byte_perm(c01, c23, 0x5410);
}

// The eight codes of a 16-byte chunk.
__device__ __forceinline__ uint2 codes8(const uint4& v, float2 ar) {
  return make_uint2(code_word(v.x, v.y, ar.x, ar.y),
                    code_word(v.z, v.w, ar.x, ar.y));
}

// The row scale a = max(amax, 1e-6) / 127 (IEEE) and its reciprocal.
__device__ __forceinline__ float2 row_scale(float amax) {
  const float a = __fdiv_rn(fmaxf(amax, 1e-6f), 127.0f);
  return make_float2(a, __frcp_rn(a));
}

// ------------------------------------------- K5, K6 and K8 at D = 3072

constexpr int kLnD = 3072;                  // every FLUX width of the registry
constexpr int kLnWarps = 8;                 // rows in progress per block
constexpr int kLnChunks = kLnD / 8 / 32;    // 16-byte chunks per lane
constexpr int kLnSmemBytes = 2 * kLnD * 2;  // bf16(1 + scale) and shift

// K5, K6, K8, and K8's halves: the row absmax, the codes at a given one
enum RowOp { kLnMod, kLnModQuant, kQuantOnly, kAmaxOnly, kQuantAt };

// bf16(1 + scale) of 8 packed values, as PyTorch's bf16 `1.0 + scale`.
__device__ __forceinline__ uint4 one_plus(const uint4& sc) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t v = word(sc, i);
    w[i] = pack_bf16(__fadd_rn(1.0f, lo_f(v)), __fadd_rn(1.0f, hi_f(v)));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// bf16 pairs multiplied and added with one rounding each (to nearest
// even). These are PyTorch's bf16 `*` and `+`, which round the f32 result:
// the f32 product of two bf16 values is exact, and so is their f32 sum
// unless their exponents differ by more than 16, where both roundings give
// the larger value. One instruction for two values, where unpacking to f32
// takes seven.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Two outputs of K5 from a packed word of x, of bf16(1 + scale), of shift.
__device__ __forceinline__ uint32_t ln_word(uint32_t x, uint32_t sc,
                                            uint32_t sh, float mean,
                                            float rstd) {
  const uint32_t y = pack_bf16(__fmul_rn(__fsub_rn(lo_f(x), mean), rstd),
                               __fmul_rn(__fsub_rn(hi_f(x), mean), rstd));
  return add_bf16x2(mul_bf16x2(y, sc), sh);
}

__device__ __forceinline__ uint4 ln_chunk(const uint4& x, const uint4& sc,
                                          const uint4& sh, float mean,
                                          float rstd) {
  return make_uint4(ln_word(x.x, sc.x, sh.x, mean, rstd),
                    ln_word(x.y, sc.y, sh.y, mean, rstd),
                    ln_word(x.z, sc.z, sh.z, mean, rstd),
                    ln_word(x.w, sc.w, sh.w, mean, rstd));
}

__device__ __forceinline__ float chunk_sum(const uint4& v) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) s += lo_f(word(v, i)) + hi_f(word(v, i));
  return s;
}

__device__ __forceinline__ float chunk_sq(const uint4& v, float mean) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = lo_f(word(v, i)) - mean, b = hi_f(word(v, i)) - mean;
    s = fmaf(a, a, fmaf(b, b, s));
  }
  return s;
}

// The LayerNorm + modulate of K5 and K6, one definition so that their bits
// cannot drift: a warp's row of x in v (lane owns chunks lane + 32 c)
// becomes bf16(bf16(y * bf16(1 + scale)) + shift), packed, in place.
__device__ __forceinline__ void ln_modulate(uint4 (&v)[kLnChunks],
                                            const uint4* msc,
                                            const uint4* msh, float eps,
                                            int lane) {
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < kLnChunks; ++c) sum += chunk_sum(v[c]);
  const float mean = warp_sum(sum) * (1.0f / kLnD);
  float sq = 0.0f;
#pragma unroll
  for (int c = 0; c < kLnChunks; ++c) sq += chunk_sq(v[c], mean);
  const float rstd = rsqrtf(warp_sum(sq) * (1.0f / kLnD) + eps);
#pragma unroll
  for (int c = 0; c < kLnChunks; ++c) {
    const int at = c * 32 + lane;
    v[c] = ln_chunk(v[c], msc[at], msh[at], mean, rstd);
  }
}

// The quantization of a warp's row in v (K6, K8): its codes to q (the
// row's D bytes), its scale to *a. A lane's chunk c is 8 codes, one
// 8-byte store: each warp store is 256 contiguous bytes. (Lanes 2i and 2i
// + 1 trading halves of their chunks c and c + 1 by shuffles, for 16-byte
// stores, were slower on an H100: the shuffles cost more issue slots than
// the stores they save.) kAmaxOnly writes the row's absmax to *a and no
// codes; kQuantAt takes the absmax from *amax instead of the row.
template <int OP>
__device__ __forceinline__ void quant_warp_row(const uint4 (&v)[kLnChunks],
                                               int lane, int8_t* q, float* a,
                                               const float* amax) {
  float2 ar;
  if constexpr (OP == kQuantAt) {
    ar = row_scale(*amax);
  } else {
    uint32_t m = 0;
#pragma unroll
    for (int c = 0; c < kLnChunks; ++c) m = absmax8(m, v[c]);
    const float mx = warp_max(row_amax(m));
    if constexpr (OP == kAmaxOnly) {
      if (lane == 0) *a = mx;
      return;
    }
    ar = row_scale(mx);
  }
  uint2* q8 = reinterpret_cast<uint2*>(q);
#pragma unroll
  for (int c = 0; c < kLnChunks; ++c) q8[c * 32 + lane] = codes8(v[c], ar);
  if (lane == 0) *a = ar.x;
}

__device__ __forceinline__ void load_row(uint4 (&v)[kLnChunks],
                                         const bf16* row, int lane) {
  const uint4* x = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int c = 0; c < kLnChunks; ++c) v[c] = __ldg(x + c * 32 + lane);
}

// This warp's rows of [lo, hi): lo + warp + kLnWarps j, the next one's
// loads in flight while the current one is reduced. msc and msh (K5, K6)
// hold the rows' batch's bf16(1 + scale) and shift.
template <int OP>
__device__ __forceinline__ void warp_rows(const RowArgs& p, int lo, int hi,
                                          const uint4* msc, const uint4* msh,
                                          int warp, int lane) {
  const int count =
      hi - lo > warp ? (hi - lo - warp + kLnWarps - 1) / kLnWarps : 0;
  const int first = lo + warp;
  uint4 v[kLnChunks], next[kLnChunks];
  if (count > 0) load_row(next, p.x.row(first), lane);
  for (int j = 0; j < count; ++j) {
#pragma unroll
    for (int c = 0; c < kLnChunks; ++c) v[c] = next[c];
    if (j + 1 < count) load_row(next, p.x.row(first + (j + 1) * kLnWarps),
                                lane);
    if constexpr (OP == kLnMod || OP == kLnModQuant)
      ln_modulate(v, msc, msh, p.eps, lane);
    const long long row = first + j * kLnWarps;
    if constexpr (OP == kLnMod) {
      uint4* o = reinterpret_cast<uint4*>(static_cast<bf16*>(p.out) +
                                          row * kLnD);
#pragma unroll
      for (int c = 0; c < kLnChunks; ++c) o[c * 32 + lane] = v[c];
    } else {
      quant_warp_row<OP>(v, lane, static_cast<int8_t*>(p.out) + row * kLnD,
                         p.a + row, p.amax ? p.amax + row : nullptr);
    }
  }
}

// K5 (kLnMod), K6 (kLnModQuant) or K8 (kQuantOnly, and its halves) at
// D = 3072: a block of eight warps, one row per warp at a time, over the
// block's span.
template <int OP>
__device__ __forceinline__ void warp_rows_body(const RowArgs& p,
                                               uint8_t* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int r0, r1;
  block_span(p.rows, r0, r1);
  if constexpr (OP != kLnMod && OP != kLnModQuant) {
    warp_rows<OP>(p, r0, r1, nullptr, nullptr, warp, lane);
  } else {
    uint4* msc = reinterpret_cast<uint4*>(smem);  // bf16(1 + scale), D / 8
    uint4* msh = msc + kLnD / 8;                  // shift
    const int s = p.x.s;
    for (int b = r0 / s; b * s < r1; ++b) {  // the span's batches
      __syncthreads();  // every warp is done with the last batch's rows
      for (int c = threadIdx.x; c < kLnD / 8; c += kLnWarps * 32) {
        msc[c] = one_plus(ldg16(p.scale + b * p.seb + c * 8));
        msh[c] = ldg16(p.shift + b * p.seb + c * 8);
      }
      __syncthreads();
      warp_rows<OP>(p, max(r0, b * s), min(r1, (b + 1) * s), msc, msh, warp,
                    lane);
    }
  }
}

__global__ void __launch_bounds__(kLnWarps * 32)
    ln_mod_kernel(const RowArgs p) {
  extern __shared__ __align__(128) uint8_t smem[];
  warp_rows_body<kLnMod>(p, smem);
}

__global__ void __launch_bounds__(kLnWarps * 32)
    ln_mod_quant_kernel(const RowArgs p) {
  extern __shared__ __align__(128) uint8_t smem[];
  warp_rows_body<kLnModQuant>(p, smem);
}

__global__ void __launch_bounds__(kLnWarps * 32)
    quant_warp_kernel(const RowArgs p) {
  warp_rows_body<kQuantOnly>(p, nullptr);
}

__global__ void __launch_bounds__(kLnWarps * 32)
    row_amax_warp_kernel(const RowArgs p) {
  warp_rows_body<kAmaxOnly>(p, nullptr);
}

__global__ void __launch_bounds__(kLnWarps * 32)
    quant_at_warp_kernel(const RowArgs p) {
  warp_rows_body<kQuantAt>(p, nullptr);
}

// K5 (QUANT false) or K6 at any D that is a multiple of 8: one warp per
// row, the row read from memory once per pass, the modulation rows read
// beside it; K6 modulates twice, for the max and for the codes (the same
// bits).
template <bool QUANT>
__global__ void __launch_bounds__(kLnWarps * 32)
    ln_mod_rows_kernel(const RowArgs p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = p.d / 8;
  const float inv_d = 1.0f / p.d;
  int r0, r1;
  block_span(p.rows, r0, r1);
  for (int r = r0 + warp; r < r1; r += kLnWarps) {
    const uint4* x = reinterpret_cast<const uint4*>(p.x.row(r));
    const int b = r / p.x.s;
    float sum = 0.0f;
    for (int c = lane; c < chunks; c += 32) sum += chunk_sum(__ldg(x + c));
    const float mean = warp_sum(sum) * inv_d;
    float sq = 0.0f;
    for (int c = lane; c < chunks; c += 32) sq += chunk_sq(__ldg(x + c), mean);
    const float rstd = rsqrtf(warp_sum(sq) * inv_d + p.eps);
    const bf16* sc = p.scale + b * p.seb;
    const bf16* sh = p.shift + b * p.seb;
    auto modulated = [&](int c) {
      return ln_chunk(__ldg(x + c), one_plus(ldg16(sc + c * 8)),
                      ldg16(sh + c * 8), mean, rstd);
    };
    const long long at = static_cast<long long>(r) * p.d;
    if constexpr (!QUANT) {
      uint4* o = reinterpret_cast<uint4*>(static_cast<bf16*>(p.out) + at);
      for (int c = lane; c < chunks; c += 32) o[c] = modulated(c);
    } else {
      uint32_t m = 0;
      for (int c = lane; c < chunks; c += 32) m = absmax8(m, modulated(c));
      const float2 ar = row_scale(warp_max(row_amax(m)));
      uint2* q = reinterpret_cast<uint2*>(static_cast<int8_t*>(p.out) + at);
      for (int c = lane; c < chunks; c += 32) q[c] = codes8(modulated(c), ar);
      if (lane == 0) p.a[r] = ar.x;
    }
  }
}

// ------------------------------------------------------- K5-K8 in f32

// The arguments of K5-K8 on f32 rows: x (B, S, D) at strides sxb, sxs,
// shift and scale (B, D) at batch stride seb (K5, K6), out (B * S, D)
// contiguous (f32 for K5, int8 codes for K6-K8, whose row scales go to a),
// and for f32_rows_kernel the threads of a row.
struct F32RowArgs {
  const float* x;
  long long sxb, sxs;
  int s;
  const float* shift;
  const float* scale;
  long long seb;
  void* out;
  int rows, d;
  float eps;
  float* a;
  int lanes;
};

__device__ __forceinline__ float4 f4_at(const float* p, int i) {
  return __ldg(reinterpret_cast<const float4*>(p) + i);
}

__device__ __forceinline__ float f4_sum(const float4& v) {
  return __fadd_rn(__fadd_rn(v.x, v.y), __fadd_rn(v.z, v.w));
}

__device__ __forceinline__ float f4_sq(const float4& v, float mean) {
  const float a = v.x - mean, b = v.y - mean, c = v.z - mean, e = v.w - mean;
  return fmaf(a, a, fmaf(b, b, fmaf(c, c, e * e)));
}

// y (x - mean) * rstd, then * (1 + scale) + shift, one rounding each.
__device__ __forceinline__ float ln_f32(float x, float mean, float rstd,
                                       float sc, float sh) {
  const float y = __fmul_rn(__fsub_rn(x, mean), rstd);
  return __fadd_rn(__fmul_rn(y, __fadd_rn(1.0f, sc)), sh);
}

__device__ __forceinline__ float4 ln_f32x4(const float4& v, float mean,
                                          float rstd, const float4& sc,
                                          const float4& sh) {
  return make_float4(ln_f32(v.x, mean, rstd, sc.x, sh.x),
                     ln_f32(v.y, mean, rstd, sc.y, sh.y),
                     ln_f32(v.z, mean, rstd, sc.z, sh.z),
                     ln_f32(v.w, mean, rstd, sc.w, sh.w));
}

__device__ __forceinline__ float f4_amax(const float4& v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// The four codes of four f32 values, one a byte (code_bits' low bytes).
__device__ __forceinline__ uint32_t codes4(const float4& v, float2 ar) {
  const uint32_t c01 = __byte_perm(code_bits(v.x, ar.x, ar.y),
                                   code_bits(v.y, ar.x, ar.y), 0x0040);
  const uint32_t c23 = __byte_perm(code_bits(v.z, ar.x, ar.y),
                                   code_bits(v.w, ar.x, ar.y), 0x0040);
  return __byte_perm(c01, c23, 0x5410);
}

// -------------------------------------------------------- K7 and K8

constexpr int kQD = 12288;                  // every FLUX MLP width
constexpr int kQThreads = 256;              // two warpgroups per row
constexpr int kQPairs = kQD / 16 / kQThreads;  // 16 values a pair
constexpr int kQWarps = kQThreads / 32;
constexpr int kQStages = 2;                 // ring rows per block
constexpr int kQRowBytes = kQD * 2;
constexpr int kQSmemBytes =
    kQStages * kQRowBytes + kQStages * 8 + 2 * kQWarps * 4;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The tanh-gelu 0.5 x (1 + tanh(u)), u = sqrt(2/pi) (x + 0.044715 x^3), in
// the form x / (1 + exp(-2u)) (the same function), exp(t) as ex2(t log2 e)
// and the division as a product with the reciprocal, both approximate; the
// bf16 rounding after it absorbs most of their ulps.
template <bool GELU>
__device__ __forceinline__ float activation(float x) {
  if constexpr (GELU) {
    const float u = __fmul_rn(0.7978845608028654f,
                              fmaf(0.044715f, __fmul_rn(__fmul_rn(x, x), x),
                                   x));
    const float e =
        ex2_approx(__fmul_rn(__fmul_rn(-2.0f, u), 1.4426950408889634f));
    return __fmul_rn(x, rcp_approx(__fadd_rn(1.0f, e)));
  } else {
    return x;
  }
}

// The activation of a packed word, rounded to bf16, packed.
template <bool GELU>
__device__ __forceinline__ uint32_t act_word(uint32_t w) {
  if constexpr (GELU)
    return pack_bf16(activation<true>(lo_f(w)), activation<true>(hi_f(w)));
  else
    return w;
}

template <bool GELU>
__device__ __forceinline__ uint4 act_chunk(const uint4& v) {
  return make_uint4(act_word<GELU>(v.x), act_word<GELU>(v.y),
                    act_word<GELU>(v.z), act_word<GELU>(v.w));
}

// The block's max over its warps' `m`, through red[kQWarps] (a block
// barrier).
__device__ __forceinline__ float block_max(float m, float* red, int warp,
                                           int lane) {
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kQWarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

// K7 (GELU) and K8 at D = 12288: two warpgroups per row, fed by a ring of
// two rows.
template <bool GELU>
__global__ void __launch_bounds__(kQThreads)
    quant_ring_kernel(const RowArgs p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint4* ring = reinterpret_cast<const uint4*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kQStages * kQRowBytes);
  float* red = reinterpret_cast<float*>(full + kQStages);  // [2][kQWarps]
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  int r0, r1;
  block_span(p.rows, r0, r1);
  const int count = r1 - r0;
  auto fill = [&](int j) {
    const int st = j % kQStages;
    mbar_arrive_expect_tx(&full[st], kQRowBytes);
    bulk_load(smem_u32(smem + st * kQRowBytes), p.x.row(r0 + j), kQRowBytes,
              &full[st]);
  };
  if (t == 0) {
#pragma unroll
    for (int st = 0; st < kQStages; ++st) mbar_init(&full[st], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (t == 0)
    for (int j = 0; j < min(kQStages, count); ++j) fill(j);
  for (int j = 0; j < count; ++j) {
    const int st = j % kQStages;
    mbar_wait(&full[st], (j / kQStages) & 1);
    // thread t's values: pair i is elements 16 (128 i + t) .. + 15
    const uint4* x = ring + st * (kQD / 8);
    uint4 g[kQPairs][2];
    uint32_t m = 0;
#pragma unroll
    for (int i = 0; i < kQPairs; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        g[i][h] = act_chunk<GELU>(x[2 * (i * kQThreads + t) + h]);
        m = absmax8(m, g[i][h]);
      }
    }
    // the barrier also tells thread 0 that every thread is done with the
    // stage, which it refills
    const float amax =
        block_max(row_amax(m), red + (j & 1) * kQWarps, warp, lane);
    if (t == 0 && j + kQStages < count) fill(j + kQStages);
    const float2 ar = row_scale(amax);
    const long long row = r0 + j;
    uint4* q = reinterpret_cast<uint4*>(static_cast<int8_t*>(p.out) +
                                        row * kQD);
#pragma unroll
    for (int i = 0; i < kQPairs; ++i) {
      const uint2 lo = codes8(g[i][0], ar), hi = codes8(g[i][1], ar);
      q[i * kQThreads + t] = make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
    if (t == 0) p.a[row] = ar.x;
  }
}

// K7 (GELU) and K8 at any D that is a multiple of 8: a group of p.lanes
// threads per row, a power of two up to the block's 256 (one 16-byte chunk
// a thread up to 2048 values a row: narrow rows do not idle most of a
// warp, and wide ones are spread over the SMs), the row read from memory
// once for the max and once for the codes (the activation computed again,
// to the same bits). A group wider than a warp takes its max through
// shared memory. K8's halves (OP, no GELU): kAmaxOnly writes the max and
// no codes, kQuantAt reads it (the max pass left out).
template <bool GELU, int OP>
__global__ void __launch_bounds__(kQThreads)
    quant_rows_kernel(const RowArgs p) {
  __shared__ float red[2][kQWarps];
  const int shift = __ffs(p.lanes) - 1;  // lanes = 2^shift
  const int lanes = 1 << shift, groups = kQThreads >> shift;
  const int t = threadIdx.x, group = t >> shift, li = t & (lanes - 1);
  const int warp = t >> 5, lane = t & 31;
  const int chunks = p.d / 8;
  int r0, r1;
  block_span(p.rows, r0, r1);
  // the loop is uniform over the block: every thread reaches the shuffles
  // and the barrier
  for (int base = r0, it = 0; base < r1; base += groups, ++it) {
    const int r = base + group;
    const bool valid = r < r1;
    const uint4* x =
        reinterpret_cast<const uint4*>(p.x.row(valid ? r : r0));
    float amax = 0.0f;
    if constexpr (OP == kQuantAt) {
      if (valid) amax = p.amax[r];
    } else {
      uint32_t m = 0;
      if (valid)
        for (int c = li; c < chunks; c += lanes)
          m = absmax8(m, act_chunk<GELU>(__ldg(x + c)));
      amax = row_amax(m);
      for (int o = min(lanes, 32) >> 1; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, o));
      if (lanes > 32) {
        // red alternates between iterations: one barrier an iteration
        float* rd = red[it & 1];
        if (lane == 0) rd[warp] = amax;
        __syncthreads();
        const int w0 = (group << shift) >> 5;
        for (int w = 0; w < lanes >> 5; ++w) amax = fmaxf(amax, rd[w0 + w]);
      }
    }
    if (!valid) continue;
    if constexpr (OP == kAmaxOnly) {
      if (li == 0) p.a[r] = amax;
      continue;
    }
    const float2 ar = row_scale(amax);
    uint2* q = reinterpret_cast<uint2*>(static_cast<int8_t*>(p.out) +
                                        static_cast<long long>(r) * p.d);
    for (int c = li; c < chunks; c += lanes)
      q[c] = codes8(act_chunk<GELU>(__ldg(x + c)), ar);
    if (li == 0) p.a[r] = ar.x;
  }
}

// ------------------------------------------------- K5-K8 on f32 rows

// What f32_rows_kernel computes: K5, K6, K8 (the RowOp values) or K7.
constexpr int kGeluQuant = kQuantAt + 1;

// The tanh-gelu of an f32 row value in K7's form x / (1 + exp(-2u)), with
// the accurate expf and an IEEE division: nothing rounds after it. Past
// -2u = 64 (x below about -8.5) the quotient is below 1e-27, which is code
// 0 at any row scale (at least 1e-6 / 127) and never a row's max unless
// the row's max is below the 1e-6 floor: it is taken as a signed zero,
// which spares the division's slow path for a divisor near the top of the
// f32 range (or infinite).
__device__ __forceinline__ float gelu_f32(float x) {
  const float u = __fmul_rn(0.7978845608028654f,
                            fmaf(0.044715f, __fmul_rn(__fmul_rn(x, x), x), x));
  const float t = __fmul_rn(-2.0f, u);
  return t > 64.0f ? __fmul_rn(x, 0.0f)
                   : __fdiv_rn(x, __fadd_rn(1.0f, expf(t)));
}

__device__ __forceinline__ float4 gelu_f32x4(const float4& v) {
  return make_float4(gelu_f32(v.x), gelu_f32(v.y), gelu_f32(v.z),
                     gelu_f32(v.w));
}

// The sum (or, with MAX, the max) of v over a group of `lanes` threads (a
// power of two, 2^shift; `group` is the thread's group): shuffles inside
// a warp, then, for a group wider than a warp, its warps' values through
// rd[kQWarps] (a block barrier), summed in warp order so that every thread
// of the group holds the same bits.
template <bool MAX>
__device__ __forceinline__ float group_reduce(float v, int lanes, int shift,
                                              int group, float* rd) {
  for (int o = min(lanes, 32) >> 1; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xFFFFFFFFu, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  if (lanes > 32) {
    if ((threadIdx.x & 31) == 0) rd[threadIdx.x >> 5] = v;
    __syncthreads();
    const int w0 = (group << shift) >> 5;
    v = rd[w0];
    for (int w = 1; w < lanes >> 5; ++w)
      v = MAX ? fmaxf(v, rd[w0 + w]) : v + rd[w0 + w];
  }
  return v;
}

// Chunk `at` of an f32 row: K5 reads it with the streaming (evict-first)
// hint and writes its output likewise, each byte once; K6-K8 through the
// read-only path.
template <int OP>
__device__ __forceinline__ float4 x_at(const float* x, int at) {
  if constexpr (OP == kLnMod)
    return __ldcs(reinterpret_cast<const float4*>(x) + at);
  else
    return f4_at(x, at);
}

// The blocks of f32_rows_kernel an SM holds at least, which caps its
// registers: at 4 chunks a thread three (85 registers; without a bound
// ptxas took 48 and spilled K6's instance), at 16 two (128: K7 and K8
// keep two blocks an SM), K6's at 16 one (its 145 registers; no path of
// the DiT runs it).
template <int OP, int C>
constexpr int kF32RowsMinBlocks = C == 4 ? 3 : OP == kLnModQuant ? 1 : 2;

// K5, K6, K7 and K8 on f32 rows of any D that is a multiple of 4: a group
// of p.lanes threads a row (a power of two up to the block's 256), 16-byte
// chunks at li + lanes c. The first C chunks of a thread stay in registers
// from the load to the store; a row wider than lanes x C chunks reads the
// rest again from memory (L2) in each pass, and computes its values again
// to the same bits. The group's sums and maxima
// go through `red`, one slot a reduction and a pair of slots alternating
// between iterations: one barrier a reduction.
template <int OP, int C>
__global__ void __launch_bounds__(kQThreads, kF32RowsMinBlocks<OP, C>)
    f32_rows_kernel(const F32RowArgs p) {
  __shared__ float red[2][3][kQWarps];
  constexpr bool kLn = OP == kLnMod || OP == kLnModQuant;
  const int shift = __ffs(p.lanes) - 1;
  const int lanes = 1 << shift, groups = kQThreads >> shift;
  const int t = threadIdx.x, group = t >> shift, li = t & (lanes - 1);
  const int quads = p.d / 4;
  const float inv_d = 1.0f / p.d;
  int r0, r1;
  block_span(p.rows, r0, r1);
  // the loop is uniform over the block: every thread reaches the shuffles
  // and the barriers
  for (int base = r0, it = 0; base < r1; base += groups, ++it) {
    const int r = base + group;
    const bool valid = r < r1;
    const int row = valid ? r : r0;
    const int b = row / p.s;
    const float* x = p.x + b * p.sxb + (row - b * p.s) * p.sxs;
    float(*rd)[kQWarps] = red[it & 1];
    const int tail = valid ? li + C * lanes : quads;   // chunks past C
    float4 v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int at = li + c * lanes;
      v[c] = valid && at < quads ? x_at<OP>(x, at)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float mean = 0.0f, rstd = 0.0f;
    const float* sc = p.scale + b * p.seb;
    const float* sh = p.shift + b * p.seb;
    if constexpr (kLn) {
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) sum += f4_sum(v[c]);
      for (int at = tail; at < quads; at += lanes)
        sum += f4_sum(x_at<OP>(x, at));
      mean = group_reduce<false>(sum, lanes, shift, group, rd[0]) * inv_d;
      float sq = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (valid && li + c * lanes < quads) sq += f4_sq(v[c], mean);
      for (int at = tail; at < quads; at += lanes)
        sq += f4_sq(x_at<OP>(x, at), mean);
      rstd = rsqrtf(group_reduce<false>(sq, lanes, shift, group, rd[1]) *
                        inv_d +
                    p.eps);
    }
    // the value that leaves at chunk `at` for chunk xv of x
    auto value = [&](const float4& xv, int at) {
      if constexpr (kLn)
        return ln_f32x4(xv, mean, rstd, f4_at(sc, at), f4_at(sh, at));
      else if constexpr (OP == kGeluQuant)
        return gelu_f32x4(xv);
      else
        return xv;
    };
    const long long at0 = static_cast<long long>(r) * p.d;
    if constexpr (OP == kLnMod) {
      if (!valid) continue;
      float4* o = reinterpret_cast<float4*>(static_cast<float*>(p.out) + at0);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int at = li + c * lanes;
        if (at < quads) __stcs(o + at, value(v[c], at));
      }
      for (int at = tail; at < quads; at += lanes)
        __stcs(o + at, value(x_at<OP>(x, at), at));
    } else {
      float m = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int at = li + c * lanes;
        if (valid && at < quads) {
          v[c] = value(v[c], at);
          m = fmaxf(m, f4_amax(v[c]));
        }
      }
      for (int at = tail; at < quads; at += lanes)
        m = fmaxf(m, f4_amax(value(f4_at(x, at), at)));
      const float amax = group_reduce<true>(m, lanes, shift, group, rd[2]);
      if (!valid) continue;
      const float2 ar = row_scale(amax);
      uint32_t* q =
          reinterpret_cast<uint32_t*>(static_cast<int8_t*>(p.out) + at0);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int at = li + c * lanes;
        if (at < quads) q[at] = codes4(v[c], ar);
      }
      for (int at = tail; at < quads; at += lanes)
        q[at] = codes4(value(f4_at(x, at), at), ar);
      if (li == 0) p.a[r] = ar.x;
    }
  }
}

// ------------------------------------------------------------- launches

constexpr int kMaxDevices = 64;

// Launch `kernel` over p.rows rows at `per_block` rows per block, on no
// more blocks than fit on the current device at once: its occupancy there,
// found once per device in `capacity[kMaxDevices]` (where its dynamic
// shared memory above 48 KB is allowed first).
template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, int threads, int smem, int per_block,
                   int* capacity, const Args& p, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (capacity[dev] == 0) {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int sms = 0, per_sm = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    capacity[dev] = sms * per_sm;
  }
  const int blocks =
      std::min(capacity[dev], (p.rows + per_block - 1) / per_block);
  kernel<<<blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

RowArgs row_args(const void* x, long long sxb, long long sxs, void* out,
                 void* a, int b, int s, int d) {
  RowArgs p = {};
  p.x = Rows{static_cast<const bf16*>(x), sxb, sxs, s};
  p.out = out;
  p.a = static_cast<float*>(a);
  p.rows = b * s;
  p.d = d;
  return p;
}

}  // namespace

// K5 (a null) or K6. x (B, S, D) bf16 with strides sxb, sxs (elements) and
// a contiguous last dim; shift and scale (B, D) bf16 at batch stride seb;
// out (B, S, D) contiguous, bf16 for K5, int8 codes for K6, whose row
// scales go to a (B * S) f32. D = 3072 takes the warp body, any other D
// the generic kernel. The wrapper (x2i_torch/ops/fused_glue.py) checks
// D % 8 == 0 and 16-byte aligned row starts. Returns the cudaError_t of
// the launch.
extern "C" int x2i_ln_mod(const void* x, long long sxb, long long sxs,
                          const void* shift, const void* scale, long long seb,
                          void* out, void* a, int b, int s, int d, float eps,
                          void* stream) {
  if (b < 1 || s < 1 || d < 8 || d % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  RowArgs p = row_args(x, sxb, sxs, out, a, b, s, d);
  p.shift = static_cast<const bf16*>(shift);
  p.scale = static_cast<const bf16*>(scale);
  p.seb = seb;
  p.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = kLnWarps * 32;
  static int cap[4][kMaxDevices] = {};  // [quant][generic][device]
  const bool quant = a != nullptr, fast = d == kLnD;
  int* c = cap[2 * quant + !fast];
  cudaError_t err;
  if (fast)
    err = quant ? launch(ln_mod_quant_kernel, threads, kLnSmemBytes, kLnWarps,
                         c, p, st)
                : launch(ln_mod_kernel, threads, kLnSmemBytes, kLnWarps, c, p,
                         st);
  else
    err = quant ? launch(ln_mod_rows_kernel<true>, threads, 0, kLnWarps, c, p,
                         st)
                : launch(ln_mod_rows_kernel<false>, threads, 0, kLnWarps, c,
                         p, st);
  return static_cast<int>(err);
}

// K5-K8 on f32 rows. `op` is what they compute: 0 K5, 1 K6, 2 K8, 3 K7.
// x (B, S, D) f32 with strides sxb, sxs (elements) and a contiguous last
// dim; K5 and K6: shift and scale (B, D) f32 at batch stride seb; out
// (B, S, D) contiguous, f32 for K5, int8 codes for the others, whose row
// scales go to a (B * S) f32. The instance of f32_rows_kernel, which the
// wrapper's f32_instance chooses: `lanes` threads a row (a power of two up
// to 256) with `chunks` (4 or 16) 16-byte chunks a thread in registers. D
// is a multiple of 4; the wrapper checks 16-byte aligned row starts.
// Returns the cudaError_t of the launch.
extern "C" int x2i_rows_f32(int op, const float* x, long long sxb,
                            long long sxs, const float* shift,
                            const float* scale, long long seb, void* out,
                            float* a, int b, int s, int d, float eps,
                            int lanes, int chunks, void* stream) {
  if (b < 1 || s < 1 || d < 4 || d % 4 || op < 0 || op > 3 || lanes < 1 ||
      lanes > kQThreads || (lanes & (lanes - 1)) ||
      (chunks != 4 && chunks != 16) || (op == 0) != (a == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  F32RowArgs p = {x, sxb, sxs, s, shift, scale, seb, out, b * s, d, eps, a,
                  lanes};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static int cap[4][2][kMaxDevices] = {};       // [op][chunks 16][device]
  int* c = cap[op][chunks == 16];
  const int per_block = kQThreads / lanes;
  cudaError_t err;
  switch (op * 2 + (chunks == 16)) {
    case 0: err = launch(f32_rows_kernel<kLnMod, 4>, kQThreads, 0, per_block,
                         c, p, st); break;
    case 1: err = launch(f32_rows_kernel<kLnMod, 16>, kQThreads, 0,
                         per_block, c, p, st); break;
    case 2: err = launch(f32_rows_kernel<kLnModQuant, 4>, kQThreads, 0,
                         per_block, c, p, st); break;
    case 3: err = launch(f32_rows_kernel<kLnModQuant, 16>, kQThreads, 0,
                         per_block, c, p, st); break;
    case 4: err = launch(f32_rows_kernel<kQuantOnly, 4>, kQThreads, 0,
                         per_block, c, p, st); break;
    case 5: err = launch(f32_rows_kernel<kQuantOnly, 16>, kQThreads, 0,
                         per_block, c, p, st); break;
    case 6: err = launch(f32_rows_kernel<kGeluQuant, 4>, kQThreads, 0,
                         per_block, c, p, st); break;
    default: err = launch(f32_rows_kernel<kGeluQuant, 16>, kQThreads, 0,
                          per_block, c, p, st); break;
  }
  return static_cast<int>(err);
}

// K7 (`gelu` 1) or K8 (`gelu` 0). x as for K5; q (B * S, D) int8 and a
// (B * S) f32, contiguous. `kind` is the instance, which the wrapper's
// quant_instance chooses from D: 0 the generic kernel at `lanes` threads
// per row (a power of two up to 256), 1 the warp body (K8 at D = 3072), 2
// the ring kernel (D = 12288). `op` (K8 only, kinds 0 and 1): 0 the codes
// and scales, 1 the row absmax alone into a (q unused), 2 the codes and
// scales at the given absmax `amax` (B * S) f32.
extern "C" int x2i_quant_rows(const void* x, long long sxb, long long sxs,
                              void* q, void* a, int b, int s, int d, int gelu,
                              int kind, int lanes, int op, const void* amax,
                              void* stream) {
  if (b < 1 || s < 1 || d < 8 || d % 8 ||
      (kind == 0 &&
       (lanes < 1 || lanes > kQThreads || (lanes & (lanes - 1)))) ||
      (kind == 1 && (d != kLnD || gelu)) || (kind == 2 && d != kQD) ||
      kind < 0 || kind > 2 || op < 0 || op > 2 ||
      (op != 0 && (gelu || kind == 2)) || (op == 2) != (amax != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  RowArgs p = row_args(x, sxb, sxs, q, a, b, s, d);
  p.lanes = lanes;
  p.amax = static_cast<const float*>(amax);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static int cap[2][3][kMaxDevices] = {};  // [gelu][kind][device]
  static int op_cap[2][2][kMaxDevices] = {};  // [op - 1][kind][device]
  int* c = op ? op_cap[op - 1][kind] : cap[gelu ? 1 : 0][kind];
  cudaError_t err;
  if (op == 1)
    err = kind == 1 ? launch(row_amax_warp_kernel, kLnWarps * 32, 0,
                             kLnWarps, c, p, st)
                    : launch(quant_rows_kernel<false, kAmaxOnly>, kQThreads,
                             0, kQThreads / lanes, c, p, st);
  else if (op == 2)
    err = kind == 1 ? launch(quant_at_warp_kernel, kLnWarps * 32, 0,
                             kLnWarps, c, p, st)
                    : launch(quant_rows_kernel<false, kQuantAt>, kQThreads,
                             0, kQThreads / lanes, c, p, st);
  else if (kind == 1)
    err = launch(quant_warp_kernel, kLnWarps * 32, 0, kLnWarps, c, p, st);
  else if (kind == 2)
    err = gelu ? launch(quant_ring_kernel<true>, kQThreads, kQSmemBytes, 1,
                        c, p, st)
               : launch(quant_ring_kernel<false>, kQThreads, kQSmemBytes, 1,
                        c, p, st);
  else
    err = gelu ? launch(quant_rows_kernel<true, kQuantOnly>, kQThreads, 0,
                        kQThreads / lanes, c, p, st)
               : launch(quant_rows_kernel<false, kQuantOnly>, kQThreads, 0,
                        kQThreads / lanes, c, p, st);
  return static_cast<int>(err);
}
