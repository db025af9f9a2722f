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

template <bool ACC_ONLY>
__global__ void __launch_bounds__(kConsumers + 128, 1) int8_gemm_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_b, Args p) {
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
  const int ksteps = (p.k + kStepBytes - 1) / kStepBytes;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers / 32);   // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    setmaxnreg_dec<24>();
    // The producer: one thread keeps the ring full, up to STAGES K steps
    // ahead of the consumers; a stage is the A box and the B box of one
    // K step, both completing on its `full`.
    if (tid == kConsumers) {
#pragma unroll 1
      for (int kt = 0; kt < ksteps; ++kt) {
        const int st = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[st], (kt / STAGES - 1) & 1);
        mbar_arrive_expect_tx(&full[st], kStageBytes);
        const uint32_t sa = ring + st * kStageBytes;
        tma_load_2d(map_a, sa, kt * kStepBytes, m0, &full[st]);
        tma_load_2d(map_b, sa + kABytes, kt * kStepBytes, n0, &full[st]);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
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
cudaError_t launch(const Args& p, cudaStream_t stream) {
  auto kernel = int8_gemm_kernel<ACC_ONLY>;
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
  if (err == cudaSuccess)
    err = make_byte_matrix_map(&map_b, p.b, p.k, p.n, p.ldb, BN);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(acc_only ? launch<true>(p, s)
                                   : launch<false>(p, s));
}
