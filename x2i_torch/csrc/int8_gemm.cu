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
// Design (a first, simple version): 128 x 128 output tiles, 8 warps each
// computing 64 x 32 with mma.sync m16n8k32 (s8 in, s32 accumulate), K in
// steps of 128 bytes through a 3-stage cp.async ring in shared memory (108
// KB, two blocks on an SM), rows padded to 144 bytes so that ldmatrix
// reads are free of bank conflicts. Rows of A past M, rows of B past N and
// columns past K are zero-filled, so any M, any N that is a multiple of 8
// and any K that is a multiple of 64 work. No wgmma or TMA yet. Of the
// layouts tried on an H100 (tile 128 or 256 by 128 or 256, warp tiles
// 64 x 32 and 64 x 64, K steps of 64 and 128 bytes, 3 or 4 stages), this
// one was the fastest: two blocks of 8 warps on each SM hide mma.sync's
// latency better than one block with larger warp tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 128;           // bytes of K per stage
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int LDS = BK + 16;      // padded shared-memory row, bytes
constexpr int CHUNKS = BK / 16;   // 16-byte chunks per row and stage
constexpr int STAGE_BYTES = (BM + BN) * LDS;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;   // 110,592

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 zero-fills the 16 bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// Stage one BK-wide slab of the A and B tiles: 1024 16-byte chunks each,
// four of each per thread; chunks past M, N or K are zero-filled.
__device__ __forceinline__ void load_stage(const Args& p, int8_t* stage,
                                           int m0, int n0, int k0) {
  int8_t* sa = stage;
  int8_t* sb = stage + BM * LDS;
#pragma unroll
  for (int i = 0; i < BM * CHUNKS / THREADS; ++i) {
    int c = threadIdx.x + i * THREADS;
    int row = c / CHUNKS, col = (c % CHUNKS) * 16;
    bool ok = m0 + row < p.m && k0 + col < p.k;
    const int8_t* src = ok ? p.a + (long long)(m0 + row) * p.lda + k0 + col
                           : p.a;
    cp_async16(sa + row * LDS + col, src, ok);
  }
#pragma unroll
  for (int i = 0; i < BN * CHUNKS / THREADS; ++i) {
    int c = threadIdx.x + i * THREADS;
    int row = c / CHUNKS, col = (c % CHUNKS) * 16;
    bool ok = n0 + row < p.n && k0 + col < p.k;
    const int8_t* src = ok ? p.b + (long long)(n0 + row) * p.ldb + k0 + col
                           : p.b;
    cp_async16(sb + row * LDS + col, src, ok);
  }
}

__device__ __forceinline__ float bf(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <bool ACC_ONLY>
__global__ void __launch_bounds__(THREADS, 2) int8_gemm_kernel(Args p) {
  extern __shared__ __align__(16) int8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 64;   // warp's rows in the tile
  const int wn = (warp & 3) * 32;    // warp's columns in the tile
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (p.k + BK - 1) / BK;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(p, smem + s * STAGE_BYTES, m0, n0, s * BK);
    cp_async_commit();
  }

  // ldmatrix row addresses: A x4 = (rows 0-7 | 8-15) x (bytes 0-15 | 16-31)
  // -> a0..a3; B x4 = (n 0-7, bytes 0-15 | 16-31), (n 8-15, ...) -> b of
  // two n8 tiles
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < ktiles)
      load_stage(p, smem + (nk % STAGES) * STAGE_BYTES, m0, n0, nk * BK);
    cp_async_commit();

    const int8_t* sa = smem + (kt % STAGES) * STAGE_BYTES;
    const int8_t* sb = sa + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], sa + (wm + mi * 16 + a_row) * LDS + kk + a_col);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldsm_x4(r, sb + (wn + nj * 16 + b_row) * LDS + kk + b_col);
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: fragment rows g and g + 8, columns 2 * tig and 2 * tig + 1
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mi * 16 + g + half * 8;
      if (row >= p.m) continue;
      const float as = ACC_ONLY ? 0.f : p.a_scale[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + tig * 2;
        if (col >= p.n) continue;
        const int c0 = acc[mi][ni][half * 2], c1 = acc[mi][ni][half * 2 + 1];
        if (ACC_ONLY) {
          int2* o = reinterpret_cast<int2*>(static_cast<int*>(p.out) +
                                            row * p.ldo + col);
          *o = make_int2(c0, c1);
          continue;
        }
        float v0 = __int2float_rn(c0) * as;
        float v1 = __int2float_rn(c1) * as;
        v0 = v0 * p.scale[col];
        v1 = v1 * p.scale[col + 1];
        __nv_bfloat16 r0 = __float2bfloat16_rn(v0);
        __nv_bfloat16 r1 = __float2bfloat16_rn(v1);
        if (p.addend) {
          const __nv_bfloat16* d = p.addend + row * p.ldd + col;
          r0 = __float2bfloat16_rn(bf(d[0]) + bf(r0));
          r1 = __float2bfloat16_rn(bf(d[1]) + bf(r1));
        }
        if (p.bias) {
          r0 = __float2bfloat16_rn(bf(r0) + bf(p.bias[col]));
          r1 = __float2bfloat16_rn(bf(r1) + bf(p.bias[col + 1]));
        }
        __nv_bfloat162 pair;
        pair.x = r0;
        pair.y = r1;
        *reinterpret_cast<__nv_bfloat162*>(
            static_cast<__nv_bfloat16*>(p.out) + row * p.ldo + col) = pair;
      }
    }
  }
}

template <bool ACC_ONLY>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        int8_gemm_kernel<ACC_ONLY>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM);
  int8_gemm_kernel<ACC_ONLY><<<grid, THREADS, SMEM_BYTES, stream>>>(p);
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
  return static_cast<int>(acc_only ? launch<true>(p, s) : launch<false>(p, s));
}
