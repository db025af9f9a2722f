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
// tiles it visited, so its value depends on the tile sizes, here (64 x 64)
// as on the TPU (256 x 512): such rows carry no meaning in either.
//
// What bounds it on an H100: at the 2048^2 FLUX point (24 heads x 16896 x
// 128) the two products take 3.5e12 FLOP per launch against 415 MB of q, k,
// v, o, so the tensor cores bound it (3.5 ms at the 989 TFLOP/s bf16
// data-sheet peak); the 32k-token causal LM prefill (14 q heads on 2 kv
// heads x 32768 x 64) needs half of 3.8e12 FLOP.
//
// Design: one block per (64-row q tile, q head, batch), four warps of 16 q
// rows each; 64-row kv tiles double-buffered in shared memory with
// cp.async, so that the copy of tile t + 1 runs under the products of tile
// t; bf16 mma.sync m16n8k16 with f32 accumulators, the K and V operand
// fragments read with ldmatrix (V transposed on the way); padded shared
// rows keep both free of bank conflicts. The q tiles are scheduled
// last-first, so that under the causal mask the longest blocks start
// first. GQA: q head h reads kv head h / group. No wgmma, no TMA: those
// are later work.
// Requires Sq and Skv to be multiples of 64, D in {64, 128}, the last dim
// contiguous and the other strides multiples of 8 elements; every offset
// is 64-bit.

#include "flash_common.cuh"

namespace {

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;                    // (B, Hq, Sq) contiguous, or null
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  const unsigned char* mask;     // (B, Skv) bytes, or null
  long long mask_sb;
  int group, sq, skv, causal;
  float scale_log2e;
};

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8 and receives, of each, the pair [l / 4][2 (l % 4)..] or,
// transposed, [2 (l % 4)..][l / 4].
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Queue the copy of ROWS rows of D bf16 (at `stride` elements) into padded
// smem rows.
template <int D, int ROWS>
__device__ __forceinline__ void stage_tile(const bf16* src, long long stride,
                                           bf16* dst, int tid) {
  constexpr int kChunks = D / 8;              // 16-byte chunks per row
  for (int c = tid; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    cp_async16(dst + r * (D + kPad) + cc * 8, src + r * stride + cc * 8);
  }
}

template <int D, bool MASKED>
__global__ void __launch_bounds__(kThreads) flash_chunked_kernel(Args a) {
  constexpr int P = D + kPad;                 // smem row pitch (elements)
  constexpr int kTile = kBK * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBQ * P;                    // two buffers
  bf16* sV = sK + 2 * kTile;                  // two buffers
  unsigned char* sM = reinterpret_cast<unsigned char*>(sV + 2 * kTile);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, hkv = h / a.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const bf16* qb = a.q + b * a.q_sb + h * a.q_sh;
  const bf16* kb = a.k + b * a.k_sb + hkv * a.k_sh;
  const bf16* vb = a.v + b * a.v_sb + hkv * a.v_sh;
  const unsigned char* mask =
      MASKED && a.mask != nullptr ? a.mask + b * a.mask_sb : nullptr;

  // the block skip: kv tiles that start above the q tile's last row
  int n_tiles = a.skv / kBK;
  if (MASKED && a.causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);

  auto stage = [&](int t) {
    const int buf = t & 1;
    const long long kv0 = static_cast<long long>(t) * kBK;
    stage_tile<D, kBK>(kb + kv0 * a.k_ss, a.k_ss, sK + buf * kTile, tid);
    stage_tile<D, kBK>(vb + kv0 * a.v_ss, a.v_ss, sV + buf * kTile, tid);
    if (mask != nullptr && tid < kBK) sM[buf * kBK + tid] = mask[kv0 + tid];
    cp_async_commit();
  };

  stage_tile<D, kBQ>(qb + q0 * a.q_ss, a.q_ss, sQ, tid);
  stage(0);

  const int r0 = warp * 16;
  const int row_a = q0 + r0 + g, row_b = row_a + 8;
  uint32_t qa[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  // this lane's row of the ldmatrix reads: K rows by kv index, V rows by
  // kv index within a 16-row step
  const int lrow = lane & 7, lmat = lane >> 3;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        load_a(qa[kk], sQ, P, r0, kk * 16, g, t4);
    }
    const bf16* tK = sK + (t & 1) * kTile;
    const bf16* tV = sV + (t & 1) * kTile;
    const int kv0 = t * kBK;

    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < D / 32; ++k2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, tK + (j * 8 + lrow) * P + k2 * 32 + lmat * 8);
        mma_bf16(s[j], qa[2 * k2], kf[0], kf[1]);
        mma_bf16(s[j], qa[2 * k2 + 1], kf[2], kf[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= a.scale_log2e;
    }

    if (MASKED) {
      // a tile wholly at or below the warp's first row needs no causal test
      const bool diag = a.causal && kv0 + kBK - 1 > q0 + r0;
      if (mask != nullptr || diag) {
        const unsigned char* tM = sM + (t & 1) * kBK;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = j * 8 + t4 * 2 + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            const bool keep = (mask == nullptr || tM[c]) &&
                              (!diag || kv0 + c <= row);
            if (!keep) s[j][e] = kNegInf;
          }
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float al0 = exp2f(m0 - mx0), al1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= al0;
      o[dn][1] *= al0;
      o[dn][2] *= al1;
      o[dn][3] *= al1;
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mx0);
      s[j][1] = exp2f(s[j][1] - mx0);
      s[j][2] = exp2f(s[j][2] - mx1);
      s[j][3] = exp2f(s[j][3] - mx1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pack_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int d2 = 0; d2 < D / 16; ++d2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, tV + (kk * 16 + (lmat & 1) * 8 + lrow) * P +
                                  (d2 * 2 + (lmat >> 1)) * 8);
        mma_bf16(o[2 * d2], pa, vf[0], vf[1]);
        mma_bf16(o[2 * d2 + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();                           // tile consumed
  }

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
  store_rows<D>(a.o + b * a.o_sb + h * a.o_sh, a.o_ss, o, row_a, row_b, t4);
}

template <int D, bool MASKED>
cudaError_t launch(const Args& a, int batch, int hq, cudaStream_t stream) {
  const int smem = (kBQ + 4 * kBK) * (D + kPad) *
                       static_cast<int>(sizeof(bf16)) + 2 * kBK;
  auto kernel = flash_chunked_kernel<D, MASKED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.sq / kBQ, hq, batch);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
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
  if ((d != 64 && d != 128) || sq <= 0 || skv <= 0 || sq % kBQ ||
      skv % kBK || hk <= 0 || hq % hk || batch <= 0 || batch > 65535 ||
      hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(o);
  a.lse = lse;
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
  const bool masked = mask != nullptr || causal != 0;
  cudaError_t err;
  if (d == 64)
    err = masked ? launch<64, true>(a, batch, hq, stream)
                 : launch<64, false>(a, batch, hq, stream);
  else
    err = masked ? launch<128, true>(a, batch, hq, stream)
                 : launch<128, false>(a, batch, hq, stream);
  return static_cast<int>(err);
}
