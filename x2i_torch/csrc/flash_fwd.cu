// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulate.
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
//     Qwen2 LM prefill.
//
// What bounds it on an H100: at the FLUX point (24 heads x 4608 x 128) the
// two products take 2.6e11 FLOP per launch against 113 MB of q, k, v, o:
// about 2300 FLOP per byte, far above the card's ~295, so the tensor cores
// bound it (0.26 ms at the 989 TFLOP/s bf16 data-sheet peak). The LM
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
//   * one block per (64-row q tile, q head, batch), four warps of 16 q
//     rows each; a loop over 64-row kv tiles staged through shared memory
//     (padded rows, so fragment loads are free of bank conflicts);
//   * bf16 mma.sync m16n8k16 with f32 accumulators in registers; the score
//     fragments are reused as the A operand of the PV product after being
//     rounded to bf16, as the TPU body casts p before its PV matmul (:193);
//   * no cp.async pipelining, no wgmma or TMA: those are later work.
// Requires Sq and Skv to be multiples of 64, D in {64, 128}, the last dim
// contiguous and the other strides multiples of 8 elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // kv rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;        // bf16 elements of row padding in smem
constexpr float kNegInf = -1e30f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 from one column of a row-major tile, rows r and r+1.
__device__ __forceinline__ uint32_t ld_col_pair(const bf16* p, int pitch) {
  uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  uint32_t hi = *reinterpret_cast<const uint16_t*>(p + pitch);
  return lo | (hi << 16);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp: optional RMSNorm (f32 row statistics, eps, per-channel scale
// w), then the half-layout rotation with the first halves of the (cos,
// sin) rows, then * post, rounded to bf16. Lane l holds channels
// l + 32 t; channel j's rotation partner j +- D/2 lives in the same lane.
template <int D>
__device__ __forceinline__ void norm_rope_row(
    const bf16* src, bf16* dst, const float* cos_row, const float* sin_row,
    const float* w_row, float eps, float post, int lane) {
  constexpr int T = D / 32;
  constexpr int H = T / 2;
  float x[T];
#pragma unroll
  for (int t = 0; t < T; ++t) x[t] = __bfloat162float(src[lane + 32 * t]);
  if (w_row != nullptr) {
    float ss = 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t) ss += x[t] * x[t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float r = rsqrtf(ss / D + eps);
#pragma unroll
    for (int t = 0; t < T; ++t) x[t] = x[t] * r * w_row[lane + 32 * t];
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int jh = lane + 32 * (t % H);
    const float c = cos_row[jh], s = sin_row[jh];
    const float partner = x[(t + H) % T];
    const float y = t < H ? x[t] * c - partner * s : x[t] * c + partner * s;
    dst[lane + 32 * t] = __float2bfloat16_rn(y * post);
  }
}

// K (B, Hk, Skv, D) strided -> normalized, rotated, contiguous bf16.
template <int D>
__global__ void __launch_bounds__(256) rope_k_kernel(
    const bf16* __restrict__ k, bf16* __restrict__ out, long long k_sb,
    long long k_sh, long long k_ss, int hk, int skv, long long rows,
    const float* cos, const float* sin, long long tab_rs, const float* kw,
    long long kw_rs, float eps) {
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= rows) return;
  const int s = static_cast<int>(warp % skv);
  const long long bh = warp / skv;
  const int h = static_cast<int>(bh % hk);
  const long long b = bh / hk;
  norm_rope_row<D>(k + b * k_sb + h * k_sh + s * k_ss,
                   out + warp * D, cos + s * tab_rs, sin + s * tab_rs,
                   kw == nullptr ? nullptr : kw + s * kw_rs, eps, 1.f, lane);
}

// Copy a 64-row tile (rows of D bf16 at `stride`) into padded smem rows.
template <int D>
__device__ __forceinline__ void copy_tile(const bf16* src, long long stride,
                                          bf16* dst, int tid) {
  constexpr int kChunks = D / 8;              // 16-byte chunks per row
  for (int c = tid; c < kBK * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + cc * 8) =
        *reinterpret_cast<const uint4*>(src + r * stride + cc * 8);
  }
}

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  const float* cos;
  const float* sin;
  long long tab_rs;
  const float* qw;
  long long qw_rs;
  const unsigned char* mask;
  long long mask_sb;
  int group, skv, causal;
  float scale_log2e, eps;
};

template <int D, bool ROPE, bool EXACT>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int P = D + kPad;                 // smem row pitch (elements)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBQ * P;
  bf16* sV = sK + kBK * P;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, hkv = h / a.group;
  const int q0 = blockIdx.x * kBQ;
  const bf16* qb = a.q + b * a.q_sb + h * a.q_sh;
  const bf16* kb = a.k + b * a.k_sb + hkv * a.k_sh;
  const bf16* vb = a.v + b * a.v_sb + hkv * a.v_sh;

  if (ROPE) {
    for (int r = warp; r < kBQ; r += kWarps) {
      const int row = q0 + r;
      norm_rope_row<D>(qb + row * a.q_ss, sQ + r * P, a.cos + row * a.tab_rs,
                       a.sin + row * a.tab_rs,
                       a.qw == nullptr ? nullptr : a.qw + row * a.qw_rs,
                       a.eps, a.scale_log2e, lane);
    }
  } else {
    copy_tile<D>(qb + q0 * a.q_ss, a.q_ss, sQ, tid);
  }
  __syncthreads();

  const int r0 = warp * 16;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* p = sQ + (r0 + g) * P + kk * 16 + t4 * 2;
    qa[kk][0] = ld32(p);
    qa[kk][1] = ld32(p + 8 * P);
    qa[kk][2] = ld32(p + 8);
    qa[kk][3] = ld32(p + 8 * P + 8);
  }

  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int row_a = q0 + r0 + g, row_b = row_a + 8;
  const unsigned char* mask =
      a.mask == nullptr ? nullptr : a.mask + b * a.mask_sb;

  for (int kv0 = 0; kv0 < a.skv; kv0 += kBK) {
    __syncthreads();                           // previous tile consumed
    copy_tile<D>(kb + kv0 * a.k_ss, a.k_ss, sK, tid);
    copy_tile<D>(vb + kv0 * a.v_ss, a.v_ss, sV, tid);
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const bf16* p = sK + (j * 8 + g) * P + kk * 16 + t4 * 2;
        mma_bf16(s[j], qa[kk], ld32(p), ld32(p + 8));
      }
    }
    if (!ROPE) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= a.scale_log2e;
    }

    if (EXACT) {
      if (mask != nullptr || a.causal) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kv0 + j * 8 + t4 * 2 + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            const bool keep = (mask == nullptr || mask[col]) &&
                              (!a.causal || col <= row);
            if (!keep) s[j][e] = kNegInf;
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
    } else {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = exp2f(fminf(fmaxf(s[j][e], -100.f), 100.f));
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }
    }

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const bf16* p = sV + (kk * 16 + t4 * 2) * P + dn * 8 + g;
        mma_bf16(o[dn], pa, ld_col_pair(p, P), ld_col_pair(p + 8 * P, P));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  bf16* ob = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(ob + row_a * a.o_ss + col) =
        pack_bf16(o[dn][0] / l0, o[dn][1] / l0);
    *reinterpret_cast<uint32_t*>(ob + row_b * a.o_ss + col) =
        pack_bf16(o[dn][2] / l1, o[dn][3] / l1);
  }
}

template <int D, bool ROPE, bool EXACT>
cudaError_t launch_main(const Args& a, int batch, int hq, int sq,
                        cudaStream_t stream) {
  const int smem = (kBQ + 2 * kBK) * (D + kPad) * static_cast<int>(sizeof(bf16));
  auto kernel = flash_fwd_kernel<D, ROPE, EXACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(sq / kBQ, hq, batch);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Args& a, int batch, int hq, int sq, bool rope,
                   bool exact, cudaStream_t stream) {
  if (rope)
    return exact ? launch_main<D, true, true>(a, batch, hq, sq, stream)
                 : launch_main<D, true, false>(a, batch, hq, sq, stream);
  return exact ? launch_main<D, false, true>(a, batch, hq, sq, stream)
               : launch_main<D, false, false>(a, batch, hq, sq, stream);
}

template <int D>
cudaError_t launch_rope_k(const bf16* k, bf16* out, const long long* st,
                          int batch, int hk, int skv, const float* cos,
                          const float* sin, long long tab_rs, const float* kw,
                          long long kw_rs, float eps, cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * hk * skv;
  const int per_block = 256 / 32;
  const long long blocks = (rows + per_block - 1) / per_block;
  rope_k_kernel<D><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      k, out, st[3], st[4], st[5], hk, skv, rows, cos, sin, tab_rs, kw,
      kw_rs, eps);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, H, S, D) bf16 with the strides in `st` (elements):
// q (b, h, s), k (b, h, s), v (b, h, s), o (b, h, s); the last dim is
// contiguous. cos/sin: (Sq, >= D/2) f32 rows at tab_rs, or null (no rope).
// qw/kw: f32 qk-norm scales with row strides qw_rs/kw_rs (0 = one shared
// (D,) row), or null (no norm; rope only). k_scratch: B*Hk*Skv*D bf16 when
// rope is given. mask: (B, Skv) bytes at mask_sb, or null. Returns the
// cudaError_t of the launches.
extern "C" int x2i_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* k_scratch,
    const long long* st, const float* cos, const float* sin,
    long long tab_rs, const float* qw, long long qw_rs, const float* kw,
    long long kw_rs, const unsigned char* mask, long long mask_sb, int batch,
    int hq, int hk, int sq, int skv, int d, int causal, int exact,
    float scale_log2e, float eps, void* stream_ptr) {
  if ((d != 64 && d != 128) || sq % kBQ || skv % kBK || hk <= 0 ||
      hq % hk || (cos != nullptr && (k_scratch == nullptr || sq != skv)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool rope = cos != nullptr;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(o);
  a.q_sb = st[0]; a.q_sh = st[1]; a.q_ss = st[2];
  a.k_sb = st[3]; a.k_sh = st[4]; a.k_ss = st[5];
  a.v_sb = st[6]; a.v_sh = st[7]; a.v_ss = st[8];
  a.o_sb = st[9]; a.o_sh = st[10]; a.o_ss = st[11];
  a.cos = cos;
  a.sin = sin;
  a.tab_rs = tab_rs;
  a.qw = qw;
  a.qw_rs = qw_rs;
  a.mask = mask;
  a.mask_sb = mask_sb;
  a.group = hq / hk;
  a.skv = skv;
  a.causal = causal;
  a.scale_log2e = scale_log2e;
  a.eps = eps;
  cudaError_t err = cudaSuccess;
  if (rope) {
    bf16* ks = static_cast<bf16*>(k_scratch);
    err = d == 64 ? launch_rope_k<64>(a.k, ks, st, batch, hk, skv, cos, sin,
                                      tab_rs, kw, kw_rs, eps, stream)
                  : launch_rope_k<128>(a.k, ks, st, batch, hk, skv, cos, sin,
                                       tab_rs, kw, kw_rs, eps, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    a.k = ks;
    a.k_ss = d;
    a.k_sh = static_cast<long long>(skv) * d;
    a.k_sb = a.k_sh * hk;
  }
  err = d == 64 ? launch<64>(a, batch, hq, sq, rope, exact != 0, stream)
                : launch<128>(a, batch, hq, sq, rope, exact != 0, stream);
  return static_cast<int>(err);
}
