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
    copy_tile<D, kBQ>(qb + q0 * a.q_ss, a.q_ss, sQ, tid);
  }
  __syncthreads();

  const int r0 = warp * 16;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a(qa[kk], sQ, P, r0, kk * 16, g, t4);

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
    copy_tile<D, kBK>(kb + kv0 * a.k_ss, a.k_ss, sK, tid);
    copy_tile<D, kBK>(vb + kv0 * a.v_ss, a.v_ss, sV, tid);
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
      uint32_t pa[4];
      pack_a(pa, s[2 * kk], s[2 * kk + 1]);
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
  store_rows<D>(a.o + b * a.o_sb + h * a.o_sh, a.o_ss, o, row_a, row_b, t4);
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

}  // namespace

// q, k, v, o: (B, H, S, D) bf16 with the strides in `st` (elements):
// q (b, h, s), k (b, h, s), v (b, h, s), o (b, h, s); the last dim is
// contiguous. lse: (B, Hq, Sq) f32 contiguous, or null; it needs the exact
// body. cos/sin: (Sq, >= D/2) f32 rows at tab_rs, or null (no rope).
// qw/kw: f32 qk-norm scales with row strides qw_rs/kw_rs (0 = one shared
// (D,) row), or null (no norm; rope only). k_scratch: B*Hk*Skv*D bf16 when
// rope is given. mask: (B, Skv) bytes at mask_sb, or null. Returns the
// cudaError_t of the launches.
extern "C" int x2i_flash_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    void* k_scratch, const long long* st, const float* cos, const float* sin,
    long long tab_rs, const float* qw, long long qw_rs, const float* kw,
    long long kw_rs, const unsigned char* mask, long long mask_sb, int batch,
    int hq, int hk, int sq, int skv, int d, int causal, int exact,
    float scale_log2e, float eps, void* stream_ptr) {
  if ((d != 64 && d != 128) || sq % kBQ || skv % kBK || hk <= 0 ||
      hq % hk || (cos != nullptr && (k_scratch == nullptr || sq != skv)) ||
      (lse != nullptr && !exact))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool rope = cos != nullptr;
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
  a.cos = cos;
  a.sin = sin;
  a.tab_rs = tab_rs;
  a.qw = qw;
  a.qw_rs = qw_rs;
  a.mask = mask;
  a.mask_sb = mask_sb;
  a.group = hq / hk;
  a.sq = sq;
  a.skv = skv;
  a.causal = causal;
  a.scale_log2e = scale_log2e;
  a.eps = eps;
  cudaError_t err = cudaSuccess;
  if (rope) {
    // K normalized and rotated once per launch (no scale: it is folded
    // into the q tile)
    bf16* ks = static_cast<bf16*>(k_scratch);
    err = d == 64 ? launch_rope_rows<64>(a.k, ks, st[3], st[4], st[5], batch,
                                         hk, skv, cos, sin, tab_rs, kw, kw_rs,
                                         eps, 1.f, stream)
                  : launch_rope_rows<128>(a.k, ks, st[3], st[4], st[5], batch,
                                          hk, skv, cos, sin, tab_rs, kw,
                                          kw_rs, eps, 1.f, stream);
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
