// Flash-attention backward for Hopper (sm_90a): bf16 in, f32 accumulate.
//
// Replaces the two TPU kernels launched by
// x2i_tpu/ops/flash_attention.py::_flash_backward:
//
//   * K3, _bwd_dq_kernel (:526-578): one program per (q tile, q head,
//     batch) recomputes s = q k^T, p = exp2(s - lse), dp = do v^T,
//     ds = p (dp - delta) scale, and writes dq = bf16(ds) k;
//   * K4, _bwd_dkv_kernel (:581-647): one program per (kv tile, kv head,
//     batch) works in the (BK, Sq) orientation, sums the GQA group inside
//     the program (:612-643) and writes dv = bf16(p)^T do and
//     dk = bf16(ds)^T q.
//
// lse is the forward's base-2 row logsumexp (flash_fwd.cu with an lse
// buffer), delta = sum(do * o) per row in f32, computed by the caller as
// in JAX (:677-678). Both kernels take the kv mask and the causal mask with
// the finite NEG_INF = -1e30 and skip no tile, so a row whose keys are all
// masked is treated as in the TPU kernels: lse = -1e30 and p = 1. do stays
// bf16 in every product, as the TPU kernels keep it in its storage type.
//
// The in-kernel rope variant (tables given) rounds as each TPU body does,
// and the two differ on purpose:
//   * K3 rotates the q tile in f32, folds scale * log2(e) in, rounds to
//     bf16 (:555-556), so p = exp2(s - lse) reuses the forward's recipe;
//     K is normalized-free rotated once per launch into a bf16 scratch
//     buffer (rope_rows_kernel, as in the forward);
//   * K4 rotates its k tile and all of Q (once per launch, into a scratch
//     buffer, as _rotate_rows_to_scratch :493-516) WITHOUT the scale, and
//     applies scale * log2(e) to the f32 scores (:605-607, :626).
// dq and dk are cotangents of the rotated q and k; each is counter-rotated
// through the transpose of the rotation before it is written
// (_counter_rotate :519-523).
//
// What bounds them on an H100: at the FLUX training point (24 heads x
// 4608 x 128, batch 1) K3 does three S x S x D products, 6 S^2 D H =
// 3.9e11 FLOP (0.40 ms at the 989 TFLOP/s bf16 peak), and K4 four,
// 5.2e11 FLOP (0.53 ms), against about 170 MB of inputs and outputs: the
// tensor cores bound both.
//
// Design: simple and right first. One block of four warps per 64-row tile
// (each warp 16 rows), bf16 mma.sync m16n8k16 with f32 accumulators, tiles
// staged through padded shared memory. K3 keeps its q fragments and its dq
// accumulators in registers and loops over 64-row kv tiles. K4 keeps dk and
// dv accumulators in registers and loops over the group and over 32-row q
// tiles (32, not 64, so that the score and dp fragments fit beside the two
// accumulators at D = 128). No cp.async pipelining, no wgmma or TMA: later
// work. Requires Sq and Skv to be multiples of 64, D in {64, 128}, the last
// dim contiguous and the other strides multiples of 8 elements.

#include "flash_common.cuh"

namespace {

constexpr int kBQ4 = 32;        // q rows per inner tile of K4

struct BwdArgs {
  const bf16* q;                // (B, Hq, Sq, D), or rotated Q (K4, rope)
  const bf16* k;                // (B, Hk, Skv, D), or rotated K (K3, rope)
  const bf16* v;
  const bf16* dout;             // (B, Hq, Sq, D)
  const float* lse;             // (B, Hq, Sq) contiguous
  const float* delta;           // (B, Hq, Sq) contiguous
  bf16* dq;                     // (B, Hq, Sq, D)
  bf16* dk;                     // (B, Hk, Skv, D)
  bf16* dv;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  const float* cos;
  const float* sin;
  long long tab_rs;
  const unsigned char* mask;
  long long mask_sb;
  int hq, group, sq, skv, causal;
  float scale, scale_log2e;
};

// ------------------------------------------------------------------- K3

template <int D, bool ROPE>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int P = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + kBQ * P;
  bf16* sK = sDO + kBQ * P;
  bf16* sV = sK + kBK * P;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, hkv = h / a.group;
  const int q0 = blockIdx.x * kBQ;
  const bf16* qb = a.q + b * a.q_sb + h * a.q_sh;
  const bf16* dob = a.dout + b * a.do_sb + h * a.do_sh;
  const bf16* kb = a.k + b * a.k_sb + hkv * a.k_sh;
  const bf16* vb = a.v + b * a.v_sb + hkv * a.v_sh;

  if (ROPE) {
    for (int r = warp; r < kBQ; r += kWarps) {
      const int row = q0 + r;
      norm_rope_row<D>(qb + row * a.q_ss, sQ + r * P, a.cos + row * a.tab_rs,
                       a.sin + row * a.tab_rs, nullptr, 0.f, a.scale_log2e,
                       lane);
    }
  } else {
    copy_tile<D, kBQ>(qb + q0 * a.q_ss, a.q_ss, sQ, tid);
  }
  copy_tile<D, kBQ>(dob + q0 * a.do_ss, a.do_ss, sDO, tid);
  __syncthreads();

  const int r0 = warp * 16;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a(qa[kk], sQ, P, r0, kk * 16, g, t4);

  const int row_a = q0 + r0 + g, row_b = row_a + 8;
  const long long bh = static_cast<long long>(b) * a.hq + h;
  const float lse0 = a.lse[bh * a.sq + row_a], lse1 = a.lse[bh * a.sq + row_b];
  const float dl0 = a.delta[bh * a.sq + row_a];
  const float dl1 = a.delta[bh * a.sq + row_b];
  const unsigned char* mask =
      a.mask == nullptr ? nullptr : a.mask + b * a.mask_sb;

  float dq[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;

  for (int kv0 = 0; kv0 < a.skv; kv0 += kBK) {
    __syncthreads();                           // previous tile consumed
    copy_tile<D, kBK>(kb + kv0 * a.k_ss, a.k_ss, sK, tid);
    copy_tile<D, kBK>(vb + kv0 * a.v_ss, a.v_ss, sV, tid);
    __syncthreads();

    // s = q k^T and dp = do v^T, each 16 x 64 per warp
    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t da[4];
      load_a(da, sDO, P, r0, kk * 16, g, t4);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const bf16* pk = sK + (j * 8 + g) * P + kk * 16 + t4 * 2;
        mma_bf16(s[j], qa[kk], ld32(pk), ld32(pk + 8));
        const bf16* pv = sV + (j * 8 + g) * P + kk * 16 + t4 * 2;
        mma_bf16(dp[j], da, ld32(pv), ld32(pv + 8));
      }
    }

    // p = exp2(s - lse), ds = p (dp - delta) scale, in place of s
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + j * 8 + t4 * 2 + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        float x = ROPE ? s[j][e] : s[j][e] * a.scale_log2e;
        const bool keep = (mask == nullptr || mask[col]) &&
                          (!a.causal || col <= row);
        if (!keep) x = kNegInf;
        const float p = exp2f(x - (e < 2 ? lse0 : lse1));
        s[j][e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1)) * a.scale;
      }

    // dq += bf16(ds) k
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pack_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const bf16* p = sK + (kk * 16 + t4 * 2) * P + dn * 8 + g;
        mma_bf16(dq[dn], pa, ld_col_pair(p, P), ld_col_pair(p + 8 * P, P));
      }
    }
  }

  if (ROPE) counter_rotate<D>(dq, a.cos, a.sin, a.tab_rs, row_a, row_b, t4);
  store_rows<D>(a.dq + b * a.dq_sb + h * a.dq_sh, a.dq_ss, dq, row_a, row_b,
                t4);
}

// ------------------------------------------------------------------- K4

template <int D, bool ROPE>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(BwdArgs a) {
  constexpr int P = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kBK * P;
  bf16* sQ = sV + kBK * P;
  bf16* sDO = sQ + kBQ4 * P;
  float* sL = reinterpret_cast<float*>(sDO + kBQ4 * P);
  float* sD = sL + kBQ4;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kBK;
  const bf16* kb = a.k + b * a.k_sb + hk * a.k_sh;
  const bf16* vb = a.v + b * a.v_sb + hk * a.v_sh;

  if (ROPE) {
    for (int r = warp; r < kBK; r += kWarps) {
      const int row = k0 + r;
      norm_rope_row<D>(kb + row * a.k_ss, sK + r * P, a.cos + row * a.tab_rs,
                       a.sin + row * a.tab_rs, nullptr, 0.f, 1.f, lane);
    }
  } else {
    copy_tile<D, kBK>(kb + k0 * a.k_ss, a.k_ss, sK, tid);
  }
  copy_tile<D, kBK>(vb + k0 * a.v_ss, a.v_ss, sV, tid);

  const int r0 = warp * 16;
  const int row_a = k0 + r0 + g, row_b = row_a + 8;   // kv rows
  const unsigned char* mask =
      a.mask == nullptr ? nullptr : a.mask + b * a.mask_sb;
  const bool valid_a = mask == nullptr || mask[row_a];
  const bool valid_b = mask == nullptr || mask[row_b];

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;

  for (int gi = 0; gi < a.group; ++gi) {
    const int h = hk * a.group + gi;
    const bf16* qb = a.q + b * a.q_sb + h * a.q_sh;
    const bf16* dob = a.dout + b * a.do_sb + h * a.do_sh;
    const long long bh = static_cast<long long>(b) * a.hq + h;
    for (int q0 = 0; q0 < a.sq; q0 += kBQ4) {
      __syncthreads();                         // previous tile consumed
      copy_tile<D, kBQ4>(qb + q0 * a.q_ss, a.q_ss, sQ, tid);
      copy_tile<D, kBQ4>(dob + q0 * a.do_ss, a.do_ss, sDO, tid);
      if (tid < kBQ4) {
        sL[tid] = a.lse[bh * a.sq + q0 + tid];
        sD[tid] = a.delta[bh * a.sq + q0 + tid];
      }
      __syncthreads();

      // s^T = k q^T and dp^T = v do^T, each 16 kv rows x 32 q cols
      float s[kBQ4 / 8][4], dp[kBQ4 / 8][4];
#pragma unroll
      for (int j = 0; j < kBQ4 / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_a(ka, sK, P, r0, kk * 16, g, t4);
        load_a(va, sV, P, r0, kk * 16, g, t4);
#pragma unroll
        for (int j = 0; j < kBQ4 / 8; ++j) {
          const bf16* pq = sQ + (j * 8 + g) * P + kk * 16 + t4 * 2;
          mma_bf16(s[j], ka, ld32(pq), ld32(pq + 8));
          const bf16* pd = sDO + (j * 8 + g) * P + kk * 16 + t4 * 2;
          mma_bf16(dp[j], va, ld32(pd), ld32(pd + 8));
        }
      }

      // p^T = exp2(s^T scale log2e - lse); s keeps p, dp becomes ds
#pragma unroll
      for (int j = 0; j < kBQ4 / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + t4 * 2 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          float x = s[j][e] * a.scale_log2e;
          const bool keep = (e < 2 ? valid_a : valid_b) &&
                            (!a.causal || row <= q0 + c);
          if (!keep) x = kNegInf;
          const float p = exp2f(x - sL[c]);
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - sD[c]) * a.scale;
        }

      // dv += bf16(p)^T do, dk += bf16(ds)^T q (k over the 32 q rows)
#pragma unroll
      for (int kk = 0; kk < kBQ4 / 16; ++kk) {
        uint32_t pa[4], sa[4];
        pack_a(pa, s[2 * kk], s[2 * kk + 1]);
        pack_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          const bf16* pd = sDO + (kk * 16 + t4 * 2) * P + dn * 8 + g;
          mma_bf16(dv[dn], pa, ld_col_pair(pd, P), ld_col_pair(pd + 8 * P, P));
          const bf16* pq = sQ + (kk * 16 + t4 * 2) * P + dn * 8 + g;
          mma_bf16(dk[dn], sa, ld_col_pair(pq, P), ld_col_pair(pq + 8 * P, P));
        }
      }
    }
  }

  if (ROPE) counter_rotate<D>(dk, a.cos, a.sin, a.tab_rs, row_a, row_b, t4);
  store_rows<D>(a.dk + b * a.dk_sb + hk * a.dk_sh, a.dk_ss, dk, row_a, row_b,
                t4);
  store_rows<D>(a.dv + b * a.dv_sb + hk * a.dv_sh, a.dv_ss, dv, row_a, row_b,
                t4);
}

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, int smem,
                          const BwdArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const BwdArgs& a, int batch, bool rope,
                      cudaStream_t stream) {
  const int smem = 2 * (kBQ + kBK) * (D + kPad) * static_cast<int>(sizeof(bf16));
  const dim3 grid(a.sq / kBQ, a.hq, batch);
  return rope ? launch_kernel(flash_bwd_dq_kernel<D, true>, grid, smem, a,
                              stream)
              : launch_kernel(flash_bwd_dq_kernel<D, false>, grid, smem, a,
                              stream);
}

template <int D>
cudaError_t launch_dkv(const BwdArgs& a, int batch, bool rope,
                       cudaStream_t stream) {
  const int smem =
      2 * (kBK + kBQ4) * (D + kPad) * static_cast<int>(sizeof(bf16)) +
      2 * kBQ4 * static_cast<int>(sizeof(float));
  const dim3 grid(a.skv / kBK, a.hq / a.group, batch);
  return rope ? launch_kernel(flash_bwd_dkv_kernel<D, true>, grid, smem, a,
                              stream)
              : launch_kernel(flash_bwd_dkv_kernel<D, false>, grid, smem, a,
                              stream);
}

// Fill the arguments both entry points share; false on shapes the kernels
// do not take.
bool fill_args(BwdArgs& a, const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               const long long* st, const float* cos, const float* sin,
               long long tab_rs, const unsigned char* mask, long long mask_sb,
               int hq, int hk, int sq, int skv, int d, int causal,
               float scale, float scale_log2e) {
  if ((d != 64 && d != 128) || sq % kBQ || skv % kBK || hk <= 0 ||
      hq % hk || (cos != nullptr && sq != skv))
    return false;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = lse;
  a.delta = delta;
  a.q_sb = st[0]; a.q_sh = st[1]; a.q_ss = st[2];
  a.k_sb = st[3]; a.k_sh = st[4]; a.k_ss = st[5];
  a.v_sb = st[6]; a.v_sh = st[7]; a.v_ss = st[8];
  a.do_sb = st[9]; a.do_sh = st[10]; a.do_ss = st[11];
  a.cos = cos;
  a.sin = sin;
  a.tab_rs = tab_rs;
  a.mask = mask;
  a.mask_sb = mask_sb;
  a.hq = hq;
  a.group = hq / hk;
  a.sq = sq;
  a.skv = skv;
  a.causal = causal;
  a.scale = scale;
  a.scale_log2e = scale_log2e;
  return true;
}

}  // namespace

// Shared arguments of both entry points. q, do: (B, Hq, Sq, D) bf16; k, v:
// (B, Hk, Skv, D) bf16, with the strides in `st` (elements): q, k, v, do,
// then the outputs', each (b, h, s); last dims contiguous. lse, delta:
// (B, Hq, Sq) f32 contiguous. cos/sin: (S, >= D/2) f32 rows at tab_rs, or
// null (no rope). mask: (B, Skv) bytes at mask_sb, or null. Each returns
// the cudaError_t of its launches.

// K3: dq (B, Hq, Sq, D) bf16 at st[12..14]. With rope, k_scratch holds
// B*Hk*Skv*D bf16 for the rotated K.
extern "C" int x2i_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* k_scratch,
    const long long* st, const float* cos, const float* sin,
    long long tab_rs, const unsigned char* mask, long long mask_sb,
    int batch, int hq, int hk, int sq, int skv, int d, int causal,
    float scale, float scale_log2e, void* stream_ptr) {
  BwdArgs a;
  if (!fill_args(a, q, k, v, dout, lse, delta, st, cos, sin, tab_rs, mask,
                 mask_sb, hq, hk, sq, skv, d, causal, scale, scale_log2e) ||
      (cos != nullptr && k_scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  a.dq = static_cast<bf16*>(dq);
  a.dq_sb = st[12]; a.dq_sh = st[13]; a.dq_ss = st[14];
  const bool rope = cos != nullptr;
  if (rope) {
    // K rotated once per launch, no scale (K3 folds it into the q tile)
    bf16* ks = static_cast<bf16*>(k_scratch);
    cudaError_t err =
        d == 64 ? launch_rope_rows<64>(a.k, ks, a.k_sb, a.k_sh, a.k_ss, batch,
                                       hk, skv, cos, sin, tab_rs, nullptr, 0,
                                       0.f, 1.f, stream)
                : launch_rope_rows<128>(a.k, ks, a.k_sb, a.k_sh, a.k_ss,
                                        batch, hk, skv, cos, sin, tab_rs,
                                        nullptr, 0, 0.f, 1.f, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    a.k = ks;
    a.k_ss = d;
    a.k_sh = static_cast<long long>(skv) * d;
    a.k_sb = a.k_sh * hk;
  }
  return static_cast<int>(d == 64 ? launch_dq<64>(a, batch, rope, stream)
                                  : launch_dq<128>(a, batch, rope, stream));
}

// K4: dk, dv (B, Hk, Skv, D) bf16 at st[12..14] and st[15..17]. With rope,
// q_scratch holds B*Hq*Sq*D bf16 for the rotated Q.
extern "C" int x2i_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    void* q_scratch, const long long* st, const float* cos, const float* sin,
    long long tab_rs, const unsigned char* mask, long long mask_sb,
    int batch, int hq, int hk, int sq, int skv, int d, int causal,
    float scale, float scale_log2e, void* stream_ptr) {
  BwdArgs a;
  if (!fill_args(a, q, k, v, dout, lse, delta, st, cos, sin, tab_rs, mask,
                 mask_sb, hq, hk, sq, skv, d, causal, scale, scale_log2e) ||
      (cos != nullptr && q_scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.dk_sb = st[12]; a.dk_sh = st[13]; a.dk_ss = st[14];
  a.dv_sb = st[15]; a.dv_sh = st[16]; a.dv_ss = st[17];
  const bool rope = cos != nullptr;
  if (rope) {
    // Q rotated once per launch, no scale (K4 scales the f32 scores)
    bf16* qs = static_cast<bf16*>(q_scratch);
    cudaError_t err =
        d == 64 ? launch_rope_rows<64>(a.q, qs, a.q_sb, a.q_sh, a.q_ss, batch,
                                       hq, sq, cos, sin, tab_rs, nullptr, 0,
                                       0.f, 1.f, stream)
                : launch_rope_rows<128>(a.q, qs, a.q_sb, a.q_sh, a.q_ss,
                                        batch, hq, sq, cos, sin, tab_rs,
                                        nullptr, 0, 0.f, 1.f, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    a.q = qs;
    a.q_ss = d;
    a.q_sh = static_cast<long long>(sq) * d;
    a.q_sb = a.q_sh * hq;
  }
  return static_cast<int>(d == 64 ? launch_dkv<64>(a, batch, rope, stream)
                                  : launch_dkv<128>(a, batch, rope, stream));
}
