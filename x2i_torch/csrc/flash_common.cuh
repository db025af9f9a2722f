// Pieces shared by the flash-attention kernels (flash_fwd.cu,
// flash_chunked.cu, flash_bwd.cu): exp2 on the special-function unit, the
// bf16 rounding of accumulator fragments into the A operand of the next
// product and their stores, and the row-wise qk RMSNorm + half-layout
// rotation with its once-per-launch pass over a whole (B, H, S, D) tensor
// (bf16, or f32 rounded to bf16 first) into a contiguous bf16 scratch
// buffer, and the f32 instances' pass that rounds f32 (B, H, S, D) inputs
// into such a buffer.
//
// Fragment layouts of mma.sync.m16n8k16.row.col, which a warp's 16 rows of
// a wgmma accumulator and register A operand share (lane = 4 g + t4):
//   A (16 x 16, row-major): a0 = A[g][2t4..], a1 = A[g+8][2t4..],
//                           a2 = A[g][2t4+8..], a3 = A[g+8][2t4+8..]
//   B (16 x 8, "col"):      b0 = B[2t4..2t4+1][g], b1 = B[2t4+8..2t4+9][g]
//   C (16 x 8):             c0, c1 = C[g][2t4..], c2, c3 = C[g+8][2t4..]

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;

typedef __nv_bfloat16 bf16;

// 2^x on the special-function unit. Where x <= 0 (p = exp2(s - m) against
// a row maximum or a row logsumexp) or is clamped (the pipelined forward's
// +-100) it is exp2f's value, except that a result below 2^-126 is flushed
// to 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of a 16 x 16 block held in C fragments c[2kk], c[2kk+1]
// (the columns of two n-tiles), rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t* a, const float* c0,
                                       const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// A row element as the bf16 bodies read it: a bf16 value, or an f32 one
// rounded to bf16 (to nearest), as round_rows_kernel rounds it.
__device__ __forceinline__ float bf16_value(bf16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float bf16_value(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One warp: optional RMSNorm (f32 row statistics, eps, per-channel scale
// w), then the half-layout rotation with the first halves of the (cos,
// sin) rows, then * post, rounded to bf16. Lane l holds channels
// l + 32 t; channel j's rotation partner j +- D/2 lives in the same lane.
// An f32 row (Src = float) is rounded to bf16 as it is read, so that every
// rounding point is the bf16 row's. norm_rope_vals leaves the f32 values
// y[t] of channels l + 32 t before the rounding; norm_rope_row rounds and
// stores them into a linear row. A caller that knows w_row is given says
// so (NORM), which leaves the row's code free of branches, so that the
// loads of several rows overlap.
template <int D, bool NORM = false, typename Src = bf16>
__device__ __forceinline__ void norm_rope_vals(
    const Src* src, float* y, const float* cos_row, const float* sin_row,
    const float* w_row, float eps, float post, int lane) {
  constexpr int T = D / 32;
  constexpr int H = T / 2;
  float x[T];
#pragma unroll
  for (int t = 0; t < T; ++t) x[t] = bf16_value(src[lane + 32 * t]);
  if (NORM || w_row != nullptr) {
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
    y[t] = (t < H ? x[t] * c - partner * s : x[t] * c + partner * s) * post;
  }
}

template <int D, typename T>
__device__ __forceinline__ void norm_rope_row(
    const T* src, bf16* dst, const float* cos_row, const float* sin_row,
    const float* w_row, float eps, float post, int lane) {
  float y[D / 32];
  norm_rope_vals<D, false, T>(src, y, cos_row, sin_row, w_row, eps, post,
                              lane);
#pragma unroll
  for (int t = 0; t < D / 32; ++t)
    dst[lane + 32 * t] = __float2bfloat16_rn(y[t]);
}

// x (B, H, S, D) strided, bf16 or f32 -> normalized, rotated, * post,
// contiguous bf16; one warp per row.
template <int D, typename T>
__global__ void __launch_bounds__(256) rope_rows_kernel(
    const T* __restrict__ x, bf16* __restrict__ out, long long x_sb,
    long long x_sh, long long x_ss, int heads, int seq, long long rows,
    const float* cos, const float* sin, long long tab_rs, const float* w,
    long long w_rs, float eps, float post) {
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= rows) return;
  const int s = static_cast<int>(warp % seq);
  const long long bh = warp / seq;
  const int h = static_cast<int>(bh % heads);
  const long long b = bh / heads;
  norm_rope_row<D, T>(x + b * x_sb + h * x_sh + s * x_ss, out + warp * D,
                      cos + s * tab_rs, sin + s * tab_rs,
                      w == nullptr ? nullptr : w + s * w_rs, eps, post, lane);
}

template <int D, typename T>
cudaError_t launch_rope_rows(const T* x, bf16* out, long long x_sb,
                             long long x_sh, long long x_ss, int batch,
                             int heads, int seq, const float* cos,
                             const float* sin, long long tab_rs,
                             const float* w, long long w_rs, float eps,
                             float post, cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * heads * seq;
  const int per_block = 256 / 32;
  const long long blocks = (rows + per_block - 1) / per_block;
  rope_rows_kernel<D, T><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      x, out, x_sb, x_sh, x_ss, heads, seq, rows, cos, sin, tab_rs, w, w_rs,
      eps, post);
  return cudaGetLastError();
}

// The transpose of the half-layout rotation, applied in place to the
// f32 C fragments acc[D/8][4] of one warp's 16 rows (row_a = its row g,
// row_b = row g + 8): g1' = g1 c + g2 s, g2' = g2 c - g1 s. Column j's
// partner j + D/2 is fragment dn + D/16 of the same thread.
template <int D>
__device__ __forceinline__ void counter_rotate(float (*acc)[4],
                                               const float* cos,
                                               const float* sin,
                                               long long tab_rs, int row_a,
                                               int row_b, int t4) {
#pragma unroll
  for (int dn = 0; dn < D / 16; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? row_a : row_b;
      const int col = dn * 8 + t4 * 2 + (e & 1);
      const float c = cos[row * tab_rs + col], s = sin[row * tab_rs + col];
      const float g1 = acc[dn][e], g2 = acc[dn + D / 16][e];
      acc[dn][e] = g1 * c + g2 * s;
      acc[dn + D / 16][e] = g2 * c - g1 * s;
    }
  }
}

// Rows row_a and row_b of a C-fragment accumulator, rounded to bf16.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long row_stride,
                                           const float (*acc)[4], int row_a,
                                           int row_b, int t4) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(base + row_a * row_stride + col) =
        pack_bf16(acc[dn][0], acc[dn][1]);
    *reinterpret_cast<uint32_t*>(base + row_b * row_stride + col) =
        pack_bf16(acc[dn][2], acc[dn][3]);
  }
}

// The same rows in f32: the outputs of the f32 instances.
template <int D>
__device__ __forceinline__ void store_rows(float* base, long long row_stride,
                                           const float (*acc)[4], int row_a,
                                           int row_b, int t4) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + t4 * 2;
    *reinterpret_cast<float2*>(base + row_a * row_stride + col) =
        make_float2(acc[dn][0], acc[dn][1]);
    *reinterpret_cast<float2*>(base + row_b * row_stride + col) =
        make_float2(acc[dn][2], acc[dn][3]);
  }
}

// The f32 instances' first pass: x (B, H, S, D) f32 strided -> contiguous
// bf16, rounded to nearest, once per launch: four channels a thread, one
// 16-byte load and one 8-byte store. The strides are multiples of 4
// elements and x starts on 16 bytes.
template <int D>
__global__ void __launch_bounds__(256) round_rows_kernel(
    const float* __restrict__ x, bf16* __restrict__ out, long long x_sb,
    long long x_sh, long long x_ss, int heads, int seq, long long quads) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= quads) return;
  const long long row = i / (D / 4);
  const int c = static_cast<int>(i % (D / 4)) * 4;
  const int s = static_cast<int>(row % seq);
  const long long bh = row / seq;
  const int h = static_cast<int>(bh % heads);
  const long long b = bh / heads;
  const float4 v =
      *reinterpret_cast<const float4*>(x + b * x_sb + h * x_sh + s * x_ss + c);
  uint2 packed;
  packed.x = pack_bf16(v.x, v.y);
  packed.y = pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(out + row * D + c) = packed;
}

template <int D>
cudaError_t launch_round_rows(const float* x, bf16* out, long long x_sb,
                              long long x_sh, long long x_ss, int batch,
                              int heads, int seq, cudaStream_t stream) {
  const long long quads = static_cast<long long>(batch) * heads * seq * D / 4;
  const long long blocks = (quads + 255) / 256;
  round_rows_kernel<D><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      x, out, x_sb, x_sh, x_ss, heads, seq, quads);
  return cudaGetLastError();
}

// f(std::integral_constant<int, D>()) for the head dim d, one of 64, 128
// and 256 (the instances of a head-dim template): its cudaError_t, or
// cudaErrorInvalidValue for another d.
template <typename F>
cudaError_t with_head_dim(int d, F&& f) {
  switch (d) {
    case 64:
      return f(std::integral_constant<int, 64>());
    case 128:
      return f(std::integral_constant<int, 128>());
    case 256:
      return f(std::integral_constant<int, 256>());
    default:
      return cudaErrorInvalidValue;
  }
}

// x (B, H, S, D) f32 at the (b, h, s) strides st[0..2] -> rounded into the
// contiguous bf16 buffer out, whose strides then replace st[0..2]. D is 64,
// 128 or 256.
inline cudaError_t round_into(const float* x, bf16* out, long long* st,
                              int batch, int heads, int seq, int d,
                              cudaStream_t stream) {
  const cudaError_t err = with_head_dim(d, [&](auto dim) {
    return launch_round_rows<decltype(dim)::value>(x, out, st[0], st[1], st[2],
                                                   batch, heads, seq, stream);
  });
  st[2] = d;
  st[1] = static_cast<long long>(seq) * d;
  st[0] = st[1] * heads;
  return err;
}

}  // namespace
