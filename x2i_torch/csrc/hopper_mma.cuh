// Hopper (sm_90a) building blocks for the attention kernels, the GEMMs
// and the row glue kernels: the warpgroup matrix product wgmma.mma_async
// (bf16 in, f32 accumulate; int8 in, s32 accumulate) with its
// shared-memory matrix descriptors, the 128-byte swizzle those descriptors
// name, TMA tile loads through tensor maps over strided (B, H, S, D)
// tensors and over byte matrices, bulk copies of contiguous rows, cp.async
// copies into swizzled tiles, mbarrier completion, named barriers and
// setmaxnreg for a producer / consumer split.
//
// Tiles. A shared-memory tile of ROWS x COLS bf16 is stored as COLS / 64
// column blocks, each ROWS rows of 128 bytes (64 bf16), and inside every
// group of 8 rows (1024 bytes) the 16-byte chunk c of row r sits at chunk
// c ^ (r % 8): the 128-byte swizzle. The hardware applies the XOR to the
// address bits, so a tile starts on a 1024-byte boundary. Both operand
// orientations read the same storage:
//   * K-major (the reduction index contiguous: q and k rows for q k^T): one
//     wgmma takes 16 reduction columns = 32 bytes of every row (32 columns
//     of an int8 tile, whose swizzled row holds 128 values), so the k
//     step advances the descriptor's start by 32 bytes inside the 128-byte
//     row and by a column block every four steps; rows 8 apart are SBO =
//     1024 bytes apart;
//   * MN-major (the output index contiguous: v rows for p v, through the
//     descriptor's transpose bit): one wgmma takes 16 rows = two 8-row
//     groups SBO = 1024 bytes apart, so the k step advances the start by
//     2048 bytes; output columns 64 apart are LBO = one column block apart.
//
// Accumulators. Warp w of the warpgroup owns rows 16 w .. 16 w + 15 of the
// 64-row product, and within the warp the f32 fragment is mma.sync's C
// layout per 8 columns: d[j][0], d[j][1] = row g, columns 8 j + 2 t4 (+1);
// d[j][2], d[j][3] = row g + 8 (lane = 4 g + t4). A register A operand is
// mma.sync's m16n8k16 A fragment, so two neighbouring accumulator chunks,
// rounded to bf16, are the A operand of the next product.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kSwizzleRowBytes = 128;   // one swizzled row: 64 bf16
constexpr int kSwizzleAtomBytes = 1024; // 8 rows: the swizzle's period

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `chunk` (0..7) of row `row` inside one
// column block of a swizzled tile.
__device__ __forceinline__ uint32_t swizzle128(int row, int chunk) {
  return row * kSwizzleRowBytes + ((chunk ^ (row & 7)) << 4);
}

// Byte offset of element (row, col) of a swizzled ROWS-row tile.
template <int ROWS>
__device__ __forceinline__ uint32_t swizzled_offset(int row, int col) {
  return (col >> 6) * (ROWS * kSwizzleRowBytes) +
         swizzle128(row, (col & 63) >> 3) + (col & 7) * 2;
}

// The 64-bit wgmma matrix descriptor of a 128-byte-swizzled operand at
// shared address `addr` (16-byte units in bits 0-13), leading byte offset
// in bits 16-29, stride byte offset in bits 32-45, layout 1 = 128-byte
// swizzle in bits 62-63.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// The descriptor moved by `bytes` (a multiple of 16).
__device__ __forceinline__ uint64_t desc_advance(uint64_t desc,
                                                 uint32_t bytes) {
  return desc + (bytes >> 4);
}

// Byte step of the k-th 16-column slice of a K-major tile of ROWS rows.
template <int ROWS>
__device__ __forceinline__ constexpr uint32_t kmajor_kstep(int kk) {
  return (kk >> 2) * (ROWS * kSwizzleRowBytes) + (kk & 3) * 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins an accumulator in its registers across the asynchronous product:
// without it the compiler may move reads or writes of d past the
// commit / wait pair, and ptxas then serializes the wgmma pipeline.
template <int N>
__device__ __forceinline__ void wgmma_pin(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// The same for an s32 accumulator (the int8 products).
template <int N>
__device__ __forceinline__ void wgmma_pin(int (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[j][e])::"memory");
}

// Declares an accumulator's earlier values dead before a product that
// overwrites it (scale_d = 0 on its first k step): unlike wgmma_pin, it
// keeps no value alive from before, so that the registers are free while
// other products are in flight. It emits no instruction.
template <int N>
__device__ __forceinline__ void wgmma_fresh(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "=f"(d[j][e])::"memory");
}

// Keeps a register A operand alive until its product has been awaited.
template <int N>
__device__ __forceinline__ void wgmma_pin_a(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// Orders ordinary shared-memory writes (st.shared, cp.async) before the
// reads of the asynchronous proxy (wgmma operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------- wgmma

// d (64 x 32, f32) (+)= A (64 x 16, shared, K-major) B^T (B 32 x 16, shared,
// K-major); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4],
                                             uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, f32) (+)= A (64 x 16, shared, K-major) B^T (B 64 x 16, shared,
// K-major); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4],
                                             uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128, f32) (+)= A (64 x 16, shared, K-major) B^T (B 128 x 16, shared,
// K-major); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4],
                                              uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128, f32) += A (64 x 16 bf16 pairs in registers, the mma.sync A
// fragment of each warp's 16 rows) B (16 x 128, shared, MN-major: rows of
// the k index, the n index contiguous).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16 bf16 pairs in registers, the mma.sync A
// fragment of each warp's 16 rows) B (16 x 64, shared, MN-major: rows of
// the k index, the n index contiguous).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x N, f32) (+)= A (64 x 16, shared, K-major) B^T (B N x 16, shared,
// K-major), for the kv tile widths N = 32, 64 and 128 of the attention
// kernels' scores.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4],
                                         uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "kv tile");
  if constexpr (N == 128) {
    wgmma_ss_n128(d, desc_a, desc_b, scale_d);
  } else if constexpr (N == 64) {
    wgmma_ss_n64(d, desc_a, desc_b, scale_d);
  } else {
    wgmma_ss_n32(d, desc_a, desc_b, scale_d);
  }
}

// ------------------------------------------------------------ int8 wgmma

// d (64 x 256, s32) (+)= A (64 x 32 int8, shared, K-major) B^T (B 256 x 32
// int8, shared, K-major); scale_d = 0 overwrites d. 8-bit operands are
// K-major only.
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[32][4],
                                             uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      :
        "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3]),
        "+r"(d[16][0]), "+r"(d[16][1]), "+r"(d[16][2]), "+r"(d[16][3]),
        "+r"(d[17][0]), "+r"(d[17][1]), "+r"(d[17][2]), "+r"(d[17][3]),
        "+r"(d[18][0]), "+r"(d[18][1]), "+r"(d[18][2]), "+r"(d[18][3]),
        "+r"(d[19][0]), "+r"(d[19][1]), "+r"(d[19][2]), "+r"(d[19][3]),
        "+r"(d[20][0]), "+r"(d[20][1]), "+r"(d[20][2]), "+r"(d[20][3]),
        "+r"(d[21][0]), "+r"(d[21][1]), "+r"(d[21][2]), "+r"(d[21][3]),
        "+r"(d[22][0]), "+r"(d[22][1]), "+r"(d[22][2]), "+r"(d[22][3]),
        "+r"(d[23][0]), "+r"(d[23][1]), "+r"(d[23][2]), "+r"(d[23][3]),
        "+r"(d[24][0]), "+r"(d[24][1]), "+r"(d[24][2]), "+r"(d[24][3]),
        "+r"(d[25][0]), "+r"(d[25][1]), "+r"(d[25][2]), "+r"(d[25][3]),
        "+r"(d[26][0]), "+r"(d[26][1]), "+r"(d[26][2]), "+r"(d[26][3]),
        "+r"(d[27][0]), "+r"(d[27][1]), "+r"(d[27][2]), "+r"(d[27][3]),
        "+r"(d[28][0]), "+r"(d[28][1]), "+r"(d[28][2]), "+r"(d[28][3]),
        "+r"(d[29][0]), "+r"(d[29][1]), "+r"(d[29][2]), "+r"(d[29][3]),
        "+r"(d[30][0]), "+r"(d[30][1]), "+r"(d[30][2]), "+r"(d[30][3]),
        "+r"(d[31][0]), "+r"(d[31][1]), "+r"(d[31][2]), "+r"(d[31][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 256, f32) += A (64 x 16 bf16 pairs in registers, the mma.sync A
// fragment of each warp's 16 rows) B^T (B 256 x 16 bf16, shared, K-major),
// or with TRANS_B = 1 B (16 x 256, shared, MN-major: the V tile of an
// attention kernel at head dim 256, read through the transpose bit).
template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_rs_bf16_n256(float (&d)[32][4],
                                                  const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(TRANS_B));
}

// d (64 x N, f32) += A (registers) B (16 x N, shared, MN-major), for the
// output widths N = 64, 128 and 256 of a head dim.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  static_assert(N == 64 || N == 128 || N == 256, "head dim");
  if constexpr (N == 256) {
    wgmma_rs_bf16_n256<1>(d, a, desc_b);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, desc_b);
  } else {
    wgmma_rs_n64(d, a, desc_b);
  }
}

// ---------------------------------------------------------------- copies

// Two floats at shared address `addr` (8-byte aligned).
__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// Four floats at shared address `addr` (16-byte aligned), and their store.
__device__ __forceinline__ float4 ld_shared_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_f4(uint32_t addr, const float* v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Queue the copy of ROWS rows of D bf16 (at `stride` elements) into the
// swizzled tile at shared address `tile`, by NT threads: consecutive
// threads take consecutive 16-byte chunks of a row.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void cp_async_tile(const __nv_bfloat16* src,
                                              long long stride, uint32_t tile,
                                              int tid) {
  constexpr int kChunks = D / 8;              // 16-byte chunks per row
  constexpr int kRowsPerPass = NT / kChunks;  // 4 (D = 256 on 128 threads)
                                              // or a multiple of 8
  static_assert(kRowsPerPass >= 1 && ROWS % kRowsPerPass == 0, "tile");
  const int cc = tid % kChunks, r0 = tid / kChunks;
  const uint32_t col = tile + (cc >> 3) * (ROWS * kSwizzleRowBytes);
#pragma unroll
  for (int i = 0; i < ROWS / kRowsPerPass; ++i) {
    const int r = r0 + i * kRowsPerPass;
    cp_async_16(col + swizzle128(r, cc & 7), src + r * stride + cc * 8);
  }
}

// Wait until every cp.async this thread has started has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ------------------------------------------------------------ registers

// A whole warpgroup gives registers back to the SM, or takes them: N per
// thread afterwards, a multiple of 8 in [24, 256]. ptxas honours the pair
// only where the two roles' code paths never rejoin.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// -------------------------------------------------------- named barriers

// Wait on barrier `id` (1..15; 0 is __syncthreads) until `threads` threads
// have reached it, by sync or by arrive.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Count this thread on barrier `id` without waiting.
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(arrivals)
               : "memory");
}

// After the inits by one thread, before any other thread uses a barrier
// (followed by a block barrier).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One arrival on `bar` when every cp.async this thread has started so far
// has landed (counted among the barrier's initial arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// The one arrival of a TMA producer, announcing `bytes` of copies that
// will complete on `bar`.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------------- TMA

// One thread: copy `bytes` (a multiple of 16) of contiguous global memory at
// `src` to shared address `dst`, both 16-byte aligned; the bytes complete
// on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A tensor map over a (B, H, S, D) bf16 tensor with any strides (the last
// dim contiguous), for tiles of `box_rows` sequence rows x 64 columns
// written with the 128-byte swizzle: one column block of a tile above.
// The map's dims are D and then S, H, B in the order of their strides
// (a tensor stored (B, S, H, D) has H inside S); pos_* is each one's place
// among the coordinates.
struct TileMap {
  CUtensorMap map;
  int pos_s, pos_h, pos_b;
};

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime (the library is not linked
// against libcuda), looked up once.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

inline cudaError_t make_tile_map(TileMap* out, const void* base, long long sb,
                                 long long sh, long long ss, int batch,
                                 int heads, int seq, int d, int box_rows) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  struct Dim {
    long long stride;
    int size, box;
    int* pos;
  };
  Dim dims[3] = {{ss, seq, box_rows, &out->pos_s},
                 {sh, heads, 1, &out->pos_h},
                 {sb, batch, 1, &out->pos_b}};
  // by stride; a dim of size 1 has no stride of its own and goes last
  std::sort(dims, dims + 3, [](const Dim& x, const Dim& y) {
    if ((x.size == 1) != (y.size == 1)) return y.size == 1;
    return x.stride < y.stride;
  });
  cuuint64_t size[4] = {static_cast<cuuint64_t>(d), 0, 0, 0};
  cuuint64_t stride[3];
  cuuint32_t box[4] = {64, 0, 0, 0}, step[4] = {1, 1, 1, 1};
  long long next = d;
  for (int i = 0; i < 3; ++i) {
    const long long st = dims[i].size == 1 ? next : dims[i].stride;
    size[i + 1] = dims[i].size;
    stride[i] = st * sizeof(__nv_bfloat16);
    box[i + 1] = dims[i].box;
    *dims[i].pos = i + 1;
    next = st * dims[i].size;
  }
  const CUresult res = encode(
      &out->map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      size, stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One thread: copy the box at column c0, sequence row s of head h, batch b
// to shared address `dst`; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load_tile(const TileMap& m, uint32_t dst,
                                              int c0, int s, int h, int b,
                                              uint64_t* bar) {
  const int c1 = m.pos_s == 1 ? s : m.pos_h == 1 ? h : b;
  const int c2 = m.pos_s == 2 ? s : m.pos_h == 2 ? h : b;
  const int c3 = m.pos_s == 3 ? s : m.pos_h == 3 ? h : b;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&m.map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A tensor map over a row-major (rows, cols) matrix of bytes (the int8
// GEMM's operands) whose rows lie `ld` bytes apart (a multiple of 16), for
// boxes of `box_rows` rows x 128 bytes written with the 128-byte swizzle:
// one K step of a K-major int8 tile. Bytes past `cols` or `rows` read as
// zero, so a tile may overhang the matrix's edges.
inline cudaError_t make_byte_matrix_map(CUtensorMap* out, const void* base,
                                        long long cols, long long rows,
                                        long long ld, int box_rows) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t size[2] = {static_cast<cuuint64_t>(cols),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t stride[1] = {static_cast<cuuint64_t>(ld)};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(kSwizzleRowBytes),
                       static_cast<cuuint32_t>(box_rows)};
  cuuint32_t step[2] = {1, 1};
  const CUresult res = encode(
      out, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), size,
      stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One thread: copy the box at byte column c0, row r0 of a matrix map to
// shared address `dst`; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load_2d(const CUtensorMap& m,
                                            uint32_t dst, int c0, int r0,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&m)), "r"(smem_u32(bar)), "r"(c0),
      "r"(r0)
      : "memory");
}

}  // namespace
