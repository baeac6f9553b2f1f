// Warp-level tensor-core pieces shared by the flash kernels' bf16 / f16
// paths (flash_fwd.cu, flash_bwd.cu): 16-byte cp.async tile copies into
// padded shared-memory rows, ldmatrix fragment loads, the
// mma.sync.m16n8k16 product with f32 accumulators, and packing of f32
// pairs into 16-bit A fragments.
//
// Fragment layouts of mma.sync.aligned.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major), 4 regs of 2 elements: a0 (row g, cols 2t, 2t+1),
//     a1 (row g+8, same cols), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8,
//     cols 2t+8, 2t+9);
//   B (16 x 8, k x n), 2 regs: b0 (k 2t, 2t+1; n g), b1 (k 2t+8, 2t+9; n g);
//   C (16 x 8, f32), 4 regs: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// So the C fragments of two neighbouring n8 tiles are, once rounded to 16
// bits, the A fragment of one k16 slice: a product's result feeds the next
// product from registers.
#pragma once

#include "common.cuh"

namespace ptt {
namespace mma {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Row pitch, in elements, of a [rows][D] 16-bit tile in shared memory: one
// 16-byte pad per row, so the 8 row addresses of an ldmatrix 8 x 8 matrix
// (and the 16-byte cp.async stores of one row's chunks) fall in 8 different
// 4-bank groups for D = 32, 64 and 128.
__host__ __device__ constexpr int tile_pitch(int d) { return d + 8; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared that skips L1; writes zeros when !valid
// (src is then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying ROWS rows of D 16-bit elements (row stride `stride`
// elements in device memory) into dst with pitch tile_pitch(D); rows >=
// valid_rows become zeros, so padded rows never multiply stale memory.
// valid_rows >= 1: row 0 stands in as the address of the zero fills.
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile_async(T* dst,
                                                const T* __restrict__ src,
                                                int64_t stride,
                                                int valid_rows) {
  constexpr int P = tile_pitch(D);
  constexpr int CH = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * CH % NT == 0, "chunks must split evenly");
#pragma unroll
  for (int i = 0; i < ROWS * CH / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = idx / CH;
    const int c = (idx % CH) * 8;
    const bool ok = r < valid_rows;
    cp_async16(dst + r * P + c, ok ? src + r * stride + c : src, ok);
  }
}

// four 8 x 8 matrices of 16-bit elements; lane l gives the address of row
// l % 8 of matrix l / 8 and receives, for each matrix, row l / 4's
// elements 2 (l % 4) and 2 (l % 4) + 1
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same, transposed: lane l receives rows 2 (l % 4) and 2 (l % 4) + 1
// of column l / 4
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// A fragment of rows [row0, row0 + 16) x cols [col0, col0 + 16) of a tile
// stored [row][col] with pitch P
template <int P, typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* tile,
                                       int row0, int col0, int lane) {
  ldsm_x4(a, tile + (row0 + (lane & 15)) * P + col0 + 8 * (lane >> 4));
}

// B fragments of two n8 tiles (n [n0, n0 + 16)) over k [k0, k0 + 16) from
// a tile stored [n][k] (B = tile^T: K for Q K^T): r0, r1 = tile n0's b0,
// b1; r2, r3 = tile n0 + 8's
template <int P, typename T>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const T* tile,
                                          int n0, int k0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + 8 * (lane >> 4)) * P + k0 +
                 8 * ((lane >> 3) & 1));
}

// the same from a tile stored [k][n] (B = tile: V for P V)
template <int P, typename T>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const T* tile,
                                          int k0, int n0, int lane) {
  ldsm_x4_t(b, tile + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * P + n0 +
                   8 * (lane >> 4));
}

// d += a b over one m16n8k16 tile, f32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same_v<T, __half>) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    static_assert(std::is_same_v<T, __nv_bfloat16>, "bf16 or f16");
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two f32 values rounded to T, lo in the low half (the lower column)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  if constexpr (std::is_same_v<T, __half>) {
    const __half2 v = __floats2half2_rn(lo, hi);
    r = *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    r = *reinterpret_cast<const uint32_t*>(&v);
  }
  return r;
}

// two neighbouring output elements (p 4-byte aligned)
template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack2<T>(lo, hi);
}

// 2^x in one MUFU instruction (relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace mma
}  // namespace ptt
