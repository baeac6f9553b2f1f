// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the tile geometry, the tile loader, the causal / sliding-window band test
// and the dropout hash.
#pragma once

#include "common.cuh"

namespace ptt {
namespace flash {

constexpr int BQ = 64;       // q rows per tile
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 128;

// pitch of Q / K / V / dO rows in shared memory: 16-byte aligned rows that
// give conflict-free float4 reads when 8 lanes read 8 different rows
__host__ __device__ constexpr int qk_pitch(int d) { return d + 4; }

// Copy 64 rows of D elements (row stride `stride` elements) into shared
// memory as f32 with row pitch `pitch`; rows >= valid_rows become zeros so
// masked entries never multiply stale memory.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const T* __restrict__ src,
                                          int64_t stride, int valid_rows) {
  constexpr int N = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int PER_ROW = D / N;
  for (int idx = threadIdx.x; idx < 64 * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * N;
    float v[N];
    if (r < valid_rows) {
      load_f32<T, N>(src + r * stride + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(&dst[r * pitch + c + i]) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// Whether (row, col) is visible: inside the key range, and, when causal, on
// or below the diagonal and (window > 0) at most `window` rows behind it
// (ops/pallas/flash_attention.py `_band_mask`).
__device__ __forceinline__ bool visible(int row, int col, int Sk, int causal,
                                        int window) {
  if (col >= Sk) return false;
  if (!causal) return true;
  return col <= row && (window <= 0 || row - col <= window);
}

// Attention-probability dropout, regenerated from the seed in every kernel
// (ops/pallas/flash_attention.py `_dropout_keep`): a murmur3 finalizer over
// the absolute (batch, head, row, col) position and the seed, in uint32
// arithmetic; an entry is kept when the hash is >= thresh. The mask depends
// on positions only, never on tile sizes.
struct Dropout {
  int on;            // 0: no dropout
  unsigned thresh;   // min(int(p * 2^32), 2^32 - 1)
  float inv_keep;    // 1 / (1 - p), rounded to f32
  unsigned mix;      // b * 1315423911 + h * 2654435761 + seed * 0x9E3779B9

  __device__ __forceinline__ void set_block(unsigned seed, int b, int h) {
    mix = static_cast<unsigned>(b) * 1315423911u +
          static_cast<unsigned>(h) * 2654435761u + seed * 0x9E3779B9u;
  }

  // the row's and the column's factors of the hash, for callers that
  // reuse them across a tile
  static __device__ __forceinline__ unsigned row_term(int row) {
    return static_cast<unsigned>(row) * 2654435761u;
  }
  static __device__ __forceinline__ unsigned col_term(int col) {
    return static_cast<unsigned>(col) * 0x85EBCA6Bu;
  }

  __device__ __forceinline__ bool keep(int row, int col) const {
    return keep_terms(row_term(row), col_term(col));
  }

  __device__ __forceinline__ bool keep_terms(unsigned rt, unsigned ct) const {
    unsigned x = (rt ^ ct) + mix;
    x ^= x >> 16;
    x *= 0x7FEB352Du;
    x ^= x >> 15;
    x *= 0x846CA68Bu;
    x ^= x >> 16;
    return x >= thresh;
  }
};

}  // namespace flash
}  // namespace ptt
