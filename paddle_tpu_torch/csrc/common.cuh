// Shared helpers of the port's CUDA kernels: element types, vector loads
// converted to f32, stores from f32, and the error string every library
// exports for its Python wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ptt {

// Masked-entry sentinel of the TPU kernels (ops/pallas/flash_attention.py
// NEG_INF): a finite floor for the running max, so m - m_new is never
// -inf - -inf.
constexpr float NEG_INF = -1e30f;

// dtype codes shared with the Python wrappers
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;
constexpr int DTYPE_F16 = 2;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
// int8 payloads of the quantized KV pools (exact in f32)
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half(v);
}

// Load N consecutive elements at p (aligned to the widest word that
// divides N * sizeof(T), up to 16 bytes) and widen them to f32.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float* o) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  using W = std::conditional_t<
      kBytes % 16 == 0, uint4,
      std::conditional_t<
          kBytes % 8 == 0, uint2,
          std::conditional_t<kBytes % 4 == 0, unsigned int,
                             std::conditional_t<kBytes % 2 == 0,
                                                unsigned short, T>>>>;
  constexpr int kWords = kBytes / static_cast<int>(sizeof(W));
  constexpr int kPer = static_cast<int>(sizeof(W) / sizeof(T));
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const W w = reinterpret_cast<const W*>(p)[i];
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int k = 0; k < kPer; ++k) o[i * kPer + k] = to_float(e[k]);
  }
}

}  // namespace ptt

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
