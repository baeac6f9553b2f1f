// Paged attention for Hopper (sm_90a): serving decode over a block-table
// addressed KV pool, fp pools or int8 pools with per-row scales.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py, `_paged_kernel`
// (launched by `paged_attention`), both branches. Each query row attends the
// logical columns [0 .. pos] of its slot, where column t lives at pool row
// (block_table[slot, t / BS], t % BS); masking is `col <= pos && page < M`,
// a row with pos = -1 gives zeros, statistics and output accumulate in f32.
// The int8 branch (`quantized=True`, entry point `paged_attention_int8`)
// reads int8 K/V pools and their f32 scales [NB, BS, H, 1] (one absmax scale
// per pool row and head) and dequantizes in registers: k * k_scale per
// element before the QK product, as the TPU kernel does, and v_scale folded
// into the token's probability weight, p * v_scale, before the PV product
// (the same sum as p . (v * v_scale) in exact arithmetic; it keeps the scale
// loads out of the value loop).
//
// What bounds it on this card: bytes. A decode step reads every cached key
// and value of every slot once (8 slots x ~1k tokens x 16 heads x 64 dims x
// bf16 x {k, v} is ~33 MB, ~10 us at 3.35 TB/s) and does 4 flops per
// element read, far below the ~295 flops per byte where operations would
// bound it. The int8 branch moves 64 bytes of payload plus a 4-byte scale
// per token, head and {k, v} instead of 128 bytes: ~0.53 of the bf16 bytes.
// What this design does about that: it reads only the pages a row can see
// (the walk stops at min(M * BS, pos + 1) columns, so pages past the table
// or past pos are never loaded — the TPU kernel's clamp-and-mask of overrun
// pages without the read); each warp streams its own 16-token chunks, two
// lanes per token reading 16-byte words of one contiguous key row (128
// bytes in bf16, 64 in int8), then one value row per token; eight warps per
// block keep loads in flight and merge their partial softmax states in
// shared memory at the end. Both scales of a token are read once, by the
// two lanes that score it, beside its key row. There is no
// scalar prefetch on the card: each lane reads its token's block id from
// the table itself.
//
// Layout: q [B, s, H, D] (f32, bf16 or f16), k/v pools [NB, BS, H, D] in
// q's dtype or int8, scales [NB, BS, H, 1] f32 (int8 pools only),
// block_table [B, M] int32, positions [B, s] int32, out [B, s, H, D] in q's
// dtype (the f32 result is rounded once on store). Block ids outside
// [0, NB) are clamped, as XLA clamps the TPU kernel's gathers.
//
// Grid: (s, H, B), one block per (query row, head, slot); 256 threads.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = 16;  // tokens per warp iteration: two lanes per token

// T: the type of q and out; P: the pools' element type (T, or int8_t with
// scales)
template <typename T, typename P, int D>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q, const P* __restrict__ k_pool,
                       const P* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ block_table,
                       const int* __restrict__ positions, T* __restrict__ out,
                       int s, int H, int NB, int M, int BS, float scale) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  constexpr int HALF = D / 2;  // dims per lane when scoring
  constexpr int DL = D / 32;   // dims per lane when accumulating values
  __shared__ float sm_m[WARPS];
  __shared__ float sm_l[WARPS];
  __shared__ float sm_acc[WARPS][D];

  const int j = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int half = lane & 1;
  const int64_t row = static_cast<int64_t>(H) * D;  // one token's row
  const int pos = positions[b * s + j];
  const int n_tok = max(0, min(M * BS, pos + 1));
  const int* table = block_table + static_cast<int64_t>(b) * M;

  float qv[HALF];
  ptt::load_f32<T, HALF>(
      q + (static_cast<int64_t>(b) * s + j) * row + h * D + half * HALF, qv);

  float m = ptt::NEG_INF, l = 0.f, acc[DL];
#pragma unroll
  for (int d = 0; d < DL; ++d) acc[d] = 0.f;

  for (int t0 = warp * CHUNK; t0 < n_tok; t0 += WARPS * CHUNK) {
    const int tok = t0 + lane / 2;
    const bool valid = tok < n_tok;
    int64_t base = 0;  // element offset of this token's row for head h
    float dot = 0.f, vscale = 1.f;
    if (valid) {
      const int blk = min(max(table[tok / BS], 0), NB - 1);
      base = (static_cast<int64_t>(blk) * BS + tok % BS) * row + h * D;
      float kv[HALF];
      ptt::load_f32<P, HALF>(k_pool + base + half * HALF, kv);
      if constexpr (kQuant) {  // one scale per (pool row, head): base / D
        const float ks = k_scale[base / D];
        vscale = v_scale[base / D];
#pragma unroll
        for (int d = 0; d < HALF; ++d) kv[d] *= ks;
      }
#pragma unroll
      for (int d = 0; d < HALF; ++d) dot += qv[d] * kv[d];
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);  // both halves of a token
    const float sc = valid ? dot * scale : -INFINITY;
    float mx = sc;
#pragma unroll
    for (int off = 16; off >= 2; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);  // >= NEG_INF: finite
    const float alpha = expf(m - m_new);
    const float p = expf(sc - m_new);  // invalid: exp(-inf) = 0
    const float pw = p * vscale;       // weight of the token's value row
    float psum = half == 0 ? p : 0.f;
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int d = 0; d < DL; ++d) acc[d] *= alpha;

    // values: lane owns dims [lane * DL, lane * DL + DL) of every token
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      const float pt = __shfl_sync(0xffffffffu, pw, 2 * t);
      const int64_t bt = __shfl_sync(0xffffffffu, base, 2 * t);
      if (t0 + t < n_tok) {  // warp-uniform
        float vv[DL];
        ptt::load_f32<P, DL>(v_pool + bt + lane * DL, vv);
#pragma unroll
        for (int d = 0; d < DL; ++d) acc[d] += pt * vv[d];
      }
    }
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int d = 0; d < DL; ++d) sm_acc[warp][lane * DL + d] = acc[d];
  __syncthreads();
  if (threadIdx.x < D) {
    float mt = ptt::NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mt = fmaxf(mt, sm_m[w]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(sm_m[w] - mt);
      lt += sm_l[w] * f;
      at += sm_acc[w][threadIdx.x] * f;
    }
    const float l_safe = lt == 0.f ? 1.f : lt;  // no visible column -> zeros
    ptt::store(out + (static_cast<int64_t>(b) * s + j) * row + h * D +
                   threadIdx.x,
               at / l_safe);
  }
}

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *table, *positions;
  void* out;
  int B, s, H, NB, M, BS;
  float scale;
};

template <typename T, typename P, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.s, a.H, a.B);
  paged_attention_kernel<T, P, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const P*>(a.k_pool),
      static_cast<const P*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.table),
      static_cast<const int*>(a.positions), static_cast<T*>(a.out), a.s, a.H,
      a.NB, a.M, a.BS, a.scale);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t dispatch_d(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, P, 32>(a, stream);
    case 64: return launch<T, P, 64>(a, stream);
    case 128: return launch<T, P, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// quantized: the pools are int8 with scales, else they share q's dtype
int run(bool quantized, int dtype, int D, const Args& a, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::DTYPE_F32)
    return quantized ? dispatch_d<float, int8_t>(D, a, st)
                     : dispatch_d<float, float>(D, a, st);
  if (dtype == ptt::DTYPE_BF16)
    return quantized ? dispatch_d<__nv_bfloat16, int8_t>(D, a, st)
                     : dispatch_d<__nv_bfloat16, __nv_bfloat16>(D, a, st);
  if (dtype == ptt::DTYPE_F16)
    return quantized ? dispatch_d<__half, int8_t>(D, a, st)
                     : dispatch_d<__half, __half>(D, a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface for ctypes. dtype (of q and out): 0 = f32, 1 = bf16, 2 = f16.
// Each returns cudaGetLastError() after the launch (0 on success).

// fp pools, in q's dtype
extern "C" int paged_attention(const void* q, const void* k_pool,
                               const void* v_pool, const void* block_table,
                               const void* positions, void* out, int B, int s,
                               int H, int D, int num_blocks, int M,
                               int block_size, float scale, int dtype,
                               void* stream) {
  const Args a{q, k_pool, v_pool, nullptr, nullptr, block_table, positions,
               out, B, s, H, num_blocks, M, block_size, scale};
  return run(false, dtype, D, a, stream);
}

// int8 pools with f32 scales [num_blocks, block_size, H, 1]
extern "C" int paged_attention_int8(const void* q, const void* k_pool,
                                    const void* v_pool, const void* k_scale,
                                    const void* v_scale,
                                    const void* block_table,
                                    const void* positions, void* out, int B,
                                    int s, int H, int D, int num_blocks,
                                    int M, int block_size, float scale,
                                    int dtype, void* stream) {
  const Args a{q, k_pool, v_pool, k_scale, v_scale, block_table, positions,
               out, B, s, H, num_blocks, M, block_size, scale};
  return run(true, dtype, D, a, stream);
}
