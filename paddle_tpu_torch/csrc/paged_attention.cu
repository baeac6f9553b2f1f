// Paged attention for Hopper (sm_90a): serving decode over a block-table
// addressed KV pool.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py, `_paged_kernel`
// (launched by `paged_attention`), fp pools — each query row attends the
// logical columns [0 .. pos] of its slot, where column t lives at pool row
// (block_table[slot, t / BS], t % BS); masking is `col <= pos && page < M`,
// a row with pos = -1 gives zeros, statistics and output accumulate in f32.
//
// What bounds it on this card: bytes. A decode step reads every cached key
// and value of every slot once (8 slots x ~1k tokens x 16 heads x 64 dims x
// bf16 x {k, v} is ~33 MB, ~10 us at 3.35 TB/s) and does 4 flops per
// element read, far below the ~295 flops per byte where operations would
// bound it. What this design does about that: it reads only the pages a row
// can see (the walk stops at min(M * BS, pos + 1) columns, so pages past the
// table or past pos are never loaded — the TPU kernel's clamp-and-mask of
// overrun pages without the read); each warp streams its own 16-token
// chunks, two lanes per token reading 16-byte words of one contiguous
// 128-byte key row, then one 128-byte value row per token; eight warps per
// block keep loads in flight and merge their partial softmax states in
// shared memory at the end. There is no scalar prefetch on the card: each
// lane reads its token's block id from the table itself.
//
// Layout: q [B, s, H, D], k/v pools [NB, BS, H, D], block_table [B, M] int32,
// positions [B, s] int32, out [B, s, H, D] in q's dtype (the f32 result is
// rounded once on store). Block ids outside [0, NB) are clamped, as XLA
// clamps the TPU kernel's gathers.
//
// Grid: (s, H, B), one block per (query row, head, slot); 256 threads.

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = 16;  // tokens per warp iteration: two lanes per token

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ block_table,
                       const int* __restrict__ positions, T* __restrict__ out,
                       int s, int H, int NB, int M, int BS, float scale) {
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
    float dot = 0.f;
    if (valid) {
      const int blk = min(max(table[tok / BS], 0), NB - 1);
      base = (static_cast<int64_t>(blk) * BS + tok % BS) * row + h * D;
      float kv[HALF];
      ptt::load_f32<T, HALF>(k_pool + base + half * HALF, kv);
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
      const float pt = __shfl_sync(0xffffffffu, p, 2 * t);
      const int64_t bt = __shfl_sync(0xffffffffu, base, 2 * t);
      if (t0 + t < n_tok) {  // warp-uniform
        float vv[DL];
        ptt::load_f32<T, DL>(v_pool + bt + lane * DL, vv);
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* table, const void* positions, void* out, int B,
                   int s, int H, int NB, int M, int BS, float scale,
                   cudaStream_t stream) {
  const dim3 grid(s, H, B);
  paged_attention_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(positions), static_cast<T*>(out), s, H, NB, M,
      BS, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k_pool,
                       const void* v_pool, const void* table,
                       const void* positions, void* out, int B, int s, int H,
                       int NB, int M, int BS, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k_pool, v_pool, table, positions, out, B, s, H, NB, M, BS, scale, stream);
    case 64: return launch<T, 64>(q, k_pool, v_pool, table, positions, out, B, s, H, NB, M, BS, scale, stream);
    case 128: return launch<T, 128>(q, k_pool, v_pool, table, positions, out, B, s, H, NB, M, BS, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface for ctypes. dtype: 0 = f32, 1 = bf16 (q, pools and out share
// it). Returns cudaGetLastError() after the launch (0 on success).
extern "C" int paged_attention(const void* q, const void* k_pool,
                               const void* v_pool, const void* block_table,
                               const void* positions, void* out, int B, int s,
                               int H, int D, int num_blocks, int M,
                               int block_size, float scale, int dtype,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::DTYPE_F32)
    return dispatch_d<float>(D, q, k_pool, v_pool, block_table, positions,
                             out, B, s, H, num_blocks, M, block_size, scale,
                             st);
  if (dtype == ptt::DTYPE_BF16)
    return dispatch_d<__nv_bfloat16>(D, q, k_pool, v_pool, block_table,
                                     positions, out, B, s, H, num_blocks, M,
                                     block_size, scale, st);
  return cudaErrorInvalidValue;
}
