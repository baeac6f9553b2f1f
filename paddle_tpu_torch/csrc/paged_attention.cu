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
// At decode shapes there are few (row, head, slot) triples (128 at 8 slots
// x 16 heads, against 132 SMs), so the limit in practice is how many bytes
// are in flight: the latency of each dependent load, not the memory rate.
//
// What this design does about that:
// - It reads only the pages a row can see (the walk stops at min(M * BS,
//   pos + 1) columns, so pages past the table or past pos are never loaded
//   — the TPU kernel's clamp-and-mask of overrun pages without the read).
// - Each (row, head, slot) is split across the C blocks of one thread-block
//   cluster. C is chosen on the host from shapes and the card alone, never
//   from positions (no host sync; the launch keeps one shape for a
//   fixed-shape step): the largest power of two up to 8 with which the
//   whole grid is resident at once, so no block waits for a second wave
//   (C = 2 at 8 slots x 16 heads on 132 SMs), and each rank keeps at least
//   64 columns of the table. Rank r walks the r-th contiguous share of the
//   row's visible tokens; a share is at least one pass of the block, so a
//   row that one pass covers is walked by rank 0 alone, with no barrier
//   and no merge (the other ranks return at once). Otherwise each rank
//   writes its partial (m, l, acc[D]) into rank 0's shared memory (DSMEM),
//   and rank 0 merges them in rank order by the lse rule and writes the
//   output. The cluster barrier is split in halves: every rank arrives
//   when it starts and waits only before its DSMEM write (rank 0 must have
//   started), then arrives once the write is out and waits before the
//   merge. One launch per call, no scratch tensor.
// - Inside a block, eight warps each stream their own chunks of tokens.
//   In a chunk, LPT lanes score one token (LPT = 2 at bf16 D = 64: two
//   16-byte words of the key row each) while the value lanes already load
//   that chunk's value rows (one 16-byte word of a row per lane, several
//   rows per lane): both rows of every token of the chunk are in flight at
//   once, and each lane's block id for the next chunk is read while this
//   one computes. The value lanes take each token's weight p (p * v_scale
//   for int8) from its scoring lane by a shuffle, keep f32 partial sums of
//   their words, and fold them across the warp once, after the walk. The
//   warps then merge their softmax states in shared memory.
// - There is no scalar prefetch on the card: each scoring lane reads its
//   token's block id from the table itself. Both scales of a token are
//   read beside its key row.
//
// Layout: q [B, s, H, D] (f32, bf16 or f16), k/v pools [NB, BS, H, D] in
// q's dtype or int8, scales [NB, BS, H, 1] f32 (int8 pools only),
// block_table [B, M] int32, positions [B, s] int32, out [B, s, H, D] in q's
// dtype (the f32 result is rounded once on store). Block ids outside
// [0, NB) are clamped, as XLA clamps the TPU kernel's gathers.
//
// Grid: (s * C, H, B) in clusters of (C, 1, 1): blocks C j .. C j + C - 1
// (ranks 0 .. C - 1) share query row j; 256 threads.

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int MIN_SHARE = 64;   // table columns per rank, at least

__host__ __device__ constexpr int max3(int a, int b, int c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// The walk's lane geometry for pools of element type P at head dim D.
template <typename P, int D>
struct Walk {
  static constexpr int RB = D * static_cast<int>(sizeof(P));  // row bytes
  // scoring: LPT lanes per token, each with KE elements (<= 32, <= 64 B)
  static constexpr int LPT = max3(2, D / 32, RB / 64);
  static constexpr int KE = D / LPT;
  static constexpr int KW = KE * static_cast<int>(sizeof(P)) / 16;  // words
  static constexpr int CHUNK = 32 / LPT;  // tokens per warp iteration
  // values: NC 16-byte words per row, EL elements each; lane l takes word
  // l % NC of tokens l / NC + TG i (i < VPL)
  static constexpr int NC = RB / 16;
  static constexpr int EL = 16 / static_cast<int>(sizeof(P));
  static constexpr int TG = 32 / NC;
  static constexpr int VPL = CHUNK / TG;
  static_assert(KW >= 1 && KE * static_cast<int>(sizeof(P)) % 16 == 0,
                "whole 16-byte words per scoring lane");
  static_assert(NC <= 32 && VPL >= 1 && CHUNK % TG == 0,
                "value words split evenly over the warp");
};

// The cluster barrier in its two halves (PTX barrier.cluster): arrive
// early, wait where it is needed.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the EL elements of one 16-byte word, widened to f32
template <typename P>
__device__ __forceinline__ void widen(const uint4& w, float* o) {
  const P* e = reinterpret_cast<const P*>(&w);
#pragma unroll
  for (int k = 0; k < 16 / static_cast<int>(sizeof(P)); ++k)
    o[k] = ptt::to_float(e[k]);
}

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
                       int s, int H, int NB, int M, int BS, float scale,
                       int C) {
  using W = Walk<P, D>;
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  __shared__ float sm_m[WARPS];
  __shared__ float sm_l[WARPS];
  __shared__ float sm_acc[WARPS][D];
  // rank 0: every rank's share of the row, acc[D], m, l
  __shared__ float part[MAX_CLUSTER][D + 2];

  const int j = blockIdx.x / C;
  const int rank = blockIdx.x % C;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kpart = lane % W::LPT;     // scoring: this lane's part of a key
  const int vword = lane % W::NC;      // values: this lane's word of a row
  const int vgroup = lane / W::NC;     // values: this lane's first token
  const int64_t row = static_cast<int64_t>(H) * D;  // one token's row
  const int pos = positions[b * s + j];
  const int n_tok = max(0, min(M * BS, pos + 1));
  // rank r walks tokens [r share, r share + share): whole warp chunks, and
  // at least one pass of the block, so a row that one pass covers is
  // walked by rank 0 alone, with no barrier and no merge
  const int share = max(
      ((n_tok + C - 1) / C + W::CHUNK - 1) / W::CHUNK * W::CHUNK,
      WARPS * W::CHUNK);
  const bool split = n_tok > share;  // the same in every rank of the cluster
  if (!split && rank > 0) return;
  if (split) cluster_arrive_relaxed();  // this block has started
  const int begin = rank * share;
  const int end = min(n_tok, begin + share);
  const int* table = block_table + static_cast<int64_t>(b) * M;

  float qv[W::KE];
  ptt::load_f32<T, W::KE>(
      q + (static_cast<int64_t>(b) * s + j) * row + h * D + kpart * W::KE,
      qv);

  float m = ptt::NEG_INF, l = 0.f, acc[W::EL];
#pragma unroll
  for (int e = 0; e < W::EL; ++e) acc[e] = 0.f;

  // each lane's token block id is read one chunk ahead
  int blk_next = 0;
  if (begin + warp * W::CHUNK + lane / W::LPT < end)
    blk_next = table[(begin + warp * W::CHUNK + lane / W::LPT) / BS];
  for (int t0 = begin + warp * W::CHUNK; t0 < end;
       t0 += WARPS * W::CHUNK) {
    // every key and value row of the chunk in flight together
    const int tok = t0 + lane / W::LPT;
    const bool valid = tok < end;
    int64_t base = h * D;  // element offset of this token's row for head h
    if (valid) {
      const int blk = min(max(blk_next, 0), NB - 1);
      base += (static_cast<int64_t>(blk) * BS + tok % BS) * row;
    }
    if (tok + WARPS * W::CHUNK < end)
      blk_next = table[(tok + WARPS * W::CHUNK) / BS];
    uint4 kraw[W::KW];
#pragma unroll
    for (int w = 0; w < W::KW; ++w)
      kraw[w] = reinterpret_cast<const uint4*>(k_pool + base +
                                               kpart * W::KE)[w];
    uint4 vraw[W::VPL];
#pragma unroll
    for (int i = 0; i < W::VPL; ++i) {
      const int tk = vgroup + W::TG * i;  // token of the chunk
      const int64_t vb = __shfl_sync(0xffffffffu, base, tk * W::LPT);
      vraw[i] = t0 + tk < end
                    ? *reinterpret_cast<const uint4*>(v_pool + vb +
                                                      vword * W::EL)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
    float ks = 1.f, vscale = 1.f;
    if constexpr (kQuant) {  // one scale per (pool row, head): base / D
      if (valid) {
        ks = k_scale[base / D];
        vscale = v_scale[base / D];
      }
    }

    float kv[W::KE];
#pragma unroll
    for (int w = 0; w < W::KW; ++w) widen<P>(kraw[w], kv + w * W::EL);
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < W::KE; ++d) {
      if constexpr (kQuant) kv[d] *= ks;
      dot += qv[d] * kv[d];
    }
#pragma unroll
    for (int off = 1; off < W::LPT; off <<= 1)  // the lanes of a token
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    const float sc = valid ? dot * scale : -INFINITY;
    float mx = sc;
#pragma unroll
    for (int off = 16; off >= W::LPT; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);  // >= NEG_INF: finite
    const float alpha = expf(m - m_new);
    const float p = expf(sc - m_new);  // invalid: exp(-inf) = 0
    const float pw = p * vscale;       // weight of the token's value row
    float psum = kpart == 0 ? p : 0.f;
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int e = 0; e < W::EL; ++e) acc[e] *= alpha;
#pragma unroll
    for (int i = 0; i < W::VPL; ++i) {
      const float pt =
          __shfl_sync(0xffffffffu, pw, (vgroup + W::TG * i) * W::LPT);
      float vv[W::EL];
      widen<P>(vraw[i], vv);
#pragma unroll
      for (int e = 0; e < W::EL; ++e) acc[e] += pt * vv[e];
    }
  }

  // fold the value lanes' token groups: lanes < NC then hold the warp's sum
#pragma unroll
  for (int off = W::NC; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < W::EL; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  if (lane < W::NC) {
#pragma unroll
    for (int e = 0; e < W::EL; ++e) sm_acc[warp][lane * W::EL + e] = acc[e];
  }
  __syncthreads();

  // this block's share: the warps merged by the lse rule
  const int d = threadIdx.x;
  float mt = ptt::NEG_INF, lt = 0.f, at = 0.f;
  if (d < D) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mt = fmaxf(mt, sm_m[w]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(sm_m[w] - mt);
      lt += sm_l[w] * f;
      at += sm_acc[w][d] * f;
    }
  }
  if (split) {
    // every rank's share goes to rank 0's shared memory, which merges them
    // in rank order, as the warps were merged
    cg::cluster_group cluster = cg::this_cluster();
    cluster_wait();  // every block of the cluster has started
    float* dst = cluster.map_shared_rank(&part[0][0], 0) + rank * (D + 2);
    if (d < D) dst[d] = at;
    if (d == 0) {
      dst[D] = mt;
      dst[D + 1] = lt;
    }
    cluster_arrive_release();
    cluster_wait();  // every share has landed
    if (rank == 0 && d < D) {
      mt = ptt::NEG_INF;
      for (int r = 0; r < C; ++r) mt = fmaxf(mt, part[r][D]);
      lt = 0.f;
      at = 0.f;
      for (int r = 0; r < C; ++r) {
        const float f = expf(part[r][D] - mt);
        lt += part[r][D + 1] * f;
        at += part[r][d] * f;
      }
    }
  }
  if (rank == 0 && d < D) {
    const float l_safe = lt == 0.f ? 1.f : lt;  // no visible column -> zeros
    ptt::store(out + (static_cast<int64_t>(b) * s + j) * row + h * D + d,
               at / l_safe);
  }
}

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *table, *positions;
  void* out;
  int B, s, H, NB, M, BS;
  float scale;
};

// How many blocks of a cluster split one (row, head, slot): the largest
// power of two up to 8 with which the whole grid is resident at once (one
// wave: SMs x this kernel's blocks per SM, from the occupancy calculator,
// read once) and each rank keeps at least MIN_SHARE of the table's M * BS
// columns. Shapes and the card only, never positions: no host sync, and
// the launch keeps one shape for a fixed-shape step.
template <typename T, typename P, int D>
int cluster_size(int blocks, int M, int BS) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, paged_attention_kernel<T, P, D>, THREADS, 0);
    resident = max(1, sms * per_sm);
  }
  int c = 1;
  while (c < MAX_CLUSTER && c * MIN_SHARE < M * BS &&
         2 * c * blocks <= resident)
    c *= 2;
  return c;
}

template <typename T, typename P, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int C = cluster_size<T, P, D>(a.B * a.s * a.H, a.M, a.BS);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.s * C, a.H, a.B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, paged_attention_kernel<T, P, D>, static_cast<const T*>(a.q),
      static_cast<const P*>(a.k_pool), static_cast<const P*>(a.v_pool),
      static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.table),
      static_cast<const int*>(a.positions), static_cast<T*>(a.out), a.s, a.H,
      a.NB, a.M, a.BS, a.scale, C);
  if (err != cudaSuccess) return err;
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

// The cluster size that paged_attention (quantized = 0) or
// paged_attention_int8 (quantized = 1) launches with at these shapes, for
// reports; -1 for a dtype or head dim the kernel is not built for.
extern "C" int paged_attention_cluster_size(int B, int s, int H, int D,
                                            int M, int block_size, int dtype,
                                            int quantized) {
  const int blocks = B * s * H;
  auto pick = [&](auto t, auto p) -> int {
    using T = decltype(t);
    using P = decltype(p);
    switch (D) {
      case 32: return cluster_size<T, P, 32>(blocks, M, block_size);
      case 64: return cluster_size<T, P, 64>(blocks, M, block_size);
      case 128: return cluster_size<T, P, 128>(blocks, M, block_size);
      default: return -1;
    }
  };
  if (dtype == ptt::DTYPE_F32)
    return quantized ? pick(float{}, int8_t{}) : pick(float{}, float{});
  if (dtype == ptt::DTYPE_BF16)
    return quantized ? pick(__nv_bfloat16{}, int8_t{})
                     : pick(__nv_bfloat16{}, __nv_bfloat16{});
  if (dtype == ptt::DTYPE_F16)
    return quantized ? pick(__half{}, int8_t{}) : pick(__half{}, __half{});
  return -1;
}
