// Flash attention backward for Hopper (sm_90a): two kernels, as on the TPU.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py, `_dkv_kernel` and
// `_dq_kernel` (both launched by `_bwd`). Each recomputes the probabilities
// p = exp(s - lse) of a (q tile, KV tile) pair from the forward's row
// log-sum-exp, regenerates the forward's dropout mask from the seed (the
// same position hash, flash_common.cuh), and forms
//   dP = dO V^T  (dropped entries zeroed, kept ones scaled by 1 / (1 - p)),
//   dS = p (dP - delta) * scale,   delta = rowsum(dO * O) from the wrapper;
// `flash_bwd_dkv` sums dV += p_drop^T dO and dK += dS^T Q over the q tiles
// of one KV tile, `flash_bwd_dq` sums dQ += dS K over the KV tiles of one q
// tile. Each output element is owned by one thread of one block and summed
// in f32 registers in a fixed order: no atomics, so the result is the same
// on every run.
//
// What bounds it on this card: at the training shape (ERNIE-base, 32 x 12
// heads x 512 x 64, bf16) the two kernels do 7 products of 64 x 64 x 64
// tiles per tile pair (4 in dkv, 3 in dq; the least work for the gradients
// is 5), 90 GFLOP per layer, against ~150 MB of traffic: at the bf16
// tensor-core rate the operations take ~0.05-0.07 ms per kernel and the
// bytes less. Beside the products each entry pays for an exponential and,
// with dropout, the 12-instruction integer hash.
//
// What the design does about it (bf16 and f16 inputs): both kernels run
// their products on the tensor cores (mma.sync.m16n8k16, f32 accumulators,
// fragments through ldmatrix) with 4 warps per block, tiles in shared
// memory in their 16-bit type (rows padded by 16 bytes: ldmatrix without
// bank conflicts), the next tiles copied with 16-byte cp.async into a
// second buffer while this tile's products run, and p, dropout and dS
// formed on the accumulators in registers, where each lane knows its (row,
// key) from the C layout (mma.cuh), so the hash is taken at the same
// absolute positions as Dropout::keep. Only tiles that cross the diagonal,
// the window edge or the ragged key edge pay for the mask; tiles outside
// the causal / window band are never loaded. The one rounding the f32
// kernels do not make is p's and dS's, to the input type, before the
// second products.
//
// - flash_bwd_dkv_mma_kernel: one block per 64-key tile, each warp owning
//   16 keys, K and V resident; the block walks the q tiles of the band with
//   Q, dO and the rows' lse (base 2) and delta double-buffered. Each warp
//   computes the transposed tiles S^T = K Q^T and dP^T = V dO^T (Q and dO
//   as B operands), 32 q rows at a time (16 at D = 128), so that the dK and
//   dV accumulators (16 keys x D each per warp) and the tiles fit without
//   spills. P^T and dS^T, rounded to the input type, are then already the
//   A operands of dV += P^T dO and dK += dS^T Q (dO and Q through
//   ldmatrix.trans).
// - flash_bwd_dq_mma_kernel: the forward's shape. One block per 64-row q
//   tile, each warp owning 16 q rows; Q and dO resident (their A fragments
//   kept in registers at D <= 64, re-read from shared memory at D = 128 to
//   stay clear of spills), the rows' lse (base 2) and delta in registers,
//   K, V and the kv_bias of the KV tiles double-buffered. Each warp forms
//   S = Q K^T and dP = dO V^T for its 16 rows, 32 keys at a time (K and V
//   as B operands), then dS = p (dP - delta) scale, rounded once to the
//   input type: the C fragments of two n8 key tiles are the A fragment of
//   one k16 slice of dQ += dS K (K's B fragments through ldmatrix.trans),
//   so dS never touches shared memory.
//
// f32 inputs take the CUDA-core kernels (flash_bwd_dkv_f32_kernel,
// flash_bwd_dq_f32_kernel: f32 FMAs, tiles widened to f32 in shared memory,
// each thread computing a 4 x 8 patch of s and dP from conflict-free
// 16-byte shared loads, p and dS through shared memory), which keep full
// f32 where tensor cores would give TF32.
//
// Layout: q, dout [B, Sq, H, D]; k, v [B, Sk, H, D] (contiguous, one dtype:
// f32, bf16 or f16); kv_bias [B, Sk] f32 or null; lse, delta [B, H, Sq] f32;
// dq like q, dk and dv like k. kv_bias takes no gradient. Rows whose every
// entry is masked have lse = NEG_INF in the forward and give zero gradients
// here.
//
// Grid: (ceil(Sk / 64) for dkv or ceil(Sq / 64) for dq, H, B); 128 threads.
// Tensor-core dkv: warp w owns keys 16w..16w+15 of the tile; lane (g =
// lane / 4, t = lane % 4) holds keys 16w+g and 16w+g+8, q rows 8j+2t,
// 8j+2t+1 of each 32-row (D = 128: 16-row) step, and output dims 8j+2t,
// 8j+2t+1 (j < D / 8). Tensor-core dq: warp w owns q rows 16w..16w+15;
// lane (g, t) holds rows 16w+g and 16w+g+8, keys 8j+2t, 8j+2t+1 of each
// 32-key step and output dims 8j+2t, 8j+2t+1 (j < D / 8).
// CUDA-core kernels: thread t computes the s / dP entries (rows r + 16i,
// cols c + 8j) with r = t / 8, c = t % 8, i < 4, j < 8, and owns output
// rows r + 16i, dims c + 8j (j < D / 8) of its block's tile.

#include "flash_common.cuh"
#include "mma.cuh"

namespace {

using namespace ptt::flash;

constexpr int TP = BQ + 4;  // pitch of the transposed p / dS tiles (dkv)
constexpr int SP = BK + 8;  // pitch of the dS tile (dq)

template <int D>
constexpr size_t dkv_f32_smem_bytes() {
  return sizeof(float) *
         (4 * static_cast<size_t>(64) * qk_pitch(D) +  // Ks Vs Qs dOs
          2 * static_cast<size_t>(BK) * TP +          // PT dST
          2 * BQ + BK);                                // Ls Dl Bs
}

template <int D>
constexpr size_t dq_f32_smem_bytes() {
  return sizeof(float) *
         (4 * static_cast<size_t>(64) * qk_pitch(D) +  // Qs dOs Ks Vs
          static_cast<size_t>(BQ) * SP +              // dSs
          BK);                                         // Bs
}

// s = Q K^T and dP = dO V^T for the thread's 4 x 8 patch; rows read from
// A (Q) and G (dO), columns from Kt (K) and Vt (V), all with pitch QP.
template <int D>
__device__ __forceinline__ void patch_products(const float* As,
                                               const float* Gs,
                                               const float* Kt,
                                               const float* Vt, int r,
                                               int c, float (&s)[4][8],
                                               float (&dp)[4][8]) {
  constexpr int QP = qk_pitch(D);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 av[4], gv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = *reinterpret_cast<const float4*>(&As[(r + 16 * i) * QP + d]);
      gv[i] = *reinterpret_cast<const float4*>(&Gs[(r + 16 * i) * QP + d]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 kv = *reinterpret_cast<const float4*>(&Kt[(c + 8 * j) * QP + d]);
      const float4 vv = *reinterpret_cast<const float4*>(&Vt[(c + 8 * j) * QP + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][j] += av[i].x * kv.x + av[i].y * kv.y + av[i].z * kv.z +
                   av[i].w * kv.w;
        dp[i][j] += gv[i].x * vv.x + gv[i].y * vv.y + gv[i].z * vv.z +
                    gv[i].w * vv.w;
      }
    }
  }
}

// p and dS of one entry from its raw score and dO.V^T value; pd is p after
// dropout (what dV takes).
__device__ __forceinline__ void entry_grads(float s, float dp, bool vis,
                                            float bias, float lse,
                                            float delta, float scale,
                                            const Dropout& drop, int row,
                                            int col, float& pd, float& ds) {
  const float x = vis ? s * scale + bias : -INFINITY;
  const float p = expf(x - lse);  // masked or padded row: 0
  pd = p;
  if (drop.on) {
    if (drop.keep(row, col)) {
      pd = p * drop.inv_keep;
      dp *= drop.inv_keep;
    } else {
      pd = 0.f;
      dp = 0.f;
    }
  }
  ds = p * (dp - delta) * scale;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const float* __restrict__ kv_bias,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Sk, int H, float scale,
                     int causal, int window, unsigned seed, Dropout drop) {
  constexpr int QP = qk_pitch(D);
  constexpr int DJ = D / 8;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * QP;
  float* Qs = Vs + BK * QP;
  float* dOs = Qs + BQ * QP;
  float* PT = dOs + BQ * QP;   // [key][q row]: p after dropout
  float* dST = PT + BK * TP;   // [key][q row]: dS
  float* Ls = dST + BK * TP;
  float* Dl = Ls + BQ;
  float* Bs = Dl + BQ;

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid / 8;
  const int c = tid % 8;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t stat = (static_cast<int64_t>(b) * H + h) * Sq;
  const int kvalid = min(BK, Sk - k0);
  drop.set_block(seed, b, h);

  const int64_t kv_off = (static_cast<int64_t>(b) * Sk + k0) * stride + h * D;
  load_tile<T, D>(Ks, QP, k + kv_off, stride, kvalid);
  load_tile<T, D>(Vs, QP, v + kv_off, stride, kvalid);
  if (tid < BK)
    Bs[tid] = (kv_bias != nullptr && tid < kvalid)
                  ? kv_bias[static_cast<int64_t>(b) * Sk + k0 + tid]
                  : 0.f;

  float adk[4][DJ], adv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  // q tiles holding any visible entry of this KV tile (`_block_runs`)
  const int nq = (Sq + BQ - 1) / BQ;
  int q_begin = 0;
  int q_end = nq;
  if (causal) {
    q_begin = k0 / BQ;
    if (window > 0) q_end = min(nq, (k0 + BK - 1 + window) / BQ + 1);
  }

  for (int iq = q_begin; iq < q_end; ++iq) {
    const int q0 = iq * BQ;
    const int qvalid = min(BQ, Sq - q0);
    __syncthreads();  // the previous tile's Qs / dOs / PT / dST are consumed
    const int64_t q_off = (static_cast<int64_t>(b) * Sq + q0) * stride + h * D;
    load_tile<T, D>(Qs, QP, q + q_off, stride, qvalid);
    load_tile<T, D>(dOs, QP, dout + q_off, stride, qvalid);
    if (tid < BQ) {
      // padded rows: lse = +inf makes p = 0, so they add nothing
      Ls[tid] = tid < qvalid ? lse[stat + q0 + tid] : INFINITY;
      Dl[tid] = tid < qvalid ? delta[stat + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[4][8], dp[4][8];
    patch_products<D>(Qs, dOs, Ks, Vs, r, c, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = r + 16 * i;
      const int row = q0 + rr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cc = c + 8 * j;
        const int col = k0 + cc;
        float pd, ds;
        entry_grads(s[i][j], dp[i][j], visible(row, col, Sk, causal, window),
                    Bs[cc], Ls[rr], Dl[rr], scale, drop, row, col, pd, ds);
        PT[cc * TP + rr] = pd;
        dST[cc * TP + rr] = ds;
      }
    }
    __syncthreads();

    // dV[key] += sum_q p_drop[q, key] dO[q];  dK[key] += sum_q dS[q, key] Q[q]
#pragma unroll 2
    for (int qq = 0; qq < BQ; qq += 4) {
      float4 pv[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(&PT[(r + 16 * i) * TP + qq]);
        sv[i] = *reinterpret_cast<const float4*>(&dST[(r + 16 * i) * TP + qq]);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float go[DJ], qv[DJ];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          go[j] = dOs[(qq + t) * QP + c + 8 * j];
          qv[j] = Qs[(qq + t) * QP + c + 8 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = t == 0 ? pv[i].x : t == 1 ? pv[i].y
                        : t == 2 ? pv[i].z : pv[i].w;
          const float g = t == 0 ? sv[i].x : t == 1 ? sv[i].y
                        : t == 2 ? sv[i].z : sv[i].w;
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            adv[i][j] += p * go[j];
            adk[i][j] += g * qv[j];
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + r + 16 * i;
    if (key >= Sk) continue;
    const int64_t off = (static_cast<int64_t>(b) * Sk + key) * stride + h * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      ptt::store(dk + off + c + 8 * j, adk[i][j]);
      ptt::store(dv + off + c + 8 * j, adv[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ kv_bias,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Sq, int Sk, int H, float scale, int causal,
                        int window, unsigned seed, Dropout drop) {
  constexpr int QP = qk_pitch(D);
  constexpr int DJ = D / 8;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BQ * QP;
  float* Ks = dOs + BQ * QP;
  float* Vs = Ks + BK * QP;
  float* dSs = Vs + BK * QP;  // [q row][key]
  float* Bs = dSs + BQ * SP;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid / 8;
  const int c = tid % 8;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t stat = (static_cast<int64_t>(b) * H + h) * Sq;
  const int qvalid = min(BQ, Sq - q0);
  drop.set_block(seed, b, h);

  const int64_t q_off = (static_cast<int64_t>(b) * Sq + q0) * stride + h * D;
  load_tile<T, D>(Qs, QP, q + q_off, stride, qvalid);
  load_tile<T, D>(dOs, QP, dout + q_off, stride, qvalid);
  float row_lse[4], row_delta[4], adq[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = r + 16 * i;
    row_lse[i] = rr < qvalid ? lse[stat + q0 + rr] : INFINITY;
    row_delta[i] = rr < qvalid ? delta[stat + q0 + rr] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) adq[i][j] = 0.f;
  }

  int kv_begin = 0;
  int kv_end = (Sk + BK - 1) / BK;
  if (causal) {
    kv_end = min(kv_end, (q0 + BQ - 1) / BK + 1);
    if (window > 0 && q0 > window) kv_begin = (q0 - window) / BK;
  }

  for (int ik = kv_begin; ik < kv_end; ++ik) {
    const int k0 = ik * BK;
    const int kvalid = min(BK, Sk - k0);
    __syncthreads();  // the previous tile's Ks / Vs / dSs are consumed
    const int64_t kv_off = (static_cast<int64_t>(b) * Sk + k0) * stride + h * D;
    load_tile<T, D>(Ks, QP, k + kv_off, stride, kvalid);
    load_tile<T, D>(Vs, QP, v + kv_off, stride, kvalid);
    if (tid < BK)
      Bs[tid] = (kv_bias != nullptr && tid < kvalid)
                    ? kv_bias[static_cast<int64_t>(b) * Sk + k0 + tid]
                    : 0.f;
    __syncthreads();

    float s[4][8], dp[4][8];
    patch_products<D>(Qs, dOs, Ks, Vs, r, c, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + r + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cc = c + 8 * j;
        const int col = k0 + cc;
        float pd, ds;
        entry_grads(s[i][j], dp[i][j], visible(row, col, Sk, causal, window),
                    Bs[cc], row_lse[i], row_delta[i], scale, drop, row, col,
                    pd, ds);
        dSs[(r + 16 * i) * SP + cc] = ds;
      }
    }
    __syncthreads();

    // dQ[q] += sum_key dS[q, key] K[key]
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sv[i] = *reinterpret_cast<const float4*>(&dSs[(r + 16 * i) * SP + kk]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float kv[DJ];
#pragma unroll
        for (int j = 0; j < DJ; ++j) kv[j] = Ks[(kk + t) * QP + c + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float g = t == 0 ? sv[i].x : t == 1 ? sv[i].y
                        : t == 2 ? sv[i].z : sv[i].w;
#pragma unroll
          for (int j = 0; j < DJ; ++j) adq[i][j] += g * kv[j];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r + 16 * i;
    if (row >= Sq) continue;
    T* o = dq + (static_cast<int64_t>(b) * Sq + row) * stride + h * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) ptt::store(o + c + 8 * j, adq[i][j]);
  }
}

// ------------------------------------------ tensor cores: dK/dV, bf16, f16 --

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  // K, V, then Q and dO in two buffers each (16-bit, padded rows); then
  // the rows' lse (base 2) and delta, two buffers each
  return 2 * static_cast<size_t>(2 * BK + 4 * BQ) * ptt::mma::tile_pitch(D) +
         sizeof(float) * 4 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ kv_bias,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int Sq, int Sk, int H,
                         float scale, int causal, int window, unsigned seed,
                         Dropout drop) {
  using namespace ptt::mma;
  constexpr int P = tile_pitch(D);
  constexpr int KS = D / 16;  // k16 slices of K Q^T and V dO^T
  constexpr int DN = D / 8;   // n8 tiles of a dK / dV row
  // q rows per product step: at D = 128 the dK and dV accumulators take
  // 128 registers a lane, so the step's S^T / dP^T tiles shrink to 16 rows
  constexpr int QC = D >= 128 ? 16 : 32;
  constexpr int NJ = QC / 8;  // n8 tiles of a step's S^T row
  extern __shared__ float4 smem4[];
  T* Ks = reinterpret_cast<T*>(smem4);
  T* Vs = Ks + BK * P;
  T* Qs = Vs + BK * P;        // [2][BQ][P]
  T* dOs = Qs + 2 * BQ * P;   // [2][BQ][P]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * P);  // [2][BQ]
  float* Dl = Ls + 2 * BQ;                                 // [2][BQ]

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t stat = (static_cast<int64_t>(b) * H + h) * Sq;
  const int kvalid = min(BK, Sk - k0);
  const float sl2 = scale * kLog2e;  // scores in base 2
  drop.set_block(seed, b, h);

  // this lane's keys: key0 and key0 + 8; their bias (base 2) and hash terms
  const int key0 = k0 + warp * 16 + g;
  float bias2[2] = {0.f, 0.f};
  unsigned ct[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (kv_bias != nullptr && key < Sk)
      bias2[i] = kv_bias[static_cast<int64_t>(b) * Sk + key] * kLog2e;
    ct[i] = Dropout::col_term(key);
  }

  // q tiles holding any visible entry of this KV tile (`_block_runs`)
  const int nq = (Sq + BQ - 1) / BQ;
  int q_begin = 0;
  int q_end = nq;
  if (causal) {
    q_begin = k0 / BQ;
    if (window > 0) q_end = min(nq, (k0 + BK - 1 + window) / BQ + 1);
  }

  // start copying q tile iq (Q, dO, lse, delta) into buffer buf
  auto fetch = [&](int iq, int buf) {
    const int q0 = iq * BQ;
    const int qvalid = min(BQ, Sq - q0);
    const int64_t q_off = (static_cast<int64_t>(b) * Sq + q0) * stride + h * D;
    load_tile_async<T, D, BQ, THREADS>(Qs + buf * BQ * P, q + q_off, stride,
                                       qvalid);
    load_tile_async<T, D, BQ, THREADS>(dOs + buf * BQ * P, dout + q_off,
                                       stride, qvalid);
    if (tid < BQ) {
      // padded rows: lse = +inf makes p = 0, so they add nothing
      Ls[buf * BQ + tid] =
          tid < qvalid ? lse[stat + q0 + tid] * kLog2e : INFINITY;
      Dl[buf * BQ + tid] = tid < qvalid ? delta[stat + q0 + tid] : 0.f;
    }
  };

  const int64_t kv_off = (static_cast<int64_t>(b) * Sk + k0) * stride + h * D;
  load_tile_async<T, D, BK, THREADS>(Ks, k + kv_off, stride, kvalid);
  load_tile_async<T, D, BK, THREADS>(Vs, v + kv_off, stride, kvalid);
  if (q_begin < q_end) fetch(q_begin, 0);
  cp_async_commit();

  float adk[DN][4], adv[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;

  for (int iq = q_begin; iq < q_end; ++iq) {
    const int buf = (iq - q_begin) & 1;
    if (iq + 1 < q_end) fetch(iq + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just started has landed
    __syncthreads();
    const T* Qt = Qs + buf * BQ * P;
    const T* Gt = dOs + buf * BQ * P;
    const float* Lt = Ls + buf * BQ;
    const float* Dt = Dl + buf * BQ;
    const int q0 = iq * BQ;
    const bool edge =
        k0 + BK > Sk ||
        (causal && (k0 + BK - 1 > q0 ||
                    (window > 0 && q0 + BQ - 1 - k0 > window)));

#pragma unroll 1
    for (int qc = 0; qc < BQ; qc += QC) {
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x QC rows
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ka[4], va[4];
        load_a<P>(ka, Ks, warp * 16, ks * 16, lane);
        load_a<P>(va, Vs, warp * 16, ks * 16, lane);
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) {
          uint32_t qf[4], gf[4];
          load_b_nk<P>(qf, Qt, qc + jp * 16, ks * 16, lane);
          load_b_nk<P>(gf, Gt, qc + jp * 16, ks * 16, lane);
          mma16816<T>(s[2 * jp], ka, qf[0], qf[1]);
          mma16816<T>(s[2 * jp + 1], ka, qf[2], qf[3]);
          mma16816<T>(dp[2 * jp], va, gf[0], gf[1]);
          mma16816<T>(dp[2 * jp + 1], va, gf[2], gf[3]);
        }
      }

      // p = exp(s scale + bias - lse); dropout; dS = p (dP - delta) scale;
      // P^T (after dropout) and dS^T rounded to T as A fragments
      uint32_t pa[QC / 16][4], sa[QC / 16][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int rr = qc + 8 * j + 2 * t;  // this lane's first row in the tile
        const float2 l2 = *reinterpret_cast<const float2*>(Lt + rr);
        const float2 d2 = *reinterpret_cast<const float2*>(Dt + rr);
        const unsigned rt[2] = {Dropout::row_term(q0 + rr),
                                Dropout::row_term(q0 + rr + 1)};
        float pd[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ki = e >> 1;  // key0 + 8 ki
          const int ri = e & 1;   // row q0 + rr + ri
          float x = fmaf(s[j][e], sl2, bias2[ki] - (ri ? l2.y : l2.x));
          if (edge && !visible(q0 + rr + ri, key0 + 8 * ki, Sk, causal,
                               window))
            x = -INFINITY;
          const float p = exp2_fast(x);  // masked or padded row: 0
          float pdrop = p;
          float dpv = dp[j][e];
          if (drop.on) {
            if (drop.keep_terms(rt[ri], ct[ki])) {
              pdrop = p * drop.inv_keep;
              dpv *= drop.inv_keep;
            } else {
              pdrop = 0.f;
              dpv = 0.f;
            }
          }
          pd[e] = pdrop;
          ds[e] = p * (dpv - (ri ? d2.y : d2.x)) * scale;
        }
        pa[j / 2][(j % 2) * 2] = pack2<T>(pd[0], pd[1]);
        pa[j / 2][(j % 2) * 2 + 1] = pack2<T>(pd[2], pd[3]);
        sa[j / 2][(j % 2) * 2] = pack2<T>(ds[0], ds[1]);
        sa[j / 2][(j % 2) * 2 + 1] = pack2<T>(ds[2], ds[3]);
      }

      // dV += P^T dO, dK += dS^T Q over this step's QC rows
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < DN / 2; ++np) {
          uint32_t gf[4], qf[4];
          load_b_kn<P>(gf, Gt, qc + kk * 16, np * 16, lane);
          load_b_kn<P>(qf, Qt, qc + kk * 16, np * 16, lane);
          mma16816<T>(adv[2 * np], pa[kk], gf[0], gf[1]);
          mma16816<T>(adv[2 * np + 1], pa[kk], gf[2], gf[3]);
          mma16816<T>(adk[2 * np], sa[kk], qf[0], qf[1]);
          mma16816<T>(adk[2 * np + 1], sa[kk], qf[2], qf[3]);
        }
      }
    }
    __syncthreads();  // this buffer is free for the tile after next
  }
  cp_async_wait<0>();  // no copy outlives the block (an empty band)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= Sk) continue;
    const int64_t off = (static_cast<int64_t>(b) * Sk + key) * stride + h * D;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      store2<T>(dk + off + 8 * j + 2 * t, adk[j][2 * i], adk[j][2 * i + 1]);
      store2<T>(dv + off + 8 * j + 2 * t, adv[j][2 * i], adv[j][2 * i + 1]);
    }
  }
}

// --------------------------------------------- tensor cores: dQ, bf16, f16 --

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  // Q and dO, then K and V in two buffers each (16-bit, padded rows); then
  // the kv_bias of the two KV tiles (f32, base 2)
  return 2 * static_cast<size_t>(2 * BQ + 4 * BK) * ptt::mma::tile_pitch(D) +
         sizeof(float) * 2 * BK;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ kv_bias,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Sq, int Sk, int H, float scale, int causal,
                        int window, unsigned seed, Dropout drop) {
  using namespace ptt::mma;
  constexpr int P = tile_pitch(D);
  constexpr int KS = D / 16;  // k16 slices of Q K^T and dO V^T
  constexpr int DN = D / 8;   // n8 tiles of a dQ row
  constexpr int KC = 32;      // keys per product step
  constexpr int NJ = KC / 8;  // n8 tiles of a step's S row
  constexpr bool kInRegs = D <= 64;  // Q's and dO's A fragments
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);
  T* dOs = Qs + BQ * P;
  T* Ks = dOs + BQ * P;      // [2][BK][P]
  T* Vs = Ks + 2 * BK * P;   // [2][BK][P]
  float* Bs = reinterpret_cast<float*>(Vs + 2 * BK * P);  // [2][BK]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t stat = (static_cast<int64_t>(b) * H + h) * Sq;
  const T* kb = k + static_cast<int64_t>(b) * Sk * stride + h * D;
  const T* vb = v + static_cast<int64_t>(b) * Sk * stride + h * D;
  const float* bb =
      kv_bias != nullptr ? kv_bias + static_cast<int64_t>(b) * Sk : nullptr;
  const float sl2 = scale * kLog2e;  // scores in base 2
  drop.set_block(seed, b, h);

  // KV tiles holding any visible entry of this q tile (`_block_runs`)
  int kv_begin = 0;
  int kv_end = (Sk + BK - 1) / BK;
  if (causal) {
    kv_end = min(kv_end, (q0 + BQ - 1) / BK + 1);
    if (window > 0 && q0 > window) kv_begin = (q0 - window) / BK;
  }

  // start copying KV tile ik into buffer buf (one cp.async group with
  // whatever else was started since the last commit)
  auto fetch = [&](int ik, int buf) {
    const int k0 = ik * BK;
    const int kvalid = min(BK, Sk - k0);
    load_tile_async<T, D, BK, THREADS>(Ks + buf * BK * P, kb + k0 * stride,
                                       stride, kvalid);
    load_tile_async<T, D, BK, THREADS>(Vs + buf * BK * P, vb + k0 * stride,
                                       stride, kvalid);
    if (bb != nullptr && tid < BK)
      Bs[buf * BK + tid] = tid < kvalid ? bb[k0 + tid] * kLog2e : 0.f;
  };

  const int qvalid = min(BQ, Sq - q0);
  const int64_t q_off = (static_cast<int64_t>(b) * Sq + q0) * stride + h * D;
  load_tile_async<T, D, BQ, THREADS>(Qs, q + q_off, stride, qvalid);
  load_tile_async<T, D, BQ, THREADS>(dOs, dout + q_off, stride, qvalid);
  if (kv_begin < kv_end) fetch(kv_begin, 0);
  cp_async_commit();

  // this lane's rows: row0 and row0 + 8; their lse (base 2), delta and
  // hash terms (padded rows: lse = +inf makes p = 0, so they add nothing)
  const int row0 = q0 + warp * 16 + g;
  float lse2[2], dlt[2];
  unsigned rt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    lse2[i] = row < Sq ? lse[stat + row] * kLog2e : INFINITY;
    dlt[i] = row < Sq ? delta[stat + row] : 0.f;
    rt[i] = Dropout::row_term(row);
  }
  uint32_t qf[kInRegs ? KS : 1][4], gf[kInRegs ? KS : 1][4];
  float acc[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int ik = kv_begin; ik < kv_end; ++ik) {
    const int buf = (ik - kv_begin) & 1;
    if (ik + 1 < kv_end) fetch(ik + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just started has landed
    __syncthreads();
    const T* Kt = Ks + buf * BK * P;
    const T* Vt = Vs + buf * BK * P;
    const float* Bt = Bs + buf * BK;
    if constexpr (kInRegs) {
      if (ik == kv_begin) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          load_a<P>(qf[ks], Qs, warp * 16, ks * 16, lane);
          load_a<P>(gf[ks], dOs, warp * 16, ks * 16, lane);
        }
      }
    }
    const int k0 = ik * BK;
    const bool edge =
        k0 + BK > Sk ||
        (causal && (k0 + BK - 1 > q0 ||
                    (window > 0 && q0 + BQ - 1 - k0 > window)));

#pragma unroll 1
    for (int kc = 0; kc < BK; kc += KC) {
      // S = Q K^T and dP = dO V^T: this warp's 16 rows x KC keys
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4], ga[4];
        if constexpr (kInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a[e] = qf[ks][e];
            ga[e] = gf[ks][e];
          }
        } else {
          load_a<P>(a, Qs, warp * 16, ks * 16, lane);
          load_a<P>(ga, dOs, warp * 16, ks * 16, lane);
        }
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) {
          uint32_t kf[4], vf[4];
          load_b_nk<P>(kf, Kt, kc + jp * 16, ks * 16, lane);
          load_b_nk<P>(vf, Vt, kc + jp * 16, ks * 16, lane);
          mma16816<T>(s[2 * jp], a, kf[0], kf[1]);
          mma16816<T>(s[2 * jp + 1], a, kf[2], kf[3]);
          mma16816<T>(dp[2 * jp], ga, vf[0], vf[1]);
          mma16816<T>(dp[2 * jp + 1], ga, vf[2], vf[3]);
        }
      }

      // p = exp(s scale + bias - lse); dropout on dP; dS = p (dP - delta)
      // scale, rounded to T as the A fragments of dS K
      uint32_t sa[KC / 16][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = kc + 8 * j + 2 * t;  // this lane's first key in the tile
        float2 bias2 = make_float2(0.f, 0.f);
        if (bb != nullptr) bias2 = *reinterpret_cast<const float2*>(Bt + c);
        const unsigned ct[2] = {Dropout::col_term(k0 + c),
                                Dropout::col_term(k0 + c + 1)};
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = e >> 1;  // row row0 + 8 ri
          const int ci = e & 1;   // key k0 + c + ci
          float x = fmaf(s[j][e], sl2, (ci ? bias2.y : bias2.x) - lse2[ri]);
          if (edge && !visible(row0 + 8 * ri, k0 + c + ci, Sk, causal,
                               window))
            x = -INFINITY;
          const float p = exp2_fast(x);  // masked or padded row: 0
          float dpv = dp[j][e];
          if (drop.on)
            dpv = drop.keep_terms(rt[ri], ct[ci]) ? dpv * drop.inv_keep : 0.f;
          ds[e] = p * (dpv - dlt[ri]) * scale;
        }
        sa[j / 2][(j % 2) * 2] = pack2<T>(ds[0], ds[1]);
        sa[j / 2][(j % 2) * 2 + 1] = pack2<T>(ds[2], ds[3]);
      }

      // dQ += dS K over this step's KC keys
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < DN / 2; ++np) {
          uint32_t kf[4];
          load_b_kn<P>(kf, Kt, kc + kk * 16, np * 16, lane);
          mma16816<T>(acc[2 * np], sa[kk], kf[0], kf[1]);
          mma16816<T>(acc[2 * np + 1], sa[kk], kf[2], kf[3]);
        }
      }
    }
    __syncthreads();  // this buffer is free for the tile after next
  }
  cp_async_wait<0>();  // no copy outlives the block (an empty band)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= Sq) continue;
    T* o = dq + (static_cast<int64_t>(b) * Sq + row) * stride + h * D;
#pragma unroll
    for (int j = 0; j < DN; ++j)
      store2<T>(o + 8 * j + 2 * t, acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

struct Args {
  const void *q, *k, *v, *kv_bias, *dout, *lse, *delta;
  void *d0, *d1;  // dkv: dk, dv; dq: dq
  int B, Sq, Sk, H;
  float scale;
  int causal, window;
  unsigned seed;
  Dropout drop;
};

template <typename T>
using DkvKernel = void (*)(const T*, const T*, const T*, const float*,
                           const T*, const float*, const float*, T*, T*, int,
                           int, int, float, int, int, unsigned, Dropout);
template <typename T>
using DqKernel = void (*)(const T*, const T*, const T*, const float*,
                          const T*, const float*, const float*, T*, int, int,
                          int, float, int, int, unsigned, Dropout);

// f32: the CUDA-core kernel; bf16 and f16: the tensor-core kernel
template <typename T, int D>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  DkvKernel<T> kernel;
  size_t smem;
  if constexpr (std::is_same_v<T, float>) {
    kernel = flash_bwd_dkv_f32_kernel<T, D>;
    smem = dkv_f32_smem_bytes<D>();
  } else {
    kernel = flash_bwd_dkv_mma_kernel<T, D>;
    smem = dkv_mma_smem_bytes<D>();
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sk + BK - 1) / BK, a.H, a.B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.kv_bias),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.d0),
      static_cast<T*>(a.d1), a.Sq, a.Sk, a.H, a.scale, a.causal, a.window,
      a.seed, a.drop);
  return cudaGetLastError();
}

// f32: the CUDA-core kernel; bf16 and f16: the tensor-core kernel
template <typename T, int D>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  DqKernel<T> kernel;
  size_t smem;
  if constexpr (std::is_same_v<T, float>) {
    kernel = flash_bwd_dq_f32_kernel<T, D>;
    smem = dq_f32_smem_bytes<D>();
  } else {
    kernel = flash_bwd_dq_mma_kernel<T, D>;
    smem = dq_mma_smem_bytes<D>();
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.kv_bias),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.d0), a.Sq, a.Sk,
      a.H, a.scale, a.causal, a.window, a.seed, a.drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool dkv, int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 32: return dkv ? launch_dkv<T, 32>(a, stream) : launch_dq<T, 32>(a, stream);
    case 64: return dkv ? launch_dkv<T, 64>(a, stream) : launch_dq<T, 64>(a, stream);
    case 128: return dkv ? launch_dkv<T, 128>(a, stream) : launch_dq<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool dkv, const Args& a, int D, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::DTYPE_F32) return dispatch<float>(dkv, D, a, s);
  if (dtype == ptt::DTYPE_BF16) return dispatch<__nv_bfloat16>(dkv, D, a, s);
  if (dtype == ptt::DTYPE_F16) return dispatch<__half>(dkv, D, a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface for ctypes. dtype: 0 = f32, 1 = bf16, 2 = f16; kv_bias may be
// null; window and dropout as for flash_fwd. Each returns cudaGetLastError()
// after its launch (0 on success).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* kv_bias, const void* dout,
                             const void* lse, const void* delta, void* dk,
                             void* dv, int B, int Sq, int Sk, int H, int D,
                             float scale, int causal, int window,
                             int dropout, unsigned seed, unsigned thresh,
                             float inv_keep, int dtype, void* stream) {
  const Args a{q, k, v, kv_bias, dout, lse, delta, dk, dv, B, Sq, Sk, H,
               scale, causal, window, seed,
               Dropout{dropout, thresh, inv_keep, 0u}};
  return run(true, a, D, dtype, stream);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* kv_bias, const void* dout,
                            const void* lse, const void* delta, void* dq,
                            int B, int Sq, int Sk, int H, int D, float scale,
                            int causal, int window, int dropout,
                            unsigned seed, unsigned thresh, float inv_keep,
                            int dtype, void* stream) {
  const Args a{q, k, v, kv_bias, dout, lse, delta, dq, nullptr, B, Sq, Sk,
               H, scale, causal, window, seed,
               Dropout{dropout, thresh, inv_keep, 0u}};
  return run(false, a, D, dtype, stream);
}
