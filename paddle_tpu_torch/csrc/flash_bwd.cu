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
// bytes less. This simple design does the products with f32 FMAs on the
// CUDA cores, so operations bound it by a wide margin. What it does about
// that: the block's fixed operand tiles (K and V for dkv; Q and dO for dq)
// stay in shared memory as f32 for the whole loop, each thread computes a
// 4 x 8 patch of s and dP from conflict-free 16-byte shared loads, p and dS
// go through shared memory once (transposed for dkv, so the accumulation
// reads them as float4 rows), and tiles outside the causal / window band
// are never loaded. Tensor cores (mma/wgmma) are the next step.
//
// Layout: q, dout [B, Sq, H, D]; k, v [B, Sk, H, D] (contiguous, one dtype:
// f32, bf16 or f16); kv_bias [B, Sk] f32 or null; lse, delta [B, H, Sq] f32;
// dq like q, dk and dv like k. kv_bias takes no gradient. Rows whose every
// entry is masked have lse = NEG_INF in the forward and give zero gradients
// here.
//
// Grid: (ceil(Sk / 64) for dkv or ceil(Sq / 64) for dq, H, B); 128 threads.
// Thread t computes the s / dP entries (rows r + 16i, cols c + 8j) with
// r = t / 8, c = t % 8, i < 4, j < 8, and owns output rows r + 16i, dims
// c + 8j (j < D / 8) of its block's tile.

#include "flash_common.cuh"

namespace {

using namespace ptt::flash;

constexpr int TP = BQ + 4;  // pitch of the transposed p / dS tiles (dkv)
constexpr int SP = BK + 8;  // pitch of the dS tile (dq)

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         (4 * static_cast<size_t>(64) * qk_pitch(D) +  // Ks Vs Qs dOs
          2 * static_cast<size_t>(BK) * TP +          // PT dST
          2 * BQ + BK);                                // Ls Dl Bs
}

template <int D>
constexpr size_t dq_smem_bytes() {
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
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const float* __restrict__ kv_bias,
                    const T* __restrict__ dout, const float* __restrict__ lse,
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

struct Args {
  const void *q, *k, *v, *kv_bias, *dout, *lse, *delta;
  void *d0, *d1;  // dkv: dk, dv; dq: dq
  int B, Sq, Sk, H;
  float scale;
  int causal, window;
  unsigned seed;
  Dropout drop;
};

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sk + BK - 1) / BK, a.H, a.B);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.kv_bias),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.d0),
      static_cast<T*>(a.d1), a.Sq, a.Sk, a.H, a.scale, a.causal, a.window,
      a.seed, a.drop);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(
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
