// Flash attention forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py, `_fwd_kernel` (launched
// by `_fwd`) — online-softmax attention over KV tiles, f32 statistics, tiles
// outside the causal / sliding-window band skipped, an optional additive
// kv_bias per key column, attention-probability dropout from a position
// hash (the denominator sums the undropped p, the output the dropped and
// rescaled p), and the row log-sum-exp written beside the output.
//
// What bounds it on this card: at the serving path's prefill shapes (one
// sequence of 128..2048 tokens, 16 heads, head dim 64, bf16) the bytes that
// must move (q, k, v read once, out and lse written once) and the causal
// product's operations at the bf16 tensor-core rate take about the same
// time, a few microseconds per call. This simple design does its products
// with f32 FMAs on the CUDA cores (67 TFLOP/s peak, about 15x below the bf16
// tensor cores), so operations bound it by a wide margin. What it does about
// that: every q and k/v tile is read from device memory once per block and
// kept in shared memory as f32, each thread computes a 4 x 8 patch of scores
// from conflict-free 16-byte shared loads, and causal tiles past the diagonal
// are never loaded. Tensor cores (mma/wgmma) are the next step.
//
// Training shapes (ERNIE-base: 32 x 12 heads x 512 x 64, non-causal, bf16)
// are bound the same way: 25.8 GFLOP per call against 100 MB of traffic.
//
// Layout: q [B, Sq, H, D], k/v [B, Sk, H, D] (contiguous), kv_bias [B, Sk]
// f32 or null, out like q, lse [B, H, Sq] f32; q, k, v and out are f32,
// bf16 or f16, statistics f32 in every case. A row whose every entry is
// masked (outside the causal band, past Sk, or with a -inf bias) gives zeros
// and lse = NEG_INF. The TPU kernel differs there: its finite -1e30 sentinel
// turns such a row into a uniform average over the columns it visited.
//
// Grid: (ceil(Sq / 64), H, B); 128 threads. Thread t owns rows r + 16i
// (r = t / 8, i < 4) of the q tile, score columns c + 8j (c = t % 8, j < 8)
// of each KV tile, and output dims c + 8j (j < D / 8).

#include "flash_common.cuh"

namespace {

using namespace ptt::flash;

constexpr int PP = BK + 8;   // pitch of the probability tile

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(BQ) * qk_pitch(D) +  // Qs
          static_cast<size_t>(BK) * qk_pitch(D) +  // Ks
          static_cast<size_t>(BK) * D +              // Vs
          static_cast<size_t>(BQ) * PP +             // Ps
          BK);                                       // Bs
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ kv_bias,
                 T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk,
                 int H, float scale, int causal, int window, unsigned seed,
                 Dropout drop) {
  constexpr int QP = qk_pitch(D);
  constexpr int DJ = D / 8;  // output dims per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * QP;
  float* Vs = Ks + BK * QP;
  float* Ps = Vs + BK * D;
  float* Bs = Ps + BQ * PP;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid / 8;
  const int c = tid % 8;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const T* kb = k + static_cast<int64_t>(b) * Sk * stride + h * D;
  const T* vb = v + static_cast<int64_t>(b) * Sk * stride + h * D;
  drop.set_block(seed, b, h);

  load_tile<T, D>(Qs, QP, q + (static_cast<int64_t>(b) * Sq + q0) * stride + h * D,
                  stride, min(BQ, Sq - q0));

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = ptt::NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // KV tiles holding any visible entry of this q tile (`_block_runs`)
  int kv_begin = 0;
  int kv_end = (Sk + BK - 1) / BK;
  if (causal) {
    kv_end = min(kv_end, (q0 + BQ - 1) / BK + 1);
    if (window > 0 && q0 > window) kv_begin = (q0 - window) / BK;
  }

  for (int ik = kv_begin; ik < kv_end; ++ik) {
    const int k0 = ik * BK;
    const int kvalid = min(BK, Sk - k0);
    __syncthreads();  // the previous tile's Ks / Vs / Ps are consumed
    load_tile<T, D>(Ks, QP, kb + k0 * stride, stride, kvalid);
    load_tile<T, D>(Vs, D, vb + k0 * stride, stride, kvalid);
    if (tid < BK)
      Bs[tid] = (kv_bias != nullptr && tid < kvalid)
                    ? kv_bias[static_cast<int64_t>(b) * Sk + k0 + tid]
                    : 0.f;
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(r + 16 * i) * QP + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(c + 8 * j) * QP + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                     qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + r + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + c + 8 * j;
        const float x = visible(row, col, Sk, causal, window)
                            ? s[i][j] * scale + Bs[c + 8 * j]
                            : -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 8 threads of a row are 8 consecutive lanes of one warp
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);  // >= NEG_INF: finite
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);  // masked: exp(-inf) = 0
        sum += p;  // the denominator takes every p, dropped or not
        float pe = p;
        if (drop.on)
          pe = drop.keep(row, k0 + c + 8 * j) ? p * drop.inv_keep : 0.f;
        Ps[(r + 16 * i) * PP + c + 8 * j] = pe;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(r + 16 * i) * PP + kk]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float vv[DJ];
#pragma unroll
        for (int j = 0; j < DJ; ++j) vv[j] = Vs[(kk + t) * D + c + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = t == 0 ? pv[i].x : t == 1 ? pv[i].y
                        : t == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int j = 0; j < DJ; ++j) acc[i][j] += p * vv[j];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r + 16 * i;
    if (row >= Sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];  // fully masked -> zeros
    T* o = out + (static_cast<int64_t>(b) * Sq + row) * stride + h * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) ptt::store(o + c + 8 * j, acc[i][j] / l_safe);
    if (c == 0)
      lse[(static_cast<int64_t>(b) * H + h) * Sq + row] = m[i] + logf(l_safe);
  }
}

struct Args {
  const void *q, *k, *v, *kv_bias;
  void *out, *lse;
  int B, Sq, Sk, H;
  float scale;
  int causal, window;
  unsigned seed;
  Dropout drop;
};

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.kv_bias),
      static_cast<T*>(a.out), static_cast<float*>(a.lse), a.Sq, a.Sk, a.H,
      a.scale, a.causal, a.window, a.seed, a.drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface for ctypes. dtype: 0 = f32, 1 = bf16, 2 = f16; kv_bias may be
// null.
// window: 0, or the sliding-window band (needs causal). dropout: 0 = off,
// else keep an entry when its hash is >= thresh and scale it by inv_keep.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* kv_bias, void* out, void* lse, int B,
                         int Sq, int Sk, int H, int D, float scale,
                         int causal, int window, int dropout, unsigned seed,
                         unsigned thresh, float inv_keep, int dtype,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{q, k, v, kv_bias, out, lse, B, Sq, Sk, H, scale, causal, window,
         seed, Dropout{dropout, thresh, inv_keep, 0u}};
  if (dtype == ptt::DTYPE_F32) return dispatch_d<float>(D, a, s);
  if (dtype == ptt::DTYPE_BF16) return dispatch_d<__nv_bfloat16>(D, a, s);
  if (dtype == ptt::DTYPE_F16) return dispatch_d<__half>(D, a, s);
  return cudaErrorInvalidValue;
}
