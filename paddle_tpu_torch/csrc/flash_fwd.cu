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
// time, a few microseconds per call; at the training shape (ERNIE-base:
// 32 x 12 heads x 512 x 64, non-causal, dropout) 25.8 GFLOP per call
// against 100 MB of traffic, and beside the products every score pays for
// an exponential and, with dropout, a 12-instruction integer hash, which
// cost about as many instruction slots as the products do on mma.sync.
//
// What the design does about it (bf16 and f16 inputs): the products run on
// the tensor cores, mma.sync.m16n8k16 with f32 accumulators fed by
// ldmatrix. One block of 4 warps takes a 64-row q tile; each warp owns 16
// q rows. Q, K and V stay in shared memory in their own 16-bit type, in
// rows padded by 16 bytes so that ldmatrix and the copies are free of bank
// conflicts; Q's fragments are loaded once and kept in registers across the
// KV loop (D <= 64; at D = 128 they are re-read from shared memory to stay
// clear of spills). The next K / V tile is copied with 16-byte cp.async
// into a second buffer while this tile's products run. Scale, kv_bias,
// the band mask and dropout are applied to the S accumulators in
// registers, where each lane knows its (row, col) from the C layout
// (mma.cuh), so the hash is taken at the same absolute positions as
// flash_common.cuh Dropout::keep; only tiles that cross the diagonal, the
// window edge or the ragged key edge pay for the mask. The online softmax
// runs in registers, in base 2 (one MUFU ex2 per score), with the row max
// reduced across the 4 lanes of a quad and the row sum reduced once at
// the end. P is rounded to the input type in registers and is, as laid
// out, the A operand of P V (V's B fragments from ldmatrix.trans): it never
// touches shared memory. Tiles outside the causal / window band are never
// loaded. The one rounding the f32 kernel does not make is P's, to the
// input type, before P V (the denominator sums the f32 p).
//
// f32 inputs take the CUDA-core kernel (flash_fwd_f32_kernel): f32 FMAs,
// every tile widened to f32 in shared memory, a 4 x 8 patch of scores per
// thread. Tensor cores would compute those products in TF32, about three
// decimal digits, and f32 callers (the parity runs) ask for full f32.
//
// Layout: q [B, Sq, H, D], k/v [B, Sk, H, D] (contiguous), kv_bias [B, Sk]
// f32 or null, out like q, lse [B, H, Sq] f32; q, k, v and out are f32,
// bf16 or f16, statistics f32 in every case. A row whose every entry is
// masked (outside the causal band, past Sk, or with a -inf bias) gives zeros
// and lse = NEG_INF. The TPU kernel differs there: its finite -1e30 sentinel
// turns such a row into a uniform average over the columns it visited.
//
// Grid: (ceil(Sq / 64), H, B); 128 threads. Tensor-core kernel: warp w owns
// q rows 16w..16w+15 of the tile; lane (g = lane / 4, t = lane % 4) holds
// rows 16w+g and 16w+g+8, score columns 8j+2t, 8j+2t+1 (j < 8) of each KV
// tile and output dims 8j+2t, 8j+2t+1 (j < D / 8). f32 kernel: thread t
// owns rows r + 16i (r = t / 8, i < 4), score columns c + 8j (c = t % 8,
// j < 8) and output dims c + 8j (j < D / 8).

#include "flash_common.cuh"
#include "mma.cuh"

namespace {

using namespace ptt::flash;

constexpr int PP = BK + 8;   // pitch of the probability tile

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(BQ) * qk_pitch(D) +  // Qs
          static_cast<size_t>(BK) * qk_pitch(D) +  // Ks
          static_cast<size_t>(BK) * D +              // Vs
          static_cast<size_t>(BQ) * PP +             // Ps
          BK);                                       // Bs
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
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

// ---------------------------------------------- tensor cores: bf16, f16 --

template <int D>
constexpr size_t mma_smem_bytes() {
  // Q, then K and V in two buffers each, 16-bit, padded rows; then the
  // kv_bias of the two KV tiles (f32, pre-scaled by log2 e)
  return 2 * static_cast<size_t>(BQ + 4 * BK) * ptt::mma::tile_pitch(D) +
         sizeof(float) * 2 * BK;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const float* __restrict__ kv_bias, T* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Sk, int H,
                     float scale, int causal, int window, unsigned seed,
                     Dropout drop) {
  using namespace ptt::mma;
  constexpr int P = tile_pitch(D);
  constexpr int KS = D / 16;   // k16 slices of Q K^T
  constexpr int DN = D / 8;    // n8 tiles of the output row
  constexpr int NJ = BK / 8;   // n8 tiles of a score row
  constexpr bool kQInRegs = D <= 64;
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);
  T* Ks = Qs + BQ * P;       // [2][BK][P]
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

  load_tile_async<T, D, BQ, THREADS>(
      Qs, q + (static_cast<int64_t>(b) * Sq + q0) * stride + h * D, stride,
      min(BQ, Sq - q0));
  if (kv_begin < kv_end) fetch(kv_begin, 0);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const unsigned rt[2] = {Dropout::row_term(row0),
                          Dropout::row_term(row0 + 8)};
  uint32_t qf[kQInRegs ? KS : 1][4];
  float o[DN][4];
  float m[2] = {ptt::NEG_INF, ptt::NEG_INF};  // running max, base 2
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int ik = kv_begin; ik < kv_end; ++ik) {
    const int buf = (ik - kv_begin) & 1;
    if (ik + 1 < kv_end) fetch(ik + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just started has landed
    __syncthreads();
    const T* Kt = Ks + buf * BK * P;
    const T* Vt = Vs + buf * BK * P;
    const float* Bt = Bs + buf * BK;
    if constexpr (kQInRegs) {
      if (ik == kv_begin) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          load_a<P>(qf[ks], Qs, warp * 16, ks * 16, lane);
      }
    }

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
      } else {
        load_a<P>(a, Qs, warp * 16, ks * 16, lane);
      }
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t kf[4];
        load_b_nk<P>(kf, Kt, jp * 16, ks * 16, lane);
        mma16816<T>(s[2 * jp], a, kf[0], kf[1]);
        mma16816<T>(s[2 * jp + 1], a, kf[2], kf[3]);
      }
    }

    // scale, bias and band mask in registers; the row max over the quad
    const int k0 = ik * BK;
    const bool edge =
        k0 + BK > Sk ||
        (causal && (k0 + BK - 1 > q0 ||
                    (window > 0 && q0 + BQ - 1 - k0 > window)));
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = 8 * j + 2 * t;  // this lane's first column in the tile
      float2 bias2 = make_float2(0.f, 0.f);
      if (bb != nullptr) bias2 = *reinterpret_cast<const float2*>(Bt + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = fmaf(s[j][e], sl2, (e & 1) ? bias2.y : bias2.x);
        if (edge && !visible(row0 + 8 * (e >> 1), k0 + c + (e & 1), Sk,
                             causal, window))
          x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);  // >= NEG_INF: finite
      alpha[i] = exp2_fast(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // p (masked: exp(-inf) = 0); the sum takes every p, dropped or not;
    // the dropped and rescaled p, rounded to T, is P V's A operand
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = k0 + 8 * j + 2 * t;
      const unsigned ct[2] = {Dropout::col_term(col),
                              Dropout::col_term(col + 1)};
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_fast(s[j][e] - m[e >> 1]);
        l[e >> 1] += p;
        pe[e] = p;
        if (drop.on)
          pe[e] = drop.keep_terms(rt[e >> 1], ct[e & 1]) ? p * drop.inv_keep
                                                         : 0.f;
      }
      pa[j / 2][(j % 2) * 2] = pack2<T>(pe[0], pe[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack2<T>(pe[2], pe[3]);
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < DN / 2; ++np) {
        uint32_t vf[4];
        load_b_kn<P>(vf, Vt, kk * 16, np * 16, lane);
        mma16816<T>(o[2 * np], pa[kk], vf[0], vf[1]);
        mma16816<T>(o[2 * np + 1], pa[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();  // this buffer is free for the tile after next
  }
  cp_async_wait<0>();  // no copy outlives the block (an empty band)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= Sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];  // fully masked -> zeros
    T* orow = out + (static_cast<int64_t>(b) * Sq + row) * stride + h * D;
#pragma unroll
    for (int j = 0; j < DN; ++j)
      store2<T>(orow + 8 * j + 2 * t, o[j][2 * i] / l_safe,
                o[j][2 * i + 1] / l_safe);
    if (t == 0)
      lse[(static_cast<int64_t>(b) * H + h) * Sq + row] =
          l[i] == 0.f ? ptt::NEG_INF : m[i] * kLn2 + logf(l[i]);
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

template <typename T>
using FwdKernel = void (*)(const T*, const T*, const T*, const float*, T*,
                           float*, int, int, int, float, int, int, unsigned,
                           Dropout);

// f32: the CUDA-core kernel; bf16 and f16: the tensor-core kernel
template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  FwdKernel<T> kernel;
  size_t smem;
  if constexpr (std::is_same_v<T, float>) {
    kernel = flash_fwd_f32_kernel<T, D>;
    smem = f32_smem_bytes<D>();
  } else {
    kernel = flash_fwd_mma_kernel<T, D>;
    smem = mma_smem_bytes<D>();
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  kernel<<<grid, THREADS, smem, stream>>>(
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
