// K2: flash attention for prefill (causal or full, GQA), for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (body
// _flash_kernel), a Pallas TPU kernel whose grid walks (batch * q_heads,
// q blocks, kv blocks) in order, carrying the running max, sum and f32
// accumulator in VMEM scratch across the sequential kv axis, and skipping kv
// blocks above the causal diagonal.
//
// What bounds it on the H100: at the serving prefill shapes (one prompt of
// 64-256 tokens, 32 query heads, head_dim 64) the work is a few hundred MFLOP
// on a few MB, so the tensor-core bound is under a microsecond; this version
// computes with f32 FFMA and is bound by those operations and by the few CTAs
// a short prompt gives (one per q-head and 64-row q tile).
//
// Design: one CTA of 256 threads per (batch * q-head, 64-row q tile). The
// TPU's sequential kv grid axis becomes a loop inside the CTA over 64-row kv
// tiles, ending at the causal diagonal (the skip of flash_attention.py:64-66).
// Query head h reads kv head h / group. Q and K tiles sit transposed in shared
// memory (f32, padded rows) so the score micro-tiles read broadcasts and
// consecutive banks; the online softmax (running max m, sum l, rescale alpha)
// is f32, one warp per 8 rows; the output accumulator (64 x head_dim, f32)
// lives in registers, 4 rows x head_dim/16 columns a thread. Ragged q and kv
// tails are masked inside the kernel, so serving's unpadded prompts never
// fall back. The causal mask is end-aligned, q_pos = i + kv_seq - q_seq (the
// oracle's convention, ref.py:50), which equals the Pallas kernel's
// top-left mask in the square case that prefill uses. Masked scores are
// -1e30, as in the oracle and the Pallas kernel. No tensor cores, no TMA:
// a faster version moves QK^T and PV onto wgmma with a TMA-fed K/V ring.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 256;
constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
struct Smem {
  static constexpr int kQt = D * (BQ + 1);
  static constexpr int kKt = D * (BKV + 1);
  static constexpr int kV = BKV * D;
  static constexpr int kP = BQ * (BKV + 1);
  static constexpr size_t bytes = sizeof(float) * (kQt + kKt + kV + kP + 3 * BQ);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int q_heads, int kv_heads, int q_seq, int kv_seq,
             int causal, float sm_scale) {
  constexpr int NJ = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qt = smem;                        // [D][BQ + 1]
  float* kt = qt + Smem<D>::kQt;           // [D][BKV + 1]
  float* vs = kt + Smem<D>::kKt;           // [BKV][D]
  float* ps = vs + Smem<D>::kV;            // [BQ][BKV + 1]
  float* m_s = ps + Smem<D>::kP;           // [BQ]
  float* l_s = m_s + BQ;                   // [BQ]
  float* a_s = l_s + BQ;                   // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lane = tid % 32;
  const int warp = tid / 32;

  const int bh = blockIdx.y;
  const int b = bh / q_heads;
  const int h = bh % q_heads;
  const int kvh = h / (q_heads / kv_heads);
  const int q0 = blockIdx.x * BQ;
  const int off = kv_seq - q_seq;

  const T* qp = q + (int64_t)bh * q_seq * D;
  const T* kp = k + ((int64_t)b * kv_heads + kvh) * kv_seq * D;
  const T* vp = v + ((int64_t)b * kv_heads + kvh) * kv_seq * D;
  T* op = o + (int64_t)bh * q_seq * D;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    qt[c * (BQ + 1) + r] = (q0 + r < q_seq) ? to_f32(qp[(int64_t)(q0 + r) * D + c]) : 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    m_s[r] = NEG_BIG;
    l_s[r] = 0.f;
  }

  int n_tiles = (kv_seq + BKV - 1) / BKV;
  if (causal) {
    const int max_kpos = min(q0 + BQ, q_seq) - 1 + off;
    n_tiles = min(n_tiles, max_kpos / BKV + 1);
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * BKV;
    __syncthreads();  // previous tile's kt / vs / ps are no longer read
    for (int idx = tid; idx < BKV * D; idx += THREADS) {
      const int r = idx / D, c = idx % D;
      const bool in = kv0 + r < kv_seq;
      const int64_t g = (int64_t)(kv0 + r) * D + c;
      kt[c * (BKV + 1) + r] = in ? to_f32(kp[g]) : 0.f;
      vs[r * D + c] = in ? to_f32(vp[g]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty + 16i, columns tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qt[c * (BQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = kt[c * (BKV + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int q_pos = q0 + r + off;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cidx = tx + 16 * j;
        const int k_pos = kv0 + cidx;
        const bool ok = k_pos < kv_seq && (!causal || q_pos >= k_pos);
        ps[r * (BKV + 1) + cidx] = ok ? s[i][j] * sm_scale : NEG_BIG;
      }
    }
    __syncthreads();

    // online softmax, one warp per 8 rows, two columns a lane
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      float* row = ps + r * (BKV + 1);
      const float x0 = row[lane], x1 = row[lane + 32];
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_cur), p1 = expf(x1 - m_cur);
      const float sum = warp_sum(p0 + p1);
      row[lane] = p0;
      row[lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_cur;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float pa[4], vb[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ps[(ty + 16 * i) * (BKV + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vb[j] = vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= q_seq) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-20f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) store(&op[(int64_t)(q0 + r) * D + tx + 16 * j], acc[i][j] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int q_heads,
           int kv_heads, int q_seq, int kv_seq, int causal, float sm_scale,
           cudaStream_t stream) {
  // Above 48 KB of dynamic shared memory needs the opt-in. It is set once,
  // at the first launch, so that no later launch (one inside a CUDA graph
  // capture, say) makes the call; the port drives one card.
  static bool configured = false;
  const size_t smem = Smem<D>::bytes;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((q_seq + BQ - 1) / BQ, batch * q_heads);
  flash_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), q_heads, kv_heads, q_seq, kv_seq, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* o, int batch,
               int q_heads, int kv_heads, int q_seq, int kv_seq, int causal, float sm_scale,
               cudaStream_t s) {
  switch (d) {
    case 64: return launch<T, 64>(q, k, v, o, batch, q_heads, kv_heads, q_seq, kv_seq, causal, sm_scale, s);
    case 96: return launch<T, 96>(q, k, v, o, batch, q_heads, kv_heads, q_seq, kv_seq, causal, sm_scale, s);
    case 128: return launch<T, 128>(q, k, v, o, batch, q_heads, kv_heads, q_seq, kv_seq, causal, sm_scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o (batch, q_heads, q_seq, d); k, v (batch, kv_heads, kv_seq, d); all
// contiguous. dtype: 0 = float32, 1 = bfloat16. d in {64, 96, 128}.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int batch, int q_heads, int kv_heads, int q_seq,
                                     int kv_seq, int d, int causal, float sm_scale, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(d, q, k, v, o, batch, q_heads, kv_heads, q_seq, kv_seq, causal, sm_scale, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(d, q, k, v, o, batch, q_heads, kv_heads, q_seq, kv_seq, causal, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
