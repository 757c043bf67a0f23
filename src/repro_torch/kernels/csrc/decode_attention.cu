// K3: single-token decode attention against a KV cache (GQA), for sm_90a.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (body
// _decode_kernel), a Pallas TPU kernel with lengths scalar-prefetched, whose
// grid walks (batch * q_heads, kv blocks) in order, masks key positions
// >= lengths[b], skips blocks wholly past the length, and returns zeros at
// length 0 (l is clamped, decode_attention.py:65).
//
// What bounds it on the H100: one query row against the valid prefix of the
// cache is O(1) FLOP per byte, so the bound is the bytes of K and V below
// lengths[b]. At batch 1 the grid is batch * kv_heads CTAs (8 for
// llama3.2-1b) on 132 SMs, so a CTA's own load rate, not the card's, limits
// it: splitting S across CTAs with a combine pass is the first thing a faster
// version adds.
//
// Design: one CTA of 4 warps per (batch, kv head). The CTA handles that kv
// head's `group` query heads together, so each K and V row is read once for
// all of them. The loop covers only keys below lengths[b], in 32-key chunks
// dealt round-robin to the warps: lane i scores key i of the chunk against
// every query head (q sits in shared memory, f32, read as broadcasts; the K
// row is read with 16-byte loads), the chunk updates each head's online
// softmax (f32 running max and sum), and the V rows are then read coalesced,
// lanes splitting head_dim, with the probabilities broadcast by shuffles.
// The warps' partial states are merged through shared memory. An empty
// prefix gives zeros, as the Pallas kernel does; the output is in q's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 8 consecutive elements, 16-byte aligned for bf16 (two 16-byte loads for f32).
__device__ __forceinline__ void load8(const float* p, float out[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float out[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

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

// G: the group size rounded up to a power of two; `group` <= G heads are live.
template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ lengths, T* __restrict__ o, int q_heads, int kv_heads,
              int s_len, int group, float sm_scale) {
  constexpr int E = D / 32;  // accumulator elements a lane holds per head
  __shared__ __align__(16) float qs[G][D];
  __shared__ float m_w[WARPS][G];
  __shared__ float l_w[WARPS][G];
  __shared__ float acc_w[WARPS][G][D];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int b = blockIdx.x / kv_heads;
  const int kvh = blockIdx.x % kv_heads;
  const int h0 = kvh * group;
  const int len = max(0, min(lengths[b], s_len));

  for (int idx = tid; idx < G * D; idx += THREADS) {
    const int g = idx / D, c = idx % D;
    qs[g][c] = g < group ? to_f32(q[((int64_t)b * q_heads + h0 + g) * D + c]) : 0.f;
  }
  __syncthreads();

  const T* kp = k + ((int64_t)b * kv_heads + kvh) * s_len * D;
  const T* vp = v + ((int64_t)b * kv_heads + kvh) * s_len * D;

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int c0 = warp * 32; c0 < len; c0 += WARPS * 32) {
    const int key = c0 + lane;
    const bool live = key < len;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (live) {
      const T* row = kp + (int64_t)key * D;
#pragma unroll
      for (int c = 0; c < D; c += 8) {
        float kv[8];
        load8(row + c, kv);
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int i = 0; i < 8; ++i) s[g] = fmaf(qs[g][c + i], kv[i], s[g]);
        }
      }
    }
    float p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float x = live ? s[g] * sm_scale : -INFINITY;
      const float m_cur = fmaxf(m[g], warp_max(x));  // finite: lane 0's key is live
      p[g] = expf(x - m_cur);
      const float alpha = expf(m[g] - m_cur);
      l[g] = l[g] * alpha + warp_sum(p[g]);
      m[g] = m_cur;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
    }
    const int n_live = min(32, len - c0);
    for (int i = 0; i < n_live; ++i) {
      const T* row = vp + (int64_t)(c0 + i) * D;
      float vv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vv[e] = to_f32(row[lane + 32 * e]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pi = __shfl_sync(0xffffffffu, p[g], i);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pi, vv[e], acc[g][e]);
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      m_w[warp][g] = m[g];
      l_w[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) acc_w[warp][g][lane + 32 * e] = acc[g][e];
  }
  __syncthreads();

  for (int idx = tid; idx < group * D; idx += THREADS) {
    const int g = idx / D, c = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_w[w][g]);
    float out = 0.f;  // empty prefix: zeros, as the Pallas kernel gives
    if (mx != -INFINITY) {
      float lsum = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float f = expf(m_w[w][g] - mx);  // 0 for a warp that saw no key
        lsum += l_w[w][g] * f;
        a += acc_w[w][g][c] * f;
      }
      out = a / fmaxf(lsum, 1e-20f);
    }
    store(&o[((int64_t)b * q_heads + h0 + g) * D + c], out);
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* o, int batch,
           int q_heads, int kv_heads, int s_len, float sm_scale, cudaStream_t stream) {
  decode_kernel<T, D, G><<<batch * kv_heads, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(o), q_heads, kv_heads, s_len, q_heads / kv_heads, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch_g(const void* q, const void* k, const void* v, const int* lengths, void* o,
               int batch, int q_heads, int kv_heads, int s_len, float sm_scale,
               cudaStream_t s) {
  const int group = q_heads / kv_heads;
  if (group <= 1) return launch<T, D, 1>(q, k, v, lengths, o, batch, q_heads, kv_heads, s_len, sm_scale, s);
  if (group <= 2) return launch<T, D, 2>(q, k, v, lengths, o, batch, q_heads, kv_heads, s_len, sm_scale, s);
  if (group <= 4) return launch<T, D, 4>(q, k, v, lengths, o, batch, q_heads, kv_heads, s_len, sm_scale, s);
  if (group <= 8) return launch<T, D, 8>(q, k, v, lengths, o, batch, q_heads, kv_heads, s_len, sm_scale, s);
  if (group <= 16) return launch<T, D, 16>(q, k, v, lengths, o, batch, q_heads, kv_heads, s_len, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, const int* lengths, void* o,
               int batch, int q_heads, int kv_heads, int s_len, float sm_scale,
               cudaStream_t s) {
  switch (d) {
    case 64: return dispatch_g<T, 64>(q, k, v, lengths, o, batch, q_heads, kv_heads, s_len, sm_scale, s);
    case 96: return dispatch_g<T, 96>(q, k, v, lengths, o, batch, q_heads, kv_heads, s_len, sm_scale, s);
    case 128: return dispatch_g<T, 128>(q, k, v, lengths, o, batch, q_heads, kv_heads, s_len, sm_scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o (batch, q_heads, 1, d); k, v (batch, kv_heads, s_len, d); lengths
// (batch,) int32 on the device; all contiguous and 16-byte aligned.
// dtype: 0 = float32, 1 = bfloat16. d in {64, 96, 128}; q_heads / kv_heads
// <= 16. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* lengths, void* o, int batch, int q_heads,
                                      int kv_heads, int s_len, int d, float sm_scale, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == 0) return dispatch_d<float>(d, q, k, v, len, o, batch, q_heads, kv_heads, s_len, sm_scale, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(d, q, k, v, len, o, batch, q_heads, kv_heads, s_len, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
