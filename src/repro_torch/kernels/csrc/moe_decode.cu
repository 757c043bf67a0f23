// The MoE FFN of a decode step (models/moe.py::_experts at one token a row),
// for sm_90a: only the experts each token chose, read once.
//
// Replaces no TPU kernel: src/repro/models/moe.py is plain jnp (a dense
// dispatch over (B, S, E, C) masks and every expert's GEMM over its C slots;
// nothing reaches pl.pallas_call). It was added because that dispatch, at one
// token a row, still computes all E experts over C = 4 slots: at
// granite-4.0-h-small's shapes (E 72, top-10, d 4,096, d_e 768) it reads 72
// experts' weights, 1.36 GB a layer, where the token needs 10 of them.
//
// What it computes, per row b with choices (e_k, g_k), k < K:
//   act[b, k] = silu(x[b] W_gate[e_k]) * (x[b] W_up[e_k])   (rounded to T)
//   y[b]      = sum_k g_k act[b, k] W_down[e_k]              (rounded once)
// which is what the dense dispatch gives wherever no expert takes more of a
// row's pairs than its capacity: always at one token, since a token's top-k
// experts are distinct and C >= 4. An index outside [0, E) adds nothing, as
// the dispatch's zero one-hot row does. The dense path rounds h, u, silu(h)
// and each expert's output to T between its GEMMs; this kernel keeps h, u and
// the sum in f32 and rounds act (as the dense path rounds what goes into its
// down GEMM) and y.
//
// What bounds it on the H100: its bytes. Per pair it reads 3 d x d_e
// matrices and does 6 d d_e FLOPs: 1 FLOP a byte in bf16, far below the
// card's 295. At granite-4.0-h's decode shape (B 1) 188.7 MB a layer: 56.3 us
// at 3.35 TB/s; granite-moe-1b-a400m's (E 32, top-8, d 1,024, d_e 512) 25.2 MB,
// 7.5 us. So the design is a streaming GEMV whose only aim is to keep enough
// 16-byte loads in flight:
//
// * moe_up_kernel: one block a (pair, tile of W = TPR x VEC columns of d_e).
//   A warp reads 32 / TPR rows of the tile per step, one 16-byte vector of
//   W_gate and one of W_up a thread (VEC values: 8 in bf16, 4 in f32),
//   UNROLL steps loaded before their sums; the 8 warps split the d rows of
//   the reduction. x sits in shared memory in f32. The warps' partial sums
//   meet in shared memory and are summed in warp order; the activation is
//   applied there and stored as T into act (B K, d_e), a scratch.
// * moe_down_kernel: one block a (tile of W columns of d, split of the K d_e
//   rows of the reduction, row b). The block's coefficients g_k act[b, k, f]
//   go to shared memory in f32, then the same streaming loop runs down the
//   rows of W_down[e_k] in (k, f) order. With one split it rounds y and
//   stores it; with more, each split stores its f32 partial sums and
//   moe_sum_kernel adds them in split order. No atomics anywhere: every sum
//   is taken in a fixed order, so a replay gives the same bits.
//
// TPR (threads a row: 4 or 8) and the splits are chosen by the wrapper from
// the shapes alone (kernels/moe_decode.py::plan): about three blocks an SM,
// which on the H100 streamed 1.6x faster at granite-4.0-h's batch-1 shape
// than one block an SM did. Sizes come from the shapes alone and nothing is
// read back to the host, so a call can be captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;      // row steps whose loads a thread starts before their sums
constexpr int MAX_TOP_K = 64;  // a row's expert table in shared memory
constexpr int SMEM_LIMIT = 48 * 1024;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int VEC = 4;
  __device__ static void unpack(const uint4& q, float* f) {
    f[0] = __uint_as_float(q.x);
    f[1] = __uint_as_float(q.y);
    f[2] = __uint_as_float(q.z);
    f[3] = __uint_as_float(q.w);
  }
  __device__ static float to_f(float v) { return v; }
  __device__ static float from_f(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static void unpack(const uint4& q, float* f) {
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i in the low half of word i
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 from_f(float v) { return __float2bfloat16_rn(v); }
};

// 16 bytes of weights, read once: not kept in L1
__device__ __forceinline__ uint4 stream_load(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// Sum each lane's VEC values over the lanes of its warp that hold the same
// columns (lanes TPR apart); every such lane ends with the same bits.
template <int TPR, int VEC>
__device__ __forceinline__ void warp_rows_sum(float* v) {
#pragma unroll
  for (int o = 16; o >= TPR; o >>= 1)
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], o);
}

template <typename T, int TPR>
__global__ void __launch_bounds__(THREADS)
moe_up_kernel(const T* __restrict__ x, const long long* __restrict__ idx,
              const T* __restrict__ w_gate, const T* __restrict__ w_up, T* __restrict__ act,
              int d, int d_e, int n_experts, int top_k) {
  constexpr int VEC = Elem<T>::VEC, RW = 32 / TPR, RB = WARPS * RW, W = TPR * VEC;
  extern __shared__ float smem[];
  float* xs = smem;      // d: the row's x in f32
  float* red = smem + d;  // 2 x WARPS x W: each warp's sums of h, then of u
  const int p = blockIdx.x, tile = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, c = lane % TPR, r0 = lane / TPR;
  const long long e = idx[p];
  T* out = act + (long long)p * d_e + tile * W;
  const int width = min(W, d_e - tile * W);
  if (e < 0 || e >= n_experts) {  // a pair routed nowhere adds nothing
    for (int j = tid; j < width; j += THREADS) out[j] = Elem<T>::from_f(0.f);
    return;
  }
  const T* xr = x + (long long)(p / top_k) * d;
  for (int i = tid; i < d; i += THREADS) xs[i] = Elem<T>::to_f(xr[i]);
  __syncthreads();

  float h[VEC], u[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) h[j] = u[j] = 0.f;
  if (c * VEC < width) {
    const long long base = (long long)e * d * d_e + tile * W + c * VEC;
    const T* g = w_gate + base;
    const T* v = w_up + base;
    int row = warp * RW + r0;
    for (; row + (UNROLL - 1) * RB < d; row += UNROLL * RB) {
      uint4 qg[UNROLL], qu[UNROLL];
#pragma unroll
      for (int i = 0; i < UNROLL; ++i) {
        qg[i] = stream_load(g + (long long)(row + i * RB) * d_e);
        qu[i] = stream_load(v + (long long)(row + i * RB) * d_e);
      }
#pragma unroll
      for (int i = 0; i < UNROLL; ++i) {
        const float xv = xs[row + i * RB];
        float fg[VEC], fu[VEC];
        Elem<T>::unpack(qg[i], fg);
        Elem<T>::unpack(qu[i], fu);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          h[j] = fmaf(xv, fg[j], h[j]);
          u[j] = fmaf(xv, fu[j], u[j]);
        }
      }
    }
    for (; row < d; row += RB) {
      const uint4 qg = stream_load(g + (long long)row * d_e);
      const uint4 qu = stream_load(v + (long long)row * d_e);
      const float xv = xs[row];
      float fg[VEC], fu[VEC];
      Elem<T>::unpack(qg, fg);
      Elem<T>::unpack(qu, fu);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        h[j] = fmaf(xv, fg[j], h[j]);
        u[j] = fmaf(xv, fu[j], u[j]);
      }
    }
  }
  warp_rows_sum<TPR, VEC>(h);
  warp_rows_sum<TPR, VEC>(u);
  if (r0 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      red[warp * W + c * VEC + j] = h[j];
      red[(WARPS + warp) * W + c * VEC + j] = u[j];
    }
  }
  __syncthreads();
  for (int j = tid; j < width; j += THREADS) {
    float hs = 0.f, us = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      hs += red[w * W + j];
      us += red[(WARPS + w) * W + j];
    }
    out[j] = Elem<T>::from_f(hs / (1.f + expf(-hs)) * us);
  }
}

template <typename T, int TPR>
__global__ void __launch_bounds__(THREADS)
moe_down_kernel(const T* __restrict__ act, const long long* __restrict__ idx,
                const float* __restrict__ vals, const T* __restrict__ w_down,
                T* __restrict__ y, float* __restrict__ part, int d, int d_e, int n_experts,
                int top_k, int split_rows) {
  constexpr int VEC = Elem<T>::VEC, RW = 32 / TPR, RB = WARPS * RW, W = TPR * VEC;
  extern __shared__ float smem[];
  float* coef = smem;              // split_rows: g_k act[b, k, f] of the split's rows
  float* red = smem + split_rows;  // WARPS x W
  __shared__ int ex[MAX_TOP_K];    // the row's experts, -1 where routed nowhere
  const int tile = blockIdx.x, split = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, c = lane % TPR, r0 = lane / TPR;
  const int lo = split * split_rows, hi = min(lo + split_rows, top_k * d_e);
  for (int k = tid; k < top_k; k += THREADS) {
    const long long e = idx[(long long)b * top_k + k];
    ex[k] = e >= 0 && e < n_experts ? static_cast<int>(e) : -1;
  }
  __syncthreads();
  const T* ab = act + (long long)b * top_k * d_e;
  for (int r = lo + tid; r < hi; r += THREADS) {
    const int k = r / d_e;
    coef[r - lo] = ex[k] < 0 ? 0.f : vals[(long long)b * top_k + k] * Elem<T>::to_f(ab[r]);
  }
  __syncthreads();

  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  const int width = min(W, d - tile * W);
  if (c * VEC < width) {
    for (int k = lo / d_e; k < top_k && k * d_e < hi; ++k) {
      if (ex[k] < 0) continue;
      const int f_hi = min(hi - k * d_e, d_e);
      const T* wk = w_down + (long long)ex[k] * d_e * d + tile * W + c * VEC;
      const int off = k * d_e - lo;  // coef[off + f] for the split's f of pair k
      int f = max(-off, 0) + warp * RW + r0;
      for (; f + (UNROLL - 1) * RB < f_hi; f += UNROLL * RB) {
        uint4 q[UNROLL];
#pragma unroll
        for (int i = 0; i < UNROLL; ++i) q[i] = stream_load(wk + (long long)(f + i * RB) * d);
#pragma unroll
        for (int i = 0; i < UNROLL; ++i) {
          const float a = coef[off + f + i * RB];
          float fw[VEC];
          Elem<T>::unpack(q[i], fw);
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] = fmaf(a, fw[j], acc[j]);
        }
      }
      for (; f < f_hi; f += RB) {
        const uint4 q = stream_load(wk + (long long)f * d);
        const float a = coef[off + f];
        float fw[VEC];
        Elem<T>::unpack(q, fw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = fmaf(a, fw[j], acc[j]);
      }
    }
  }
  warp_rows_sum<TPR, VEC>(acc);
  if (r0 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) red[warp * W + c * VEC + j] = acc[j];
  }
  __syncthreads();
  for (int j = tid; j < width; j += THREADS) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[w * W + j];
    const long long at = (long long)b * d + tile * W + j;
    if (part != nullptr)
      part[(long long)split * gridDim.z * d + at] = s;
    else
      y[at] = Elem<T>::from_f(s);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
moe_sum_kernel(const float* __restrict__ part, T* __restrict__ y, int n, int splits) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(long long)k * n + i];
  y[i] = Elem<T>::from_f(s);
}

template <typename T, int TPR>
cudaError_t launch_up(const void* x, const long long* idx, const void* w_gate, const void* w_up,
                      void* act, int pairs, int d, int d_e, int n_experts, int top_k,
                      cudaStream_t s) {
  constexpr int W = TPR * Elem<T>::VEC;
  const size_t smem = (size_t)(d + 2 * WARPS * W) * sizeof(float);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  moe_up_kernel<T, TPR><<<dim3(pairs, (d_e + W - 1) / W), THREADS, smem, s>>>(
      static_cast<const T*>(x), idx, static_cast<const T*>(w_gate), static_cast<const T*>(w_up),
      static_cast<T*>(act), d, d_e, n_experts, top_k);
  return cudaGetLastError();
}

template <typename T, int TPR>
cudaError_t launch_down(const void* act, const long long* idx, const float* vals,
                        const void* w_down, void* y, float* part, int batch, int d, int d_e,
                        int n_experts, int top_k, int splits, cudaStream_t s) {
  constexpr int W = TPR * Elem<T>::VEC;
  const int split_rows = (top_k * d_e + splits - 1) / splits;
  const size_t smem = (size_t)(split_rows + WARPS * W) * sizeof(float);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  moe_down_kernel<T, TPR><<<dim3((d + W - 1) / W, splits, batch), THREADS, smem, s>>>(
      static_cast<const T*>(act), idx, vals, static_cast<const T*>(w_down), static_cast<T*>(y),
      splits > 1 ? part : nullptr, d, d_e, n_experts, top_k, split_rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_all(const void* x, const long long* idx, const float* vals, const void* w_gate,
                       const void* w_up, const void* w_down, void* act, float* part, void* y,
                       int batch, int top_k, int d, int d_e, int n_experts, int tpr_up,
                       int tpr_down, int splits, cudaStream_t s) {
  const int pairs = batch * top_k;
  cudaError_t e = tpr_up == 8
      ? launch_up<T, 8>(x, idx, w_gate, w_up, act, pairs, d, d_e, n_experts, top_k, s)
      : launch_up<T, 4>(x, idx, w_gate, w_up, act, pairs, d, d_e, n_experts, top_k, s);
  if (e != cudaSuccess) return e;
  e = tpr_down == 8
      ? launch_down<T, 8>(act, idx, vals, w_down, y, part, batch, d, d_e, n_experts, top_k,
                          splits, s)
      : launch_down<T, 4>(act, idx, vals, w_down, y, part, batch, d, d_e, n_experts, top_k,
                          splits, s);
  if (e != cudaSuccess || splits == 1) return e;
  const int n = batch * d;
  moe_sum_kernel<T><<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(part, static_cast<T*>(y), n,
                                                                      splits);
  return cudaGetLastError();
}

}  // namespace

// x (B, d), idx (B, K) int64, vals (B, K) f32, w_gate and w_up (E, d, d_e),
// w_down (E, d_e, d), y (B, d): contiguous, 16-byte aligned; x, the weights
// and y in dtype (0 f32, 1 bf16). act (B K, d_e) in dtype and part (splits,
// B, d) f32 are scratch (part null at one split). d and d_e multiples of 16
// bytes' values; tpr_up and tpr_down 4 or 8; 1 <= K <= 64. Returns the first
// cudaGetLastError() of the launches that is not 0 (cudaErrorInvalidValue for
// arguments it does not take, before any launch).
extern "C" int repro_moe_decode(const void* x, const void* idx, const void* vals,
                                const void* w_gate, const void* w_up, const void* w_down,
                                void* act, void* part, void* y, int batch, int top_k, int d,
                                int d_e, int n_experts, int dtype, int tpr_up, int tpr_down,
                                int splits, void* stream) {
  const int vec = dtype == 1 ? 8 : 4;
  if ((dtype != 0 && dtype != 1) || batch < 1 || batch > 65535 || top_k < 1 ||
      top_k > MAX_TOP_K || n_experts < 1 || d < vec || d_e < vec || d % vec || d_e % vec ||
      (tpr_up != 4 && tpr_up != 8) || (tpr_down != 4 && tpr_down != 8) || splits < 1 ||
      splits > top_k * d_e || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* ix = static_cast<const long long*>(idx);
  const float* gv = static_cast<const float*>(vals);
  float* pt = static_cast<float*>(part);
  const cudaError_t e =
      dtype == 1 ? launch_all<__nv_bfloat16>(x, ix, gv, w_gate, w_up, w_down, act, pt, y, batch,
                                             top_k, d, d_e, n_experts, tpr_up, tpr_down, splits, s)
                 : launch_all<float>(x, ix, gv, w_gate, w_up, w_down, act, pt, y, batch, top_k,
                                     d, d_e, n_experts, tpr_up, tpr_down, splits, s);
  return static_cast<int>(e);
}
