// K3: single-token decode attention against a KV cache (GQA), for sm_90a,
// as a split-KV flash-decode with a deterministic combine inside the kernel.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (body
// _decode_kernel), a Pallas TPU kernel with lengths scalar-prefetched, whose
// grid walks (batch * q_heads, kv blocks) in order, masks key positions
// >= lengths[b], skips blocks wholly past the length, and returns zeros at
// length 0 (l is clamped, decode_attention.py:65).
//
// What bounds it on the H100: one query row against the valid prefix of the
// cache is O(1) FLOP per byte, so the bound is the bytes of K and V below
// lengths[b] (545 KB at llama3.2-1b's 266 valid keys: 0.00017 ms at 3.35
// TB/s). At that size a call is the launch and a chain of memory latencies
// (lengths, then the K/V rows, then the partials), so the design spreads the
// prefix over the card and keeps each CTA to one trip to memory per tile.
//
// Design:
// - Split-KV. The grid is batch * kv_heads * n_splits CTAs. The host picks
//   n_splits from the shapes only (decode_attention.py::n_splits), never
//   from lengths, so the launch needs no host sync and can be captured in a
//   CUDA graph. Each CTA reads lengths[b] itself and takes keys
//   [s * chunk, (s + 1) * chunk) of the valid prefix, chunk =
//   ceil(len / n_splits) rounded up to KEY_GRAN keys
//   (decode_attention.py::split_range): the work follows the prefix, not the
//   cache's capacity.
// - One CTA serves all `group` query heads of its kv head, so each K and V
//   row is read once. Per tile of TK = 32 * W keys, the V rows go to shared
//   memory by 16-byte cp.async and the K rows to registers by 16-byte loads
//   (lane = key), all issued before any is used. q sits in shared memory in
//   f32 and is read as broadcasts. The tile updates an f32 online softmax
//   (max and sum over warps in a fixed order); for PV a thread owns two
//   adjacent columns of some heads and reads P from shared memory.
// - Combine. Each CTA writes its partial (m, l and the f32 PV sum, per head)
//   to a workspace the wrapper allocates. The last CTA of a (batch, kv head)
//   to finish, known by an atomic ticket (acq_rel, gpu scope, taken after a
//   bar.sync), merges the n_splits partials in split order and writes the
//   output, then resets its ticket to 0, so the next call and every graph
//   replay start clean. The fixed order makes the result bitwise repeatable.
//   An empty split writes m = -inf, l = 0 and is merged as a factor of 0; a
//   length of 0 gives zeros, as the Pallas kernel does.
// - CUDA cores, not tensor cores: at the main shape the work is 2.2 MFLOP
//   over 545 KB. A wgmma tile has 64 rows and mma.sync at least 16, against
//   4 query heads a kv head, so either would waste most of the product.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KEY_GRAN = 32;    // a split's keys are a multiple of this
constexpr int MAX_SPLITS = 32;  // as decode_attention.py; the merge gives a lane each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// 8 consecutive elements held as loaded: one 16-byte load for bf16, two for f32.
template <typename T> struct Vec8;
template <> struct Vec8<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void unpack(float out[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};
template <> struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void unpack(float out[8]) const {
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
};

// two adjacent elements, 4-byte (bf16) or 8-byte (f32) aligned
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// Warps per CTA: 4 (a 128-key tile) where the static shared memory allows,
// else 2. G is the group size rounded up to a power of two.
template <typename T, int D, int G>
constexpr int smem_bytes(int w) {
  return 32 * w * D * static_cast<int>(sizeof(T)) + G * 32 * w * 4 + G * D * 4 + 2 * w * G * 4 + G * 4;
}
template <typename T, int D, int G>
constexpr int warps() { return smem_bytes<T, D, G>(4) <= 46 * 1024 ? 4 : 2; }

template <typename T, int D, int G, int W>
__global__ void __launch_bounds__(32 * W)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ lengths, T* __restrict__ o, float* __restrict__ ws,
              int* __restrict__ tickets, int q_heads, int kv_heads, int s_len, int group,
              int n_splits, float sm_scale) {
  constexpr int THREADS = 32 * W;
  constexpr int TK = 32 * W;            // keys a tile
  constexpr int CH = D * sizeof(T) / 16;  // 16-byte chunks a row
  constexpr int PAIRS = D / 2;          // PV: a thread owns two adjacent columns ...
  constexpr int HS = THREADS / PAIRS;   // ... of heads hs, hs + HS, ...
  constexpr int NH = (G + HS - 1) / HS;
  static_assert(HS >= 1, "a thread a column pair");
  static_assert(TK * D * sizeof(T) >= MAX_SPLITS * G * 4, "merge scratch must fit in vs");
  __shared__ __align__(16) float qs[G][D];
  __shared__ __align__(16) T vs[TK][D];  // the tile's V rows; the merge's scratch after
  __shared__ __align__(16) float ps[G][TK];
  __shared__ float red_m[W][G];
  __shared__ float red_l[W][G];
  __shared__ float alpha_s[G];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int bk = blockIdx.x / n_splits;  // b * kv_heads + kv head
  const int split = blockIdx.x % n_splits;
  const int b = bk / kv_heads;
  const int h0 = (bk % kv_heads) * group;
  const int pv_hs = tid / PAIRS;
  const int dp = 2 * (tid % PAIRS);
  const bool pv_thread = tid < HS * PAIRS;

  for (int idx = tid; idx < G * D; idx += THREADS) {
    const int g = idx / D, c = idx % D;
    qs[g][c] = g < group ? to_f32(q[((int64_t)b * q_heads + h0 + g) * D + c]) : 0.f;
  }
  // this split's keys: decode_attention.py::split_range
  const int len = max(0, min(lengths[b], s_len));
  const int per = (len + n_splits - 1) / n_splits;
  const int chunk = max(KEY_GRAN, (per + KEY_GRAN - 1) / KEY_GRAN * KEY_GRAN);
  const int start = min(split * chunk, len);
  const int end = min(start + chunk, len);

  // workspace: partial p = bk * n_splits + split holds acc[group][D], m[group], l[group]
  const int part = group * (D + 2);
  float* my = ws + ((int64_t)bk * n_splits + split) * part;

  if (start < end) {
    const T* kp = k + (int64_t)bk * s_len * D;
    const T* vp = v + (int64_t)bk * s_len * D;
    // AP partial PV sums a column, over keys r % AP, added in a fixed order
    // at the end: shorter FMA chains where a thread has few heads
    constexpr int AP = NH == 1 ? 4 : NH == 2 ? 2 : 1;
    float m[G], l[G], acc[NH][AP][2];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int u = 0; u < AP; ++u) acc[j][u][0] = acc[j][u][1] = 0.f;

    for (int t0 = start; t0 < end; t0 += TK) {
      const int n = min(TK, end - t0);
      const int n4 = (n + 3) & ~3;
      // V rows [t0, t0 + n4) to shared memory; rows past n are zero-filled
      for (int idx = tid; idx < n4 * CH; idx += THREADS) {
        const int r = idx / CH, c = idx % CH;
        const T* src = vp + (int64_t)(t0 + min(r, n - 1)) * D + c * (16 / sizeof(T));
        cp_async16(&vs[r][c * (16 / sizeof(T))], src, r < n);
      }
      cp_async_commit();
      // this lane's K row to registers
      const int key = t0 + warp * 32 + lane;
      const bool live = key < end;
      Vec8<T> kr[D / 8];
      if (live) {
        const T* row = kp + (int64_t)key * D;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) kr[c].load(row + 8 * c);
      }
      __syncthreads();  // qs written (first tile); vs, ps and red_* free (later tiles)

      float x[G];
#pragma unroll
      for (int g = 0; g < G; ++g) x[g] = 0.f;
      if (live) {
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          float kf[8];
          kr[c].unpack(kf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 qa = *reinterpret_cast<const float4*>(&qs[g][8 * c]);
            const float4 qb = *reinterpret_cast<const float4*>(&qs[g][8 * c + 4]);
            x[g] = fmaf(qa.x, kf[0], x[g]);
            x[g] = fmaf(qa.y, kf[1], x[g]);
            x[g] = fmaf(qa.z, kf[2], x[g]);
            x[g] = fmaf(qa.w, kf[3], x[g]);
            x[g] = fmaf(qb.x, kf[4], x[g]);
            x[g] = fmaf(qb.y, kf[5], x[g]);
            x[g] = fmaf(qb.z, kf[6], x[g]);
            x[g] = fmaf(qb.w, kf[7], x[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        x[g] = live ? x[g] * sm_scale : -INFINITY;
        const float wm = warp_max(x[g]);
        if (lane == 0) red_m[warp][g] = wm;
      }
      __syncthreads();
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float tm = red_m[0][g];
#pragma unroll
        for (int w = 1; w < W; ++w) tm = fmaxf(tm, red_m[w][g]);
        const float m_new = fmaxf(m[g], tm);  // finite: key t0 is live
        const float p = live ? expf(x[g] - m_new) : 0.f;
        ps[g][warp * 32 + lane] = p;
        const float wsum = warp_sum(p);
        if (lane == 0) red_l[warp][g] = wsum;
        const float alpha = expf(m[g] - m_new);  // 0 on the first tile
        if (tid == 0) alpha_s[g] = alpha;
        l[g] *= alpha;
        m[g] = m_new;
      }
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int w = 0; w < W; ++w) l[g] += red_l[w][g];
      }
      if (pv_thread) {
        float al[NH];
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          const int g = pv_hs + j * HS;
          al[j] = g < G ? alpha_s[g] : 0.f;
#pragma unroll
          for (int u = 0; u < AP; ++u) {
            acc[j][u][0] *= al[j];
            acc[j][u][1] *= al[j];
          }
        }
#pragma unroll 2
        for (int r = 0; r < n4; r += 4) {
          float2 vr[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) vr[i] = load2(&vs[r + i][dp]);
#pragma unroll
          for (int j = 0; j < NH; ++j) {
            const int g = pv_hs + j * HS;
            if (g < G) {
              const float4 p4 = *reinterpret_cast<const float4*>(&ps[g][r]);
              const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                acc[j][i % AP][0] = fmaf(pr[i], vr[i].x, acc[j][i % AP][0]);
                acc[j][i % AP][1] = fmaf(pr[i], vr[i].y, acc[j][i % AP][1]);
              }
            }
          }
        }
      }
      __syncthreads();  // before the next tile overwrites vs, ps, red_*
    }

    if (pv_thread) {
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const int g = pv_hs + j * HS;
        float a0 = acc[j][0][0], a1 = acc[j][0][1];
#pragma unroll
        for (int u = 1; u < AP; ++u) {
          a0 += acc[j][u][0];
          a1 += acc[j][u][1];
        }
        if (g < group) store2(my + g * D + dp, a0, a1);
      }
    }
    if (tid == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g < group) {
          my[group * D + g] = m[g];
          my[group * D + group + g] = l[g];
        }
      }
    }
  } else if (tid < group) {  // an empty split: merged as a factor of 0
    my[group * D + tid] = -INFINITY;
    my[group * D + group + tid] = 0.f;
  }

  // The last CTA of this (batch, kv head) to arrive merges. The bar.sync
  // orders every thread's partial before thread 0's ticket, an acq_rel
  // atomic at gpu scope: its release publishes this CTA's partial, its
  // acquire and the next bar.sync order the merge's reads after every
  // other CTA's partial.
  __syncthreads();
  if (tid == 0) {
    int ticket;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;"
                 : "=r"(ticket) : "l"(&tickets[bk]) : "memory");
    last = ticket == n_splits - 1;
  }
  __syncthreads();
  if (!last) return;

  // Merge, split by split in order. The PV sums of the first SB splits are
  // loaded together with every split's m and l, so that up to SB splits take
  // one trip to L2; then one trip per SB splits more.
  constexpr int SB = NH >= 16 ? 1 : 16 / NH;
  float* fac = reinterpret_cast<float*>(&vs[0][0]);  // [n_splits][group]: exp(m_s - max)
  const float* first = ws + (int64_t)bk * n_splits * part;
  float2 a[NH][SB];
  auto load_block = [&](int s0) {
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const int g = pv_hs + j * HS;
#pragma unroll
      for (int i = 0; i < SB; ++i) {
        a[j][i] = make_float2(0.f, 0.f);
        if (pv_thread && g < group && s0 + i < n_splits)
          a[j][i] = __ldcg(reinterpret_cast<const float2*>(first + (int64_t)(s0 + i) * part + g * D + dp));
      }
    }
  };
  load_block(0);
  // a warp per head, a lane per split
  for (int g = warp; g < group; g += W) {
    const bool held = lane < n_splits;
    const float ms = held ? __ldcg(first + (int64_t)lane * part + group * D + g) : -INFINITY;
    const float ls = held ? __ldcg(first + (int64_t)lane * part + group * D + group + g) : 0.f;
    const float mx = warp_max(ms);
    const float f = ms == -INFINITY ? 0.f : expf(ms - mx);  // an empty split: 0
    const float lsum = warp_sum(ls * f);                    // 0 where the prefix is empty
    if (held) fac[lane * group + g] = f;
    if (lane == 0) alpha_s[g] = lsum;
  }
  __syncthreads();
  if (tid == 0) tickets[bk] = 0;
  float out[NH][2];
#pragma unroll
  for (int j = 0; j < NH; ++j) out[j][0] = out[j][1] = 0.f;
  for (int s0 = 0;;) {
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const int g = pv_hs + j * HS;
      if (pv_thread && g < group) {
#pragma unroll
        for (int i = 0; i < SB; ++i) {
          const float f = s0 + i < n_splits ? fac[(s0 + i) * group + g] : 0.f;
          if (f != 0.f) {  // an empty split's PV sum is never written: skip it
            out[j][0] = fmaf(a[j][i].x, f, out[j][0]);
            out[j][1] = fmaf(a[j][i].y, f, out[j][1]);
          }
        }
      }
    }
    s0 += SB;
    if (s0 >= n_splits) break;
    load_block(s0);
  }
  if (pv_thread) {
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const int g = pv_hs + j * HS;
      if (g < group) {
        const float lsum = fmaxf(alpha_s[g], 1e-20f);  // empty prefix: zeros
        store2(&o[((int64_t)b * q_heads + h0 + g) * D + dp], out[j][0] / lsum, out[j][1] / lsum);
      }
    }
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* o, void* ws,
           void* tickets, int batch, int q_heads, int kv_heads, int s_len, int n_splits,
           float sm_scale, cudaStream_t stream) {
  constexpr int W = warps<T, D, G>();
  decode_kernel<T, D, G, W><<<batch * kv_heads * n_splits, 32 * W, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(o), static_cast<float*>(ws), static_cast<int*>(tickets), q_heads, kv_heads,
      s_len, q_heads / kv_heads, n_splits, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

#define REPRO_DECODE_ARGS q, k, v, lengths, o, ws, tickets, batch, q_heads, kv_heads, s_len, n_splits, sm_scale, s

template <typename T, int D>
int dispatch_g(const void* q, const void* k, const void* v, const int* lengths, void* o,
               void* ws, void* tickets, int batch, int q_heads, int kv_heads, int s_len,
               int n_splits, float sm_scale, cudaStream_t s) {
  const int group = q_heads / kv_heads;
  if (group <= 1) return launch<T, D, 1>(REPRO_DECODE_ARGS);
  if (group <= 2) return launch<T, D, 2>(REPRO_DECODE_ARGS);
  if (group <= 4) return launch<T, D, 4>(REPRO_DECODE_ARGS);
  if (group <= 8) return launch<T, D, 8>(REPRO_DECODE_ARGS);
  if (group <= 16) return launch<T, D, 16>(REPRO_DECODE_ARGS);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, const int* lengths, void* o,
               void* ws, void* tickets, int batch, int q_heads, int kv_heads, int s_len,
               int n_splits, float sm_scale, cudaStream_t s) {
  switch (d) {
    case 64: return dispatch_g<T, 64>(REPRO_DECODE_ARGS);
    case 96: return dispatch_g<T, 96>(REPRO_DECODE_ARGS);
    case 128: return dispatch_g<T, 128>(REPRO_DECODE_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o (batch, q_heads, 1, d); k, v (batch, kv_heads, s_len, d); lengths
// (batch,) int32 on the device; all contiguous and 16-byte aligned.
// workspace: batch * kv_heads * n_splits * group * (d + 2) floats, no
// initial value needed. tickets: batch * kv_heads int32, zero before the
// first call; every call leaves them zero. Calls that share tickets must not
// run at the same time. dtype: 0 = float32, 1 = bfloat16. d in {64, 96,
// 128}; q_heads / kv_heads <= 16; 1 <= n_splits <= MAX_SPLITS (32). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* lens, void* o, void* ws, void* tickets,
                                      int batch, int q_heads, int kv_heads, int s_len, int d,
                                      int n_splits, float sm_scale, int dtype, void* stream) {
  if (n_splits < 1 || n_splits > MAX_SPLITS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lengths = static_cast<const int*>(lens);
  if (dtype == 0) return dispatch_d<float>(d, REPRO_DECODE_ARGS);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(d, REPRO_DECODE_ARGS);
  return static_cast<int>(cudaErrorInvalidValue);
}

#undef REPRO_DECODE_ARGS
