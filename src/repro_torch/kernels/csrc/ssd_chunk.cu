// Mamba2's chunked SSD scan (the prefill form of models/ssm.py::ssd_chunked), for sm_90a.
//
// Replaces no TPU kernel: src/repro/models/ssm.py::ssd_chunked is plain jnp
// (nothing reaches pl.pallas_call). It was added because the port's plain
// version, a loop over chunks of PyTorch ops, built each chunk's decay as a
// dense (B, L, L, H) f32 tensor in device memory (about nine passes over 16.8
// MB a chunk at zamba2-1.2b's L = 256, H = 64) and launched some twenty
// kernels a chunk.
//
// What it computes, per batch row b, head h and chunk c of L positions
// (a_t = dt_t * A_h, csum the inclusive sum of a within the chunk):
//   y_i = sum_{j <= i} (C_i . B_j) exp(csum_i - csum_j) dt_j x_j      (intra)
//       + (C_i . H_c) exp(csum_i)                                       (inter)
//       + D_h x_i
//   H_{c+1} = exp(csum_last) H_c + sum_j B_j exp(csum_last - csum_j) dt_j x_j
// with H_0 = h0 or 0, every product and sum in f32 (FFMA; never TF32 or
// bf16 products), y cast to x's type at the end. A ragged last chunk (S not a
// multiple of L) reads its missing positions as dt = 0, x = B = C = 0, as the
// plain version pads them.
//
// What bounds it on the H100: at zamba2's shape (H 64, N = P = 64, L 256)
// a chunk needs about 0.54 GFLOP (the intra product with the causal half
// skipped, 4.2 MFLOP a head; the inter product and the state, 2.1 each; C.B
// once for all heads), against 2 x 2 MB of x and y: operations, at the 67
// TFLOP/s of f32 FFMA, bound it, about 8 us a chunk. At granite-4.0-h's
// (H 128, N 128, P 64) a chunk needs about 1.6 GFLOP (intra 4.2 MFLOP a
// head, inter and state 4.2 each), against 2 x 4 MB: about 24 us.
//
// Three launches a call, none of which writes an L x L x H tensor:
//
// * ssd_state_kernel: one block of 64 threads a (b, c, h) computes the
//   chunk's csum (one thread, in torch.cumsum's order: a running f32 sum of
//   the rounded products dt * A), writes it, and computes the chunk's own
//   state sum_j (B_j w_j) x_j dt_j, w_j = exp(csum_last - csum_j), an N x P
//   product over the chunk's positions in 64-position tiles. Further blocks
//   of the same launch compute C.B once a chunk (zamba2 has one group, so it
//   is shared by every head): the 64 x 64 tiles on and below the diagonal,
//   stored transposed (cb[j][i]), 3.9 MB at 3,840 tokens, which stay in L2.
// * ssd_pass_kernel: one thread an element of the state walks the chunks in
//   order, four chunks' loads issued together: it writes the state each
//   chunk starts from, H_c, and H_final. (h * exp(csum_last)) + own, each
//   rounded, as the plain version's two operations round.
// * ssd_out_kernel: one block of 64 threads a (b, c, h, 64-row tile of the
//   chunk), the tiles with the most work launched first. It starts from the
//   inter part, (C_i . H_c) exp(csum_i), and adds the intra part tile by tile
//   along j up to the diagonal: the scores (C_i . B_j) exp(csum_i - csum_j)
//   of a 64 x 64 tile are made from cb in shared memory, zero above the
//   diagonal (the plain version's exp(-1e30)), and multiplied by the tile's
//   x dt. Then D x is added and y is cast and stored.
//
// A state wider than 64 (N 128) is taken in blocks of 64 of its rows: the
// chunk's own state one block after another, C.B and the inter product as
// sums over the blocks of N in order, so that every operand tile stays 64 x
// 64 and the sums run in the order of one pass over N.
//
// Every product is a 64-thread tile product on shared memory: an 8 x 8 grid
// of threads, each holding an (M/8) x (W/8) block of the output in registers
// and reading two float4s of each operand a step (rows t*4.., 32 + t*4..),
// so a warp's loads are broadcasts or 128 contiguous bytes. A tile's global
// loads are issued in batches of eight a thread before any is used (with
// two warps a block and about six blocks an SM, one load at a time left the
// blocks waiting on memory: on an H100, 0.305 against 0.224 ms a call at S
// 2048). dt * A, the
// decays and the skip term are rounded as the plain version's elementwise
// ops round (__fmul_rn, __fadd_rn, accurate expf): with the same inputs
// csum and each decay are the plain version's bit for bit; the sums of
// products are taken in another order than cuBLAS takes them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 64;         // positions (rows) of a tile
constexpr int THREADS = 64;   // an 8 x 8 grid of threads
constexpr int TILE = T * 64;  // floats of one operand buffer (64 rows of at most 64)

struct Params {
  const void* x;    // (B, S, H, P): strides x_sb, x_ss, x_sh; P contiguous
  const float* dt;  // (B, S, H) contiguous
  const float* A;   // (H,)
  const void* Bm;   // (B, S, N): strides b_sb, b_ss; N contiguous
  const void* Cm;   // (B, S, N): strides c_sb, c_ss; N contiguous
  const float* D;   // (H,)
  const float* h0;  // (B, H, N, P) contiguous, or null
  void* y;          // (B, S, H, P) contiguous, x's type
  float* h_final;   // (B, H, N, P)
  float* states;    // (B, nC, H, N, P): each chunk's own state
  float* starts;    // (B, nC, H, N, P): the state each chunk starts from
  float* csum;      // (B, H, nC, Lp): csum within each chunk, held past its last position
  float* cb;        // (B, nC, Lp, Lp): cb[j][i] = B_j . C_i for the tiles with j's <= i's
  long long x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss;
  int batch, seq, heads, L, n_chunks, n_tiles;
};

// Four consecutive elements of an input, loaded as one vector and widened to f32.
template <typename X>
struct Elem;

template <>
struct Elem<float> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ void widen(Raw r, float* v) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Elem<__nv_bfloat16> {
  using Raw = uint2;
  static __device__ __forceinline__ Raw load4(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  static __device__ __forceinline__ Raw zero() { return make_uint2(0u, 0u); }
  static __device__ __forceinline__ void widen(Raw r, float* v) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// The e-th of the W/8 indices that thread coordinate t (0..7) holds of a
// W-wide row: t*W/16 .. and W/2 + t*W/16 ..
template <int W>
__device__ __forceinline__ int frag(int t, int e) {
  constexpr int H = W / 16;
  return e < H ? t * H + e : W / 2 + t * H + (e - H);
}

template <int W>
__device__ __forceinline__ void load_frag(const float* row, int t, float (&v)[W / 8]) {
  if constexpr (W == 64) {
    const float4 a = *reinterpret_cast<const float4*>(row + t * 4);
    const float4 b = *reinterpret_cast<const float4*>(row + 32 + t * 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < W / 8; ++e) v[e] = row[frag<W>(t, e)];
  }
}

// acc[m][w] += sum_k As[k][m] * Bs[k][w] over K steps, As rows of M floats,
// Bs rows of W floats; thread (ty, tx) holds rows frag<M>(ty, .) and
// columns frag<W>(tx, .).
template <int M, int W, int K>
__device__ __forceinline__ void mma(const float* As, const float* Bs, int ty, int tx,
                                    float (&acc)[M / 8][W / 8]) {
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    float a[M / 8], b[W / 8];
    load_frag<M>(As + k * M, ty, a);
    load_frag<W>(Bs + k * W, tx, b);
#pragma unroll
    for (int i = 0; i < M / 8; ++i)
#pragma unroll
      for (int j = 0; j < W / 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// dst[j][c..c+3] = f(j, src row first + j, columns c..c+3) for a 64 x W tile
// (rows past `valid` read as zeros). Thread tid takes column group tid % (W/4)
// of every (THREADS / (W/4))-th row; the global loads are issued in batches
// of eight before any is used, so their latencies overlap.
template <typename X, int W, typename F>
__device__ __forceinline__ void load_rows(float* dst, const X* src, long long stride, int first,
                                          int valid, int tid, F f) {
  constexpr int PER_ROW = W / 4, STEP = THREADS / PER_ROW, ITER = T / STEP;
  constexpr int BATCH = ITER < 8 ? ITER : 8;
  const int j0 = tid / PER_ROW, c = (tid % PER_ROW) * 4;
#pragma unroll
  for (int r0 = 0; r0 < ITER; r0 += BATCH) {
    typename Elem<X>::Raw raw[BATCH];
#pragma unroll
    for (int r = 0; r < BATCH; ++r) {
      const int pos = first + j0 + (r0 + r) * STEP;
      raw[r] = pos < valid ? Elem<X>::load4(src + pos * stride + c) : Elem<X>::zero();
    }
#pragma unroll
    for (int r = 0; r < BATCH; ++r) {
      const int j = j0 + (r0 + r) * STEP;
      float v[4];
      Elem<X>::widen(raw[r], v);
      f(j, c, v);
      *reinterpret_cast<float4*>(dst + j * W + c) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// 64 rows of an N-wide input map from row `first`, transposed into dst[n][j]
// (rows past `valid` are zeros). Thread tid takes row tid, so the stores do
// not conflict; its loads are issued together.
template <typename X, int N>
__device__ __forceinline__ void load_transposed(float* dst, const X* src, long long stride,
                                                int first, int valid, int tid) {
  const int pos = first + tid;
  typename Elem<X>::Raw raw[N / 4];
#pragma unroll
  for (int r = 0; r < N / 4; ++r)
    raw[r] = pos < valid ? Elem<X>::load4(src + pos * stride + r * 4) : Elem<X>::zero();
#pragma unroll
  for (int r = 0; r < N / 4; ++r) {
    float v[4];
    Elem<X>::widen(raw[r], v);
#pragma unroll
    for (int k = 0; k < 4; ++k) dst[(r * 4 + k) * T + tid] = v[k];
  }
}

// dst[j][p] = x_j[p] * dt_j for the 64 positions from `first` (zeros past `valid`)
template <typename X, int P>
__device__ __forceinline__ void load_xdt(float* dst, const X* x, long long stride,
                                         const float* dts, int first, int valid, int tid) {
  load_rows<X, P>(dst, x, stride, first, valid, tid, [&](int j, int, float* v) {
    const float d = dts[first + j];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __fmul_rn(v[k], d);
  });
}

struct Chunk {
  int b, c, h, c0, Lc;
};

__device__ __forceinline__ Chunk chunk_of(const Params& p, int q) {
  Chunk k;
  k.h = q % p.heads;
  k.c = (q / p.heads) % p.n_chunks;
  k.b = q / (p.heads * p.n_chunks);
  k.c0 = k.c * p.L;
  k.Lc = min(p.L, p.seq - k.c0);
  return k;
}

// ssd_state_kernel's first blocks: csum of (b, c, h) and the chunk's own state
template <typename X, int N, int P>
__device__ __forceinline__ void chunk_state(const Params& p, int q, float* smem) {
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int Lp = p.n_tiles * T;
  float* As = smem;       // [T][NB]: B_j w_j, rows n0.. of the state
  float* Bs = As + TILE;  // [T][P]: x_j dt_j
  float* cs = Bs + TILE;  // [Lp]: csum, then w
  float* dts = cs + Lp;   // [Lp]
  constexpr int NB = N < 64 ? N : 64;  // rows of the state a tile holds
  const Chunk k = chunk_of(p, q);
  const float* dt = p.dt + ((long long)k.b * p.seq + k.c0) * p.heads + k.h;
  for (int j = tid; j < Lp; j += THREADS) dts[j] = j < k.Lc ? dt[(long long)j * p.heads] : 0.f;
  __syncthreads();
  if (tid == 0) {
    // torch.cumsum's order on the card: one running f32 sum from 0 of the
    // rounded products dt * A; held past the chunk's last position, where
    // the plain version adds its padding's zeros
    const float a = p.A[k.h];
    float acc = 0.f;
    for (int j0 = 0; j0 < Lp; j0 += 8) {
      float d[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j] = dts[j0 + j];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j0 + j < k.Lc) acc = __fadd_rn(acc, __fmul_rn(d[j], a));
        cs[j0 + j] = acc;
      }
    }
  }
  __syncthreads();
  const float last = cs[k.Lc - 1];
  __syncthreads();  // read by every thread before its place is overwritten
  float* out_cs = p.csum + (((long long)k.b * p.heads + k.h) * p.n_chunks + k.c) * Lp;
  for (int j = tid; j < Lp; j += THREADS) {
    out_cs[j] = cs[j];
    cs[j] = expf(__fsub_rn(last, cs[j]));  // w_j; each j is read and written by one thread
  }
  __syncthreads();

  const X* Bm = static_cast<const X*>(p.Bm) + k.b * p.b_sb + (long long)k.c0 * p.b_ss;
  const X* x = static_cast<const X*>(p.x) + k.b * p.x_sb + (long long)k.c0 * p.x_ss +
               k.h * p.x_sh;
  float* out = p.states + (((long long)k.b * p.n_chunks + k.c) * p.heads + k.h) * N * P;
  for (int n0 = 0; n0 < N; n0 += NB) {
    float acc[NB / 8][P / 8] = {};
    for (int t0 = 0; t0 < k.Lc; t0 += T) {
      load_rows<X, NB>(As, Bm + n0, p.b_ss, t0, k.Lc, tid, [&](int j, int, float* v) {
        const float w = cs[t0 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = __fmul_rn(v[i], w);
      });
      load_xdt<X, P>(Bs, x, p.x_ss, dts, t0, k.Lc, tid);
      __syncthreads();
      mma<NB, P, T>(As, Bs, ty, tx, acc);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < NB / 8; ++i)
#pragma unroll
      for (int j = 0; j < P / 8; ++j)
        out[(n0 + frag<NB>(ty, i)) * P + frag<P>(tx, j)] = acc[i][j];
  }
}

// ssd_state_kernel's last blocks: one 64 x 64 tile of cb[j][i] = B_j . C_i
template <typename X, int N>
__device__ __forceinline__ void chunk_cb(const Params& p, int q, float* smem) {
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int Lp = p.n_tiles * T;
  const int n_low = p.n_tiles * (p.n_tiles + 1) / 2;
  int t = q % n_low;
  const int c = (q / n_low) % p.n_chunks, b = q / (n_low * p.n_chunks);
  int it = 0;  // the tile pair (it, jt), jt <= it, of index t in row order
  while (t > it) {
    t -= it + 1;
    ++it;
  }
  const int jt = t;
  constexpr int NB = N < 64 ? N : 64;  // rows of the state a tile holds
  const int c0 = c * p.L, Lc = min(p.L, p.seq - c0);
  float* As = smem;       // [NB][T]: B^T, rows n0.. of N
  float* Bs = As + TILE;  // [NB][T]: C^T
  const X* Bm = static_cast<const X*>(p.Bm) + b * p.b_sb + (long long)c0 * p.b_ss;
  const X* Cm = static_cast<const X*>(p.Cm) + b * p.c_sb + (long long)c0 * p.c_ss;
  float acc[8][8] = {};
  for (int n0 = 0; n0 < N; n0 += NB) {
    load_transposed<X, NB>(As, Bm + n0, p.b_ss, jt * T, Lc, tid);
    load_transposed<X, NB>(Bs, Cm + n0, p.c_ss, it * T, Lc, tid);
    __syncthreads();
    mma<T, T, NB>(As, Bs, ty, tx, acc);
    __syncthreads();
  }
  float* out = p.cb + ((long long)b * p.n_chunks + c) * Lp * Lp + (long long)jt * T * Lp + it * T;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = out + (long long)frag<T>(ty, i) * Lp;
    *reinterpret_cast<float4*>(row + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 32 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

template <typename X, int N, int P>
__global__ void __launch_bounds__(THREADS) ssd_state_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n_state = p.batch * p.n_chunks * p.heads;
  if ((int)blockIdx.x < n_state)
    chunk_state<X, N, P>(p, blockIdx.x, smem);
  else
    chunk_cb<X, N>(p, blockIdx.x - n_state, smem);
}

template <int N, int P>
__global__ void __launch_bounds__(256) ssd_pass_kernel(Params p) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)p.batch * p.heads * N * P) return;
  const int np = e % (N * P);
  const long long bh = e / (N * P);  // b * heads + h
  const int h = bh % p.heads;
  const long long b = bh / p.heads;
  const int Lp = p.n_tiles * T;
  const float* cs = p.csum + bh * p.n_chunks * Lp;
  const long long step = (long long)p.heads * N * P;  // from one chunk to the next
  const long long at = (b * p.n_chunks * p.heads + h) * N * P + np;
  float hv = p.h0 != nullptr ? p.h0[e] : 0.f;
  // four chunks' own states and decays loaded together, then carried in order
  for (int c0 = 0; c0 < p.n_chunks; c0 += 4) {
    float own[4], decay[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = min(c0 + u, p.n_chunks - 1);
      own[u] = p.states[at + c * step];
      decay[u] = expf(cs[c * Lp + min(p.L, p.seq - c * p.L) - 1]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u < p.n_chunks) {
        p.starts[at + (c0 + u) * step] = hv;
        hv = __fadd_rn(__fmul_rn(hv, decay[u]), own[u]);
      }
    }
  }
  p.h_final[e] = hv;
}

template <typename X, int N, int P>
__global__ void __launch_bounds__(THREADS) ssd_out_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int Lp = p.n_tiles * T;
  const int per_tile = p.batch * p.n_chunks * p.heads;
  const int rt = p.n_tiles - 1 - (int)blockIdx.x / per_tile;  // the longest rows first
  const Chunk k = chunk_of(p, (int)blockIdx.x % per_tile);
  const int r0 = rt * T;
  if (r0 >= k.Lc) return;  // past a ragged last chunk's end
  constexpr int NB = N < 64 ? N : 64;  // rows of the state a tile holds
  float* As = smem;       // [T][T] scores (j, i), or [NB][T] C^T (rows n0.. of N)
  float* Bs = As + TILE;  // [T][P] x dt, or [NB][P] the chunk's starting state
  float* cs = Bs + TILE;  // [Lp]
  float* dts = cs + Lp;   // [Lp]
  const float* csum = p.csum + (((long long)k.b * p.heads + k.h) * p.n_chunks + k.c) * Lp;
  const float* dt = p.dt + ((long long)k.b * p.seq + k.c0) * p.heads + k.h;
  for (int j = tid; j < r0 + T; j += THREADS) {
    cs[j] = csum[j];
    dts[j] = j < k.Lc ? dt[(long long)j * p.heads] : 0.f;
  }
  float acc[8][P / 8] = {};
  if (k.c > 0 || p.h0 != nullptr) {
    // inter: (C_i . H_c) exp(csum_i), summed over N in blocks of NB
    const X* Cm = static_cast<const X*>(p.Cm) + k.b * p.c_sb + (long long)k.c0 * p.c_ss;
    const float4* st = reinterpret_cast<const float4*>(
        p.starts + (((long long)k.b * p.n_chunks + k.c) * p.heads + k.h) * N * P);
    for (int n0 = 0; n0 < N; n0 += NB) {
      load_transposed<X, NB>(As, Cm + n0, p.c_ss, r0, k.Lc, tid);
#pragma unroll
      for (int r = 0; r < NB * P / 4 / THREADS; ++r)
        reinterpret_cast<float4*>(Bs)[tid + r * THREADS] = st[n0 * P / 4 + tid + r * THREADS];
      __syncthreads();
      mma<T, P, NB>(As, Bs, ty, tx, acc);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float g = expf(cs[r0 + frag<T>(ty, i)]);
#pragma unroll
      for (int j = 0; j < P / 8; ++j) acc[i][j] = __fmul_rn(acc[i][j], g);
    }
  }
  __syncthreads();
  const X* x = static_cast<const X*>(p.x) + k.b * p.x_sb + (long long)k.c0 * p.x_ss +
               k.h * p.x_sh;
  const float* cb = p.cb + ((long long)k.b * p.n_chunks + k.c) * Lp * Lp + r0;
  const int ci = (tid % (T / 4)) * 4;  // this thread's four columns i of every score row
  float cs_i[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) cs_i[m] = cs[r0 + ci + m];
  for (int jt = 0; jt <= rt; ++jt) {
    const int j0 = jt * T;
    // scores (C_i . B_j) exp(csum_i - csum_j), zero where j > i
    load_rows<float, T>(As, cb, Lp, j0, Lp, tid, [&](int j, int i4, float* v) {
      const float cj = cs[j0 + j];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        v[m] = (jt < rt || j <= i4 + m) ? __fmul_rn(v[m], expf(__fsub_rn(cs_i[m], cj))) : 0.f;
    });
    load_xdt<X, P>(Bs, x, p.x_ss, dts, j0, k.Lc, tid);
    __syncthreads();
    mma<T, P, T>(As, Bs, ty, tx, acc);
    __syncthreads();
  }
  // y = intra + inter + D x, in x's type
  const float d = p.D[k.h];
  X* y = static_cast<X*>(p.y) + (((long long)k.b * p.seq + k.c0) * p.heads + k.h) * P;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + frag<T>(ty, i);
    if (row >= k.Lc) continue;
    const X* xr = x + row * p.x_ss;
    X* yr = y + (long long)row * p.heads * P;
#pragma unroll
    for (int j = 0; j < P / 8; ++j) {
      const int col = frag<P>(tx, j);
      Elem<X>::store(yr + col, __fadd_rn(acc[i][j], __fmul_rn(Elem<X>::load(xr + col), d)));
    }
  }
}

template <typename X, int N, int P>
int launch(const Params& p, cudaStream_t s) {
  // two operand tiles, csum and dt of the chunk: under 48 KB for L <= 2048
  const size_t smem = (2 * TILE + 2 * p.n_tiles * T) * sizeof(float);
  const int n_state = p.batch * p.n_chunks * p.heads;
  const int n_cb = p.batch * p.n_chunks * (p.n_tiles * (p.n_tiles + 1) / 2);
  ssd_state_kernel<X, N, P><<<n_state + n_cb, THREADS, smem, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long elems = (long long)p.batch * p.heads * N * P;
  ssd_pass_kernel<N, P><<<(unsigned)((elems + 255) / 256), 256, 0, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_out_kernel<X, N, P><<<n_state * p.n_tiles, THREADS, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, S, H, P) with strides x_sb, x_ss, x_sh and P contiguous; dt (B, S, H)
// f32 contiguous; A, D (H,) f32; Bm, Cm (B, S, N) with strides (b_sb, b_ss),
// (c_sb, c_ss) and N contiguous, in x's type; h0 (B, H, N, P) f32 or null.
// x, Bm and Cm start and step by multiples of 4 elements. (N, P) = (d_state,
// head_dim) in {(16, 16), (64, 64), (128, 64)}; chunk is min(chunk, S), at
// most 2048. Out: y (B, S, H, P) in x's
// type and h_final (B, H, N, P) f32, contiguous. Workspaces, f32: states and
// starts (B, nC, H, N, P), csum (B, H, nC, Lp), cb (B, nC, Lp, Lp), with nC =
// ceil(S / chunk) and Lp = chunk rounded up to 64. dtype: 0 = float32, 1 =
// bfloat16. Returns the first cudaGetLastError() of the three launches that
// is not 0.
extern "C" int repro_ssd_chunked(const void* x, const void* dt, const void* A, const void* Bm,
                                 const void* Cm, const void* D, const void* h0, void* y,
                                 void* h_final, void* states, void* starts, void* csum, void* cb,
                                 int batch, int seq, int heads, int d_state, int head_dim,
                                 int chunk,
                                 long long x_sb, long long x_ss, long long x_sh, long long b_sb,
                                 long long b_ss, long long c_sb, long long c_ss, int dtype,
                                 void* stream) {
  if (seq < 1 || chunk < 1 || chunk > 2048) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.Bm = Bm;
  p.Cm = Cm;
  p.D = static_cast<const float*>(D);
  p.h0 = static_cast<const float*>(h0);
  p.y = y;
  p.h_final = static_cast<float*>(h_final);
  p.states = static_cast<float*>(states);
  p.starts = static_cast<float*>(starts);
  p.csum = static_cast<float*>(csum);
  p.cb = static_cast<float*>(cb);
  p.x_sb = x_sb;
  p.x_ss = x_ss;
  p.x_sh = x_sh;
  p.b_sb = b_sb;
  p.b_ss = b_ss;
  p.c_sb = c_sb;
  p.c_ss = c_ss;
  p.batch = batch;
  p.seq = seq;
  p.heads = heads;
  p.L = chunk;
  p.n_chunks = (seq + chunk - 1) / chunk;
  p.n_tiles = (chunk + T - 1) / T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int shape = d_state * 1000 + head_dim;
  if (dtype == 0) {
    switch (shape) {
      case 16016: return launch<float, 16, 16>(p, s);
      case 64064: return launch<float, 64, 64>(p, s);
      case 128064: return launch<float, 128, 64>(p, s);
    }
  } else if (dtype == 1) {
    switch (shape) {
      case 16016: return launch<__nv_bfloat16, 16, 16>(p, s);
      case 64064: return launch<__nv_bfloat16, 64, 64>(p, s);
      case 128064: return launch<__nv_bfloat16, 128, 64>(p, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
