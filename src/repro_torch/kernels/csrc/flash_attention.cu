// K2: flash attention for prefill (causal or full, GQA, optional sliding window), for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (body
// _flash_kernel), a Pallas TPU kernel whose grid walks (batch * q_heads,
// q blocks, kv blocks) in order, carrying the running max, sum and f32
// accumulator in VMEM scratch across the sequential kv axis, skipping kv
// blocks above the causal diagonal, and rounding P to the input type before
// the PV product.
//
// What bounds it on the H100: at the serving prefill shapes (one prompt of
// 64-256 tokens, 32 query heads, 8 kv heads, head_dim 64, bf16) the work is
// about 0.26 GFLOP (causal) on about 2.6 MB, so the least time is set by
// bytes and is under a microsecond. What sets the real time is latency: one
// CTA's serial chain of at most four kv tiles (load, QK^T, softmax, PV) plus
// the launch.
//
// Two bodies, picked by dtype in repro_flash_attention (a fixed dispatch, not
// a fallback; each dtype has exactly one body):
//
// * bf16 (the serving path): flash_tc_kernel, on the tensor cores. One CTA
//   of one warpgroup (128 threads) per (batch * q-head, 64-row q tile); the
//   grid's slow axis walks q tiles from the last, so the tiles with the most
//   kv tiles (the bottom of the causal triangle) start first. QK^T is
//   wgmma.mma_async m64n64k16 (bf16 in, f32 accumulate) with Q and K both
//   K-major in shared memory. The softmax runs on the accumulator fragment in
//   registers (each thread holds two rows; row max and sum take two quad
//   shuffles), in f32 with exp2 on log2e-scaled scores. P is rounded to bf16
//   as the Pallas kernel rounds it, and the converted S fragment is already
//   the register A-fragment of the PV wgmma (m64n{64,128}k16, B = V,
//   MN-major, transpose bit set): P never goes through shared memory, and no
//   block barrier separates the softmax from PV. K and V come in through a
//   two-stage ring filled by 16-byte cp.async.cg copies, one commit group a
//   tile, so tile t+1 loads while tile t computes; rows past kv_seq (and q
//   rows past q_seq) are zero-filled by the copy's src-size operand. Every
//   tile is stored with the 128-byte swizzle the wgmma descriptors name: a
//   64-column bf16 row is one 128-byte line, d = 128 is two 64-column atoms,
//   each atom 1024-byte aligned. d = 96 reads only six k16 steps of QK^T, so
//   atom 1's unused columns never enter it, and computes PV at n = 128: V's
//   columns 96-127 (never written) reach only output columns 96-127, which
//   are not stored.
//   cp.async is chosen over TMA: a TMA tensor map would have to be encoded on
//   the host at every call (q, k and v are new tensors at every layer), on a
//   path whose host is already the bottleneck, through libcuda's
//   cuTensorMapEncodeTiled. A later version would move the copies to TMA
//   with a warp-specialised producer and overlap one tile's softmax with the
//   next tile's QK^T.
//
// * f32: flash_kernel, IEEE FFMA on shared-memory tiles (one CTA of 256
//   threads per q tile, Q and K transposed in shared memory, P through
//   shared memory). f32 stays off the tensor cores because the f32 model is
//   held to 1e-4 of the plain path, which TF32 would not meet.
//
// Both bodies: GQA by kv head h / (q_heads / kv_heads); the causal mask is
// end-aligned, q_pos = i + kv_seq - q_seq (the oracle's convention, ref.py),
// which equals the Pallas kernel's top-left mask in the square case prefill
// uses; masked scores are -1e30 and the output is divided by max(l, 1e-20),
// as in the Pallas kernel; ragged q and kv tails are masked inside the
// kernel, so serving's unpadded prompts never fall back; the kv loop ends at
// the causal diagonal (the skip of flash_attention.py:64-66).
//
// Sliding window (window > 0; 0 is none): a key is kept only where
// q_pos - k_pos < window, on top of the causal mask (and without it, as the
// oracle's attention_ref(window=) keeps it). The Pallas kernel has no
// window; the reference computes a windowed prefill with that oracle. The kv
// loop starts at the tile of the q tile's first row's left edge,
// max(0, q0 + off - window + 1) / BKV, so it reads only the band; a tile
// that straddles a row's left edge is masked like the diagonal tile. A row
// whose running max is still -1e30 (every key it has seen masked, which
// happens when its band starts in a later tile than its q tile's first row)
// adds nothing: its exponents are taken against 0 instead of its max, so
// every -1e30 score gives exactly 0 and the row starts its online softmax
// at its first kept key (one select a row a tile, not one an element).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr float NEG_BIG = -1e30f;

// ---------------------------------------------------------------------------
// f32: IEEE FFMA body
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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
             int causal, int window, float sm_scale) {
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
  // the first kv tile in the band of the q tile's first row
  const int t0 = window > 0 ? max(0, q0 + off - window + 1) / BKV : 0;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int t = t0; t < n_tiles; ++t) {
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
        const bool ok = k_pos < kv_seq && (!causal || q_pos >= k_pos) &&
                        (window <= 0 || q_pos - k_pos < window);
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
      const float m_sub = m_cur > NEG_BIG ? m_cur : 0.f;  // 0 while no key is kept
      const float p0 = expf(x0 - m_sub), p1 = expf(x1 - m_sub);
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

// ---------------------------------------------------------------------------
// bf16: tensor-core body
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;  // one warpgroup
constexpr int ATOM = BQ * 128;   // bytes of one 64-column atom of a 64-row tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (bf16 columns 8c..8c+7) of row r in a tile
// stored as 64-column atoms with the 128-byte swizzle: chunk c & 7 of a row
// sits at position (c & 7) ^ (r & 7) of the row's 128-byte line.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (c >> 3) * ATOM + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (each >> 4), layout type 1 in
// bits 62-63, base offset 0 (every atom is 1024-byte aligned).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  // src-size 0 zero-fills the 16 bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// cp.async writes through the generic proxy, wgmma reads through the async
// proxy: each writer fences before the barrier that precedes the wgmma
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from touching wgmma registers between launch and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 64, f32) (+)= A (64 x 16, smem) * B (16 x 64, smem), both K-major
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], uint32_t a0, uint32_t a1,
                                                    uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], uint32_t a0, uint32_t a1,
                                                    uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}


// Rows [row0, row0 + 64) of a (rows, D) bf16 matrix into a swizzled tile by
// cp.async; rows at or past n_rows are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* g, int row0,
                                          int n_rows, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int it = 0; it < BQ * CH / TC_THREADS; ++it) {
    const int i = tid + it * TC_THREADS;
    const int r = i / CH, c = i % CH;
    const bool in = row0 + r < n_rows;
    cp_async16(tile + swizzled(r, c), g + (int64_t)(in ? row0 + r : 0) * D + c * 8, in);
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int q_heads,
                int kv_heads, int q_seq, int kv_seq, int causal, int window, float sm_scale) {
  constexpr int ATOMS = (D + 63) / 64;  // 64-column atoms a row spans
  constexpr int TILE = ATOMS * ATOM;    // bytes of one 64-row tile
  constexpr int NPV = ATOMS * 64;       // width of the PV product
  constexpr int KSTEPS = D / 16;        // k16 steps of QK^T
  extern __shared__ uint8_t smem_raw[];
  // Q | K stage 0 | K stage 1 | V stage 0 | V stage 1, each 1024-byte aligned
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + TILE;
  const uint32_t sv = sq + 3 * TILE;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / q_heads;
  const int h = bh % q_heads;
  const int kvh = h / (q_heads / kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the q tiles with most kv tiles first
  const int off = kv_seq - q_seq;

  const __nv_bfloat16* qp = q + (int64_t)bh * q_seq * D;
  const __nv_bfloat16* kp = k + ((int64_t)b * kv_heads + kvh) * kv_seq * D;
  const __nv_bfloat16* vp = v + ((int64_t)b * kv_heads + kvh) * kv_seq * D;
  __nv_bfloat16* op = o + (int64_t)bh * q_seq * D;

  int n_tiles = (kv_seq + BKV - 1) / BKV;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BQ, q_seq) - 1 + off) / BKV + 1);
  // the first kv tile in the band of the q tile's first row
  const int t0 = window > 0 ? max(0, q0 + off - window + 1) / BKV : 0;
  // the lowest key that every row of the tile keeps (the last row's band edge)
  const int band_lo = window > 0 ? q0 + BQ + off - window : INT_MIN;

  // commit group 0: Q and kv tile t0; group 1: kv tile t0 + 1 (empty if
  // none); the group committed after tile t holds tile t + 2, so tile t is
  // in group t - t0, and in ring stage (t - t0) & 1
  load_tile<D>(sq, qp, q0, q_seq, tid);
  load_tile<D>(sk, kp, t0 * BKV, kv_seq, tid);
  load_tile<D>(sv, vp, t0 * BKV, kv_seq, tid);
  cp_async_commit();
  if (t0 + 1 < n_tiles) {
    load_tile<D>(sk + TILE, kp, (t0 + 1) * BKV, kv_seq, tid);
    load_tile<D>(sv + TILE, vp, (t0 + 1) * BKV, kv_seq, tid);
  }
  cp_async_commit();

  const float scale = sm_scale * LOG2E;  // scores in log2 units: exp(x) = exp2(x log2 e)
  const int r0 = warp * 16 + lane / 4;   // this thread's rows r0, r0 + 8 of the tile
  const int c0 = 2 * (lane % 4);         // and columns 8j + c0, 8j + c0 + 1
  float m[2] = {NEG_BIG, NEG_BIG};
  float l[2] = {0.f, 0.f};  // this thread's part of the row sums
  float acc[NPV / 2];
#pragma unroll
  for (int i = 0; i < NPV / 2; ++i) acc[i] = 0.f;

  for (int t = t0; t < n_tiles; ++t) {
    const int st = (t - t0) & 1;
    const int kv0 = t * BKV;
    cp_async_wait1();  // this thread's copies of tile t have landed
    fence_async_shared();
    __syncthreads();  // and everyone's

    // S = Q K^T, 64 x 64 in f32; accumulator element 4j + 2hh + e is row
    // r0 + 8hh, column 8j + c0 + e
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const uint32_t koff = (ks / 4) * ATOM + (ks % 4) * 32;  // k16 step: 32 bytes into the atom
      wgmma_ss_m64n64k16(s, make_desc(sq + koff, 16, 1024),
                         make_desc(sk + st * TILE + koff, 16, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // mask, then the online softmax in f32 (two quad shuffles a row)
    const bool edge = kv0 + BKV > kv_seq || (causal && kv0 + BKV - 1 > q0 + off) ||
                      kv0 < band_lo;
    float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[4 * j + 2 * hh + e] * scale;
          if (edge) {
            const int k_pos = kv0 + 8 * j + c0 + e;
            const int q_pos = q0 + r0 + 8 * hh + off;
            if (k_pos >= kv_seq || (causal && k_pos > q_pos) ||
                (window > 0 && q_pos - k_pos >= window))
              x = NEG_BIG;
          }
          s[4 * j + 2 * hh + e] = x;
          mx[hh] = fmaxf(mx[hh], x);
        }
      }
    }
    float alpha[2];
    float m_sub[2];  // the row's max, or 0 while no key is kept
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      alpha[hh] = exp2f(m[hh] - m_new);
      m[hh] = m_new;
      m_sub[hh] = m_new > NEG_BIG ? m_new : 0.f;
      l[hh] *= alpha[hh];
    }
    // P in bf16, as the PV wgmma's A fragment: register 4kk + i of the
    // k16 step kk packs accumulator elements 2(4kk + i) and 2(4kk + i) + 1
    uint32_t pa[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int hh = i % 2;
      const float p0 = exp2f(s[2 * i] - m_sub[hh]);
      const float p1 = exp2f(s[2 * i + 1] - m_sub[hh]);
      l[hh] += p0 + p1;
      pa[i] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int j = 0; j < NPV / 8; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        acc[4 * j + 2 * hh] *= alpha[hh];
        acc[4 * j + 2 * hh + 1] *= alpha[hh];
      }
    }

    // O += P V: V's tile is 64 kv rows x NPV columns, MN-major for this
    // product; a k16 step is 16 rows (2048 bytes) down the atom
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = make_desc(sv + st * TILE + kk * 16 * 128, ATOM, 1024);
      if constexpr (NPV == 64)
        wgmma_rs_m64n64k16(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3], dv);
      else
        wgmma_rs_m64n128k16(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3], dv);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    fence_regs(pa);

    __syncthreads();  // every warp is done with stage st
    if (t + 2 < n_tiles) {
      load_tile<D>(sk + st * TILE, kp, kv0 + 2 * BKV, kv_seq, tid);
      load_tile<D>(sv + st * TILE, vp, kv0 + 2 * BKV, kv_seq, tid);
    }
    cp_async_commit();
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int row = q0 + r0 + 8 * hh;
    if (row >= q_seq) continue;
    const float inv = 1.f / fmaxf(l[hh], 1e-20f);
    __nv_bfloat16* orow = op + (int64_t)row * D + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hh] * inv, acc[4 * j + 2 * hh + 1] * inv);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int batch, int q_heads,
               int kv_heads, int q_seq, int kv_seq, int causal, int window, float sm_scale,
               cudaStream_t stream) {
  // Above 48 KB of dynamic shared memory needs the opt-in. It is set once,
  // at the first launch, so that no later launch (one inside a CUDA graph
  // capture, say) makes the call; the port drives one card.
  static bool configured = false;
  const size_t smem = Smem<D>::bytes;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_kernel<float, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((q_seq + BQ - 1) / BQ, batch * q_heads);
  flash_kernel<float, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), q_heads, kv_heads, q_seq, kv_seq, causal, window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int batch, int q_heads,
                int kv_heads, int q_seq, int kv_seq, int causal, int window, float sm_scale,
                cudaStream_t stream) {
  // Q and two stages of K and V, plus room to align the first tile to 1024
  static bool configured = false;
  const size_t smem = 5 * ((D + 63) / 64) * ATOM + 1024;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid(batch * q_heads, (q_seq + BQ - 1) / BQ);
  flash_tc_kernel<D><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), q_heads, kv_heads,
      q_seq, kv_seq, causal, window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o (batch, q_heads, q_seq, d); k, v (batch, kv_heads, kv_seq, d); all
// contiguous, bf16 ones 16-byte aligned. dtype: 0 = float32 (the FFMA body),
// 1 = bfloat16 (the tensor-core body). d in {64, 96, 128}. window: the
// sliding window in keys, 0 for none.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int batch, int q_heads, int kv_heads, int q_seq,
                                     int kv_seq, int d, int causal, int window, float sm_scale,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_ARGS \
  q, k, v, o, batch, q_heads, kv_heads, q_seq, kv_seq, causal, window, sm_scale, s
  if (dtype == 0) {
    switch (d) {
      case 64: return launch_f32<64>(REPRO_FLASH_ARGS);
      case 96: return launch_f32<96>(REPRO_FLASH_ARGS);
      case 128: return launch_f32<128>(REPRO_FLASH_ARGS);
    }
  } else if (dtype == 1) {
    switch (d) {
      case 64: return launch_bf16<64>(REPRO_FLASH_ARGS);
      case 96: return launch_bf16<96>(REPRO_FLASH_ARGS);
      case 128: return launch_bf16<128>(REPRO_FLASH_ARGS);
    }
  }
#undef REPRO_FLASH_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
