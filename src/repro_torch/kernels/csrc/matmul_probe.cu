// K1: tiled matrix product C = A @ B, the Minos probe, for sm_90a.
//
// Replaces: src/repro/kernels/matmul_probe.py::matmul (body _matmul_kernel),
// a Pallas TPU kernel with (128, 128, 512) MXU blocks and an f32 VMEM
// accumulator carried across the sequential K grid axis.
//
// What bounds it on the H100: at the probe's size (n = 512, f32) the product
// does 2n^3 = 268 MFLOP on 3 MiB, so it is bound by operations: 0.004 ms at
// 67 TFLOP/s. f32 must run in IEEE FFMA, not TF32 and not on the tensor
// cores: the probe does the f32 work the JAX probe does and is held to rtol
// 2e-3 / atol 2e-2. So what is left to win is occupancy, reuse of each
// shared-memory read, and overlap of copies with arithmetic.
//
// f32 body (matmul_f32_kernel):
// * 64x32 output tiles, so the probe's 512^3 makes 128 CTAs for the 132 SMs
//   (64x64 tiles made 64). 128 threads a CTA, each a 4x4 micro-tile: rows
//   ty + 16i, columns 4tx..4tx+3.
// * The K loop runs over a 3-stage ring of 64x32 A and 32x32 B tiles filled
//   by cp.async, one commit group a stage, so stage kt+2 loads while stage kt
//   computes; one barrier a 32-deep stage.
// * A stays row-major in shared memory: cp.async cannot transpose, and
//   staging A through registers to store it transposed would put the copy
//   back on the threads. A thread reads each of its four rows as a float4
//   along k, and each of four B rows as a float4 along n: eight LDS.128 feed
//   64 FFMA over four k steps. A's rows are padded to 36 floats, so the four
//   rows a warp reads fall in different banks; B's reads are one 128-byte
//   line, broadcast across the warp's rows.
// * Rows of A (of B) are 16-byte aligned when K (N) is a multiple of 4 and
//   the pointer is aligned; an operand whose rows are not takes 4-byte
//   cp.async copies instead of 16-byte ones. That is a template choice made
//   from the shapes and pointers inside the kernel family, not a fallback.
// * Ragged M, N and K are zero-filled by the copies' src-size operand and
//   masked at the store, so the caller pads nothing. Each output is summed
//   in order of k by one thread: no split of K, no atomics, and repeated
//   calls give bitwise equal results.
// A later version would make the CTAs persistent and give the f32 probe a
// deeper register tile; the bf16 path gets wgmma.
//
// bf16 body (matmul_kernel): one CTA of 256 threads per 64x64 output tile,
// bf16 widened to f32 in shared memory, FFMA with a 4x4 register block, no
// pipeline. bf16 is not on the probe's path; it is the first thing a later
// version moves onto wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
              int m, int n, int k) {
  __shared__ float as[BK][BM + 4];  // A tile, transposed: as[kk][row]
  __shared__ float bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    // A tile: 64 rows x 16 cols; thread loads 4 elements, adjacent threads
    // on adjacent columns of one row (coalesced in 16-element runs).
#pragma unroll
    for (int e = 0; e < (BM * BK) / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int r = idx / BK, cc = idx % BK;
      const int gr = row0 + r, gc = k0 + cc;
      as[cc][r] = (gr < m && gc < k) ? to_f32(a[(int64_t)gr * k + gc]) : 0.f;
    }
    // B tile: 16 rows x 64 cols.
#pragma unroll
    for (int e = 0; e < (BK * BN) / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int r = idx / BN, cc = idx % BN;
      const int gr = k0 + r, gc = col0 + cc;
      bs[r][cc] = (gr < k && gc < n) ? to_f32(b[(int64_t)gr * n + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gc < n) store(&c[(int64_t)gr * n + gc], acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int m, int n, int k, cudaStream_t stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  matmul_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: the probe's body
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int BM = 64;
constexpr int BN = 32;
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int THREADS = 128;
constexpr int LDA = BK + 4;  // padded row of the A tile, in floats

struct alignas(16) Tiles {
  float a[STAGES][BM][LDA];  // A tile, row-major: a[stage][row][kk]
  float b[STAGES][BK][BN];   // B tile, row-major: b[stage][kk][col]
};

// BYTES 16: cp.async.cg of a 16-byte chunk; 4: cp.async.ca of one float.
// Out of range (in == false), src-size 0 writes zeros and reads nothing.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(in ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(in ? 4 : 0)
                 : "memory");
}

// Stage st <- A[row0:row0+BM, k0:k0+BK] and B[k0:k0+BK, col0:col0+BN].
// VA (VB): A's (B's) rows are 16-byte aligned, so whole chunks are copied;
// then K (N) is a multiple of 4 and a chunk is all in range or all out.
template <bool VA, bool VB>
__device__ __forceinline__ void load_stage(Tiles& s, int st, const float* __restrict__ a,
                                           const float* __restrict__ b, int m, int n, int k,
                                           int row0, int col0, int k0, int tid) {
  constexpr int CA = VA ? 4 : 1;  // floats a copy
  constexpr int CB = VB ? 4 : 1;
#pragma unroll
  for (int e = 0; e < BM * BK / CA / THREADS; ++e) {
    const int i = tid + e * THREADS;
    const int r = i / (BK / CA), c = (i % (BK / CA)) * CA;
    const bool in = row0 + r < m && k0 + c < k;
    cp_async<4 * CA>(&s.a[st][r][c], in ? a + (int64_t)(row0 + r) * k + k0 + c : a, in);
  }
#pragma unroll
  for (int e = 0; e < BK * BN / CB / THREADS; ++e) {
    const int i = tid + e * THREADS;
    const int r = i / (BN / CB), c = (i % (BN / CB)) * CB;
    const bool in = k0 + r < k && col0 + c < n;
    cp_async<4 * CB>(&s.b[st][r][c], in ? b + (int64_t)(k0 + r) * n + col0 + c : b, in);
  }
}

template <bool VA, bool VB>
__global__ void __launch_bounds__(THREADS)
matmul_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int m, int n, int k) {
  __shared__ Tiles s;
  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int ty = tid / 8;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int nk = (k + BK - 1) / BK;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // stage kt is commit group kt (groups past nk are empty)
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load_stage<VA, VB>(s, st, a, b, m, n, k, row0, col0, st * BK, tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();  // stage kt has landed for all; stage kt - 1 is free
    const int nt = kt + STAGES - 1;
    if (nt < nk) load_stage<VA, VB>(s, nt % STAGES, a, b, m, n, k, row0, col0, nt * BK, tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const int st = kt % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const float4*>(&s.a[st][ty + 16 * i][kk]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        bv[q] = *reinterpret_cast<const float4*>(&s.b[st][kk + q][4 * tx]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ak[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][0] = fmaf(ak[q], bv[q].x, acc[i][0]);
          acc[i][1] = fmaf(ak[q], bv[q].y, acc[i][1]);
          acc[i][2] = fmaf(ak[q], bv[q].z, acc[i][2]);
          acc[i][3] = fmaf(ak[q], bv[q].w, acc[i][3]);
        }
      }
    }
  }

  const int col = col0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= m) continue;
    float* crow = c + (int64_t)row * n;
    if constexpr (VB) {  // N a multiple of 4 and C aligned: all 4 columns or none in range
      if (col < n)
        *reinterpret_cast<float4*>(crow + col) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < n) crow[col + j] = acc[i][j];
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int launch(const float* a, const float* b, float* c, int m, int n, int k, cudaStream_t stream) {
  const bool va = k % 4 == 0 && aligned16(a);
  const bool vb = n % 4 == 0 && aligned16(b) && aligned16(c);
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  if (va && vb) matmul_f32_kernel<true, true><<<grid, THREADS, 0, stream>>>(a, b, c, m, n, k);
  else if (va) matmul_f32_kernel<true, false><<<grid, THREADS, 0, stream>>>(a, b, c, m, n, k);
  else if (vb) matmul_f32_kernel<false, true><<<grid, THREADS, 0, stream>>>(a, b, c, m, n, k);
  else matmul_f32_kernel<false, false><<<grid, THREADS, 0, stream>>>(a, b, c, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

}  // namespace

// dtype: 0 = float32 (the probe's body), 1 = bfloat16. Row-major, contiguous
// A (m, k), B (k, n), C (m, n). Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int repro_matmul(const void* a, const void* b, void* c, int m, int n, int k,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return f32::launch(static_cast<const float*>(a), static_cast<const float*>(b),
                       static_cast<float*>(c), m, n, k, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, c, m, n, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
