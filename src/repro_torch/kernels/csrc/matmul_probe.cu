// K1: tiled matrix product C = A @ B, the Minos probe, for sm_90a.
//
// Replaces: src/repro/kernels/matmul_probe.py::matmul (body _matmul_kernel),
// a Pallas TPU kernel with (128, 128, 512) MXU blocks and an f32 VMEM
// accumulator carried across the sequential K grid axis.
//
// What bounds it on the H100: at the probe's size (n = 512, f32) the product
// does 2n^3 = 268 MFLOP on 3 MiB, so it is bound by operations. f32 must run
// in IEEE FFMA (67 TFLOP/s), not TF32: the probe does the f32 work the JAX
// probe does and is held to rtol 2e-3 / atol 2e-2.
//
// Design: one CTA of 256 threads per 64x64 output tile. The K loop stages a
// 64x16 tile of A (transposed, so a thread's row reads are broadcasts) and a
// 16x64 tile of B through shared memory; each thread keeps a 4x4 block of f32
// accumulators in registers (rows ty + 16i, columns tx + 16j, so the B reads
// of a warp hit 16 consecutive banks). Ragged M, N and K edges are masked in
// the loads and the store, so the caller pads nothing. The result is cast to
// the input type on store. bf16 inputs are widened to f32 in shared memory and
// take the same FFMA path: no tensor cores, no cp.async, no TMA. That is the
// first thing a faster version changes (wgmma on bf16, a cp.async/TMA ring).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Row-major, contiguous A (m, k), B (k, n),
// C (m, n). Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_matmul(const void* a, const void* b, void* c, int m, int n, int k,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, c, m, n, k, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, c, m, n, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
