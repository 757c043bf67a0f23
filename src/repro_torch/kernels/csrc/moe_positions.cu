// The MoE router's queue positions (models/moe.py::dispatch_combine), for sm_90a.
//
// Replaces no TPU kernel: src/repro/models/moe.py computes the positions in
// plain jnp (a cumsum of the f32 one-hot of every (token, choice) pair down
// the row's S*K pairs; nothing reaches pl.pallas_call). It was added because
// the port's plain version of that form, aten's outer-dimension scan, gives
// each of the E columns one thread that walks all S*K rows in order: at
// granite-4.0-h-small's prefill (S 3,840, K 10, E 72) about 6 ms a layer for
// 8.5 MB in and out, some 1,000x its bytes bound.
//
// What it computes, per batch row b: pos[b, i] for the row's pairs i = s*K +
// k in that order, the number of pairs j < i of the same row with
// idx[b, j] == idx[b, i]: the pair's 0-based place in its expert's queue.
// Nothing is clipped (a pair past the capacity keeps its position). A pair
// whose index lies outside [0, E) is counted nowhere and gets 0, as the
// one-hot form gives it. The positions are integer counts, so any order of
// counting gives them exactly.
//
// What bounds it on the H100: its bytes, 12 a pair (an int64 index in, an
// int32 position out): 0.46 MB at S 3,840 and K 10, about 0.14 us at 3.35
// TB/s, far below a launch's own cost. So the design keeps the launches few
// and short and reads each index twice at most:
//
// * moe_count_kernel (only when the row has more than one chunk of CHUNK
//   pairs): one block a (chunk, row) counts the chunk's pairs of each expert
//   with atomics in shared memory (the counts are order-free) and writes
//   them, (B, n_chunks - 1, E) int32. The last chunk's counts are needed by
//   no one and are not made.
// * moe_rank_kernel: one block a (chunk, row), one thread a pair. Each
//   expert's offset is the sum of its counts in the chunks before this one
//   (at most n_chunks - 1 reads a thread, E threads). Within a warp a pair's
//   rank is the number of lower lanes holding the same expert
//   (__match_any_sync, __popc); the lowest such lane writes the warp's count
//   of that expert into a per-warp table in shared memory, which E threads
//   then turn into exclusive prefix sums over the warps, starting from the
//   chunk's offset. pos = table[warp][expert] + rank.
//
// A row of one chunk (every decode step, and a prefill of at most CHUNK / K
// tokens) takes the second launch alone, with its threads cut to the pairs
// rounded up to a warp. Sizes come from the shapes alone and nothing is read
// back to the host, so a call can be captured in a CUDA graph.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 1024;        // pairs a rank block takes, one a thread
constexpr int WARPS = CHUNK / 32;  // warps of a full rank block
constexpr int MAX_EXPERTS = 256;   // the per-warp table: WARPS x MAX_EXPERTS ints, 32 KB
constexpr int COUNT_THREADS = 256;

__global__ void __launch_bounds__(COUNT_THREADS)
moe_count_kernel(const long long* __restrict__ idx, int* __restrict__ counts, int n,
                 int n_experts) {
  __shared__ int seen[MAX_EXPERTS];
  const int chunk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  for (int e = tid; e < n_experts; e += COUNT_THREADS) seen[e] = 0;
  __syncthreads();
  const long long* row = idx + (long long)b * n;
  const int hi = min((chunk + 1) * CHUNK, n);
  for (int i = chunk * CHUNK + tid; i < hi; i += COUNT_THREADS) {
    const long long e = row[i];
    if (e >= 0 && e < n_experts) atomicAdd(&seen[e], 1);
  }
  __syncthreads();
  int* out = counts + ((long long)b * gridDim.x + chunk) * n_experts;
  for (int e = tid; e < n_experts; e += COUNT_THREADS) out[e] = seen[e];
}

__global__ void __launch_bounds__(CHUNK)
moe_rank_kernel(const long long* __restrict__ idx, const int* __restrict__ counts,
                int* __restrict__ pos, int n, int n_chunks, int n_experts) {
  __shared__ int table[WARPS * MAX_EXPERTS];  // [warp][expert], n_experts to a row
  const int chunk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  for (int k = tid; k < n_warps * n_experts; k += blockDim.x) table[k] = 0;
  const int i = chunk * CHUNK + tid;
  int key = -1;  // the pair's expert; -1 past the row's end or outside [0, E)
  if (i < n) {
    const long long e = idx[(long long)b * n + i];
    if (e >= 0 && e < n_experts) key = static_cast<int>(e);
  }
  const unsigned same = __match_any_sync(0xffffffffu, key);
  const unsigned below = same & ((1u << lane) - 1u);
  __syncthreads();  // the table is zero
  if (key >= 0 && below == 0) table[warp * n_experts + key] = __popc(same);
  __syncthreads();
  // each expert's start in every warp: the earlier chunks' pairs, then the
  // earlier warps' of this chunk
  const int* before = counts + (long long)b * (n_chunks - 1) * n_experts;
  for (int e = tid; e < n_experts; e += blockDim.x) {
    int run = 0;
    for (int c = 0; c < chunk; ++c) run += before[c * n_experts + e];
    for (int w = 0; w < n_warps; ++w) {
      const int here = table[w * n_experts + e];
      table[w * n_experts + e] = run;
      run += here;
    }
  }
  __syncthreads();
  if (i < n)
    pos[(long long)b * n + i] = key >= 0 ? table[warp * n_experts + key] + __popc(below) : 0;
}

}  // namespace

// idx (B, n) int64 contiguous, the row's pairs in (s, k) order (n = S * K);
// pos (B, n) int32 contiguous; counts (B, ceil(n / 1024) - 1, n_experts) int32,
// a workspace (null where n <= 1024). 1 <= n_experts <= 256, 1 <= B <= 65,535.
// Returns the first cudaGetLastError() of the launches that is not 0.
extern "C" int repro_moe_positions(const void* idx, void* pos, void* counts, int batch, int n,
                                   int n_experts, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || n_experts < 1 || n_experts > MAX_EXPERTS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* ix = static_cast<const long long*>(idx);
  const int n_chunks = (n + CHUNK - 1) / CHUNK;
  if (n_chunks > 1) {
    moe_count_kernel<<<dim3(n_chunks - 1, batch), COUNT_THREADS, 0, s>>>(
        ix, static_cast<int*>(counts), n, n_experts);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = n_chunks > 1 ? CHUNK : (n + 31) / 32 * 32;
  moe_rank_kernel<<<dim3(n_chunks, batch), threads, 0, s>>>(
      ix, static_cast<const int*>(counts), static_cast<int*>(pos), n, n_chunks, n_experts);
  return static_cast<int>(cudaGetLastError());
}
