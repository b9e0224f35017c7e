// Coordinate-wise robust aggregation on Hopper (sm_90a), the defense plane's
// trimmed mean and median over the first n of N stacked client updates:
//
//     trimmed mean  out[m] = (xs[b] + xs[b+1] + ... + xs[n-b-1]) / (n - 2b)
//     median        out[m] = (xs[(n-1)/2] + xs[n/2]) * 0.5
//
// where xs is column m of x (N, M) sorted ascending over its first n rows.
// Replaces the Pallas TPU kernel src/repro/kernels/robust_aggregate.py:31
// (`_robust_kernel`, launched by `robust_aggregate` / `_robust_call`).
//
// Bound: memory. The kernel must read n*M values and write M; at the main
// path's n = 44, M = 50,890 in f32 that is 9.16 MB, 2.73 us at the H100's
// 3.35 TB/s. Sorting needs at least log2(n!) ~ 181 comparisons a column,
// 9.2M in all, ~0.3 us at the card's 32-bit instruction rate; so bytes
// bound it, as they bound FedAvg.
//
// Design. The TPU kernel loads an (N, block_m) tile into VMEM, marks rows
// >= n with +inf and runs a statically unrolled odd-even transposition
// sort of all N rows. Here one thread owns one column: it reads only the n
// real rows (no sentinel), 8 loads in flight at a time, and a warp reads
// 32 neighbouring columns of a row, 128 contiguous bytes for f32. The
// column goes to shared memory laid out [row][thread], so the 32 threads
// of a warp hit 32 different banks, and is sorted there in place by
// insertion sort (NaN after every number, as numpy and torch.sort order
// it). The ranks b .. n-b-1 are then added in ascending order, one f32 add
// at a time, and divided once by (float)(n - 2b): the reference's
// `_seq_mean` order (src/repro/core/defenses.py:125-132), so the result is
// bit-equal to the host oracle and to the plain version. The file is built
// without --use_fast_math, so the division is IEEE. bf16 input is widened
// to f32 on load and the result is rounded once on the store (round to
// nearest even, through the intrinsics).
//
// Shared memory: n rows x 64 threads x 4 B, at most 32 KB for the largest
// n (128), inside the default 48 KB a block may take without
// cudaFuncSetAttribute; so blocks are 64 threads (796 blocks at the main
// path's M). n and b are arguments: one build serves every cohort size.
// A simple kernel that is right: insertion sort costs ~n^2/2 dependent
// shared-memory steps a warp, which a faster sort would cut.
//
// Plain C interface, loaded with ctypes; the functions return the
// cudaError_t of the launch (0 on success) and never synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;    // columns a block
constexpr int kMaxRows = 128;   // rows sorted in shared memory: 32 KB
constexpr int kBatch = 8;       // row loads in flight a thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// a sorts after b in ascending order with NaN last (x != x only for a NaN;
// the file is built without fast math, which would fold that test away)
__device__ __forceinline__ bool after(float a, float b) {
  return a > b || (a != a && b == b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
robust_kernel(const T* __restrict__ x, T* __restrict__ out, int n, int64_t m,
              int trim, int median) {
  extern __shared__ float rows[];   // [row][thread]
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= m) return;   // no barrier below: each thread owns its column
  float* v = rows + threadIdx.x;    // v[i * kThreads] is row i of column c
  const T* p = x + c;

  int i = 0;
  for (; i + kBatch <= n; i += kBatch) {
    float r[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) r[j] = to_f32(p[static_cast<int64_t>(i + j) * m]);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) v[(i + j) * kThreads] = r[j];
  }
  for (; i < n; ++i) v[i * kThreads] = to_f32(p[static_cast<int64_t>(i) * m]);

  for (int a = 1; a < n; ++a) {
    const float key = v[a * kThreads];
    int b = a - 1;
    while (b >= 0 && after(v[b * kThreads], key)) {
      v[(b + 1) * kThreads] = v[b * kThreads];
      --b;
    }
    v[(b + 1) * kThreads] = key;
  }

  float res;
  if (median) {
    res = (v[((n - 1) / 2) * kThreads] + v[(n / 2) * kThreads]) * 0.5f;
  } else {
    float acc = v[trim * kThreads];
    for (int r = trim + 1; r < n - trim; ++r) acc += v[r * kThreads];
    res = acc / static_cast<float>(n - 2 * trim);
  }
  store1(out + c, res);
}

template <typename T>
int launch(const T* x, T* out, int n, long long m, int trim, int median,
           cudaStream_t stream) {
  if (n < 1 || n > kMaxRows || m < 1 || trim < 0 || 2 * trim >= n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((m + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(n) * kThreads * sizeof(float);
  robust_kernel<T><<<blocks, kThreads, smem, stream>>>(x, out, n, m, trim, median != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int robust_aggregate_f32(const float* x, float* out, int n, long long m, int trim,
                                    int median, cudaStream_t stream) {
  return launch<float>(x, out, n, m, trim, median, stream);
}

extern "C" int robust_aggregate_bf16(const void* x, void* out, int n, long long m, int trim,
                                     int median, cudaStream_t stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x),
                               static_cast<__nv_bfloat16*>(out), n, m, trim, median, stream);
}
