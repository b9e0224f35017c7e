// FedAvg weighted aggregation on Hopper (sm_90a):
//
//     out[m] = sum_{i=0}^{N-1} w[i] * x[i, m]        x (N, M), w (N,), out (M,)
//
// Replaces the Pallas TPU kernel src/repro/kernels/weighted_aggregate.py
// (`_agg_kernel`, launched by `weighted_aggregate`): the paper's Alg. 1
// line 13 over the N stacked client updates flattened to (N, M).
//
// Bound: memory. The kernel reads N*M values and N weights and writes M
// values, 2*N*M flops; at the main path's N = 32, M = 50,890 (f32) that is
// 6.5 MB, about 2 us at the H100's 3.35 TB/s. That is below the launch
// latency, so on the main path the kernel is launch-bound.
//
// Design: one thread owns 2 consecutive columns and walks the N rows in
// order (i = 0..N-1, the TPU kernel's accumulation order) with an f32
// accumulator per column. The main path's M gives only ~25k threads, too
// few to hide a memory latency per row, so rows are read in batches of 8,
// all 8 loads issued before the first is used: each thread keeps 8 rows in
// flight in 16 registers (with 4 columns a thread the batch outgrew the 32
// registers ptxas allotted, spilled, and took ~0.37 us a row on an H100).
// A row's 2 columns are one 8-byte float2 (f32) or one 4-byte bf16 pair
// when M is even and the pointers aligned (the main path's M = 50,890 is
// even), else two scalar loads; neighbouring threads read neighbouring
// addresses. The thread
// holding an odd M's last column reads scalars. The N weights are staged
// in shared memory once per block. The result is cast to the input dtype
// (bf16 by round-to-nearest-even through the intrinsics).
//
// Plain C interface, loaded with ctypes; the functions return the
// cudaError_t of the launch (0 on success) and never synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;   // 199 blocks at the main path's M
constexpr int kBatch = 8;       // rows in flight per thread
constexpr int kCols = 2;        // columns per thread
// the weights sit in dynamic shared memory, within its default 48 KB limit
constexpr int kMaxRows = 48 * 1024 / sizeof(float);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Read / write the 2 columns at p, as one vector when kVec (p is then
// aligned to 2 elements) or as scalars.
template <bool kVec>
__device__ __forceinline__ void load2(const float* p, float v[kCols]) {
  if constexpr (kVec) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = p[0]; v[1] = p[1];
  }
}

template <bool kVec>
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float v[kCols]) {
  if constexpr (kVec) {
    const float2 q = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = __bfloat162float(p[0]); v[1] = __bfloat162float(p[1]);
  }
}

template <bool kVec>
__device__ __forceinline__ void store2(float* p, const float v[kCols]) {
  if constexpr (kVec) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0]; p[1] = v[1];
  }
}

template <bool kVec>
__device__ __forceinline__ void store2(__nv_bfloat16* p, const float v[kCols]) {
  if constexpr (kVec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    p[0] = __float2bfloat16(v[0]); p[1] = __float2bfloat16(v[1]);
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
agg_kernel(const T* __restrict__ x, const float* __restrict__ w,
           T* __restrict__ out, int n, int64_t m) {
  extern __shared__ float sw[];
  for (int i = threadIdx.x; i < n; i += blockDim.x) sw[i] = w[i];
  __syncthreads();

  const int64_t c0 = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kCols;
  if (c0 >= m) return;
  float acc[kCols] = {0.f, 0.f};
  const T* p = x + c0;
  if (m - c0 >= kCols) {
    int i = 0;
    for (; i + kBatch <= n; i += kBatch, p += kBatch * m) {
      float v[kBatch][kCols];
#pragma unroll
      for (int r = 0; r < kBatch; ++r) load2<kVec>(p + r * m, v[r]);
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const float wi = sw[i + r];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[j] += wi * v[r][j];
      }
    }
    for (; i < n; ++i, p += m) {
      float v[kCols];
      load2<kVec>(p, v);
      const float wi = sw[i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[j] += wi * v[j];
    }
    store2<kVec>(out + c0, acc);
  } else {  // an odd M's last column
    const int cols = static_cast<int>(m - c0);
    for (int i = 0; i < n; ++i, p += m) {
      const float wi = sw[i];
      for (int j = 0; j < cols; ++j) acc[j] += wi * to_f32(p[j]);
    }
    for (int j = 0; j < cols; ++j) store1(out + c0 + j, acc[j]);
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
int launch(const T* x, const float* w, T* out, int n, long long m, cudaStream_t stream) {
  if (n < 1 || n > kMaxRows || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = (m + kCols - 1) / kCols;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  // vector loads need every row start (x + i*m + c0) and out + c0 aligned
  const size_t vec_bytes = kCols * sizeof(T);
  if (m % kCols == 0 && aligned(x, vec_bytes) && aligned(out, vec_bytes)) {
    agg_kernel<T, true><<<blocks, kThreads, smem, stream>>>(x, w, out, n, m);
  } else {
    agg_kernel<T, false><<<blocks, kThreads, smem, stream>>>(x, w, out, n, m);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int weighted_aggregate_f32(const float* x, const float* w, float* out, int n,
                                      long long m, cudaStream_t stream) {
  return launch<float>(x, w, out, n, m, stream);
}

extern "C" int weighted_aggregate_bf16(const void* x, const float* w, void* out, int n,
                                       long long m, cudaStream_t stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), w,
                               static_cast<__nv_bfloat16*>(out), n, m, stream);
}
