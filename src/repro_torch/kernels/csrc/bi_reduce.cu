// Batch-invariant float32 reductions on Hopper (sm_90a), over the middle
// axis of a contiguous x (R, M, D):
//
//     sum        out[r, d] = sum_m x[r, m, d]                    (R, D)
//     logsumexp  out[r] = log(sum_m exp(x[r, m] - max)) + max    (R, 1), D = 1
//     argmax     out[r] = the first m of the largest x[r, m]     (R, 1) int64
//
// Replaces no TPU kernel. The JAX package leaves its reductions to XLA;
// the port's task plane (federated/task.py, federated/cohort.py) runs
// every float32 sum of its two models on the card through this kernel —
// the masked loss and accuracy sums, the mean of rms_norm, the
// logsumexp of the cross-entropy, the gradients of the vector parameters
// that a client's rows share (autograd's sums over a broadcast), the
// attention gradient's row sums — because a library's reduction chooses
// its launch, and with it the order of a row's sum, by how many rows
// there are, and the loop engine must equal the vectorized engine bit for
// bit.
//
// The order of a row depends only on the positions of its elements:
//   D > 1: one thread per output (r, d) adds x[r, 0, d], x[r, 1, d], ...
//          in order (the columns of a warp are neighbouring addresses);
//   D = 1: one warp per row, lane j adds the elements j, j + 32, j + 64,
//          ... in order, then the 32 lane sums meet in a fixed tree
//          (shuffles down by 16, 8, 4, 2, 1).
// In both, element m always lands at the same place of the same chain, so
// zeros appended to a row (a padded client's masked-out samples) change
// no bit, and nothing depends on R.
// logsumexp and argmax take one thread per row (their rows are a
// vocabulary or a head's keys long): the maximum (NaN first, as torch's
// amax), then the sum of exp(x - max) in order; argmax keeps the first of
// equal maxima and takes a NaN as the largest, as torch.argmax does.
//
// Bound: bytes — each input read once, each output written once. Every
// call of the task plane moves at most a few MB, so the launch dominates.
//
// Plain C interface, loaded with ctypes; the functions return the
// cudaError_t of the launch (0 on success) and never synchronise.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sum_columns_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int64_t r, int64_t m, int64_t d) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= r * d) return;
  const int64_t row = i / d, col = i % d;
  const float* p = x + row * m * d + col;
  float acc = 0.f;
  for (int64_t k = 0; k < m; ++k) acc += p[k * d];
  out[i] = acc;
}

__global__ void __launch_bounds__(kThreads)
sum_rows_kernel(const float* __restrict__ x, float* __restrict__ out,
                int64_t r, int64_t m) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= r) return;  // a whole warp: kThreads is a multiple of 32
  const float* p = x + row * m;
  float acc = 0.f;
  for (int64_t k = lane; k < m; k += 32) acc += p[k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[row] = acc;
}

__device__ __forceinline__ bool above(float v, float best) {
  return v > best || (isnan(v) && !isnan(best));
}

__global__ void __launch_bounds__(kThreads)
logsumexp_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int64_t r, int64_t m) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= r) return;
  const float* p = x + row * m;
  float mx = -INFINITY;
  for (int64_t k = 0; k < m; ++k) {
    const float v = p[k];
    if (above(v, mx)) mx = v;
  }
  float s = 0.f;
  for (int64_t k = 0; k < m; ++k) s += expf(p[k] - mx);
  out[row] = logf(s) + (isinf(mx) ? 0.f : mx);
}

__global__ void __launch_bounds__(kThreads)
argmax_kernel(const float* __restrict__ x, int64_t* __restrict__ out,
              int64_t r, int64_t m) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= r) return;
  const float* p = x + row * m;
  float best = p[0];
  int64_t at = 0;
  for (int64_t k = 1; k < m; ++k) {
    const float v = p[k];
    if (above(v, best)) { best = v; at = k; }
  }
  out[row] = at;
}

unsigned blocks(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int bi_sum_f32(const float* x, float* out, long long r,
                          long long m, long long d, void* stream) {
  if (r <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 1)
    sum_rows_kernel<<<blocks(r * 32), kThreads, 0, s>>>(x, out, r, m);
  else
    sum_columns_kernel<<<blocks(r * d), kThreads, 0, s>>>(x, out, r, m, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bi_logsumexp_f32(const float* x, float* out, long long r,
                                long long m, void* stream) {
  if (r <= 0) return 0;
  logsumexp_kernel<<<blocks(r), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, r, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bi_argmax_f32(const float* x, long long* out, long long r,
                             long long m, void* stream) {
  if (r <= 0) return 0;
  argmax_kernel<<<blocks(r), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, reinterpret_cast<int64_t*>(out), r, m);
  return static_cast<int>(cudaGetLastError());
}
