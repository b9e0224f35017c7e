// Batch-invariant float32 batched matrix product on Hopper (sm_90a):
//
//     c[z] = a[z] @ b[z]        a[z] (M, K), b[z] (K, N), c (batch, M, N)
//
// a and b are read through arbitrary element strides (batch, row, column),
// so a transposed operand is the same matrix with its two strides swapped
// and a batch stride of 0 shares one matrix with every product of the
// batch; c is written contiguous.
//
// Replaces no TPU kernel. The JAX package leaves its float32 products to
// XLA; the port's task plane (federated/task.py, federated/cohort.py) runs
// every float32 product of its two models, forward and backward, through
// this kernel on the card, because a library's product sums in an order
// that depends on the batch count (a cuBLAS bmm of 2 or more parts from
// the lone mm in the last bits at lm_tiny's shapes) and the loop engine
// must equal the vectorized engine, and a sweep its sequential runs, bit
// for bit.
//
// The order: every output element is one chain of fused multiply-adds
// from +0 over k = 0, 1, ..., K-1 in order, kept by one thread in one
// register: no split-K, no atomics, no reduction across threads, no TF32
// (the CUDA cores' FFMA). So an element depends on its row of a, its
// column of b and K alone, not on M, N, the batch count, the tiling or
// the launch; padding k with zeros past K adds +0 and changes nothing (the
// chain never holds -0), and so do trailing zero rows of a summed-over
// axis (a padded client's zero gradients).
//
// Bound: operations at the §V evaluation (50 models x 10,000 x 784 x 64,
// 50.2 GFLOP: 0.75 ms at the H100's 67 TFLOP/s float32), bytes or the
// launch at the training shapes (a client's step is a few MFLOP).
//
// Design: a block of 256 threads owns a 64 x 64 tile of c and walks K in
// slices of 16; each thread keeps a 4 x 4 block of c in registers (rows
// ty + 16 i, columns tx + 16 j), so a slice costs it 8 shared-memory reads
// for 16 FFMA. The slices of a and b are staged through shared memory,
// double-buffered: the next slice is read into registers while this one
// is multiplied. Each operand is read along whichever of its two strides
// is 1 (neighbouring threads on neighbouring addresses), and the tile is
// stored [k][m] / [k][n] with one word of padding a row. The batch runs
// over grid.z (a block loops when the batch exceeds 65,535).
//
// Plain C interface, loaded with ctypes; the function returns the
// cudaError_t of the launch (0 on success) and never synchronises.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kThreads = 256;                      // 16 x 16
constexpr int kLoads = kBM * kBK / kThreads;       // 4 of a and 4 of b
static_assert(kBN * kBK / kThreads == kLoads, "tile shapes");
constexpr int kMaxGridZ = 65535;

struct Slice {
  float a[kLoads];
  float b[kLoads];
};

// Where load r of thread `tid` sits in the a slice (row mm, k kk) and in
// the b slice (k kb, column nn), reading along the operand's unit stride.
__device__ __forceinline__ void a_slot(int e, bool k_fast, int& mm, int& kk) {
  if (k_fast) { mm = e / kBK; kk = e % kBK; } else { kk = e / kBM; mm = e % kBM; }
}
__device__ __forceinline__ void b_slot(int e, bool n_fast, int& kb, int& nn) {
  if (n_fast) { kb = e / kBN; nn = e % kBN; } else { nn = e / kBK; kb = e % kBK; }
}

__global__ void __launch_bounds__(kThreads)
bi_gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ c, int batch, int m, int n, int k,
               int64_t sab, int64_t sam, int64_t sak,
               int64_t sbb, int64_t sbk, int64_t sbn) {
  __shared__ float as[2][kBK][kBM + 1];
  __shared__ float bs[2][kBK][kBN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const bool a_k_fast = sak == 1 && sam != 1;
  const bool b_n_fast = sbn == 1;
  const int slices = (k + kBK - 1) / kBK;

  for (int z = blockIdx.z; z < batch; z += gridDim.z) {
    const float* pa = a + static_cast<int64_t>(z) * sab;
    const float* pb = b + static_cast<int64_t>(z) * sbb;
    Slice reg;
    auto fetch = [&](int k0) {
#pragma unroll
      for (int r = 0; r < kLoads; ++r) {
        const int e = tid + r * kThreads;
        int mm, kk, kb, nn;
        a_slot(e, a_k_fast, mm, kk);
        b_slot(e, b_n_fast, kb, nn);
        const int gm = m0 + mm, gk = k0 + kk, gn = n0 + nn, gkb = k0 + kb;
        reg.a[r] = (gm < m && gk < k) ? pa[gm * sam + gk * sak] : 0.f;
        reg.b[r] = (gn < n && gkb < k) ? pb[gkb * sbk + gn * sbn] : 0.f;
      }
    };
    auto stash = [&](int buf) {
#pragma unroll
      for (int r = 0; r < kLoads; ++r) {
        const int e = tid + r * kThreads;
        int mm, kk, kb, nn;
        a_slot(e, a_k_fast, mm, kk);
        b_slot(e, b_n_fast, kb, nn);
        as[buf][kk][mm] = reg.a[r];
        bs[buf][kb][nn] = reg.b[r];
      }
    };

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    fetch(0);
    stash(0);
    __syncthreads();
    for (int s = 0; s < slices; ++s) {
      const int buf = s & 1;
      if (s + 1 < slices) fetch((s + 1) * kBK);
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = as[buf][kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[buf][kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (s + 1 < slices) stash(buf ^ 1);
      __syncthreads();
    }

    float* pc = c + static_cast<int64_t>(z) * m * n;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + ty + 16 * i;
      if (gm >= m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + tx + 16 * j;
        if (gn < n) pc[static_cast<int64_t>(gm) * n + gn] = acc[i][j];
      }
    }
  }
}

}  // namespace

extern "C" int bi_gemm_f32(const float* a, const float* b, float* c,
                           int batch, int m, int n, int k,
                           long long sab, long long sam, long long sak,
                           long long sbb, long long sbk, long long sbn,
                           void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM,
                  batch < kMaxGridZ ? batch : kMaxGridZ);
  bi_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, batch, m, n, k, sab, sam, sak, sbb, sbk, sbn);
  return static_cast<int>(cudaGetLastError());
}
