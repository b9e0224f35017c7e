// Grouped expert GEMM on Hopper (sm_90a): one product per expert
//
//     out[e,c,j] = sum_k x[e,c,k] * w[e,k,j]        x (E,C,K), w (E,K,N) -> (E,C,N)
//
// x, w and out contiguous, all float32 or all bfloat16; the sum is taken in
// float32 and rounded to the inputs' type once, on the store. Every edge may
// be ragged: rows past C, columns past N and the contraction past K are
// masked (zero-filled on the load, skipped on the store).
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gemm.py:18
// (`_gemm_kernel`, launched by `moe_gemm`), whose grid (E, C/bc, N/bf, K/bk)
// carries a float32 accumulator in VMEM scratch across the sequential
// contraction axis and asserts that every block divides its axis. Here one
// block owns one (BM x BN) output tile of one expert and walks the
// contraction axis itself, the accumulator in registers; blocks run in no
// order and share nothing. The edges are masked, so any C (the MoE
// capacity, 1,368 at qwen2-moe-a2.7b's prefill, is no multiple of 128), K
// and N are taken.
//
// Bound: at the MoE prefill (C in the thousands) the products are bound by
// operations, ~2·C flops a weight byte; at decode (C = 8) by the bytes of
// the expert weights, every expert's read once a launch, routed tokens or
// not (the capacity-padded dispatch computes them all, as the reference
// does).
//
// Design, bfloat16: the tensor cores through mma.sync.m16n8k16 (bf16
// operands, float32 accumulator; a bf16 x bf16 product is exact in float32,
// so this is the TPU kernel's cast-to-f32-and-dot). 128 threads, a 64 x 64
// output tile, four warps of 32 x 32 (2 x 4 mma tiles each, 32 float32
// accumulators a thread); tiles of 32 along the contraction axis staged in
// shared memory through a 3-stage cp.async ring (16 bytes a copy, zero-fill
// past the edges; every copy of a tile issued before the first is waited
// for), read into fragments with ldmatrix (.trans for w, which is K-major).
// Where a row's 16-byte chunks are not aligned (K or N not a multiple of 8,
// or a misaligned base) the chunk is loaded element by element instead.
//
// Design, float32: the CUDA cores, never TF32 (which would round the
// inputs). 256 threads, a 64 x 64 tile, each thread a 4 x 4 register tile;
// tiles of 16 along the contraction axis staged in shared memory, x
// transposed so both operands are read as float4.
//
// Plain C interface, loaded with ctypes; the functions return the
// cudaError_t of the launch (0 on success) and never synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 64;  // output rows (capacity slots) a block
constexpr int kBN = 64;  // output columns a block

// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kBK16 = 32;                // contraction a stage
constexpr int kStages = 3;
constexpr int kThreads16 = 128;
constexpr int kAStride = kBK16 + 8;      // bf16 a row of the x tile (80 bytes)
constexpr int kBStride = kBN + 8;        // bf16 a row of the w tile (144 bytes)
constexpr int kATile = kBM * kAStride;
constexpr int kBTile = kBK16 * kBStride;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; `bytes` 0 fills the chunk with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 8-element (16-byte) chunk of a row-major (rows x cols) matrix into
// shared memory: rows past `rows` and columns past `cols` read as zero. With
// `vec` (cols a multiple of 8 and the base 16-byte aligned) a chunk is all in
// or all out and goes by cp.async; else element by element.
__device__ __forceinline__ void load_chunk(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int row, int col, int rows, int cols, bool vec) {
  const bool in_row = row < rows;
  if (vec) {
    const bool in = in_row && col < cols;
    const __nv_bfloat16* p = in ? src + static_cast<size_t>(row) * cols + col : src;
    cp_async16(dst, p, in ? 16 : 0);
    return;
  }
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    dst[i] = (in_row && col + i < cols) ? src[static_cast<size_t>(row) * cols + col + i] : zero;
  }
}

__global__ void __launch_bounds__(kThreads16)
    moe_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                         __nv_bfloat16* __restrict__ out, int C, int K, int N, bool vec_x,
                         bool vec_w) {
  __shared__ __align__(16) __nv_bfloat16 sa[kStages][kATile];
  __shared__ __align__(16) __nv_bfloat16 sb[kStages][kBTile];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32;  // the warp's 32 x 32 piece of the tile
  const int wn = (warp & 1) * 32;

  const __nv_bfloat16* xe = x + static_cast<size_t>(e) * C * K;
  const __nv_bfloat16* we = w + static_cast<size_t>(e) * K * N;

  // a stage: the x tile (64 rows x 32) is 256 chunks, the w tile (32 rows x
  // 64) 256 chunks; two of each a thread, all issued before any is waited for
  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads16;
      const int r = c >> 2, k8 = (c & 3) * 8;  // x: 4 chunks a row
      load_chunk(&sa[stage][r * kAStride + k8], xe, m0 + r, k0 + k8, C, K, vec_x);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads16;
      const int r = c >> 3, n8 = (c & 7) * 8;  // w: 8 chunks a row
      // rows of w past K read as zero, like the columns of x past K
      load_chunk(&sb[stage][r * kBStride + n8], we, k0 + r, n0 + n8, K, N, vec_w);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  const int n_tiles = (K + kBK16 - 1) / kBK16;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_stage(s, s * kBK16);
    cp_async_commit();
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();               // ... and everyone's; stage (t-1) is free
    const int next = t + kStages - 1;
    if (next < n_tiles) load_stage(next % kStages, next * kBK16);
    cp_async_commit();

    const __nv_bfloat16* a_s = sa[t % kStages];
    const __nv_bfloat16* b_s = sb[t % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK16; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // lanes 0-15: rows 0-15 at k; lanes 16-31: rows 0-15 at k + 8
        const int r = wm + mi * 16 + (lane & 15);
        ldmatrix_x4(af[mi], &a_s[r * kAStride + kk + (lane >> 4) * 8]);
      }
#pragma unroll
      for (int nj = 0; nj < 4; nj += 2) {
        // lanes 0-15: k rows 0-15 at n; lanes 16-31: the same at n + 8
        uint32_t bf[4];
        const int kr = kk + (lane & 15);
        ldmatrix_x4_trans(bf, &b_s[kr * kBStride + wn + nj * 8 + (lane >> 4) * 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][nj], af[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][nj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* oe = out + static_cast<size_t>(e) * C * N;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the mma tile
        const int row = m0 + wm + mi * 16 + g + h * 8;
        const int col = n0 + wn + nj * 8 + q2;
        if (row >= C) continue;
        __nv_bfloat16* o = oe + static_cast<size_t>(row) * N + col;
        if (col < N) o[0] = __float2bfloat16(acc[mi][nj][2 * h]);
        if (col + 1 < N) o[1] = __float2bfloat16(acc[mi][nj][2 * h + 1]);
      }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kBK32 = 16;
constexpr int kThreads32 = 256;

__global__ void __launch_bounds__(kThreads32)
    moe_gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        float* __restrict__ out, int C, int K, int N, bool vec_x, bool vec_w) {
  __shared__ __align__(16) float sa[kBK32][kBM];  // x tile, transposed: [k][row]
  __shared__ __align__(16) float sb[kBK32][kBN];  // w tile: [k][col]

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tr = (tid >> 4) * 4;  // the thread's 4 rows and 4 columns
  const int tc = (tid & 15) * 4;

  const float* xe = x + static_cast<size_t>(e) * C * K;
  const float* we = w + static_cast<size_t>(e) * K * N;
  // one 4-float chunk of each tile a thread: x row ar, columns ak..ak+3;
  // w row bk, columns bn..bn+3
  const int ar = tid >> 2, ak = (tid & 3) * 4;
  const int bk = tid >> 4, bn = (tid & 15) * 4;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK32) {
    float va[4], vb[4];
    const int xr = m0 + ar, xk = k0 + ak;
    if (vec_x && xr < C && xk < K) {
      const float4 v = *reinterpret_cast<const float4*>(xe + static_cast<size_t>(xr) * K + xk);
      va[0] = v.x, va[1] = v.y, va[2] = v.z, va[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        va[i] = (xr < C && xk + i < K) ? xe[static_cast<size_t>(xr) * K + xk + i] : 0.0f;
    }
    const int wk = k0 + bk, wc = n0 + bn;
    if (vec_w && wk < K && wc < N) {
      const float4 v = *reinterpret_cast<const float4*>(we + static_cast<size_t>(wk) * N + wc);
      vb[0] = v.x, vb[1] = v.y, vb[2] = v.z, vb[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        vb[i] = (wk < K && wc + i < N) ? we[static_cast<size_t>(wk) * N + wc + i] : 0.0f;
    }
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int i = 0; i < 4; ++i) sa[ak + i][ar] = va[i];
    *reinterpret_cast<float4*>(&sb[bk][bn]) = make_float4(vb[0], vb[1], vb[2], vb[3]);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK32; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&sa[k][tr]);
      const float4 b = *reinterpret_cast<const float4*>(&sb[k][tc]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  float* oe = out + static_cast<size_t>(e) * C * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + tr + i;
    if (row >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tc + j;
      if (col < N) oe[static_cast<size_t>(row) * N + col] = acc[i][j];
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

dim3 grid_of(int e, int c, int n) { return dim3((n + kBN - 1) / kBN, (c + kBM - 1) / kBM, e); }

}  // namespace

extern "C" int moe_gemm_f32(const float* x, const float* w, float* out, int e, int c, int k,
                            int n, cudaStream_t stream) {
  const bool vec_x = k % 4 == 0 && aligned16(x);
  const bool vec_w = n % 4 == 0 && aligned16(w);
  moe_gemm_f32_kernel<<<grid_of(e, c, n), kThreads32, 0, stream>>>(x, w, out, c, k, n, vec_x,
                                                                   vec_w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int moe_gemm_bf16(const void* x, const void* w, void* out, int e, int c, int k, int n,
                             cudaStream_t stream) {
  using B = __nv_bfloat16;
  const bool vec_x = k % 8 == 0 && aligned16(x);
  const bool vec_w = n % 8 == 0 && aligned16(w);
  moe_gemm_bf16_kernel<<<grid_of(e, c, n), kThreads16, 0, stream>>>(
      static_cast<const B*>(x), static_cast<const B*>(w), static_cast<B*>(out), c, k, n, vec_x,
      vec_w);
  return static_cast<int>(cudaGetLastError());
}
