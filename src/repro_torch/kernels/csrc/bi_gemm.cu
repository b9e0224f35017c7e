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
// from +0 over k = 0, 1, ..., K-1 in order, then over zeros up to the next
// multiple of 16 (fmaf(0, 0, acc), which turns nothing but a -0 into +0),
// kept by one thread in one register: no split-K, no atomics, no reduction
// across threads, no TF32, no tensor cores (the CUDA cores' FFMA). So an
// element depends on its row of a, its column of b and K alone, not on M,
// N, the batch count, the tiling, the configuration or the launch; zeros
// appended to k add +0, and so do trailing zero rows of a summed-over axis
// (a padded client's zero gradients). The configuration below is chosen by
// shape; it decides which thread computes an element, never how.
//
// Bound: operations at the §V evaluation (48 models x 10,000 x 784 x 64,
// 48.2 GFLOP: 0.72 ms at the H100's 67 TFLOP/s float32), bytes at the
// training shapes (a client's step is a few MFLOP over a few hundred KB).
//
// Design: a block owns a BM x BN tile of c, each thread a TM x TN block of
// it in registers. K is walked in slices of 16 or 32 through a ring of 4-6
// shared-memory stages filled by cp.async: the slices ahead are in flight
// while one is multiplied (a K of fewer slices gets that many stages, so
// more blocks fit an SM). An operand is staged by 16-byte copies along
// whichever of its strides is 1: kK, rows of k (a row of m of a, of n of b
// — x^T's or w's unit stride), or kW, rows of m or n holding k (x's or
// w^T's); an operand that is not aligned for 16-byte copies is copied 4
// bytes at a time (kAny, both operands then). Copies past an edge are
// filled with zeros by the copy itself. Every fragment the chains read is
// one 128-bit shared load (LDS.128): along m or n from a kK stage, the
// thread's rows (columns) taken in groups of 4 neighbours so that a
// quarter-warp's loads are contiguous or one broadcast; along k from a kW
// stage, 4 steps at once, its columns one apart so that a quarter-warp's
// rows fall on distinct banks — 8 to 10.7 FFMA a shared load. Four
// configurations: 64 x 64 tiles of 8 x 4 a thread where they fill the
// card twice over (the evaluations), the same tile of 4 x 4 in slices of
// 16 for a K under 64 (a client's 50 samples: the products start sooner);
// 32 x 64 of 4 x 4 where 64 x 64 tiles leave SMs empty (a client's 50
// rows: the training products); 32 x 32 where N is at most 32. The grid is
// (N tiles, M tiles, batch), or the batch first where an operand is shared
// by it (the evaluation's x, whose tiles then stay in L2 across the models
// that read them together).
//
// Plain C interface, loaded with ctypes; the function returns the
// cudaError_t of the launch (0 on success) and never synchronises.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPad = 4;          // words a staged row is padded by
constexpr int kGroup = 16;       // the chain runs to a multiple of 16 k
constexpr int kMaxGrid = 65535;  // grid.y and grid.z

// How an operand's slice is staged: kK rows of k (16-byte copies along the
// operand's unit stride of m or n), kW rows of m or n (16-byte copies
// along its unit stride of k), or kAny: rows of k, copied 4 bytes at a
// time whatever the strides (an unaligned operand; both operands then)
enum Stage { kK = 0, kW = 1, kAny = 2 };

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 or 4 bytes from global to shared memory; the bytes past `bytes` are
// filled with zeros (`bytes` 0 reads nothing)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Args {
  const float* a;
  const float* b;
  float* c;
  int batch, m, n, k;
  int64_t sab, sam, sak, sbb, sbk, sbn;
  int batch_first;   // the grid's x is the batch (else the N tiles, z the batch)
};

// BK: k a slice (16 or 32), STAGES slices in the ring
template <int BM_, int BN_, int TM_, int TN_, int BK_, int STAGES_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = BK_, STAGES = STAGES_;
  static constexpr int kMinBlocks = MIN_BLOCKS_;
  static constexpr int kTY = BM / TM, kTX = BN / TN;
  static constexpr int kThreads = kTY * kTX;
  static constexpr int kRowK = BK + kPad;                       // a kW row
  static constexpr int kA = (BM + kPad) * BK > BM * kRowK ? (BM + kPad) * BK : BM * kRowK;
  static constexpr int kB = (BN + kPad) * BK > BN * kRowK ? (BN + kPad) * BK : BN * kRowK;
  static constexpr int kStage = kA + kB;                         // floats a stage
  static constexpr int kSmem = static_cast<int>(sizeof(float)) * STAGES * kStage;
  static_assert(BM % TM == 0 && BN % TN == 0 && TM % 4 == 0 && TN % 4 == 0, "tile");
  static_assert(kTX >= 8 && kThreads % 32 == 0, "a quarter-warp spans 8 columns");
  static_assert(BK * BM % (4 * kThreads) == 0 && BK * BN % (4 * kThreads) == 0, "copies");
  static_assert(BK == kGroup || BK == 2 * kGroup, "a slice is one or two groups");
};

// One kBK-deep slice of an operand into its stage: element (w, kk) is
// g[(w0 + w) * sw + (k0 + kk) * sk], zero where w0 + w >= w_lim or
// k0 + kk >= k_lim; staged at s[kk * (W + kPad) + w] (kK, kAny) or
// s[w * kRowK + kk] (kW).
template <int W, int NT, int STAGE, int kBK>
__device__ __forceinline__ void copy_slice(float* s, const float* g, int64_t sw, int64_t sk,
                                           int w0, int w_lim, int k0, int k_lim, int tid) {
  constexpr int kRowK = kBK + kPad;
  if constexpr (STAGE == kK) {            // sw == 1: 4 along w a copy
#pragma unroll
    for (int i = 0; i < kBK * W / 4 / NT; ++i) {
      const int v = tid + i * NT;
      const int kk = v / (W / 4), w = v % (W / 4) * 4;
      const int left = w_lim - (w0 + w);
      const int bytes = k0 + kk < k_lim && left > 0 ? 4 * min(left, 4) : 0;
      const float* src = bytes ? g + (w0 + w) + static_cast<int64_t>(k0 + kk) * sk : g;
      cp_async16(s + kk * (W + kPad) + w, src, bytes);
    }
  } else if constexpr (STAGE == kW) {     // sk == 1: 4 along k a copy
#pragma unroll
    for (int i = 0; i < kBK * W / 4 / NT; ++i) {
      const int v = tid + i * NT;
      const int w = v / (kBK / 4), kk = v % (kBK / 4) * 4;
      const int left = k_lim - (k0 + kk);
      const int bytes = w0 + w < w_lim && left > 0 ? 4 * min(left, 4) : 0;
      const float* src = bytes ? g + static_cast<int64_t>(w0 + w) * sw + (k0 + kk) : g;
      cp_async16(s + w * kRowK + kk, src, bytes);
    }
  } else {                                // any strides: 8 lanes on k
#pragma unroll 4
    for (int i = 0; i < kBK * W / NT; ++i) {
      const int e = tid + i * NT;
      const int kk = e % 8 + 8 * (e / (8 * W)), w = e / 8 % W;
      const bool ok = w0 + w < w_lim && k0 + kk < k_lim;
      const float* src = ok ? g + static_cast<int64_t>(w0 + w) * sw +
                                  static_cast<int64_t>(k0 + kk) * sk
                            : g;
      cp_async4(s + kk * (W + kPad) + w, src, ok ? 4 : 0);
    }
  }
}

// The thread's rows and columns: groups of 4 neighbours (a 128-bit load of
// a kK stage), a kW stage's columns one apart (conflict-free loads of its
// rows by a quarter-warp)
template <class T>
__device__ __forceinline__ int row_of(int i, int ty) {
  return i / 4 * T::kTY * 4 + ty * 4 + i % 4;
}
template <class T, int STAGE>
__device__ __forceinline__ int col_of(int j, int tx) {
  return STAGE == kW ? tx + T::kTX * j : j / 4 * T::kTX * 4 + tx * 4 + j % 4;
}

// 4 k steps (KQ .. KQ + 3 of the stage) of the thread's chains
template <class T, int SA, int SB, int KQ>
__device__ __forceinline__ void mac4(float (&acc)[T::TM][T::TN], const float* as,
                                     const float* bs, int ty, int tx) {
  constexpr int kRowK = T::BK + kPad;
  float av[4][T::TM];
  if constexpr (SA == kW) {
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(as + row_of<T>(i, ty) * kRowK + KQ);
      av[0][i] = v.x, av[1][i] = v.y, av[2][i] = v.z, av[3][i] = v.w;
    }
  }
  float bw[4][SB == kW ? T::TN : 1];
  if constexpr (SB == kW) {
#pragma unroll
    for (int j = 0; j < T::TN; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(bs + col_of<T, kW>(j, tx) * kRowK + KQ);
      bw[0][j] = v.x, bw[1][j] = v.y, bw[2][j] = v.z, bw[3][j] = v.w;
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if constexpr (SA != kW) {
#pragma unroll
      for (int g = 0; g < T::TM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            as + (KQ + u) * (T::BM + kPad) + g * T::kTY * 4 + ty * 4);
        av[u][4 * g] = v.x, av[u][4 * g + 1] = v.y, av[u][4 * g + 2] = v.z,
        av[u][4 * g + 3] = v.w;
      }
    }
    float bv[T::TN];
    if constexpr (SB == kW) {
#pragma unroll
      for (int j = 0; j < T::TN; ++j) bv[j] = bw[u][j];
    } else {
#pragma unroll
      for (int g = 0; g < T::TN / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            bs + (KQ + u) * (T::BN + kPad) + g * T::kTX * 4 + tx * 4);
        bv[4 * g] = v.x, bv[4 * g + 1] = v.y, bv[4 * g + 2] = v.z, bv[4 * g + 3] = v.w;
      }
    }
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
#pragma unroll
      for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(av[u][i], bv[j], acc[i][j]);
  }
}

// 16 k steps (KQ .. KQ + 15 of the stage): one group of the chain
template <class T, int SA, int SB, int KQ>
__device__ __forceinline__ void mac16(float (&acc)[T::TM][T::TN], const float* as,
                                      const float* bs, int ty, int tx) {
  mac4<T, SA, SB, KQ>(acc, as, bs, ty, tx);
  mac4<T, SA, SB, KQ + 4>(acc, as, bs, ty, tx);
  mac4<T, SA, SB, KQ + 8>(acc, as, bs, ty, tx);
  mac4<T, SA, SB, KQ + 12>(acc, as, bs, ty, tx);
}

// The grid is (N tiles, M tiles, batch), or (batch, M tiles, N tiles) where
// an operand is shared by the batch (the evaluation's x: the blocks that
// run together then share its tiles in L2) or the batch exceeds grid.z's
// limit. A K of fewer slices than stages gets (and touches) that many
// stages only.
template <int BM, int BN, int TM, int TN, int BK, int STAGES, int MIN_BLOCKS, int SA, int SB>
__global__ void __launch_bounds__(BM / TM * (BN / TN), MIN_BLOCKS)
bi_gemm_kernel(const Args p) {
  using T = Tile<BM, BN, TM, TN, BK, STAGES, MIN_BLOCKS>;
  extern __shared__ __align__(16) float stages[];
  const int tid = threadIdx.x;
  const int tx = tid % T::kTX, ty = tid / T::kTX;
  const int z = p.batch_first ? blockIdx.x : blockIdx.z;
  const int m0 = blockIdx.y * T::BM, n0 = (p.batch_first ? blockIdx.z : blockIdx.x) * T::BN;
  const int slices = (p.k + BK - 1) / BK;
  const int k_end = (p.k + kGroup - 1) / kGroup * kGroup;   // the chain's length
  const float* pa = p.a + static_cast<int64_t>(z) * p.sab;
  const float* pb = p.b + static_cast<int64_t>(z) * p.sbb;
  auto load = [&](int s) {
    float* st = stages + (s % T::STAGES) * T::kStage;
    copy_slice<T::BM, T::kThreads, SA, BK>(st, pa, p.sam, p.sak, m0, p.m, s * BK, p.k, tid);
    copy_slice<T::BN, T::kThreads, SB, BK>(st + T::kA, pb, p.sbn, p.sbk, n0, p.n, s * BK,
                                            p.k, tid);
  };

  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < slices) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < slices; ++s) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();   // slice s is in; every thread is done with s - 1
    if (s + T::STAGES - 1 < slices) load(s + T::STAGES - 1);
    cp_async_commit();
    const float* as = stages + (s % T::STAGES) * T::kStage;
    const float* bs = as + T::kA;
    mac16<T, SA, SB, 0>(acc, as, bs, ty, tx);
    if constexpr (BK > kGroup) {   // the second group, unless past the chain
      if (k_end - s * BK > kGroup) mac16<T, SA, SB, kGroup>(acc, as, bs, ty, tx);
    }
  }

  float* pc = p.c + static_cast<int64_t>(z) * p.m * p.n;
  const bool vec = SB != kW && p.n % 4 == 0;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int row = m0 + row_of<T>(i, ty);
    if (row >= p.m) continue;
    float* dst = pc + static_cast<int64_t>(row) * p.n;
#pragma unroll
    for (int j = 0; j < T::TN; j += 4) {
      const int col = n0 + col_of<T, SB>(j, tx);
      if (vec && col + 3 < p.n) {
        *reinterpret_cast<float4*>(dst + col) =
            make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cc = n0 + col_of<T, SB>(j + c, tx);
          if (cc < p.n) dst[cc] = acc[i][j + c];
        }
      }
    }
  }
}

template <class T, int SA, int SB>
int launch_tile(const Args& p, cudaStream_t stream) {
  auto kernel =
      bi_gemm_kernel<T::BM, T::BN, T::TM, T::TN, T::BK, T::STAGES, T::kMinBlocks, SA, SB>;
  if (T::kSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int slices = (p.k + T::BK - 1) / T::BK;
  const int smem = static_cast<int>(sizeof(float)) * T::kStage *
                   (slices < T::STAGES ? (slices > 0 ? slices : 1) : T::STAGES);
  const int gy = (p.m + T::BM - 1) / T::BM, gn = (p.n + T::BN - 1) / T::BN;
  if (gy > kMaxGrid || (p.batch_first && gn > kMaxGrid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid = p.batch_first ? dim3(p.batch, gy, gn) : dim3(gn, gy, p.batch);
  kernel<<<grid, T::kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_stages(int sa, int sb, const Args& p, cudaStream_t s) {
  if (sa == kAny || sb == kAny) return launch_tile<T, kAny, kAny>(p, s);
  if (sa == kK) return sb == kK ? launch_tile<T, kK, kK>(p, s) : launch_tile<T, kK, kW>(p, s);
  return sb == kK ? launch_tile<T, kW, kK>(p, s) : launch_tile<T, kW, kW>(p, s);
}

// The configurations: 64 x 64 tiles where they make enough blocks to fill
// the card twice over — 8 x 4 a thread (the evaluations), or for K under 64
// (the first layer's weight gradient over a client's 50 samples) 4 x 4 a
// thread in slices of 16, which start the products sooner —; 32 x 64 tiles
// of 4 x 4 where they do not (a client's 50 rows); 32 x 32 where N is at
// most 32 (attention, the MLP's 10 classes).
using Wide = Tile<64, 64, 8, 4, 32, 4, 3>;
using Short = Tile<64, 64, 4, 4, 16, 6, 2>;
using Small = Tile<32, 64, 4, 4, 32, 4, 4>;
using Narrow = Tile<32, 32, 4, 4, 32, 4, 4>;
enum Config { kWide = 0, kShort = 1, kSmall = 2, kNarrow = 3 };
constexpr long long kFill = 2 * 132;

int launch(int cfg, int sa, int sb, const Args& p, cudaStream_t s) {
  switch (cfg) {
    case kWide: return launch_stages<Wide>(sa, sb, p, s);
    case kShort: return launch_stages<Short>(sa, sb, p, s);
    case kSmall: return launch_stages<Small>(sa, sb, p, s);
    default: return launch_stages<Narrow>(sa, sb, p, s);
  }
}

int choose(int batch, int m, int n, int k) {
  if (n <= 32) return kNarrow;
  const long long blocks = static_cast<long long>(batch) * ((m + Wide::BM - 1) / Wide::BM) *
                           ((n + Wide::BN - 1) / Wide::BN);
  if (blocks < kFill) return kSmall;
  return k < 64 ? kShort : kWide;
}

// How an operand is staged (w its tile's wide axis: m of a, n of b): by
// 16-byte copies along whichever of its strides is 1, where the matrix and
// every row of it along that stride starts on 16 bytes; else kAny.
int stage_of(const float* base, long long sbatch, long long sw, long long sk) {
  const bool aligned = reinterpret_cast<uintptr_t>(base) % 16 == 0 && sbatch % 4 == 0;
  if (aligned && sw == 1 && sk % 4 == 0) return kK;
  if (aligned && sk == 1 && sw % 4 == 0) return kW;
  return kAny;
}

}  // namespace

extern "C" int bi_gemm_f32(const float* a, const float* b, float* c,
                           int batch, int m, int n, int k,
                           long long sab, long long sam, long long sak,
                           long long sbb, long long sbk, long long sbn,
                           void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  const int batch_first = sab == 0 || sbb == 0 || batch > kMaxGrid;
  const Args p{a, b, c, batch, m, n, k, sab, sam, sak, sbb, sbk, sbn, batch_first};
  return launch(choose(batch, m, n, k), stage_of(a, sab, sam, sak), stage_of(b, sbb, sbn, sbk), p,
                static_cast<cudaStream_t>(stream));
}
