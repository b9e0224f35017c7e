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
// operations, ~2·C flops a weight byte; at decode (C = 8) by bytes: x and
// the output once, and the weights of the occupied experts only. An expert
// that no token was routed to has an all-zero x block (the capacity-padded
// dispatch zero-fills its slots), so its sums are +0 and the decode kernels
// never read its weights; a roofline of the decode counts the occupied
// experts' bytes (8 decode tokens route to ~25 of qwen2-moe-a2.7b's 60
// experts and ~57 of DeepSeek-V3's 256).
//
// Design, bfloat16, C >= kWgmmaMinC (the MoE prefill): Hopper's warpgroup
// products fed by the Tensor Memory Accelerator. 384 threads: warpgroup 0
// the producer, of which one thread issues the TMA copies, and warpgroups 1
// and 2 the consumers, each owning 64 rows of a 128 x 256 output tile of
// one expert. A 4-stage ring of 64-deep contraction tiles sits in shared
// memory, 128-byte swizzled by the copy engine, with a `full` and an
// `empty` mbarrier a stage: the producer
// waits for a stage to be empty, arms its `full` barrier with the stage's
// bytes and issues one TMA copy of the x tile (128 x 64) and four of the w
// tile (64 x 64 each); a consumer waits for `full`, issues four
// wgmma.mma_async.m64n256k16 (bf16 operands from shared memory through
// matrix descriptors, float32 accumulators in registers: a bf16 x bf16
// product is exact in float32, so this is the TPU kernel's cast-to-f32
// dot), and releases the stage it used one step earlier, once its products
// have completed (one group of products stays in flight). The tensor maps
// are 3-D, over (E, C, K) for x and (E, K, N) for w, so a tile never
// crosses an expert, and the copy engine zero-fills every row past C and
// every k past K (the capacity 1,368 is no multiple of 128). w is N-major,
// as stored: wgmma reads it as an MN-major B operand through its transpose
// bit, so no transposed copy is made. The epilogue rounds each sum once to
// bf16 and skips rows past C and columns past N. The maps are encoded on
// the host for each call, in the C launcher, through cuTensorMapEncodeTiled
// looked up at run time with cudaGetDriverEntryPoint: the library links no
// -lcuda. TMA needs 16-byte strides and bases (K and N
// multiples of 8); a call that does not give them, or has C below
// kWgmmaMinC, takes a decode kernel below.
//
// Design, bfloat16, C < kWgmmaMinC (the MoE decode at C = 8; see PERF.md
// for its times beside both bounds): a product at C = 8 is a stream of the
// weights, so the design is about bytes. The operands are swapped, out[e]ᵀ =
// w[e]ᵀ x[e]ᵀ: a block owns 128 output columns of one expert, and each of
// its 8 warps 16 of them as the 16 rows of mma.sync.m16n8k16 (bf16
// operands, float32 accumulators), with the slots as the n8 side, so at C =
// 8 no lane of the product is padding (a 64-slot tile would waste 56 of its
// rows) and each weight is read once. The block first tests its
// expert's x block (passes of 16-byte loads, a block-wide vote after each;
// the first pass decides an occupied expert) and, where it is all ±0,
// writes +0 and leaves before any weight copy. Else a producer warp keeps a
// 6-stage ring of TMA copies full (each stage the x box, CT·8 slots x 64 of
// k, and two 64 x 64 boxes of w, 128-byte swizzled; 17 KB, two blocks an
// SM, ~85 KB in flight each), the weights with an evict-first L2 hint, and
// the 8 consumer warps read it with ldmatrix (.trans for w, which is
// K-major) through the swizzle, each releasing a stage after a
// fence.proxy.async (the stage is refilled through the async proxy after
// generic-proxy reads). C up to 127 takes CT = 1, 2, 4, 8 or 16 tiles of 8
// slots. Where TMA does not take the strides (K or N not a multiple of 8, a
// misaligned base; and C >= kWgmmaMinC there, in chunks of 128 slots) the
// same block and test run on a 4- to 7-stage cp.async ring of 32-deep tiles,
// element by element where a 16-byte chunk is not aligned.
//
// Design, float32: the CUDA cores, never TF32 (which would round the
// inputs). 256 threads, a 64 x 64 tile, each thread a 4 x 4 register tile;
// tiles of 16 along the contraction axis staged in shared memory, x
// transposed so both operands are read as float4.
//
// Plain C interface, loaded with ctypes; the functions return the
// cudaError_t of the launch (0 on success) and never synchronise.
#include <cuda.h>  // CUtensorMap and its enums only: nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kBM = 64;  // the float32 kernel's tile: output rows (capacity slots) a block
constexpr int kBN = 64;  // ... and output columns

// ---------------------------------------------------------------------------
// bfloat16 below kWgmmaMinC (the decode), and ragged K or N: mma.sync with the
// operands swapped, each weight read once, experts with no token skipped
// ---------------------------------------------------------------------------
constexpr int kDBN = 128;            // output columns (w's N) a block: 16 a warp
constexpr int kDBK = 32;             // contraction a stage
constexpr int kDThreads = kDBN * 2;  // a warp for each 16 columns
constexpr int kDChunks = kDBN / 8;   // 16-byte chunks a row of the w panel
constexpr int kDRows = 128;          // output rows (capacity slots) a block at most
constexpr int kDWStride = kDBN + 8;  // bf16 a row of the w panel (272 bytes)
constexpr int kDXStride = kDBK + 8;  // bf16 a row of the x tile (80 bytes)
constexpr int kDWTile = kDBK * kDWStride;

// CT tiles of 8 capacity slots a block (1, 2, 4, 8 or 16); the ring as deep
// as ~64-76 KB of shared memory allows, so three blocks fit an SM below 16
template <int CT>
struct DecodeShape {
  static constexpr int kStages = CT <= 2 ? 7 : CT == 4 ? 6 : CT == 8 ? 5 : 4;
  static constexpr int kXTile = CT * 8 * kDXStride;
  static constexpr size_t kSmem = static_cast<size_t>(kStages) * (kDWTile + kXTile) * 2;
};

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

// Whether the first `rows` rows of a row-major matrix of K columns are all
// +0 or -0 (bits & 0x7FFF == 0: a NaN or any other value is not). The block
// reads them in passes, with a block-wide vote after each: first one 16-byte
// load a thread (a routed expert's first slot holds a token, so that pass
// decides an occupied expert), then kZeroPass a thread. With `vec`, K is a
// multiple of 8 and the base 16-byte aligned; else element by element.
constexpr int kZeroPass = 8;

__device__ __forceinline__ bool block_all_zero(const __nv_bfloat16* src, int rows, int K,
                                               bool vec) {
  const int threads = blockDim.x;
  if (vec) {
    const uint4* p = reinterpret_cast<const uint4*>(src);
    const int n = rows * (K >> 3);
    for (int base = 0, per = 1; base < n || base == 0; base += per * threads, per = kZeroPass) {
      uint32_t bits = 0;
#pragma unroll
      for (int j = 0; j < kZeroPass; ++j) {
        const int c = base + threadIdx.x + j * threads;
        if (j < per && c < n) {
          const uint4 v = __ldg(p + c);
          bits |= v.x | v.y | v.z | v.w;
        }
      }
      if (__syncthreads_or((bits & 0x7FFF7FFFu) != 0)) return false;
    }
    return true;
  }
  const unsigned short* p = reinterpret_cast<const unsigned short*>(src);
  const int n = rows * K;
  for (int base = 0; base < n; base += kZeroPass * threads) {
    uint32_t bits = 0;
#pragma unroll
    for (int j = 0; j < kZeroPass; ++j) {
      const int c = base + threadIdx.x + j * threads;
      if (c < n) bits |= p[c];
    }
    if (__syncthreads_or((bits & 0x7FFFu) != 0)) return false;
  }
  return true;
}

// The epilogue of both decode kernels: accumulator j of tile ct is slot
// 8·ct + 2·(lane % 4) (+1 for odd j) and column 16·warp + lane / 4 (+8 for
// j >= 2) of the block's tile; each sum rounded once to bf16; slots past
// `rows` and columns past N skipped. A skipped expert's accumulators are
// +0, so it writes +0.
template <int CT>
__device__ __forceinline__ void store_decode_tile(const float (&acc)[CT][4],
                                                  __nv_bfloat16* oe, int rows, int N, int n0,
                                                  int warp, int lane) {
  const int g = lane >> 2, q2 = (lane & 3) * 2;
#pragma unroll
  for (int ct = 0; ct < CT; ++ct)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ct * 8 + q2 + (j & 1);
      const int col = n0 + warp * 16 + g + (j >> 1) * 8;
      if (r < rows && col < N) oe[static_cast<size_t>(r) * N + col] = __float2bfloat16(acc[ct][j]);
    }
}

// The decode kernel for what TMA does not take (K or N not a multiple of 8,
// a misaligned base; and C >= kWgmmaMinC there): one block is expert
// blockIdx.y, output columns [n0, n0 + 128) of w and the capacity slots
// [c0, c0 + 128) (blockIdx.z; one chunk below kWgmmaMinC), staged through a
// cp.async ring. Warp i owns columns n0 + 16i .. n0 + 16i + 15 as the 16
// rows of mma.sync's A (w's panel through ldmatrix.trans) and every slot as
// its n8 side (x through ldmatrix), so at C = 8 no lane of the product is
// padding.
template <int CT>
__global__ void __launch_bounds__(kDThreads, CT >= 16 ? 1 : CT >= 8 ? 2 : 3)
    moe_gemm_decode_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ out,
                           int C, int K, int N, bool vec_x, bool vec_w) {
  using Shape = DecodeShape<CT>;
  constexpr int kStages = Shape::kStages;
  extern __shared__ __align__(16) unsigned char decode_smem[];
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(decode_smem);  // [stage][kDBK][kDWStride]
  __nv_bfloat16* sx = sw + kStages * kDWTile;  // [stage][CT·8][kDXStride]

  const int n0 = blockIdx.x * kDBN;
  const int e = blockIdx.y;
  const int c0 = blockIdx.z * kDRows;
  const int rows = min(C - c0, kDRows);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const __nv_bfloat16* xe = x + (static_cast<size_t>(e) * C + c0) * K;
  const __nv_bfloat16* we = w + static_cast<size_t>(e) * K * N;

  float acc[CT][4];
#pragma unroll
  for (int ct = 0; ct < CT; ++ct)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[ct][j] = 0.0f;

  // An expert no token was routed to has an all-zero x block (the dispatch
  // zero-fills its slots; the down product's silu(0)·0 is 0 too): its sums
  // are +0 and w is never read. Tested before the first weight copy.
  if (!block_all_zero(xe, rows, K, vec_x)) {
    // a stage: the w panel (32 rows x 128) is 512 chunks, two a thread; the x
    // tile (CT·8 rows x 32) CT·32 chunks
    auto load_stage = [&](int stage, int k) {
      __nv_bfloat16* ws = sw + stage * kDWTile;
#pragma unroll
      for (int i = 0; i < kDBK * kDChunks / kDThreads; ++i) {
        const int c = tid + i * kDThreads;
        const int r = c / kDChunks, n8 = (c % kDChunks) * 8;
        load_chunk(ws + r * kDWStride + n8, we, k + r, n0 + n8, K, N, vec_w);
      }
      __nv_bfloat16* xs = sx + stage * Shape::kXTile;
      for (int c = tid; c < CT * 8 * 4; c += kDThreads) {
        const int r = c >> 2, k8 = (c & 3) * 8;
        load_chunk(xs + r * kDXStride + k8, xe, r, k + k8, rows, K, vec_x);
      }
    };

    const int n_tiles = (K + kDBK - 1) / kDBK;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_tiles) load_stage(s, s * kDBK);
      cp_async_commit();
    }
    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<kStages - 2>();  // tile t has landed (this thread's copies)
      __syncthreads();               // ... and everyone's; stage (t-1) is free
      const int next = t + kStages - 1;
      if (next < n_tiles) load_stage(next % kStages, next * kDBK);
      cp_async_commit();

      const __nv_bfloat16* ws = sw + (t % kStages) * kDWTile;
      const __nv_bfloat16* xs = sx + (t % kStages) * Shape::kXTile;
      // A (16 columns of w x 16 of k), k-major in shared memory: matrices
      // (n 0-7, k 0-7), (n 8-15, k 0-7), (n 0-7, k 8-15), (n 8-15, k 8-15)
      uint32_t af[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ldmatrix_x4_trans(af[h], ws + (h * 16 + (lane & 7) + ((lane >> 4) << 3)) * kDWStride +
                                     warp * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int ct = 0; ct < CT; ++ct) {
        // B (16 of k x 8 slots) is x's rows: k 0-7, 8-15, 16-23, 24-31
        uint32_t bf[4];
        ldmatrix_x4(bf, xs + (ct * 8 + (lane & 7)) * kDXStride + (lane >> 3) * 8);
        mma_bf16(acc[ct], af[0], bf[0], bf[1]);
        mma_bf16(acc[ct], af[1], bf[2], bf[3]);
      }
    }
    cp_async_wait<0>();
  }
  store_decode_tile<CT>(acc, out + (static_cast<size_t>(e) * C + c0) * N, rows, N, n0, warp, lane);
}

// ---------------------------------------------------------------------------
// bfloat16, C >= kWgmmaMinC: wgmma from a TMA ring
// ---------------------------------------------------------------------------
constexpr int kWgmmaMinC = 128;  // one full 128-row tile: below it the decode kernels
constexpr int kWBM = 128;        // output rows a block, 64 a consumer warpgroup
constexpr int kWBK = 64;         // contraction a stage: one 128-byte swizzled row
constexpr int kWStages = 4;
constexpr int kWThreads = 384;   // warpgroup 0 the producer, 1 and 2 the consumers
constexpr int kWBN = 256;        // output columns a block
constexpr int kBox = 64;         // w is copied in boxes of 64 (N) x 64 (K)
constexpr int kWA = kWBM * kWBK;  // bf16 of x a stage (16 KB)
constexpr int kWB = kWBK * kWBN;  // bf16 of w a stage (32 KB)
constexpr int kWStageBytes = (kWA + kWB) * 2;
// the stages, 1 KB aligned for the 128-byte swizzle, then 2 barriers a stage
constexpr size_t kWSmem =
    1024 + static_cast<size_t>(kWStages) * kWStageBytes + 2 * kWStages * sizeof(uint64_t);

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the same with an L2 eviction priority (`policy`: createpolicy's encoding)
__device__ __forceinline__ void tma_load_3d_hint(void* dst, const CUtensorMap* map, uint64_t* bar,
                                                 int c0, int c1, int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "l"(policy)
      : "memory");
}

// a wgmma matrix descriptor of a 128-byte swizzled operand in shared memory;
// the offsets in bytes (stored in 16-byte units)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of an accumulator across a wgmma
// fence or wait: the registers are written by the tensor cores meanwhile
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 256, float32) += A (64 x 16, K-major) B (16 x 256, MN-major: the
// transpose bit set), both bf16 from shared memory
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(kWThreads, 1)
    moe_gemm_wgmma_kernel(__grid_constant__ const CUtensorMap map_x,
                          __grid_constant__ const CUtensorMap map_w,
                          __nv_bfloat16* __restrict__ out, int C, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024 - (smem_addr(smem_raw) & 1023)) & 1023;
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem_raw + pad);  // [stage][128][64]
  __nv_bfloat16* sb = sa + kWStages * kWA;  // [stage][4][64 (k)][64 (n)]
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kWStages * kWB);
  uint64_t* empty = full + kWStages;

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kWBM;
  const int n0 = blockIdx.x * kWBN;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int n_k = (K + kWBK - 1) / kWBK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&full[s], 1);        // the producer's arrive, plus the bytes
      mbar_init(&empty[s], 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::);
    if (tid == 0) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kWStages;
        mbar_wait(&empty[s], ((kt / kWStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kWStageBytes);
        tma_load_3d(sa + s * kWA, &map_x, &full[s], kt * kWBK, m0, e);
#pragma unroll
        for (int j = 0; j < kWBN / kBox; ++j)
          tma_load_3d(sb + s * kWB + j * kBox * kWBK, &map_w, &full[s], n0 + j * kBox,
                      kt * kWBK, e);
      }
    }
  } else {
    // a consumer: 64 rows of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::);
    const int c = wg - 1;
    float acc[kWBN / 2];
#pragma unroll
    for (int i = 0; i < kWBN / 2; ++i) acc[i] = 0.0f;
    fence_acc(acc);
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % kWStages;
      mbar_wait(&full[s], (kt / kWStages) & 1);
      // x: K-major, rows 128 bytes apart, 8-row groups 1 KB apart, k16 steps
      // 32 bytes along the row; w: MN-major, 64-wide boxes 8 KB apart (the
      // leading offset), 8-k groups 1 KB apart (the stride offset), k16 steps
      // 16 rows of 128 bytes
      const uint32_t a0 = smem_addr(sa + s * kWA + c * 64 * kWBK);
      const uint32_t b0 = smem_addr(sb + s * kWB);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWBK / 16; ++kk)
        wgmma_m64n256(acc, wgmma_desc(a0 + kk * 32, 16, 1024),
                      wgmma_desc(b0 + kk * 16 * 128, kBox * kWBK * 2, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the products of step kt - 1 are done
      fence_acc(acc);
      if (kt > 0) mbar_arrive(&empty[(kt - 1) % kWStages]);
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // epilogue: accumulator i holds row 16·warp + g (+ 8 for i % 4 >= 2),
    // column 8·(i / 4) + 2·(lane % 4) (+ 1 for odd i) of the warpgroup's 64
    __nv_bfloat16* oe = out + static_cast<size_t>(e) * C * N;
    const int lane = tid & 31, warp = tid >> 5;
    const int row = m0 + c * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < kWBN / 8; ++j) {
      const int col = n0 + j * 8 + (lane & 3) * 2;
      if (col >= N) continue;  // N is a multiple of 8, so col + 1 < N too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row + h * 8 >= C) continue;
        *reinterpret_cast<__nv_bfloat162*>(oe + static_cast<size_t>(row + h * 8) * N + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 below kWgmmaMinC where TMA takes the strides (the decode): the
// decode kernel's product fed by a TMA ring
// ---------------------------------------------------------------------------
constexpr int kTBK = 64;                  // contraction a stage: one 128-byte swizzled row of x
constexpr int kTThreads = kDThreads + 32;  // 8 consumer warps, then the producer warp
constexpr int kTSmemBudget = 105 * 1024;   // the ring: two blocks an SM
// w is read once a call: its lines go first from L2, x and the rest stay
constexpr uint64_t kEvictFirst = 0x12F0000000000000ull;

template <int CT>
struct TmaShape {
  static constexpr int kW = kTBK * kDBN;    // bf16 of w a stage: kDBN / 64 boxes of 64 x 64
  static constexpr int kX = CT * 8 * kTBK;  // bf16 of x a stage: one CT·8 x 64 box
  static constexpr int kStageBytes = (kW + kX) * 2;
  static constexpr int kStages = kTSmemBudget / kStageBytes > 2 ? kTSmemBudget / kStageBytes : 2;
  // the stages 1 KB aligned for the 128-byte swizzle, then 2 barriers a stage
  static constexpr size_t kSmem =
      1024 + static_cast<size_t>(kStages) * kStageBytes + 2 * kStages * sizeof(uint64_t);
};

// One block: expert blockIdx.y, output columns [n0, n0 + 128) of w, every
// slot (C < kWgmmaMinC). Warp 8's first thread keeps the ring full: a stage
// is one TMA copy of the x box (CT·8 slots x 64 of k; slots past C read as
// zero) and two of the w boxes (64 of k x 64 columns each; k past K and
// columns past N read as zero), all 128-byte swizzled, signalled on the
// stage's `full` mbarrier; warps 0-7 wait for it, multiply as the cp.async
// kernel does (the swizzle undone in the ldmatrix addresses: chunk j of row r
// lies at chunk j ^ (r % 8)), and arrive on its `empty` mbarrier.
template <int CT>
__global__ void __launch_bounds__(kTThreads, CT >= 16 ? 1 : 2)
    moe_gemm_decode_tma_kernel(__grid_constant__ const CUtensorMap map_x,
                               __grid_constant__ const CUtensorMap map_w,
                               const __nv_bfloat16* __restrict__ x,
                               __nv_bfloat16* __restrict__ out, int C, int K, int N) {
  using Shape = TmaShape<CT>;
  constexpr int kStages = Shape::kStages;
  extern __shared__ unsigned char tma_smem[];
  const uint32_t pad = (1024 - (smem_addr(tma_smem) & 1023)) & 1023;
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(tma_smem + pad);  // [stage][2][64 k][64 n]
  __nv_bfloat16* sx = sw + kStages * Shape::kW;  // [stage][CT·8][64 k]
  uint64_t* full = reinterpret_cast<uint64_t*>(sx + kStages * Shape::kX);
  uint64_t* empty = full + kStages;

  const int n0 = blockIdx.x * kDBN;
  const int e = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_k = (K + kTBK - 1) / kTBK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);           // the producer's arrive, plus the bytes
      mbar_init(&empty[s], kDThreads);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the skip, as in the cp.async kernel; its block-wide vote also publishes
  // the barriers' initialisation
  const __nv_bfloat16* xe = x + static_cast<size_t>(e) * C * K;
  const bool skip = block_all_zero(xe, C, K, true);

  if (warp == kDThreads / 32) {
    // the producer; a w box that lies past N is left out
    const int boxes = min(kDBN / 64, (N - n0 + 63) / 64);
    const int bytes = (Shape::kX + boxes * 64 * kTBK) * 2;
    if (lane == 0 && !skip) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], bytes);
        tma_load_3d(sx + s * Shape::kX, &map_x, &full[s], kt * kTBK, 0, e);
        for (int b = 0; b < boxes; ++b)
          tma_load_3d_hint(sw + s * Shape::kW + b * 64 * kTBK, &map_w, &full[s], n0 + b * 64,
                           kt * kTBK, e, kEvictFirst);
      }
    }
    return;
  }

  float acc[CT][4];
#pragma unroll
  for (int ct = 0; ct < CT; ++ct)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[ct][j] = 0.0f;
  if (!skip) {
    // the warp's 16 columns: box warp / 4, chunks 2·(warp % 4) and one more
    const int box = (warp >> 2) * 64 * kTBK;
    const int chunk = (warp & 3) * 2 + ((lane >> 3) & 1);
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      const __nv_bfloat16* ws = sw + s * Shape::kW + box;
      const __nv_bfloat16* xs = sx + s * Shape::kX;
#pragma unroll
      for (int kk = 0; kk < kTBK; kk += 32) {
        uint32_t af[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kr = kk + h * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4_trans(af[h], ws + kr * 64 + ((chunk ^ (kr & 7)) << 3));
        }
#pragma unroll
        for (int ct = 0; ct < CT; ++ct) {
          const int r = ct * 8 + (lane & 7);
          uint32_t bf[4];
          ldmatrix_x4(bf, xs + r * 64 + ((((kk >> 3) + (lane >> 3)) ^ (r & 7)) << 3));
          mma_bf16(acc[ct], af[0], bf[0], bf[1]);
          mma_bf16(acc[ct], af[1], bf[2], bf[3]);
        }
      }
      // the stage was read through the generic proxy and is refilled
      // through the async one: without this fence a TMA copy has been seen
      // to land before the reads it follows (wrong sums, 13 of 90 calls)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&empty[s]);
    }
  }
  store_decode_tile<CT>(acc, out + static_cast<size_t>(e) * C * N, C, N, n0, warp, lane);
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once at run time
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 3-D bf16 tensor map over a contiguous (d2, d1, d0) array, box (b1, b0)
// of one d2 slice, 128-byte swizzled, zero-filled out of bounds
bool encode_3d(CUtensorMap* map, const void* base, int d2, int d1, int d0, int b1, int b0) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0) * 2,
                                 static_cast<cuuint64_t>(d0) * d1 * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0), static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_wgmma(const void* x, const void* w, void* out, int e, int c, int k, int n,
                 cudaStream_t stream) {
  CUtensorMap map_x, map_w;
  if (!encode_3d(&map_x, x, e, c, k, kWBM, kWBK) || !encode_3d(&map_w, w, e, k, n, kWBK, kBox))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      moe_gemm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kWSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kWBN - 1) / kWBN, (c + kWBM - 1) / kWBM, e);
  moe_gemm_wgmma_kernel<<<grid, kWThreads, kWSmem, stream>>>(
      map_x, map_w, static_cast<__nv_bfloat16*>(out), c, k, n);
  return static_cast<int>(cudaGetLastError());
}

template <int CT>
int launch_decode(const void* x, const void* w, void* out, int e, int c, int k, int n,
                  bool vec_x, bool vec_w, cudaStream_t stream) {
  using B = __nv_bfloat16;
  const int gz = (c + kDRows - 1) / kDRows;
  if (e > 65535 || gz > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = DecodeShape<CT>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      moe_gemm_decode_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kDBN - 1) / kDBN, e, gz);
  moe_gemm_decode_kernel<CT><<<grid, kDThreads, smem, stream>>>(
      static_cast<const B*>(x), static_cast<const B*>(w), static_cast<B*>(out), c, k, n, vec_x,
      vec_w);
  return static_cast<int>(cudaGetLastError());
}

template <int CT>
int launch_decode_tma(const void* x, const void* w, void* out, int e, int c, int k, int n,
                      cudaStream_t stream) {
  using B = __nv_bfloat16;
  if (e > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_w;
  if (!encode_3d(&map_x, x, e, c, k, CT * 8, kTBK) || !encode_3d(&map_w, w, e, k, n, kTBK, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = TmaShape<CT>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      moe_gemm_decode_tma_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kDBN - 1) / kDBN, e);
  moe_gemm_decode_tma_kernel<CT><<<grid, kTThreads, smem, stream>>>(
      map_x, map_w, static_cast<const B*>(x), static_cast<B*>(out), c, k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int moe_gemm_f32(const float* x, const float* w, float* out, int e, int c, int k,
                            int n, cudaStream_t stream) {
  const bool vec_x = k % 4 == 0 && aligned16(x);
  const bool vec_w = n % 4 == 0 && aligned16(w);
  moe_gemm_f32_kernel<<<grid_of(e, c, n), kThreads32, 0, stream>>>(x, w, out, c, k, n, vec_x,
                                                                   vec_w);
  return static_cast<int>(cudaGetLastError());
}

// The route is a fixed rule: the wgmma kernel where C fills at least one
// 128-row tile and TMA takes the strides (K and N multiples of 8, x, w and
// out 16-byte aligned); below it the decode kernel fed by TMA where TMA takes
// them, else the decode kernel fed by cp.async; each decode kernel with the
// fewest of 8, 16, 32, 64 or 128 slots a block that hold C (128 a chunk for
// the cp.async kernel above that).
extern "C" int moe_gemm_bf16(const void* x, const void* w, void* out, int e, int c, int k, int n,
                             cudaStream_t stream) {
  const bool tma = k > 0 && k % 8 == 0 && n % 8 == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(out);
  if (tma && c >= kWgmmaMinC) return launch_wgmma(x, w, out, e, c, k, n, stream);
  const int tiles = (std::min(c, kDRows) + 7) / 8;
  if (tma) {
    if (tiles <= 1) return launch_decode_tma<1>(x, w, out, e, c, k, n, stream);
    if (tiles <= 2) return launch_decode_tma<2>(x, w, out, e, c, k, n, stream);
    if (tiles <= 4) return launch_decode_tma<4>(x, w, out, e, c, k, n, stream);
    if (tiles <= 8) return launch_decode_tma<8>(x, w, out, e, c, k, n, stream);
    return launch_decode_tma<16>(x, w, out, e, c, k, n, stream);
  }
  const bool vec_x = k % 8 == 0 && aligned16(x);
  const bool vec_w = n % 8 == 0 && aligned16(w);
  if (tiles <= 1) return launch_decode<1>(x, w, out, e, c, k, n, vec_x, vec_w, stream);
  if (tiles <= 2) return launch_decode<2>(x, w, out, e, c, k, n, vec_x, vec_w, stream);
  if (tiles <= 4) return launch_decode<4>(x, w, out, e, c, k, n, vec_x, vec_w, stream);
  if (tiles <= 8) return launch_decode<8>(x, w, out, e, c, k, n, vec_x, vec_w, stream);
  return launch_decode<16>(x, w, out, e, c, k, n, vec_x, vec_w, stream);
}
