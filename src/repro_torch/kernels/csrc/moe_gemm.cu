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
// kWgmmaMinC, takes the mma.sync kernel below.
//
// Design, bfloat16, the rest (the MoE decode at C = 8, at 1.16x its bytes
// bound; ragged K or N): the tensor cores through mma.sync.m16n8k16 (bf16
// operands, float32 accumulator). 128 threads, a 64 x 64 output tile, four
// warps of 32 x 32 (2 x 4 mma tiles each, 32 float32 accumulators a
// thread); tiles of 32 along the contraction axis staged in shared memory
// through a 3-stage cp.async ring (16 bytes a copy, zero-fill past the
// edges; every copy of a tile issued before the first is waited for), read
// into fragments with ldmatrix (.trans for w, which is K-major). Where a
// row's 16-byte chunks are not aligned (K or N not a multiple of 8, or a
// misaligned base) the chunk is loaded element by element instead.
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
// bfloat16, C >= kWgmmaMinC: wgmma from a TMA ring
// ---------------------------------------------------------------------------
constexpr int kWgmmaMinC = 128;  // one full 128-row tile: below it the mma.sync kernel
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
// out 16-byte aligned); the mma.sync kernel otherwise.
extern "C" int moe_gemm_bf16(const void* x, const void* w, void* out, int e, int c, int k, int n,
                             cudaStream_t stream) {
  using B = __nv_bfloat16;
  if (c >= kWgmmaMinC && k > 0 && k % 8 == 0 && n % 8 == 0 && aligned16(x) && aligned16(w) &&
      aligned16(out)) {
    return launch_wgmma(x, w, out, e, c, k, n, stream);
  }
  const bool vec_x = k % 8 == 0 && aligned16(x);
  const bool vec_w = n % 8 == 0 && aligned16(w);
  moe_gemm_bf16_kernel<<<grid_of(e, c, n), kThreads16, 0, stream>>>(
      static_cast<const B*>(x), static_cast<const B*>(w), static_cast<B*>(out), c, k, n, vec_x,
      vec_w);
  return static_cast<int>(cudaGetLastError());
}
