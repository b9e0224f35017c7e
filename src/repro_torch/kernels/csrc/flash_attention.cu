// Flash attention forward on Hopper (sm_90a): online-softmax attention
//
//     o[b,h,i,:] = sum_j softmax_j(scale * q[b,h,i,:] . k[b,h//G,j,:]) v[b,h//G,j,:]
//
// q (B,H,S,D), k/v (B,Hkv,T,D), o (B,H,S,D), T >= S unless nothing is
// masked (not `causal`, no window: any S and T), H a multiple of Hkv,
// G = H / Hkv query heads to a KV head (jnp.repeat's grouping: query head h
// reads KV head h // G), float32 or bfloat16. Queries are right-aligned
// (query i sits at position i + T - S); a key j is masked when `causal` and
// j > i + T - S, or when `window` > 0 and (i + T - S) - j >= window (the
// window applies with or without `causal`). A masked logit is -1e30, as in
// the TPU kernel, so a row's result does not depend on which wholly masked
// tiles are skipped.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:26
// (`_flash_kernel`, launched by `flash_attention`), which keeps the running
// max, sum and accumulator in VMEM scratch across a sequential KV grid
// axis. Here one block owns a tile of query rows of one (b, h) and walks
// the KV tiles itself; nothing is carried between blocks. The K and V of a
// KV head are read in place by each of its G query heads: no repeated copy.
//
// Bound: at the LM task's shapes (S = T = 32, D = 16, float32) memory: each
// of q, k, v and o is moved once, 4·D flops per (query, key) pair in the
// band against 16·D bytes a row. At the serving prefill (S = T = 2,048,
// D = 128, bfloat16) operations: ~2,000 flops a byte, far above the H100's
// ~295 bf16 tensor-core flops a byte.
//
// Design, bfloat16: the tensor cores (the FlashAttention-2 schedule on
// mma.sync.m16n8k16, bf16 operands, float32 accumulators). A block of four
// warps owns 64 query rows, one 16-row m-tile a warp. q is loaded once,
// straight into the mma A-fragments held in registers. K and V stream
// through shared memory in tiles of 64 keys, in bf16, rows padded by 16
// bytes so that ldmatrix reads no bank twice, double-buffered by cp.async
// (zero-filled past T) so that the next tile loads while this one is
// multiplied. S = q·Kᵀ accumulates in float32 registers (K is row-major,
// so plain ldmatrix gives the "col" B operand); the online softmax runs on
// those accumulator fragments in the exp2 domain (scale·log2 e folded into
// the logits), a row's max and sum reduced across the four lanes of a quad.
// The -1e30 mask is applied only on tiles that cross the causal edge, the
// window edge or T; tiles wholly outside the band of every row of the
// block are not loaded. P is rounded to bf16 in registers (as the plain
// version rounds the probabilities to v's type): the m16n8 C layout of two
// neighbouring key tiles is the m16k16 A layout, so P never goes through
// shared memory. O += P·V reads V by ldmatrix.trans. The result is divided
// once by max(l, 1e-30) and rounded once on the store. Blocks of the last
// query tiles, which see the most keys under `causal`, are launched first.
//
// Design, float32: the CUDA cores, never TF32 (which would round the
// inputs), each row's arithmetic fixed to the bit (the kernel below says
// how). Rows are grouped in tiles of 32 or 64 (32 when S <= 32): a tile's
// rows walk the same keys, from the same first key, in updates of 16 keys.
// A row is computed by a team of 2 to 16 threads: each takes the dot
// products of a few keys of an update, from the whole q row in registers
// and K rows read by 16-byte shared loads (rows padded 16 bytes, so the
// team's keys sit in distinct banks), and holds 4 or 8 dims of the
// accumulator. A block of 1, 2 or 4 warps takes 4 to 32 rows of one tile,
// so that the long heads spread over every SM and the LM's 32-row heads
// (D = 16) make one block each where there are enough of them. K and V
// stream through a ring of three 16-key chunks by 16-byte cp.async (4-byte
// where an operand is not on a 16-byte boundary), the next chunks loading
// while this one is walked; an update wholly outside the band of every row
// of a warp skips its dot products (its logits are -1e30 either way). At
// the LM's shapes the bytes bound it; at long sequences the CUDA cores.
//
// Plain C interface, loaded with ctypes; the functions return the
// cudaError_t of the launch (0 on success) and never synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's masked logit
constexpr int kBK = 64;            // keys per shared-memory tile

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kKC = 16;             // keys per online-softmax update
constexpr int kDPL = 16;            // head dims in one partial dot product
constexpr int kStages = 3;          // chunks of kKC keys in the cp.async ring
constexpr int kRowTile = 64;        // query rows that walk one key range (32 when S <= 32)
constexpr int kFullGrid = 2 * 132;  // two blocks on each of the H100's SMs
constexpr int kBusyGrid = 768;      // row tiles from which 2 threads a row beat 4 at D = 16

// a row's probabilities in shared memory, KT times an odd number of floats
// apart where that is a multiple of 4, so that the rows of a warp write
// distinct banks
template <int KT>
__host__ __device__ constexpr int f32_pstride() {
  return KT == 8 ? 24 : KT == 16 ? 16 : 20;
}
template <int D, int KT, int NW>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kStages) * kKC * (2 * D + 4) +
                          static_cast<size_t>(NW) * (32 / KT) * f32_pstride<KT>());
}

// 4 bytes from global to shared memory (operands not on a 16-byte boundary)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// Each row's arithmetic is fixed, whatever thread computes it, so that its
// bits depend on nothing else (not on B, not on the team or the block): D / 16
// partial dot products (partial g sums dims g, g + D/16, ... in order, one
// fma each, from +0), folded pairwise as a butterfly over D / 16 lanes folds
// them (offsets D/32, ..., 1); the logit dot·scale, or -1e30 where masked;
// per update of kKC keys counted from the row tile's k_begin: m_cur by
// fmaxf, alpha = expf(m - m_new), acc·alpha, then p = expf(logit - m_new)
// added to psum and p·v added to acc in key order, l = l·alpha + psum; at the
// end acc / fmaxf(l, 1e-30f). Every key from the tile's k_begin to its k_end
// is walked, masked or not: a masked key adds 0·v, which is NaN where v is
// not finite. Only expf is not a correctly rounded operation, and it is
// always the same function; the others are the _rn intrinsics, which nvcc
// never contracts into other operations.
//
// A row's team of KT threads: each takes the dot products of kKC / KT keys
// of a chunk (u, u + KT, ...) and holds D / KT dims of the accumulator; the
// team shares the chunk's maximum by shuffles and its probabilities through
// shared memory. A block is NW warps, 32 / KT rows each, of one row tile.
template <int D, int KT, int NW>
__global__ void __launch_bounds__(32 * NW)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int n_bh, int h,
                 int group, int n_ptiles, int ptile, int n_sub, int s, int t, int causal,
                 int window, float scale, int vec) {
  constexpr int G = D / kDPL;            // partial dot products of a row
  constexpr int RW = 32 / KT;            // rows of a warp
  constexpr int RB = NW * RW;            // rows of a block
  constexpr int KPT = kKC / KT;          // keys a thread takes the dot product of
  constexpr int DPT = D / KT;            // accumulator dims of a thread
  constexpr int KS = D + 4;              // a K row in shared memory, 16 bytes padded
  constexpr int STAGE = kKC * (KS + D);  // floats of one chunk: K, then V
  constexpr int PS = f32_pstride<KT>();
  static_assert(KPT >= 1 && DPT % 4 == 0 && RB <= 32, "team");
  extern __shared__ __align__(16) float smem[];
  float* const pbuf = smem + kStages * STAGE;  // [RB][PS] a chunk's probabilities

  // the last row tiles first (under `causal` they walk the most keys)
  const int blk = static_cast<int>(blockIdx.x);
  const int per_tile = n_bh * n_sub;
  const int pt = n_ptiles - 1 - blk / per_tile;
  const int bh = blk % per_tile / n_sub;
  const int row0 = pt * ptile + blk % n_sub * RB;
  if (row0 >= s) return;
  const int kvh = (bh / h) * (h / group) + (bh % h) / group;  // (b, h // G)
  const int ln = threadIdx.x & 31;
  const int rb = (threadIdx.x >> 5) * RW + ln / KT;  // the row in the block
  const int u = ln % KT;                             // the thread in its row's team
  const int row = row0 + rb;
  const bool active = row < s;  // rows past S compute, but never store
  const int shift = t - s;      // queries right-aligned
  const int qi = row + shift;
  const float* kb = k + static_cast<int64_t>(kvh) * t * D;
  const float* vb = v + static_cast<int64_t>(kvh) * t * D;

  // keys some row of the row tile may attend to: every row of the tile walks
  // them all, its 16-key updates counted from k_begin
  const int first = pt * ptile + shift;
  const int last = min(pt * ptile + ptile, s) - 1 + shift;
  const int k_end = causal ? min(t, last + 1) : t;
  const int k_begin = window > 0 ? max(0, first - window + 1) : 0;
  const int n_chunks = (k_end - k_begin + kKC - 1) / kKC;

  // chunk j (keys from k_begin + kKC·j, none past k_end) into stage j % kStages;
  // a group is committed even when empty, so that the wait counts stay right
  auto load = [&](int j) {
    if (j < n_chunks) {
      const int k0 = k_begin + j * kKC;
      const int nk = min(kKC, k_end - k0);
      float* ks = smem + (j % kStages) * STAGE;
      float* vs = ks + kKC * KS;
      const float* kt = kb + static_cast<int64_t>(k0) * D;
      const float* vt = vb + static_cast<int64_t>(k0) * D;
      if (vec) {
        for (int x = threadIdx.x; x < nk * (D / 4); x += 32 * NW) {
          const int r = x / (D / 4), c = x % (D / 4) * 4;
          cp_async16(ks + r * KS + c, kt + r * D + c, 16);
          cp_async16(vs + r * D + c, vt + r * D + c, 16);
        }
      } else {
        for (int x = threadIdx.x; x < nk * D; x += 32 * NW) {
          cp_async4(ks + x / D * KS + x % D, kt + x);
          cp_async4(vs + x, vt + x);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) load(j);

  // the whole q row in registers, while the first chunks land
  float qv[D];
  const float* qrow = q + (static_cast<int64_t>(bh) * s + row) * D;
  if (vec) {
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const float4 x = active ? __ldg(reinterpret_cast<const float4*>(qrow) + i)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      qv[4 * i] = x.x;
      qv[4 * i + 1] = x.y;
      qv[4 * i + 2] = x.z;
      qv[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) qv[i] = active ? __ldg(qrow + i) : 0.f;
  }

  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;
  float* const prow = pbuf + rb * PS;

  // one update over the chunk in `ks`, `vs` (keys k0 to k0 + nc - 1); FULL:
  // nc = kKC, known to the compiler
  auto update = [&](auto full, const float* ks, const float* vs, int k0, int nc) {
    constexpr bool FULL = decltype(full)::value;
    // a chunk outside the band of every row of the warp: each logit is -1e30
    // without its dot product
    const int lo = window > 0 ? max(k0, qi - window + 1) : k0;
    const int hi = causal ? min(k0 + nc - 1, qi) : k0 + nc - 1;
    const bool live = __any_sync(0xffffffffu, active && lo <= hi);

    // the logits of keys u, u + KT, ...
    float sc[KPT];
    float m_cur = kNegInf;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int c = u + KT * jj;
      sc[jj] = kNegInf;
      if (live && (FULL || c < nc)) {
        const float* kr = ks + c * KS;
        float part[G];
#pragma unroll
        for (int g = 0; g < G; ++g) part[g] = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + 4 * d4);
          const int d = 4 * d4;
          part[d % G] = __fmaf_rn(qv[d], kv.x, part[d % G]);
          part[(d + 1) % G] = __fmaf_rn(qv[d + 1], kv.y, part[(d + 1) % G]);
          part[(d + 2) % G] = __fmaf_rn(qv[d + 2], kv.z, part[(d + 2) % G]);
          part[(d + 3) % G] = __fmaf_rn(qv[d + 3], kv.w, part[(d + 3) % G]);
        }
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
          for (int g = 0; g < off; ++g) part[g] = __fadd_rn(part[g], part[g + off]);
        const int kj = k0 + c;
        bool keep = !causal || kj <= qi;
        if (window > 0) keep = keep && (qi - kj) < window;
        if (keep) sc[jj] = __fmul_rn(part[0], scale);
      }
      m_cur = fmaxf(m_cur, sc[jj]);
    }
#pragma unroll
    for (int off = KT / 2; off > 0; off >>= 1)
      m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, off));
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int c = u + KT * jj;
      if (FULL || c < nc) prow[c] = expf(__fsub_rn(sc[jj], m_new));
    }
    __syncwarp();
    float p[kKC];
#pragma unroll
    for (int i = 0; i < kKC / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(prow)[i];
      p[4 * i] = x.x;
      p[4 * i + 1] = x.y;
      p[4 * i + 2] = x.z;
      p[4 * i + 3] = x.w;
    }
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < kKC; ++c)
      if (FULL || c < nc) psum = __fadd_rn(psum, p[c]);
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] = __fmul_rn(acc[i], alpha);
    const float* vc = vs + u * DPT;
#pragma unroll
    for (int c = 0; c < kKC; ++c) {
      if (FULL || c < nc) {
#pragma unroll
        for (int i = 0; i < DPT / 4; ++i) {
          const float4 x = reinterpret_cast<const float4*>(vc + c * D)[i];
          acc[4 * i] = __fmaf_rn(p[c], x.x, acc[4 * i]);
          acc[4 * i + 1] = __fmaf_rn(p[c], x.y, acc[4 * i + 1]);
          acc[4 * i + 2] = __fmaf_rn(p[c], x.z, acc[4 * i + 2]);
          acc[4 * i + 3] = __fmaf_rn(p[c], x.w, acc[4 * i + 3]);
        }
      }
    }
    l = __fmaf_rn(l, alpha, psum);
    m = m_new;
  };

  for (int j = 0; j < n_chunks; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk j is in; chunk j - 1's stage and probabilities are free
    load(j + kStages - 1);
    const float* ks = smem + (j % kStages) * STAGE;
    const int k0 = k_begin + j * kKC;
    const int nc = min(kKC, k_end - k0);  // the same for the whole block
    if (nc == kKC)
      update(std::true_type{}, ks, ks + kKC * KS, k0, nc);
    else
      update(std::false_type{}, ks, ks + kKC * KS, k0, nc);
  }

  if (active) {
    const float denom = fmaxf(l, 1e-30f);
    float* orow = o + (static_cast<int64_t>(bh) * s + row) * D + u * DPT;
    if (vec) {
#pragma unroll
      for (int i = 0; i < DPT / 4; ++i)
        reinterpret_cast<float4*>(orow)[i] =
            make_float4(acc[4 * i] / denom, acc[4 * i + 1] / denom, acc[4 * i + 2] / denom,
                        acc[4 * i + 3] / denom);
    } else {
#pragma unroll
      for (int i = 0; i < DPT; ++i) orow[i] = acc[i] / denom;
    }
  }
}

template <int D, int KT, int NW>
int launch_f32_blocks(const float* q, const float* k, const float* v, float* o, int n_bh,
                      int h, int group, int n_ptiles, int ptile, int s, int t, int causal,
                      int window, float scale, int vec, cudaStream_t stream) {
  constexpr int RB = NW * 32 / KT;
  const int n_sub = ptile / RB;
  const long long blocks = static_cast<long long>(n_bh) * n_ptiles * n_sub;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = f32_smem_bytes<D, KT, NW>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel<D, KT, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_f32_kernel<D, KT, NW><<<static_cast<unsigned>(blocks), 32 * NW, smem, stream>>>(
      q, k, v, o, n_bh, h, group, n_ptiles, ptile, n_sub, s, t, causal, window, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

// The team: 4 threads a row at D = 16, 8 at D = 32, 16 at D = 64 and 128
// (at most 4 accumulator dims a thread below D = 128); at D = 16 on a grid
// of kBusyGrid row tiles or more, 2 (fewer instructions a row, where the
// card is full anyway: the LM's B = 192 on, where the H100 took 0.95x the
// time of a 4-thread team, 0.81x at B = 6,400). A block of 1, 2 or 4 warps holds 4 to 32 rows of one
// row tile: the most warps that still make kFullGrid blocks, else one (the
// short grids of a few long heads). 16-byte copies and loads where every
// operand allows them.
template <int D, int KT>
int launch_f32_team(const float* q, const float* k, const float* v, float* o, int n_bh,
                    int h, int group, int n_ptiles, int ptile, int s, int t, int causal,
                    int window, float scale, int vec, cudaStream_t stream) {
  constexpr int RW = 32 / KT;
  const long long tiles = static_cast<long long>(n_bh) * n_ptiles;
  if (RW * 4 <= 32 && tiles * (ptile / (4 * RW)) >= kFullGrid)
    return launch_f32_blocks<D, KT, (RW * 4 <= 32 ? 4 : 1)>(
        q, k, v, o, n_bh, h, group, n_ptiles, ptile, s, t, causal, window, scale, vec, stream);
  if (RW * 2 <= 32 && tiles * (ptile / (2 * RW)) >= kFullGrid)
    return launch_f32_blocks<D, KT, (RW * 2 <= 32 ? 2 : 1)>(
        q, k, v, o, n_bh, h, group, n_ptiles, ptile, s, t, causal, window, scale, vec, stream);
  return launch_f32_blocks<D, KT, 1>(q, k, v, o, n_bh, h, group, n_ptiles, ptile, s, t,
                                     causal, window, scale, vec, stream);
}

template <int D>
int launch_f32(const float* q, const float* k, const float* v, float* o, int b, int h,
               int group, int s, int t, int causal, int window, float scale,
               cudaStream_t stream) {
  const long long n_bh = static_cast<long long>(b) * h;
  if (n_bh > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int ptile = s <= 32 ? 32 : kRowTile;
  const int n_ptiles = (s + ptile - 1) / ptile;
  const int vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
                   15) == 0;
  const int nb = static_cast<int>(n_bh);
  if constexpr (D == 16) {
    if (n_bh * n_ptiles >= kBusyGrid)
      return launch_f32_team<D, 2>(q, k, v, o, nb, h, group, n_ptiles, ptile, s, t, causal,
                                   window, scale, vec, stream);
    return launch_f32_team<D, 4>(q, k, v, o, nb, h, group, n_ptiles, ptile, s, t, causal,
                                 window, scale, vec, stream);
  } else {
    return launch_f32_team<D, D == 32 ? 8 : 16>(q, k, v, o, nb, h, group, n_ptiles, ptile, s,
                                                t, causal, window, scale, vec, stream);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kWarps16 = 4;
constexpr int kBQ16 = 16 * kWarps16;  // query rows a block, 16 a warp
constexpr int kThreads16 = 32 * kWarps16;
constexpr float kLog2e = 1.4426950408889634f;

// shared memory of one block: K and V, two stages each, 64 keys x (D + 8)
template <int D>
constexpr size_t bf16_smem_bytes() {
  return 4 * static_cast<size_t>(kBK) * (D + 8) * sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(kThreads16)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int h, int group,
                  int n_qtiles, int s, int t, int causal, int window, float scale_log2) {
  constexpr int kStride = D + 8;        // bf16 a shared-memory row (16 bytes of padding)
  constexpr int kTile = kBK * kStride;  // one stage of K or V
  constexpr int kDT = D / 16;           // 16-wide steps along D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [2][kBK][kStride]
  bf16* vs = ks + 2 * kTile;                     // [2][kBK][kStride]

  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x % n_qtiles);
  const int bh = blockIdx.x / n_qtiles;
  const int kvh = (bh / h) * (h / group) + (bh % h) / group;  // (b, h // G)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;  // the lane's row and column pair in an mma tile
  const int shift = t - s;                 // queries right-aligned
  const int row0 = qt * kBQ16 + warp * 16;
  const bf16* qb = q + static_cast<int64_t>(bh) * s * D;
  const bf16* kb = k + static_cast<int64_t>(kvh) * t * D;
  const bf16* vb = v + static_cast<int64_t>(kvh) * t * D;

  // q as A-fragments: rows row0 + g (regs 0, 2) and + 8 (regs 1, 3), columns
  // 2·qd (regs 0, 1) and + 8 (regs 2, 3) of each 16-wide step; rows past S zero
  uint32_t qf[kDT][4];
#pragma unroll
  for (int kk = 0; kk < kDT; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + g + (r & 1) * 8;
      const int col = kk * 16 + (r >> 1) * 8 + 2 * qd;
      qf[kk][r] = row < s ? *reinterpret_cast<const uint32_t*>(qb + static_cast<int64_t>(row) * D + col)
                          : 0u;
    }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g and g + 8

  // keys some row of this block may attend to
  const int first = qt * kBQ16 + shift;
  const int last = min(qt * kBQ16 + kBQ16, s) - 1 + shift;
  const int k_end = causal ? min(t, last + 1) : t;
  const int k_begin = window > 0 ? max(0, first - window + 1) : 0;
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;

  auto load_tile = [&](int j) {
    constexpr int kChunks = D / 8;  // 16-byte chunks a row
    const int k0 = k_begin + j * kBK;
    bf16* kd = ks + (j & 1) * kTile;
    bf16* vd = vs + (j & 1) * kTile;
#pragma unroll
    for (int i = 0; i < kBK * kChunks / kThreads16; ++i) {
      const int c = tid + i * kThreads16;
      const int r = c / kChunks, col = (c % kChunks) * 8;
      const bool in = k0 + r < t;
      const int64_t off = in ? static_cast<int64_t>(k0 + r) * D + col : 0;
      cp_async16(kd + r * kStride + col, kb + off, in ? 16 : 0);
      cp_async16(vd + r * kStride + col, vb + off, in ? 16 : 0);
    }
  };

  load_tile(0);
  cp_async_commit();
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_tile(j + 1);  // into the stage read in iteration j - 1
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed (this thread's copies)
    __syncthreads();     // ... and everyone's
    const bf16* kt = ks + (j & 1) * kTile;
    const bf16* vt = vs + (j & 1) * kTile;
    const int k0 = k_begin + j * kBK;

    // S = q Kᵀ: 8 key tiles of 8, float32
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDT; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // matrices (keys 0-7, d 0-7), (keys 0-7, d 8-15), (keys 8-15, d 0-7),
        // (keys 8-15, d 8-15) of the 16 keys 16·np..
        uint32_t bfr[4];
        const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(bfr, kt + key * kStride + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * np], qf[kk], bfr[0], bfr[1]);
        mma_bf16(sc[2 * np + 1], qf[kk], bfr[2], bfr[3]);
      }

    // logits in the exp2 domain; the mask only where the tile crosses an edge
    const bool edge = k0 + kBK > t || (causal && k0 + kBK - 1 > first) ||
                      (window > 0 && last - k0 >= window);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * scale_log2;
        if (edge) {
          const int kj = k0 + n * 8 + 2 * qd + (e & 1);
          const int qi = row0 + g + (e >> 1) * 8 + shift;
          bool keep = kj < t && (!causal || kj <= qi);
          if (window > 0) keep = keep && (qi - kj) < window;
          if (!keep) x = kNegInf;
        }
        sc[n][e] = x;
      }

    // online softmax on the accumulator fragments; a row's four lanes agree
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r] = exp2f(m[r] - mx);
      m[r] = mx;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = exp2f(sc[n][e] - m[e >> 1]);
        rs[e >> 1] += sc[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];  // this lane's share
#pragma unroll
    for (int j2 = 0; j2 < D / 8; ++j2) {
      acc[j2][0] *= alpha[0];
      acc[j2][1] *= alpha[0];
      acc[j2][2] *= alpha[1];
      acc[j2][3] *= alpha[1];
    }

    // O += P V: P in bf16 A-fragments straight from the accumulators
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);          // row g, keys 2qd
      pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);          // row g + 8
      pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);  // row g, keys 8 + 2qd
      pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);  // row g + 8
#pragma unroll
      for (int dn = 0; dn < kDT; ++dn) {
        // lanes 0-15: key rows 0-15 at d; lanes 16-31: the same at d + 8
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vt + (kk * 16 + (lane & 15)) * kStride + dn * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dn], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dn + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is loaded again
  }

  bf16* ob = o + static_cast<int64_t>(bh) * s * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    const int row = row0 + g + r * 8;
    if (row >= s) continue;
#pragma unroll
    for (int j2 = 0; j2 < D / 8; ++j2) {
      const __nv_bfloat162 val =
          __floats2bfloat162_rn(acc[j2][2 * r] * inv, acc[j2][2 * r + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<int64_t>(row) * D + j2 * 8 + 2 * qd) =
          val;
    }
  }
}

template <int D>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o, int b, int h, int group,
                int s, int t, int causal, int window, float scale, cudaStream_t stream) {
  const int n_qtiles = (s + kBQ16 - 1) / kBQ16;
  const long long blocks = static_cast<long long>(b) * h * n_qtiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = bf16_smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_bf16_kernel<D><<<static_cast<unsigned>(blocks), kThreads16, smem, stream>>>(
      q, k, v, o, h, group, n_qtiles, s, t, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// S > T only without a mask: then `shift` (negative) feeds nothing, since
// first, last and qi are read only under `causal` or a window
bool valid(int b, int h, int hkv, int s, int t, int causal, int window) {
  return b >= 1 && hkv >= 1 && h >= hkv && h % hkv == 0 && s >= 1 && t >= 1 && window >= 0 &&
         (t >= s || (!causal && window == 0));
}

}  // namespace

// h query heads, hkv KV heads (h a multiple of hkv); window: 0 = no window,
// else >= 1. The bf16 route reads q, k and v as 32-bit and 16-byte words:
// their bases must be 16-byte aligned.
extern "C" int flash_attention_f32(const float* q, const float* k, const float* v, float* o,
                                   int b, int h, int hkv, int s, int t, int d, int causal,
                                   int window, float scale, cudaStream_t stream) {
  if (!valid(b, h, hkv, s, t, causal, window)) return static_cast<int>(cudaErrorInvalidValue);
  const int group = h / hkv;
  switch (d) {
    case 16: return launch_f32<16>(q, k, v, o, b, h, group, s, t, causal, window, scale, stream);
    case 32: return launch_f32<32>(q, k, v, o, b, h, group, s, t, causal, window, scale, stream);
    case 64: return launch_f32<64>(q, k, v, o, b, h, group, s, t, causal, window, scale, stream);
    case 128: return launch_f32<128>(q, k, v, o, b, h, group, s, t, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int b,
                                    int h, int hkv, int s, int t, int d, int causal, int window,
                                    float scale, cudaStream_t stream) {
  if (!valid(b, h, hkv, s, t, causal, window)) return static_cast<int>(cudaErrorInvalidValue);
  const int group = h / hkv;
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(o);
  switch (d) {
    case 16: return launch_bf16<16>(qq, kk, vv, oo, b, h, group, s, t, causal, window, scale, stream);
    case 32: return launch_bf16<32>(qq, kk, vv, oo, b, h, group, s, t, causal, window, scale, stream);
    case 64: return launch_bf16<64>(qq, kk, vv, oo, b, h, group, s, t, causal, window, scale, stream);
    case 128: return launch_bf16<128>(qq, kk, vv, oo, b, h, group, s, t, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
