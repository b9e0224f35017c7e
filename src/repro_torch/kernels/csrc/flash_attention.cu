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
// inputs). A block of 32 or 64 query rows (32 when S <= 32, so the LM's
// 32-row heads fill the block). D / 16 neighbouring lanes share a row,
// each holding 16 of its dims (lane + G·i, strided so the lanes of a row
// read neighbouring shared-memory words) of q and of the f32 accumulator
// in registers; the row's dot product is reduced across those lanes by
// warp shuffles. K and V are staged through shared memory in tiles of 64
// keys; the softmax is updated once per 16 keys. Ragged S and T are masked
// at the tile edges. At the LM's shapes every byte moves once and the
// kernel is bound by its launch.
//
// Plain C interface, loaded with ctypes; the functions return the
// cudaError_t of the launch (0 on success) and never synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

#include <climits>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's masked logit
constexpr int kBK = 64;            // keys per shared-memory tile

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kKC = 16;   // keys per online-softmax update
constexpr int kDPL = 16;  // head dims held by one lane

template <int D>
__global__ void __launch_bounds__(64 * (D / kDPL))
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int h, int group,
                 int n_qtiles, int bq, int s, int t, int causal, int window, float scale) {
  constexpr int G = D / kDPL;  // lanes sharing one query row
  extern __shared__ float smem[];
  float* ks = smem;            // [kBK][D]
  float* vs = smem + kBK * D;  // [kBK][D]

  const int bh = blockIdx.x / n_qtiles;
  const int qt = blockIdx.x % n_qtiles;
  const int kvh = (bh / h) * (h / group) + (bh % h) / group;  // (b, h // G)
  const int lane = threadIdx.x % G;
  const int row = qt * bq + threadIdx.x / G;
  const bool active = row < s;  // rows past S compute, but never store
  const int shift = t - s;      // queries right-aligned
  const int qi = row + shift;
  const float* qrow = q + (static_cast<int64_t>(bh) * s + row) * D;
  const float* kb = k + static_cast<int64_t>(kvh) * t * D;
  const float* vb = v + static_cast<int64_t>(kvh) * t * D;

  float qv[kDPL], acc[kDPL];
#pragma unroll
  for (int i = 0; i < kDPL; ++i) {
    qv[i] = active ? qrow[lane + G * i] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // keys some row of this block may attend to
  const int first = qt * bq + shift;
  const int last = min(qt * bq + bq, s) - 1 + shift;
  const int k_end = causal ? min(t, last + 1) : t;
  const int k_begin = window > 0 ? max(0, first - window + 1) : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    const int nk = min(kBK, k_end - k0);
    __syncthreads();  // the previous tile is consumed
    const float* kt = kb + static_cast<int64_t>(k0) * D;
    const float* vt = vb + static_cast<int64_t>(k0) * D;
    for (int idx = threadIdx.x; idx < nk * D; idx += blockDim.x) {
      ks[idx] = kt[idx];
      vs[idx] = vt[idx];
    }
    __syncthreads();

    for (int c0 = 0; c0 < nk; c0 += kKC) {
      const int nc = min(kKC, nk - c0);  // the same for the whole block
      float sc[kKC];
      float m_cur = kNegInf;
#pragma unroll
      for (int c = 0; c < kKC; ++c) {
        if (c < nc) {
          const float* kr = ks + (c0 + c) * D;
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < kDPL; ++i) dot += qv[i] * kr[lane + G * i];
#pragma unroll
          for (int off = G / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          const int kj = k0 + c0 + c;
          bool keep = !causal || kj <= qi;
          if (window > 0) keep = keep && (qi - kj) < window;
          sc[c] = keep ? dot * scale : kNegInf;
          m_cur = fmaxf(m_cur, sc[c]);
        }
      }
      const float m_new = fmaxf(m, m_cur);
      const float alpha = expf(m - m_new);
#pragma unroll
      for (int i = 0; i < kDPL; ++i) acc[i] *= alpha;
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kKC; ++c) {
        if (c < nc) {
          const float p = expf(sc[c] - m_new);
          psum += p;
          const float* vr = vs + (c0 + c) * D;
#pragma unroll
          for (int i = 0; i < kDPL; ++i) acc[i] += p * vr[lane + G * i];
        }
      }
      l = l * alpha + psum;
      m = m_new;
    }
  }

  if (active) {
    const float denom = fmaxf(l, 1e-30f);
    float* orow = o + (static_cast<int64_t>(bh) * s + row) * D;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) orow[lane + G * i] = acc[i] / denom;
  }
}

template <int D>
int launch_f32(const float* q, const float* k, const float* v, float* o, int b, int h,
               int group, int s, int t, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr int G = D / kDPL;
  const int bq = s <= 32 ? 32 : 64;
  const int n_qtiles = (s + bq - 1) / bq;
  const long long blocks = static_cast<long long>(b) * h * n_qtiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * kBK * D * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_f32_kernel<D><<<static_cast<unsigned>(blocks), bq * G, smem, stream>>>(
      q, k, v, o, h, group, n_qtiles, bq, s, t, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
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
