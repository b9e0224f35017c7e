// Flash decode on Hopper (sm_90a): one query token per head over a KV cache
//
//     o[b,h,:] = sum_{j < length} softmax_j(scale * q[b,h,:] . k[b,j,h/G,:]) v[b,j,h/G,:]
//
// q (B,H,D) and o (B,H,D) contiguous; k/v (B,T,Hkv,D) with (Hkv, D) dense in
// each position and the batch and position strides given (a view along the
// position axis, such as a sliding window's slice of a linear cache, is
// read in place); G = H / Hkv query heads share a KV head (head h reads KV
// head h / G). float32 or bfloat16; logits, running max and sum and the
// accumulator in float32, the result rounded once on the store. Positions
// at or past `length` are never read (1 <= length <= T; the wrapper
// rejects length < 1, where the TPU kernel returns the mean of V).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py:22
// (`_decode_kernel`, launched by `decode_attention` through the
// `pallas_call` at :70), whose grid (B, H, n_kv) carries the online-softmax
// state in VMEM scratch across a sequential cache axis and masks positions
// >= length inside each block. Here one block owns one (b, KV head) and a
// contiguous split of the valid cache, serving all G query heads of the
// group, so every cache byte is read from device memory once (the TPU
// kernel's Hkv == H signature is G = 1). Blocks run in no order, so nothing
// is carried between them in the loop: each split ends with a partial
// state (running max, sum and the unnormalised G x D accumulator), and the
// splits of each (b, h) are combined by the same online-softmax rule (on
// the tensor-core route inside a thread-block cluster; on the CUDA-core
// route through a float32 workspace and a second kernel).
//
// Bound: memory. K and V move once, 2·length·Hkv·D elements per batch row,
// against 4·G·D flops a key: 12 flops a byte at starcoder2-15b's serving
// shape in bf16 (G = 12, D = 128), far below the card's balance point. So
// what counts is keeping enough bytes in flight (3.35 TB/s at ~1 us of
// latency is ~25 KB an SM) and spending little else a byte: B·Hkv is small
// at serving (32 blocks at that shape), so the cache axis is split.
//
// Design, bfloat16 with G <= 16 (every serving shape of the zoo; the
// wrapper raises for G > 16): the tensor cores. The group's G query heads
// are the 16 M rows of an mma.sync.m16n8k16 tile (rows G..15 zero), q
// loaded once, straight into A-fragments in registers. Each of the block's four warps
// owns its own run of 16-key steps of the split (steps w, w + 4, ...) and
// streams them through its own ring of 3 (D = 128) or 4 stages in shared
// memory, in bf16, by 16-byte cp.async, zero-filled past the split's end,
// rows padded by 16 bytes so that ldmatrix reads no bank twice; a warp
// waits only for its own copies, so no block barrier stands in the loop.
// S = q·Kᵀ accumulates in float32 (plain ldmatrix of the key rows is the
// "col" B operand), the scale applied to the float32 logits; the online
// softmax runs on the accumulator fragments in the exp2 domain; P is
// rounded to bf16 in registers (the plain version rounds the
// probabilities to v's type) and, the C layout of two 8-key tiles being
// the A layout of one 16-key step, is the A operand of O += P·V, V read by
// ldmatrix.trans. Each warp keeps its own max, sum and 16 x D float32
// accumulator; the four are merged in shared memory once, at the end of
// the split. The splits of a (b, KV head), at most 8, are launched as one
// thread-block cluster: after a cluster barrier each block merges a share
// of the group's outputs from every split's state, read through
// distributed shared memory, and writes them; no workspace, no second
// kernel.
//
// Design, float32 (and a bfloat16 view not 16-byte aligned): the CUDA
// cores, 256 threads. A tile of 64 positions of K and V is staged in shared memory as
// float32 (K rows padded to D + 4 floats so the float4 reads of
// neighbouring rows fall in distinct banks), each thread's loads issued
// together so one memory latency, not one a load, is paid a tile; the G·64
// logits of a tile are one thread a (head, key) pair, a float4 dot product
// against the group's queries (also in shared memory); one warp a head
// then updates that head's running max and sum with warp-shuffle
// reductions and writes the tile's probabilities back; last each thread
// rescales and accumulates its (head, dim) outputs of the G x D
// accumulator, which lives in shared memory. The tail tile is cut at
// `length`, so no position past it is loaded.
//
// Plain C interface, loaded with ctypes; the functions return the
// cudaError_t of the launch (0 on success) and never synchronise.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

#include <climits>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's masked logit
constexpr int kThreads = 256;
constexpr int kTK = 64;            // positions per shared-memory tile
constexpr int kMaxSmem = 232448;   // the most one block may use on Hopper

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D>
__host__ __device__ constexpr int key_stride() { return D + 4; }

template <int D>
size_t smem_bytes(int g) {
  const size_t floats = static_cast<size_t>(kTK) * key_stride<D>()  // K tile
                        + static_cast<size_t>(kTK) * D                // V tile
                        + 2 * static_cast<size_t>(g) * D              // q, acc
                        + static_cast<size_t>(g) * kTK                // probabilities
                        + 3 * static_cast<size_t>(g);                 // max, sum, rescale
  return floats * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ ws, int hkv, int g, int length,
              int split_len, int n_split, long long sb, long long st,
              float scale) {
  constexpr int KS = key_stride<D>();
  constexpr int kLoads = kTK * D / kThreads;  // staged elements a thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem;                // [kTK][KS]
  float* vs = ks + kTK * KS;       // [kTK][D]
  float* qs = vs + kTK * D;        // [g][D]
  float* acc = qs + g * D;         // [g][D]
  float* ps = acc + g * D;         // [g][kTK]
  float* mrow = ps + g * kTK;      // [g]
  float* lrow = mrow + g;          // [g]
  float* arow = lrow + g;          // [g]

  const int split = blockIdx.x % n_split;
  const int bk = blockIdx.x / n_split;
  const int b = bk / hkv;
  const int kh = bk - b * hkv;
  const int64_t qoff = (static_cast<int64_t>(b) * hkv + kh) * g * D;
  const T* kb = k + b * sb + static_cast<int64_t>(kh) * D;
  const T* vb = v + b * sb + static_cast<int64_t>(kh) * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int first = split * split_len;
  const int end = min(length, first + split_len);

  for (int i = threadIdx.x; i < g * D; i += kThreads) {
    qs[i] = to_f32(q[qoff + i]);
    acc[i] = 0.f;
  }
  for (int i = threadIdx.x; i < g; i += kThreads) {
    mrow[i] = kNegInf;
    lrow[i] = 0.f;
  }

  for (int k0 = first; k0 < end; k0 += kTK) {
    const int nk = min(kTK, end - k0);
    __syncthreads();  // the previous tile is consumed (and q, acc are set)
    T kr[kLoads], vr[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {  // every load in flight at once
      const int idx = threadIdx.x + i * kThreads;
      const int j = idx / D, c = idx - j * D;
      if (j < nk) {
        const int64_t off = static_cast<int64_t>(k0 + j) * st + c;
        kr[i] = kb[off];
        vr[i] = vb[off];
      }
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int j = idx / D, c = idx - j * D;
      if (j < nk) {
        ks[j * KS + c] = to_f32(kr[i]);
        vs[j * D + c] = to_f32(vr[i]);
      }
    }
    __syncthreads();

    // logits: one thread a (head, key) pair
    for (int p = threadIdx.x; p < g * nk; p += kThreads) {
      const int gi = p / nk, j = p - gi * nk;
      const float4* qr = reinterpret_cast<const float4*>(qs + gi * D);
      const float4* kr4 = reinterpret_cast<const float4*>(ks + j * KS);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < D / 4; ++i) {
        const float4 a = qr[i], c = kr4[i];
        dot += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
      }
      ps[gi * kTK + j] = dot * scale;
    }
    __syncthreads();

    // online softmax: one warp a head
    for (int gi = warp; gi < g; gi += kThreads / 32) {
      float* pr = ps + gi * kTK;
      float mx = kNegInf;
      for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = mrow[gi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < kTK; j += 32) {  // zero past nk: read below
        const float e = j < nk ? expf(pr[j] - m_new) : 0.f;
        pr[j] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        arow[gi] = alpha;
        lrow[gi] = lrow[gi] * alpha + sum;
        mrow[gi] = m_new;
      }
    }
    __syncthreads();

    // accumulate: one thread a (head, dim) output, four keys at a time
    for (int e = threadIdx.x; e < g * D; e += kThreads) {
      const int gi = e / D, c = e - gi * D;
      const float4* pr = reinterpret_cast<const float4*>(ps + gi * kTK);
      float a = acc[e] * arow[gi];
      for (int j4 = 0; j4 < (nk + 3) / 4; ++j4) {
        const float4 p = pr[j4];
        const float* vc = vs + 4 * j4 * D + c;
        a += p.x * vc[0];
        if (4 * j4 + 1 < nk) a += p.y * vc[D];
        if (4 * j4 + 2 < nk) a += p.z * vc[2 * D];
        if (4 * j4 + 3 < nk) a += p.w * vc[3 * D];
      }
      acc[e] = a;
    }
  }
  __syncthreads();

  if (n_split == 1) {
    for (int e = threadIdx.x; e < g * D; e += kThreads)
      store(o + qoff + e, acc[e] / fmaxf(lrow[e / D], 1e-30f));
    return;
  }
  // partial state of this split: [B·H][n_split][D + 2] = (acc, max, sum)
  for (int e = threadIdx.x; e < g * D; e += kThreads) {
    const int gi = e / D, c = e - gi * D;
    float* w = ws + ((qoff / D + gi) * n_split + split) * (D + 2);
    w[c] = acc[e];
    if (c == 0) {
      w[D] = mrow[gi];
      w[D + 1] = lrow[gi];
    }
  }
}

// one block a (b, h), one thread a dim: the splits' partial states merged
template <typename T>
__global__ void combine_kernel(const float* __restrict__ ws, T* __restrict__ o,
                               int n_split, int d) {
  const float* w = ws + static_cast<int64_t>(blockIdx.x) * n_split * (d + 2);
  float m = kNegInf;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, w[s * (d + 2) + d]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float* ws_s = w + s * (d + 2);
    const float f = expf(ws_s[d] - m);
    l += ws_s[d + 1] * f;
    a += ws_s[threadIdx.x] * f;
  }
  store(o + static_cast<int64_t>(blockIdx.x) * d + threadIdx.x, a / fmaxf(l, 1e-30f));
}

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, T* o, float* ws, int b, int hkv, int g,
             int length, int split_len, int n_split, long long sb, long long st,
             float scale, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(b) * hkv * n_split;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<D>(g);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_kernel<T, D><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      q, k, v, o, ws, hkv, g, length, split_len, n_split, sb, st, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  combine_kernel<T><<<static_cast<unsigned>(b * hkv * g), D, 0, stream>>>(ws, o, n_split, D);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int b, int h, int hkv, int length, int split_len, int n_split) {
  return b >= 1 && hkv >= 1 && h % hkv == 0 && length >= 1 && n_split >= 1 &&
         split_len >= 1 && split_len % kTK == 0 &&
         static_cast<long long>(split_len) * (n_split - 1) < length &&
         static_cast<long long>(split_len) * n_split >= length;
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, float* ws, int b, int h, int hkv,
           int d, int length, int split_len, int n_split, long long sb, long long st,
           float scale, cudaStream_t stream) {
  if (!valid(b, h, hkv, length, split_len, n_split) || (n_split > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = h / hkv;
  switch (d) {
    case 16: return launch_d<T, 16>(q, k, v, o, ws, b, hkv, g, length, split_len, n_split, sb, st, scale, stream);
    case 32: return launch_d<T, 32>(q, k, v, o, ws, b, hkv, g, length, split_len, n_split, sb, st, scale, stream);
    case 64: return launch_d<T, 64>(q, k, v, o, ws, b, hkv, g, length, split_len, n_split, sb, st, scale, stream);
    case 128: return launch_d<T, 128>(q, k, v, o, ws, b, hkv, g, length, split_len, n_split, sb, st, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bfloat16, G <= 16: mma.sync on the tensor cores, K/V from a cp.async ring
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kWarpsMma = 4;
constexpr int kThreadsMma = 32 * kWarpsMma;
constexpr int kKeysW = 16;   // keys a warp takes a step: the K depth of one P·V mma
constexpr int kRowsMma = 16; // query heads a block at most: the M rows of the mma
constexpr int kMaxCluster = 8;  // splits a (b, KV head) at most: one portable cluster
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct MmaShape {
  static constexpr int kStride = D + 8;  // bf16 a shared-memory row (16 bytes of padding)
  static constexpr int kStages = D >= 128 ? 3 : 4;
  static constexpr int kTile = kKeysW * kStride;  // one stage of K or of V
  static constexpr int kRed = D + 4;              // floats a row of the merge buffer
  static constexpr size_t kRing =
      static_cast<size_t>(kWarpsMma) * 2 * kStages * kTile * sizeof(bf16);
  static constexpr size_t kMerge =  // the warps' states, the block's, the splits' weights
      (static_cast<size_t>(kWarpsMma) * kRowsMma * (kRed + 2) + kRowsMma * (D + 3) +
       kMaxCluster * kRowsMma) * sizeof(float);
  static constexpr size_t kSmem = kRing > kMerge ? kRing : kMerge;
};

template <int D>
__global__ void __launch_bounds__(kThreadsMma)
decode_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int hkv, int g, int length,
                  int split_len, int n_split, long long sb, long long st, float scale_log2) {
  using S = MmaShape<D>;
  constexpr int kDT = D / 16;                  // 16-wide steps along D
  constexpr int kCopies = kKeysW * D / 8 / 32;  // 16-byte copies a lane a step, K and V each
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, qd = lane & 3;  // the lane's row and column pair in an mma tile
  bf16* kring = reinterpret_cast<bf16*>(smem_raw) + warp * 2 * S::kStages * S::kTile;
  bf16* vring = kring + S::kStages * S::kTile;

  const int split = blockIdx.x % n_split;
  const int bk = blockIdx.x / n_split;
  const int b = bk / hkv, kh = bk - b * hkv;
  const int64_t head0 = static_cast<int64_t>(bk) * g;  // b·H + kh·G: the group's first head
  const bf16* kb = k + b * sb + static_cast<int64_t>(kh) * D;
  const bf16* vb = v + b * sb + static_cast<int64_t>(kh) * D;
  const int first = split * split_len;
  const int end = min(length, first + split_len);
  const int n_steps = (end - first + kKeysW - 1) / kKeysW;
  const int mine = warp < n_steps ? (n_steps - 1 - warp) / kWarpsMma + 1 : 0;

  // this warp's i-th step (keys first + 16·(warp + 4i) ..) into its ring
  auto load_step = [&](int i) {
    const int k0 = first + (warp + i * kWarpsMma) * kKeysW;
    bf16* kd = kring + (i % S::kStages) * S::kTile;
    bf16* vd = vring + (i % S::kStages) * S::kTile;
#pragma unroll
    for (int u = 0; u < kCopies; ++u) {
      const int c = lane + u * 32;
      const int r = c / (D / 8), col = (c % (D / 8)) * 8;
      const bool in = k0 + r < end;
      const int64_t off = in ? static_cast<int64_t>(k0 + r) * st + col : 0;
      cp_async16(kd + r * S::kStride + col, kb + off, in ? 16 : 0);
      cp_async16(vd + r * S::kStride + col, vb + off, in ? 16 : 0);
    }
  };

  // q as A-fragments: head gr (regs 0, 2) and gr + 8 (regs 1, 3) of the
  // group, columns 2·qd (regs 0, 1) and + 8 (regs 2, 3) of each 16-wide step
  uint32_t qf[kDT][4];
#pragma unroll
  for (int kk = 0; kk < kDT; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = gr + (r & 1) * 8;
      const int col = kk * 16 + (r >> 1) * 8 + 2 * qd;
      qf[kk][r] = row < g ? *reinterpret_cast<const uint32_t*>(q + (head0 + row) * D + col) : 0u;
    }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows gr and gr + 8

#pragma unroll
  for (int s = 0; s < S::kStages - 1; ++s) {
    if (s < mine) load_step(s);
    cp_async_commit();  // an empty group keeps the count uniform
  }
  for (int i = 0; i < mine; ++i) {
    if (i + S::kStages - 1 < mine) load_step(i + S::kStages - 1);  // into the stage freed at i - 1
    cp_async_commit();
    cp_async_wait<S::kStages - 1>();  // step i has landed (this lane's copies)
    __syncwarp();                     // ... and the warp's
    const bf16* kt = kring + (i % S::kStages) * S::kTile;
    const bf16* vt = vring + (i % S::kStages) * S::kTile;
    const int k0 = first + (warp + i * kWarpsMma) * kKeysW;

    // S = q Kᵀ: two key tiles of 8, float32
    float sc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDT; ++kk) {
      // matrices (keys 0-7, d 0-7), (keys 0-7, d 8-15), (keys 8-15, d 0-7), (keys 8-15, d 8-15)
      uint32_t bfr[4];
      const int key = (lane & 7) + ((lane >> 4) << 3);
      ldmatrix_x4(bfr, kt + key * S::kStride + kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(sc[0], qf[kk], bfr[0], bfr[1]);
      mma_bf16(sc[1], qf[kk], bfr[2], bfr[3]);
    }

    // logits in the exp2 domain; keys past the split's end masked on its last step
    const bool edge = k0 + kKeysW > end;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * scale_log2;
        if (edge && k0 + n * 8 + 2 * qd + (e & 1) >= end) x = kNegInf;
        sc[n][e] = x;
      }

    // online softmax on the accumulator fragments; a row's four lanes agree
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(m[r], fmaxf(fmaxf(sc[0][2 * r], sc[0][2 * r + 1]),
                                   fmaxf(sc[1][2 * r], sc[1][2 * r + 1])));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r] = exp2f(m[r] - mx);
      m[r] = mx;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = exp2f(sc[n][e] - m[e >> 1]);
        rs[e >> 1] += sc[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];  // this lane's share
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: P in bf16 A-fragments straight from the accumulators
    uint32_t pa[4];
    pa[0] = pack_bf16(sc[0][0], sc[0][1]);  // row gr, keys 2qd
    pa[1] = pack_bf16(sc[0][2], sc[0][3]);  // row gr + 8
    pa[2] = pack_bf16(sc[1][0], sc[1][1]);  // row gr, keys 8 + 2qd
    pa[3] = pack_bf16(sc[1][2], sc[1][3]);  // row gr + 8
#pragma unroll
    for (int dn = 0; dn < kDT; ++dn) {
      // lanes 0-15: key rows 0-15 at d; lanes 16-31: the same at d + 8
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, vt + (lane & 15) * S::kStride + dn * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dn], pa, vf[0], vf[1]);
      mma_bf16(acc[2 * dn + 1], pa, vf[2], vf[3]);
    }
    __syncwarp();  // this stage is consumed before the warp loads it again
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring is consumed: the merge buffer reuses it

  // the four warps' states merged once: [warp][row][D] accumulators, max, sum
  float* red = reinterpret_cast<float*>(smem_raw);
  float* mw = red + kWarpsMma * kRowsMma * S::kRed;
  float* lw = mw + kWarpsMma * kRowsMma;
  float* bacc = lw + kWarpsMma * kRowsMma;  // [row][D]: the block's merged state
  float* bm = bacc + kRowsMma * D;          // [row]
  float* bl = bm + kRowsMma;                // [row]
  float* fr = bl + kRowsMma;                // [split][row]: each split's weight
  float* il = fr + kMaxCluster * kRowsMma;  // [row]: 1 / the merged sum
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = gr + r * 8;
    float* dst = red + (warp * kRowsMma + row) * S::kRed;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + j * 8 + 2 * qd) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
    if (qd == 0) {
      mw[warp * kRowsMma + row] = m[r];
      lw[warp * kRowsMma + row] = lr;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < g * D; e += kThreadsMma) {
    const int row = e / D, c = e - row * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarpsMma; ++w) mx = fmaxf(mx, mw[w * kRowsMma + row]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsMma; ++w) {  // a warp with no step: max -1e30, weight 0
      const float f = exp2f(mw[w * kRowsMma + row] - mx);
      sum += lw[w * kRowsMma + row] * f;
      a += red[(w * kRowsMma + row) * S::kRed + c] * f;
    }
    if (n_split == 1) {
      store(o + (head0 + row) * D + c, a / fmaxf(sum, 1e-30f));
    } else {
      bacc[e] = a;
      if (c == 0) {
        bm[row] = mx;
        bl[row] = sum;
      }
    }
  }
  if (n_split == 1) return;

  // the splits of this (b, KV head) are the blocks of one cluster: merged by
  // the same rule through distributed shared memory, each block a share of
  // the outputs; no block leaves while another still reads its state
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (threadIdx.x < g) {  // a row's max over the splits, each split's weight, the sum
    const int row = threadIdx.x;
    float ms[kMaxCluster], mx = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n_split) {
        ms[r] = cluster.map_shared_rank(bm, r)[row];
        mx = fmaxf(mx, ms[r]);
      }
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n_split) {
        const float f = exp2f(ms[r] - mx);
        fr[r * kRowsMma + row] = f;
        sum += cluster.map_shared_rank(bl, r)[row] * f;
      }
    il[row] = 1.f / fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  for (int e = split * kThreadsMma + threadIdx.x; e < g * D; e += n_split * kThreadsMma) {
    const int row = e / D, c = e - row * D;
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)  // the splits' loads issued together
      if (r < n_split) a += fr[r * kRowsMma + row] * cluster.map_shared_rank(bacc, r)[e];
    store(o + (head0 + row) * D + c, a * il[row]);
  }
  cluster.sync();
}

template <int D>
int launch_mma_d(const bf16* q, const bf16* k, const bf16* v, bf16* o, int b, int hkv, int g,
                 int length, int split_len, int n_split, long long sb, long long st,
                 float scale, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(b) * hkv * n_split;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = MmaShape<D>::kSmem;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // a cluster of the n_split blocks of each (b, KV head): blockIdx.x / n_split
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = static_cast<unsigned>(n_split);
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreadsMma);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = n_split > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, decode_mma_kernel<D>, q, k, v, o, hkv, g,
                                             length, split_len, n_split, sb, st,
                                             scale * kLog2e));
}

}  // namespace

// sb, st: the batch and position strides of k and v, in elements; the
// valid positions [0, length) are cut in n_split splits of split_len (a
// multiple of 64, every split non-empty); ws: a float32 workspace of
// B·H·n_split·(d + 2) floats when n_split > 1 (null otherwise)
extern "C" int decode_attention_f32(const float* q, const float* k, const float* v, float* o,
                                    float* ws, int b, int h, int hkv, int d, int length,
                                    int split_len, int n_split, long long sb, long long st,
                                    float scale, cudaStream_t stream) {
  return launch<float>(q, k, v, o, ws, b, h, hkv, d, length, split_len, n_split, sb, st,
                       scale, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                     float* ws, int b, int h, int hkv, int d, int length,
                                     int split_len, int n_split, long long sb, long long st,
                                     float scale, cudaStream_t stream) {
  using B = __nv_bfloat16;
  return launch<B>(static_cast<const B*>(q), static_cast<const B*>(k),
                   static_cast<const B*>(v), static_cast<B*>(o), ws, b, h, hkv, d, length,
                   split_len, n_split, sb, st, scale, stream);
}

// the tensor-core route: bfloat16, G = h / hkv <= 16 query heads to a KV
// head, at most 8 splits (one thread-block cluster merges them, so no
// workspace and no second kernel); the other arguments as
// decode_attention_bf16's
extern "C" int decode_attention_bf16_mma(const void* q, const void* k, const void* v, void* o,
                                         int b, int h, int hkv, int d, int length,
                                         int split_len, int n_split, long long sb, long long st,
                                         float scale, cudaStream_t stream) {
  if (!valid(b, h, hkv, length, split_len, n_split) || h / hkv > kRowsMma ||
      n_split > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = h / hkv;
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(o);
  switch (d) {
    case 16: return launch_mma_d<16>(qq, kk, vv, oo, b, hkv, g, length, split_len, n_split, sb, st, scale, stream);
    case 32: return launch_mma_d<32>(qq, kk, vv, oo, b, hkv, g, length, split_len, n_split, sb, st, scale, stream);
    case 64: return launch_mma_d<64>(qq, kk, vv, oo, b, hkv, g, length, split_len, n_split, sb, st, scale, stream);
    case 128: return launch_mma_d<128>(qq, kk, vv, oo, b, hkv, g, length, split_len, n_split, sb, st, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
