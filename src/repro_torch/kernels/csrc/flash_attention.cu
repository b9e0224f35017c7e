// Flash attention forward on Hopper (sm_90a): online-softmax attention
//
//     o[b,h,i,:] = sum_j softmax_j(scale * q[b,h,i,:] . k[b,h,j,:]) v[b,h,j,:]
//
// q (B,H,S,D), k/v (B,H,T,D), o (B,H,S,D), T >= S, float32 or bfloat16.
// Queries are right-aligned (query i sits at position i + T - S); a key j
// is masked when `causal` and j > i + T - S, or when `window` > 0 and
// (i + T - S) - j >= window (the window applies with or without
// `causal`). A masked logit is -1e30, as in the TPU kernel, so a row's
// result does not depend on which wholly masked tiles are skipped.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:26
// (`_flash_kernel`, launched by `flash_attention`), which keeps the running
// max, sum and accumulator in VMEM scratch across a sequential KV grid
// axis. Here one block owns a tile of query rows of one (b, h) and walks
// the KV tiles itself; nothing is carried between blocks.
//
// Bound: at the LM task's shapes (S = T = 32, D = 16) memory. Each of
// q, k, v and o is moved once: 4·B·H·S·D elements against 4·D flops per
// (query, key) pair in the band, ~2.6 flops a byte in f32 (causal), far
// below the H100's ~20 f32 flops a byte. For S, T in the thousands the
// flops bound, and a CUDA-core kernel is far from the tensor cores' rate.
//
// Design: a block of 32 or 64 query rows (32 when S <= 32, so the LM's
// 32-row heads fill the block). D / 16 neighbouring lanes share a row,
// each holding 16 of its dims (lane + G·i, strided so the lanes of a row
// read neighbouring shared-memory words) of q and of the f32 accumulator
// in registers; the row's dot product is reduced across those lanes by
// warp shuffles. K and V are staged through shared memory in tiles of 64
// keys, converted to f32 once on the load (2·64·D·4 bytes: above the
// default 48 KB at D = 128, so that instantiation raises its dynamic
// shared-memory limit). The softmax is updated once per 16 keys: max,
// rescale, 16 exps. KV tiles wholly past the causal edge or before the
// window of every row of the block are not loaded. Ragged S and T are
// masked at the tile edges. Each input element is read from device memory
// once per block that needs it (K and V once per query tile, q and o
// once), so at the LM's shapes every byte moves once. The result is
// divided once by max(l, 1e-30) and rounded once on the store (bf16 by
// round-to-nearest-even). No tensor cores (mma.sync / wgmma) and no
// TMA: this is the simple first version.
//
// Plain C interface, loaded with ctypes; the functions return the
// cudaError_t of the launch (0 on success) and never synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's masked logit
constexpr int kBK = 64;            // keys per shared-memory tile
constexpr int kKC = 16;            // keys per online-softmax update
constexpr int kDPL = 16;           // head dims held by one lane

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(64 * (D / kDPL))
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int n_qtiles,
             int bq, int s, int t, int causal, int window, float scale) {
  constexpr int G = D / kDPL;  // lanes sharing one query row
  extern __shared__ float smem[];
  float* ks = smem;            // [kBK][D]
  float* vs = smem + kBK * D;  // [kBK][D]

  const int bh = blockIdx.x / n_qtiles;
  const int qt = blockIdx.x % n_qtiles;
  const int lane = threadIdx.x % G;
  const int row = qt * bq + threadIdx.x / G;
  const bool active = row < s;  // rows past S compute, but never store
  const int shift = t - s;      // queries right-aligned
  const int qi = row + shift;
  const T* qrow = q + (static_cast<int64_t>(bh) * s + row) * D;
  const T* kb = k + static_cast<int64_t>(bh) * t * D;
  const T* vb = v + static_cast<int64_t>(bh) * t * D;

  float qv[kDPL], acc[kDPL];
#pragma unroll
  for (int i = 0; i < kDPL; ++i) {
    qv[i] = active ? to_f32(qrow[lane + G * i]) : 0.f;
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
    const T* kt = kb + static_cast<int64_t>(k0) * D;
    const T* vt = vb + static_cast<int64_t>(k0) * D;
    for (int idx = threadIdx.x; idx < nk * D; idx += blockDim.x) {
      ks[idx] = to_f32(kt[idx]);
      vs[idx] = to_f32(vt[idx]);
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
    T* orow = o + (static_cast<int64_t>(bh) * s + row) * D;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) store(orow + lane + G * i, acc[i] / denom);
  }
}

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, T* o, int bh, int s, int t,
             int causal, int window, float scale, cudaStream_t stream) {
  constexpr int G = D / kDPL;
  const int bq = s <= 32 ? 32 : 64;
  const int n_qtiles = (s + bq - 1) / bq;
  const long long blocks = static_cast<long long>(bh) * n_qtiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * kBK * D * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_kernel<T, D><<<static_cast<unsigned>(blocks), bq * G, smem, stream>>>(
      q, k, v, o, n_qtiles, bq, s, t, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, int bh, int s, int t,
           int d, int causal, int window, float scale, cudaStream_t stream) {
  if (bh < 1 || s < 1 || t < s || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 16: return launch_d<T, 16>(q, k, v, o, bh, s, t, causal, window, scale, stream);
    case 32: return launch_d<T, 32>(q, k, v, o, bh, s, t, causal, window, scale, stream);
    case 64: return launch_d<T, 64>(q, k, v, o, bh, s, t, causal, window, scale, stream);
    case 128: return launch_d<T, 128>(q, k, v, o, bh, s, t, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window: 0 = no window, else >= 1
extern "C" int flash_attention_f32(const float* q, const float* k, const float* v, float* o,
                                   int bh, int s, int t, int d, int causal, int window,
                                   float scale, cudaStream_t stream) {
  return launch<float>(q, k, v, o, bh, s, t, d, causal, window, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    int bh, int s, int t, int d, int causal, int window,
                                    float scale, cudaStream_t stream) {
  using B = __nv_bfloat16;
  return launch<B>(static_cast<const B*>(q), static_cast<const B*>(k),
                   static_cast<const B*>(v), static_cast<B*>(o), bh, s, t, d, causal,
                   window, scale, stream);
}
