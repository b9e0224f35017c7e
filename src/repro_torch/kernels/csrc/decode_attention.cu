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
// (`_decode_kernel`, launched by `decode_attention`), whose grid (B, H,
// n_kv) carries the online-softmax state in VMEM scratch across a
// sequential cache axis and masks positions >= length inside each block.
// Here one block owns one (b, KV head) and a contiguous split of the valid
// cache, serving all G query heads of the group, so every cache byte is
// read from device memory once (the TPU kernel's Hkv == H signature is
// G = 1). Blocks run in no order, so nothing is carried between them: with
// more than one split each block writes its partial state (running max,
// sum and the unnormalised G x D accumulator) to a float32 workspace, and
// a second kernel combines the splits of each (b, h) by the same
// online-softmax rule.
//
// Bound: memory. K and V move once, 2·length·Hkv·D elements per batch row,
// against 4·G·D flops a key: 12 flops a byte at starcoder2-15b's serving
// shape in bf16 (G = 12, D = 128), far below the card's balance point.
// B·Hkv is small at serving (32 blocks at that shape), so the cache axis is
// split until there are two blocks an SM; the dot products run on the
// CUDA cores.
//
// Design: 256 threads. A tile of 64 positions of K and V is staged in
// shared memory as float32 (K rows padded to D + 4 floats so the float4
// reads of neighbouring rows fall in distinct banks), each thread's loads
// issued together so one memory latency, not one a load, is paid a tile;
// the G·64 logits of a tile are one thread a (head, key) pair, a float4
// dot product against the group's queries (also in shared memory); one
// warp a head then updates that head's running max and sum with
// warp-shuffle reductions and writes the tile's probabilities back; last
// each thread rescales and accumulates its (head, dim) outputs of the
// G x D accumulator, which lives in shared memory. The tail tile is cut at
// `length`, so no position past it is loaded.
//
// Plain C interface, loaded with ctypes; the functions return the
// cudaError_t of the launch (0 on success) and never synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, float* ws, int b, int h, int hkv,
           int d, int length, int split_len, int n_split, long long sb, long long st,
           float scale, cudaStream_t stream) {
  if (b < 1 || hkv < 1 || h % hkv != 0 || length < 1 || n_split < 1 ||
      split_len < 1 || split_len % kTK != 0 ||
      static_cast<long long>(split_len) * (n_split - 1) >= length ||
      static_cast<long long>(split_len) * n_split < length ||
      (n_split > 1 && ws == nullptr))
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
