// Mamba2 SSD chunked scan on Hopper (sm_90a)
//
//     h_t = exp(dt_t A) h_{t-1} + dt_t B_t (x) x_t,    y_t = C_t . h_t
//
// computed chunk by chunk, as the TPU kernel does. Per chunk of Q positions,
// with cum = cumsum(dt·A) over the chunk:
//
//     y     = (C Bᵀ ∘ tril(exp(cum_i − cum_j))) (x dt) + (C ∘ exp(cum)) state
//     state = exp(cum_Q) state + (B ∘ exp(cum_Q − cum))ᵀ (x dt)
//
// x (B,L,H,P) float32 or bfloat16; dt (B,L,H) and A (H,) float32; B/C
// (B,L,G,N) in x's dtype, head h reading group h / (H/G). x, B and C take
// their batch and position strides (their last two axes dense), so the
// caller passes slices of the convolved projection in place. y (B,L,H,P)
// in x's dtype; the final state (B,H,N,P) float32; an optional initial
// state (B,H,N,P) float32 (zero when null). Every product, sum and
// exponent is float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:26
// (`_ssd_kernel`, launched by `ssd_scan`), whose grid (B, H, n_chunks)
// carries the (N, P) state in VMEM scratch across the sequential chunk
// axis and builds the whole (Q, Q) decay and score matrices in VMEM. On
// Hopper a block owns one (b, h, tile of P columns) and loops over the
// chunks itself, the state in shared memory; the columns of P are
// independent given x's columns, so the P split is exact (each tile
// recomputes C Bᵀ). The TPU kernel returns y only; this one also writes
// the final state, which the decode cache needs.
//
// Bound: operations. At mamba2-370m's shape (Q 256, N 128, P 64) a chunk
// needs 2·Q·(N+P)·Q/2 causal flops and 4·Q·N·P more per (b, h), about 100
// flops a byte moved; on the CUDA cores in float32 this version is far from
// that bound (no tensor cores).
//
// Design: the (Q, Q) matrices (256 KB in f32 at Q = 256) do not fit in the
// 227 KB a block has, so the chunk is tiled: blocks of 64 query rows
// against blocks of 64 keys j <= i, the causal mask and the decay applied
// to each 64 x 64 score tile as it is made. Each staging of rows issues a
// thread's loads 8 at a time, so their memory latencies overlap. 256
// threads as a 16 x 16 grid; each holds a 4 x 4 tile of scores, a
// 4 x (P_tile/16) tile of y and a
// (N/16) x (P_tile/16) tile of the next state in registers. Per row block:
// its C rows are staged; the inter-chunk term reads the state from shared
// memory; each key block stages its B rows and x·dt, forms the masked score
// tile and adds its product into y. The last row block meets every key
// block, and there the state update is accumulated. The chunk's cumsum is
// one warp's shuffle scan. Shared-memory rows are padded to an odd stride
// (N + 1, 65) so the threads of a warp read distinct banks.
//
// Plain C interface, loaded with ctypes; the functions return the
// cudaError_t of the launch (0 on success) and never synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kR = 64;          // query rows and keys per sub-block
constexpr int kMaxN = 128;      // state size the register tile holds
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Stage rows [0, kR) of a row-strided global matrix (row r at src + r·ld,
// `width` elements) into shared memory as float32 (row stride sld), row r
// times row_scale(r), rows >= nrows zero. A thread issues its loads 8 at a
// time before storing any, so 8 memory latencies overlap, not one a load.
template <typename T, typename Scale>
__device__ __forceinline__ void stage_rows(float* dst, int sld, const T* src,
                                           long long ld, int nrows, int width,
                                           Scale row_scale) {
  constexpr int kBatch = 8;
  const int total = kR * width;
  for (int base = threadIdx.x; base < total; base += kBatch * kThreads) {
    float vals[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads;
      const int r = idx / width, c = idx - r * width;
      vals[u] = idx < total && r < nrows ? to_f32(src[r * ld + c]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads;
      const int r = idx / width, c = idx - r * width;
      if (idx < total) dst[r * sld + c] = r < nrows ? vals[u] * row_scale(r) : 0.f;
    }
  }
}

size_t smem_bytes(int q, int n, int pt) {
  const size_t floats = 2 * static_cast<size_t>(q)                  // dt, cum
                        + static_cast<size_t>(n) * pt                // state
                        + 2 * static_cast<size_t>(kR) * (n + 1)      // C, B rows
                        + static_cast<size_t>(kR) * pt               // x dt
                        + static_cast<size_t>(kR) * (kR + 1);        // scores
  return floats * sizeof(float);
}

template <typename T, int PT>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ init,
           T* __restrict__ y, float* __restrict__ state_out, int L, int H,
           int G, int P, int N, int Q, long long xsb, long long xsl,
           long long bsb, long long bsl, long long csb, long long csl) {
  constexpr int PB = PT / 16;   // y / state columns a thread holds
  constexpr int NA = kMaxN / 16;
  const int NS = N + 1;         // padded row stride of the B and C tiles
  constexpr int GS = kR + 1;    // padded row stride of the score tile
  extern __shared__ float smem[];
  float* dts = smem;            // [Q]
  float* cum = dts + Q;         // [Q]
  float* S = cum + Q;           // [N][PT]
  float* Cs = S + N * PT;       // [kR][NS]
  float* Bs = Cs + kR * NS;     // [kR][NS]
  float* Xs = Bs + kR * NS;     // [kR][PT]
  float* Gs = Xs + kR * PT;     // [kR][GS]

  const int n_pt = P / PT;
  const int pt = blockIdx.x % n_pt;
  const int bh = blockIdx.x / n_pt;
  const int b = bh / H, h = bh - b * H;
  const int grp = h / (H / G);
  const int p0 = pt * PT;
  const float a_h = A[h];
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const T* xb = x + b * xsb + static_cast<int64_t>(h) * P + p0;
  const T* bb_ = Bm + b * bsb + static_cast<int64_t>(grp) * N;
  const T* cb = Cm + b * csb + static_cast<int64_t>(grp) * N;
  const float* dtb = dt + static_cast<int64_t>(b) * L * H + h;
  T* yb = y + (static_cast<int64_t>(b) * L * H + h) * P + p0;
  const int64_t soff = (static_cast<int64_t>(b) * H + h) * N * P + p0;

  for (int idx = threadIdx.x; idx < N * PT; idx += kThreads) {
    const int n = idx / PT, c = idx - n * PT;
    S[idx] = init ? init[soff + static_cast<int64_t>(n) * P + c] : 0.f;
  }

  for (int t0 = 0; t0 < L; t0 += Q) {
    __syncthreads();  // the previous chunk's state update is done
    for (int i = threadIdx.x; i < Q; i += kThreads)
      dts[i] = dtb[static_cast<int64_t>(t0 + i) * H];
    __syncthreads();
    if (warp == 0) {  // inclusive cumsum of dt·A over the chunk
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        float v = base + lane < Q ? dts[base + lane] * a_h : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += u;
        }
        if (base + lane < Q) cum[base + lane] = carry + v;
        carry += __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];

    float sacc[NA][PB];
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int c = 0; c < PB; ++c) sacc[a][c] = 0.f;

    for (int i0 = 0; i0 < Q; i0 += kR) {
      const int nr = min(kR, Q - i0);
      const bool last_rows = i0 + kR >= Q;
      stage_rows(Cs, NS, cb + (t0 + i0) * csl, csl, nr, N,
                 [](int) { return 1.f; });
      __syncthreads();

      // inter-chunk term: exp(cum_i) · C_i · state
      float yacc[4][PB];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < PB; ++c) yacc[a][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[PB];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = Cs[(tr + 16 * a) * NS + n];
#pragma unroll
        for (int c = 0; c < PB; ++c) sv[c] = S[n * PT + tc + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < PB; ++c) yacc[a][c] += cv[a] * sv[c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = tr + 16 * a;
        const float w = i < nr ? expf(cum[i0 + i]) : 0.f;
#pragma unroll
        for (int c = 0; c < PB; ++c) yacc[a][c] *= w;
      }

      // intra-chunk term over the key blocks j0 <= i0
      for (int j0 = 0; j0 <= i0; j0 += kR) {
        const int nk = min(kR, Q - j0);
        __syncthreads();  // the previous key block is consumed
        stage_rows(Bs, NS, bb_ + (t0 + j0) * bsl, bsl, nk, N,
                   [](int) { return 1.f; });
        const float* dtj = dts + j0;
        stage_rows(Xs, PT, xb + (t0 + j0) * xsl, xsl, nk, PT,
                   [dtj](int r) { return dtj[r]; });
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = Cs[(tr + 16 * a) * NS + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = Bs[(tc + 16 * c) * NS + n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[a][c] += cv[a] * bv[c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = tr + 16 * a, gi = i0 + i;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = tc + 16 * c, gj = j0 + j;
            Gs[i * GS + j] = (i < nr && j < nk && gi >= gj)
                                 ? s[a][c] * expf(cum[gi] - cum[gj]) : 0.f;
          }
        }
        __syncthreads();

        for (int j = 0; j < nk; ++j) {
          float gv[4], xv[PB];
#pragma unroll
          for (int a = 0; a < 4; ++a) gv[a] = Gs[(tr + 16 * a) * GS + j];
#pragma unroll
          for (int c = 0; c < PB; ++c) xv[c] = Xs[j * PT + tc + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < PB; ++c) yacc[a][c] += gv[a] * xv[c];
        }
        if (last_rows) {  // every key block passes here once: the state update
          for (int j = 0; j < nk; ++j) {
            const float w = expf(cum_last - cum[j0 + j]);
            float xv[PB];
#pragma unroll
            for (int c = 0; c < PB; ++c) xv[c] = Xs[j * PT + tc + 16 * c];
#pragma unroll
            for (int a = 0; a < NA; ++a) {
              const int n = tr + 16 * a;
              const float bv = n < N ? Bs[j * NS + n] * w : 0.f;
#pragma unroll
              for (int c = 0; c < PB; ++c) sacc[a][c] += bv * xv[c];
            }
          }
        }
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = tr + 16 * a;
        if (i < nr) {
          T* yr = yb + static_cast<int64_t>(t0 + i0 + i) * H * P;
#pragma unroll
          for (int c = 0; c < PB; ++c) store(yr + tc + 16 * c, yacc[a][c]);
        }
      }
      __syncthreads();  // Cs is restaged by the next row block
    }

    const float decay = expf(cum_last);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const int n = tr + 16 * a;
      if (n < N) {
#pragma unroll
        for (int c = 0; c < PB; ++c) {
          float* sp = S + n * PT + tc + 16 * c;
          *sp = *sp * decay + sacc[a][c];
        }
      }
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < N * PT; idx += kThreads) {
    const int n = idx / PT, c = idx - n * PT;
    state_out[soff + static_cast<int64_t>(n) * P + c] = S[idx];
  }
}

template <typename T, int PT>
int launch_pt(const T* x, const float* dt, const float* A, const T* Bm, const T* Cm,
              const float* init, T* y, float* state, int b, int L, int H, int G, int P,
              int N, int Q, long long xsb, long long xsl, long long bsb, long long bsl,
              long long csb, long long csl, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(b) * H * (P / PT);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(Q, N, PT);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_kernel<T, PT><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      x, dt, A, Bm, Cm, init, y, state, L, H, G, P, N, Q, xsb, xsl, bsb, bsl, csb, csl);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* x, const float* dt, const float* A, const T* Bm, const T* Cm,
           const float* init, T* y, float* state, int b, int L, int H, int G, int P, int N,
           int Q, int pt, long long xsb, long long xsl, long long bsb, long long bsl,
           long long csb, long long csl, cudaStream_t stream) {
  if (b < 1 || L < 1 || H < 1 || G < 1 || H % G != 0 || N < 1 || N > kMaxN ||
      Q < 1 || L % Q != 0 || P % pt != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (pt) {
    case 16: return launch_pt<T, 16>(x, dt, A, Bm, Cm, init, y, state, b, L, H, G, P, N, Q,
                                     xsb, xsl, bsb, bsl, csb, csl, stream);
    case 32: return launch_pt<T, 32>(x, dt, A, Bm, Cm, init, y, state, b, L, H, G, P, N, Q,
                                     xsb, xsl, bsb, bsl, csb, csl, stream);
    case 64: return launch_pt<T, 64>(x, dt, A, Bm, Cm, init, y, state, b, L, H, G, P, N, Q,
                                     xsb, xsl, bsb, bsl, csb, csl, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// init may be null (a zero initial state); pt: the P columns a block takes
// (16, 32 or 64, dividing P); strides in elements
extern "C" int ssd_scan_f32(const float* x, const float* dt, const float* A, const float* Bm,
                            const float* Cm, const float* init, float* y, float* state,
                            int b, int L, int H, int G, int P, int N, int Q, int pt,
                            long long xsb, long long xsl, long long bsb, long long bsl,
                            long long csb, long long csl, cudaStream_t stream) {
  return launch<float>(x, dt, A, Bm, Cm, init, y, state, b, L, H, G, P, N, Q, pt, xsb, xsl,
                       bsb, bsl, csb, csl, stream);
}

extern "C" int ssd_scan_bf16(const void* x, const float* dt, const float* A, const void* Bm,
                             const void* Cm, const float* init, void* y, float* state,
                             int b, int L, int H, int G, int P, int N, int Q, int pt,
                             long long xsb, long long xsl, long long bsb, long long bsl,
                             long long csb, long long csl, cudaStream_t stream) {
  using B = __nv_bfloat16;
  return launch<B>(static_cast<const B*>(x), dt, A, static_cast<const B*>(Bm),
                   static_cast<const B*>(Cm), init, static_cast<B*>(y), state, b, L, H, G, P,
                   N, Q, pt, xsb, xsl, bsb, bsl, csb, csl, stream);
}
