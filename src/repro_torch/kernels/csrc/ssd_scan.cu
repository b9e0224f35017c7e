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
// state (B,H,N,P) float32 (zero when null). Every sum and exponent is
// float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:26
// (`_ssd_kernel`, launched by `ssd_scan` through the `pallas_call` at
// :77), whose grid (B, H, n_chunks) carries the (N, P) state in VMEM
// scratch across the sequential chunk axis and builds the whole (Q, Q)
// decay and score matrices in VMEM. The TPU kernel returns y only; this
// one also writes the final state, which the decode cache needs.
//
// Bound: per (b, h, chunk) Q·N·Q causal score flops, Q·P·Q for their
// product with x·dt and 4·Q·N·P for the inter-chunk term and the state
// update. At mamba2-370m's prefill (bf16; B 8, L 2,048, H 32, Q 256, N
// 128, P 64) that is 43 GFLOP against 149 MB moved, ~290 flops a byte:
// level with the H100's bf16 tensor-core balance point, so bytes and
// operations bound it alike (~0.045 ms). On the CUDA cores in float32 the
// operations bound it.
//
// Design, bfloat16 with P in {16, 32, 64, 128}, N a multiple of 16 up to
// 128 and Q a multiple of 64 (the wrapper's route; mamba2 and Jamba):
// chunk-parallel, Mamba2's own decomposition (arXiv:2405.21060 §6-7), in
// three kernels over B·H·n_chunks independent units (2,048 at mamba2's
// prefill, against 256 blocks of the sequential design), every product on
// the tensor cores (mma.sync.m16n8k16, float32 accumulators), operands
// staged by 16-byte cp.async into shared memory with rows padded by 16
// bytes, so that ldmatrix reads no bank twice.
//   1. chunk states, a block a (b, h, chunk): a block-wide scan gives the
//      chunk's cumsum of dt·A, kept in the exp2 domain as cum2 = cum·log2 e
//      with the key factor kj = cum2 − log2 dt, so that every decay times
//      dt below is one ex2 of a difference, 2^(cum2_i − kj_j) =
//      exp(cum_i − cum_j)·dt_j; both go to a small float32 workspace. Then
//      s_c = Bᵀ (x ∘ w), w_j = 2^(cum2_Q − kj_j), over 64-position tiles
//      (double-buffered), the scaled x rows split hi/lo in shared memory,
//      into a float32 workspace (B,H,nc,N,P).
//   2. state passing, a thread a 4 state elements of a (b, h): S_c =
//      2^(cum2_Q,c)·S_{c−1} + s_c from `init` (or zero), the state entering
//      each chunk written already split (hi, lo: B,H,nc,2,N,P) for stage
//      3's ldmatrix, the final state written. Elementwise, memory-bound.
//   3. chunk scan, a block a (b, h, chunk, 64 query rows), a warp 16 rows:
//      y = diag(2^cum2)·(C·S_{c−1}) + (C·Bᵀ ∘ tril(2^(cum2_i − kj_j)))·x.
//      C·Bᵀ runs on the bf16 inputs as they are; the decay and dt are one
//      ex2 on its float32 accumulator fragments, the causal mask only on
//      the diagonal tile, and the key groups above the diagonal are
//      skipped. The C rows and the entering state share one shared-memory
//      region with the ring of key tiles, which takes it over once they
//      are in registers, so four blocks fit an SM.
// A float32 operand is never rounded to bf16 once, nor taken through
// TF32: one bf16 rounding of the decayed x rows, the score matrix or the
// state costs ~2e-3 relative and would miss the plain version's state by
// more than 5e-4. Each enters as a hi/lo pair, hi = bf16(v), lo =
// bf16(v − hi), and its product is two mma (hi·u + lo·u), which keeps
// ~2^-16 relative; x, B and C are bf16 already and enter exactly. Stage 3
// keeps the score matrix in registers between its two products (the C
// layout of two 8-key tiles is the A layout of one 16-key step). What
// binds it now is latency at four blocks an SM and the L2 traffic of each
// block restaging the entering state and its key tiles: not the tensor
// cores' rate.
//
// The bf16-compute route (the reference's ssm.compute_dtype = "bfloat16",
// whose chunked form rounds the decay matrix, the scores and x·dt to bf16
// and sums in float32) is the same three kernels with the template flag
// kSplit off: every operand enters mma.sync as one bf16 — x ∘ w in stage 1,
// the entering state (stage 2 writes its hi half only) and the decayed
// score matrix in stage 3 — so each product is one mma instead of two. The
// inter-chunk state is still carried in float32.
//
// Design, float32 (and any other bf16 shape): a block owns one (b, h, tile
// of P columns) and loops over the chunks itself, the state in shared
// memory; the columns of P are independent given x's columns, so the P
// split is exact (each tile recomputes C Bᵀ). The (Q, Q) matrices (256 KB
// in f32 at Q = 256) do not fit in the 227 KB a block has, so the chunk is
// tiled: blocks of 64 query rows against blocks of 64 keys j <= i, the
// causal mask and the decay applied to each 64 x 64 score tile as it is
// made. Each staging of rows issues a thread's loads 8 at a time, so their
// memory latencies overlap. 256 threads as a 16 x 16 grid; each holds a
// 4 x 4 tile of scores, a 4 x (P_tile/16) tile of y and a (N/16) x
// (P_tile/16) tile of the next state in registers. Per row block: its C
// rows are staged; the inter-chunk term reads the state from shared
// memory; each key block stages its B rows and x·dt, forms the masked
// score tile and adds its product into y. The last row block meets every
// key block, and there the state update is accumulated. The chunk's
// cumsum is one warp's shuffle scan. Shared-memory rows are padded to an
// odd stride (N + 1, 65) so the threads of a warp read distinct banks. All
// products are float32 FMAs on the CUDA cores.
//
// Plain C interface, loaded with ctypes; the functions return the
// cudaError_t of the launch (0 on success) and never synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

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

// ---------------------------------------------------------------------------
// bfloat16: chunk-parallel on the tensor cores, float32 operands as hi/lo pairs
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kTileRows = 64;       // positions a tile: query rows, and keys of each product
constexpr int kStateThreads = 256;  // stage 1: 8 warps, a 16-row m-tile of the state each
constexpr int kPassThreads = 256;   // stage 2: a thread 4 state elements of a (b, h)
constexpr int kScanThreads = 128;   // stage 3: 4 warps, 16 query rows each
constexpr int kMaxNMma = 128;       // N the register tiles hold (8 steps of 16)
constexpr float kLog2e = 1.4426950408889634f;

// 2^x, one MUFU instruction (relative error ~2^-22; 0 below 2^-126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two float32 values as hi = bf16(v) and lo = bf16(v − hi), each pair packed
// as one 32-bit mma operand register (the first value in the low half)
__device__ __forceinline__ void split_pack(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// two float32 values rounded to bf16, packed as one 32-bit mma operand
// register (the first value in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// `rows` rows of a row-strided matrix (row r at src + r·ld elements, `bytes`
// a row, a multiple of 16) into shared memory (row stride `sbytes`), by
// 16-byte cp.async from every thread of the block
template <typename T>
__device__ __forceinline__ void stage_async(T* dst, int sbytes, const T* src, long long ld,
                                            int rows, int bytes) {
  const int per_row = bytes / 16;
  const int step_r = blockDim.x / per_row, step_c = blockDim.x - step_r * per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x - r * per_row;
  const char* s = reinterpret_cast<const char*>(src);
  char* d = reinterpret_cast<char*>(dst);
  while (r < rows) {
    cp_async16(d + r * sbytes + c * 16, s + (r * ld) * static_cast<long long>(sizeof(T)) + c * 16,
               16);
    r += step_r;
    c += step_c;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// Stage 1's scan of the chunk (256 threads, Q <= 1024): cum_i = Σ_{i' <= i}
// dt_i'·a in float32, kept in the exp2 domain as cum2 = cum·log2 e, and the
// key factor kj = cum2 − log2 dt (so that exp(cum_i − cum_j)·dt_j =
// 2^(cum2_i − kj_j)); written to shared memory and to the unit's factors
// `fac` [cum2 (Q)][kj (Q)]; returns with the block synchronised
__device__ void chunk_factors(float* cum2s, float* kjs, float* __restrict__ fac,
                              const float* __restrict__ dtc, int H, int Q, float a) {
  __shared__ float wsum[kStateThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (Q + kStateThreads - 1) / kStateThreads;  // <= 4
  const int first = threadIdx.x * per;
  float d[4], run[4], s = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    d[k] = 1.f;
    if (k < per && first + k < Q) {
      d[k] = dtc[static_cast<int64_t>(first + k) * H];
      s += d[k] * a;
    }
    run[k] = s;
  }
  float incl = s;  // inclusive scan of the threads' sums, then of the warps'
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kStateThreads / 32 ? wsum[lane] : 0.f;
#pragma unroll
    for (int off = 1; off < kStateThreads / 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += u;
    }
    if (lane < kStateThreads / 32) wsum[lane] = t;
  }
  __syncthreads();
  const float base = (warp > 0 ? wsum[warp - 1] : 0.f) + incl - s;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = first + k;
    if (k < per && i < Q) {
      const float cum2 = (base + run[k]) * kLog2e;
      const float kj = cum2 - log2f(d[k]);
      cum2s[i] = cum2;
      kjs[i] = kj;
      fac[i] = cum2;
      fac[Q + i] = kj;
    }
  }
  __syncthreads();
}

size_t state_smem_bytes(int n, int p, int q) {
  return 2 * static_cast<size_t>(q) * sizeof(float)  // cum2, kj
         + (2 * static_cast<size_t>(kTileRows) * (n + 8)  // B (two stages)
            + 4 * static_cast<size_t>(kTileRows) * (p + 8)) * sizeof(bf16);  // x (two), x·w hi, lo
}

// stage 3's bf16 region: first the C rows and the entering state (hi, lo),
// then, once both are in registers, the ring of key tiles (B and x, two
// stages)
size_t scan_region(int n, int p) {
  const size_t prologue =
      static_cast<size_t>(kTileRows) * (n + 8) + 2 * static_cast<size_t>(n) * (p + 8);
  const size_t ring = 2 * static_cast<size_t>(kTileRows) * (n + p + 16);
  return prologue > ring ? prologue : ring;
}

size_t scan_smem_bytes(int n, int p, int q) {
  return static_cast<size_t>(q) * sizeof(float) + scan_region(n, p) * sizeof(bf16);
}

// stage 1, a block a (b, h, chunk) = blockIdx.x: the chunk's factors
// (chunk_factors) into fac[blockIdx.x] and its local state s_c = Bᵀ (x ∘ w),
// w_j = exp(cum_Q − cum_j)·dt_j, into states[blockIdx.x] (N, P) float32;
// x ∘ w split hi/lo (kSplit) or rounded to one bf16
template <int P, bool kSplit>
__global__ void __launch_bounds__(kStateThreads)
ssd_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Bm,
                 float* __restrict__ states, float* __restrict__ fac, int L, int H, int G,
                 int N, int Q, long long xsb, long long xsl, long long bsb, long long bsl) {
  constexpr int PS = P + 8;  // bf16 a shared-memory row: 16 bytes of padding
  const int NS = N + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum2s = reinterpret_cast<float*>(smem_raw);  // [Q]
  float* kjs = cum2s + Q;                              // [Q]
  bf16* braw = reinterpret_cast<bf16*>(kjs + Q);       // [2][kTileRows][NS]
  bf16* xraw = braw + 2 * kTileRows * NS;              // [2][kTileRows][PS]
  bf16* xhi = xraw + 2 * kTileRows * PS;               // [kTileRows][PS]
  bf16* xlo = xhi + kTileRows * PS;                    // [kTileRows][PS]

  const int nc = L / Q;
  const int bh = blockIdx.x / nc, c = blockIdx.x - bh * nc;
  const int b = bh / H, h = bh - b * H, grp = h / (H / G);
  const int64_t t0 = static_cast<int64_t>(c) * Q;
  const bf16* xb = x + b * xsb + t0 * xsl + static_cast<int64_t>(h) * P;
  const bf16* bb = Bm + b * bsb + t0 * bsl + static_cast<int64_t>(grp) * N;
  const int n_tiles = Q / kTileRows;
  auto load_tile = [&](int t) {
    stage_async(braw + (t & 1) * kTileRows * NS, NS * 2, bb + t * kTileRows * bsl, bsl, kTileRows, N * 2);
    stage_async(xraw + (t & 1) * kTileRows * PS, PS * 2, xb + t * kTileRows * xsl, xsl, kTileRows, P * 2);
  };
  load_tile(0);
  cp_async_commit();
  chunk_factors(cum2s, kjs, fac + static_cast<int64_t>(blockIdx.x) * 2 * Q,
                dt + (static_cast<int64_t>(b) * L + t0) * H + h, H, Q, A[h]);
  const float cum2_last = cum2s[Q - 1];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, qd = lane & 3;
  const bool active = warp * 16 < N;  // the warp's m-tile: state rows 16·warp ..
  float acc[P / 8][4];
#pragma unroll
  for (int j = 0; j < P / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tile(t + 1);  // into the stage consumed at t - 1
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile t has landed
    // x rows scaled by w_j = 2^(cum2_Q − kj_j), split hi/lo or rounded once
    const bf16* xt = xraw + (t & 1) * kTileRows * PS;
    for (int idx = threadIdx.x; idx < kTileRows * P / 2; idx += kStateThreads) {
      const int j = idx / (P / 2), col = (idx - j * (P / 2)) * 2;
      const float w = ex2(cum2_last - kjs[t * kTileRows + j]);
      const float2 xv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xt + j * PS + col));
      if constexpr (kSplit) {
        uint32_t hi, lo;
        split_pack(xv.x * w, xv.y * w, hi, lo);
        *reinterpret_cast<uint32_t*>(xhi + j * PS + col) = hi;
        *reinterpret_cast<uint32_t*>(xlo + j * PS + col) = lo;
      } else {
        *reinterpret_cast<uint32_t*>(xhi + j * PS + col) = pack_bf16(xv.x * w, xv.y * w);
      }
    }
    __syncthreads();
    if (active) {
      const bf16* bt = braw + (t & 1) * kTileRows * NS;
#pragma unroll
      for (int ks = 0; ks < kTileRows / 16; ++ks) {
        // A = Bᵀ, stored position-major: ldmatrix.trans of (16 positions, 16 states)
        uint32_t af[4];
        ldmatrix_x4_trans(af, bt + (ks * 16 + (lane & 7) + (lane >> 4) * 8) * NS + warp * 16 +
                                  ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int pp = 0; pp < P / 16; ++pp) {
          uint32_t xh[4];  // x ∘ w (positions, P) as the "col" B operand
          const int off = (ks * 16 + (lane & 15)) * PS + pp * 16 + (lane >> 4) * 8;
          ldmatrix_x4_trans(xh, xhi + off);
          mma_bf16(acc[2 * pp], af, xh[0], xh[1]);
          mma_bf16(acc[2 * pp + 1], af, xh[2], xh[3]);
          if constexpr (kSplit) {
            uint32_t xl[4];
            ldmatrix_x4_trans(xl, xlo + off);
            mma_bf16(acc[2 * pp], af, xl[0], xl[1]);
            mma_bf16(acc[2 * pp + 1], af, xl[2], xl[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage and the hi/lo tile are consumed
  }
  if (active) {
    float* sp = states + static_cast<int64_t>(blockIdx.x) * N * P;
#pragma unroll
    for (int j = 0; j < P / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = warp * 16 + gr + r * 8;
        *reinterpret_cast<float2*>(sp + n * P + j * 8 + 2 * qd) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      }
  }
}

// stage 2, a thread 4 state elements (e4) of a (b, h): the chunks walked in
// order from `init` (zero when null), S_c = 2^(cum2_Q,c)·S_{c−1} + s_c; the
// state entering chunk c written to prev[(b, h, c)] as hi (N, P) then, with
// kSplit, lo (N, P) bf16, the last to state_out
template <bool kSplit>
__global__ void __launch_bounds__(kPassThreads)
ssd_pass_kernel(const float* __restrict__ states, const float* __restrict__ fac,
                const float* __restrict__ init, bf16* __restrict__ prev,
                float* __restrict__ state_out, int nc, int Q, int np4, int per_bh) {
  const int bh = blockIdx.x / per_bh;
  const int e4 = (blockIdx.x - bh * per_bh) * kPassThreads + threadIdx.x;
  if (e4 >= np4) return;
  const int64_t off = static_cast<int64_t>(bh) * np4 + e4;
  float4 s = init ? reinterpret_cast<const float4*>(init)[off] : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc; ++c) {
    const int64_t u = static_cast<int64_t>(bh) * nc + c;
    const float4 loc = reinterpret_cast<const float4*>(states)[u * np4 + e4];
    uint2* pu = reinterpret_cast<uint2*>(prev + u * 8 * np4);  // 2·N·P bf16 a unit
    if constexpr (kSplit) {
      uint32_t h01, l01, h23, l23;
      split_pack(s.x, s.y, h01, l01);
      split_pack(s.z, s.w, h23, l23);
      pu[e4] = make_uint2(h01, h23);
      pu[np4 + e4] = make_uint2(l01, l23);
    } else {
      pu[e4] = make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
    }
    const float d = ex2(fac[u * 2 * Q + Q - 1]);
    s.x = s.x * d + loc.x;
    s.y = s.y * d + loc.y;
    s.z = s.z * d + loc.z;
    s.w = s.w * d + loc.w;
  }
  reinterpret_cast<float4*>(state_out)[off] = s;
}

// stage 3, a block a (b, h, chunk, 64 query rows), the row tiles of a chunk
// next to each other, the one that sees the most keys first: y =
// diag(2^cum2)·(C·S) + (C·Bᵀ ∘ tril(2^(cum2_i − kj_j)))·x, S the state
// entering the chunk (zero and skipped for chunk 0 when `zero_init`); S and
// the decayed scores as hi/lo pairs (kSplit) or one bf16 each
template <int P, bool kSplit>
__global__ void __launch_bounds__(kScanThreads, P >= 128 ? 2 : 4)
ssd_chunk_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ fac,
                      const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                      const bf16* __restrict__ prev, bf16* __restrict__ y, int L, int H, int G,
                      int N, int Q, int zero_init, long long xsb, long long xsl, long long bsb,
                      long long bsl, long long csb, long long csl) {
  constexpr int PS = P + 8;
  constexpr int kNT = kMaxNMma / 16;
  const int NS = N + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* kjs = reinterpret_cast<float*>(smem_raw);  // [Q]: the keys' factors
  bf16* region = reinterpret_cast<bf16*>(kjs + Q);
  bf16* cs = region;                   // [kTileRows][NS]   } the prologue
  bf16* shi = cs + kTileRows * NS;     // [N][PS]           }
  bf16* slo = shi + N * PS;            // [N][PS]           }
  const int ring = kTileRows * (NS + PS);  // a stage: B [kTileRows][NS], x [kTileRows][PS]

  const int nc = L / Q, n_rt = Q / kTileRows;
  const int rt = n_rt - 1 - static_cast<int>(blockIdx.x % n_rt);
  const int u = blockIdx.x / n_rt;
  const int bh = u / nc, c = u - bh * nc;
  const int b = bh / H, h = bh - b * H, grp = h / (H / G);
  const int64_t t0 = static_cast<int64_t>(c) * Q;
  const int i0 = rt * kTileRows;
  const bf16* xb = x + b * xsb + t0 * xsl + static_cast<int64_t>(h) * P;
  const bf16* bb = Bm + b * bsb + t0 * bsl + static_cast<int64_t>(grp) * N;
  const bf16* cb = Cm + b * csb + t0 * csl + static_cast<int64_t>(grp) * N;
  const float* fu = fac + static_cast<int64_t>(u) * 2 * Q;
  const bool inter = !(zero_init && c == 0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, qd = lane & 3;
  const int row0 = i0 + warp * 16;  // the warp's first query row in the chunk

  stage_async(cs, NS * 2, cb + i0 * csl, csl, kTileRows, N * 2);
  if (inter)
    stage_async(shi, PS * 2, prev + static_cast<int64_t>(u) * 2 * N * P, P,
                kSplit ? 2 * N : N, P * 2);  // hi rows, then lo rows
  stage_async(kjs, 0, fu + Q, 0, 1, (i0 + kTileRows) * 4);
  cp_async_commit();
  const float ci0 = fu[row0 + gr], ci1 = fu[row0 + gr + 8];  // the rows' cum2
  cp_async_wait<0>();
  __syncthreads();

  // C rows as A-fragments, held for both products
  uint32_t cf[kNT][4];
#pragma unroll
  for (int kk = 0; kk < kNT; ++kk)
    if (kk * 16 < N)
      ldmatrix_x4(cf[kk], cs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * NS + kk * 16 +
                              (lane >> 4) * 8);

  float yacc[P / 8][4];
#pragma unroll
  for (int j = 0; j < P / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;
  if (inter) {  // C·S_hi (+ C·S_lo), then the rows' decay 2^cum2_i
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      if (kk * 16 >= N) continue;
#pragma unroll
      for (int pp = 0; pp < P / 16; ++pp) {
        uint32_t sh[4];
        const int off = (kk * 16 + (lane & 15)) * PS + pp * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(sh, shi + off);
        mma_bf16(yacc[2 * pp], cf[kk], sh[0], sh[1]);
        mma_bf16(yacc[2 * pp + 1], cf[kk], sh[2], sh[3]);
        if constexpr (kSplit) {
          uint32_t sl[4];
          ldmatrix_x4_trans(sl, slo + off);
          mma_bf16(yacc[2 * pp], cf[kk], sl[0], sl[1]);
          mma_bf16(yacc[2 * pp + 1], cf[kk], sl[2], sl[3]);
        }
      }
    }
    const float e0 = ex2(ci0), e1 = ex2(ci1);
#pragma unroll
    for (int j = 0; j < P / 8; ++j) {
      yacc[j][0] *= e0;
      yacc[j][1] *= e0;
      yacc[j][2] *= e1;
      yacc[j][3] *= e1;
    }
  }
  __syncthreads();  // C and the state are in registers: the region takes the key ring

  auto load_keys = [&](int kt) {
    bf16* st = region + (kt & 1) * ring;
    stage_async(st, NS * 2, bb + kt * kTileRows * bsl, bsl, kTileRows, N * 2);
    stage_async(st + kTileRows * NS, PS * 2, xb + kt * kTileRows * xsl, xsl, kTileRows, P * 2);
  };
  load_keys(0);
  cp_async_commit();
  for (int kt = 0; kt <= rt; ++kt) {
    if (kt < rt) load_keys(kt + 1);  // into the stage consumed at kt - 1
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* bt = region + (kt & 1) * ring;
    const bf16* xt = bt + kTileRows * NS;
    const int j0 = kt * kTileRows;
    const bool diag = kt == rt;
    // the 16-key groups the warp's rows reach: all four below the diagonal tile
    const int groups = diag ? warp + 1 : 4;

    // C·Bᵀ on the bf16 inputs, float32: eight key tiles of 8
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      if (kk * 16 >= N) continue;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np >= groups) continue;
        uint32_t bfr[4];
        const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(bfr, bt + key * NS + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * np], cf[kk], bfr[0], bfr[1]);
        mma_bf16(sc[2 * np + 1], cf[kk], bfr[2], bfr[3]);
      }
    }
    // the decay and dt, 2^(cum2_i − kj_j), on the float32 fragments; the
    // causal mask on the diagonal tile
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int j = j0 + n * 8 + 2 * qd;
      const float2 kj = *reinterpret_cast<const float2*>(kjs + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row0 + gr + (e >> 1) * 8;
        const float v = sc[n][e] * ex2((e >> 1 ? ci1 : ci0) - (e & 1 ? kj.y : kj.x));
        sc[n][e] = diag && j + (e & 1) > i ? 0.f : v;
      }
    }
    // y += M·x, M in hi/lo (or one bf16) A-fragments straight from the
    // accumulators
#pragma unroll
    for (int kg = 0; kg < 4; ++kg) {
      if (kg >= groups) continue;
      uint32_t ah[4], al[4];
      if constexpr (kSplit) {
        split_pack(sc[2 * kg][0], sc[2 * kg][1], ah[0], al[0]);          // row gr, keys 2qd
        split_pack(sc[2 * kg][2], sc[2 * kg][3], ah[1], al[1]);          // row gr + 8
        split_pack(sc[2 * kg + 1][0], sc[2 * kg + 1][1], ah[2], al[2]);  // row gr, keys 8 + 2qd
        split_pack(sc[2 * kg + 1][2], sc[2 * kg + 1][3], ah[3], al[3]);  // row gr + 8
      } else {
        ah[0] = pack_bf16(sc[2 * kg][0], sc[2 * kg][1]);
        ah[1] = pack_bf16(sc[2 * kg][2], sc[2 * kg][3]);
        ah[2] = pack_bf16(sc[2 * kg + 1][0], sc[2 * kg + 1][1]);
        ah[3] = pack_bf16(sc[2 * kg + 1][2], sc[2 * kg + 1][3]);
      }
#pragma unroll
      for (int pp = 0; pp < P / 16; ++pp) {
        uint32_t xf[4];
        ldmatrix_x4_trans(xf, xt + (kg * 16 + (lane & 15)) * PS + pp * 16 + (lane >> 4) * 8);
        mma_bf16(yacc[2 * pp], ah, xf[0], xf[1]);
        mma_bf16(yacc[2 * pp + 1], ah, xf[2], xf[3]);
        if constexpr (kSplit) {
          mma_bf16(yacc[2 * pp], al, xf[0], xf[1]);
          mma_bf16(yacc[2 * pp + 1], al, xf[2], xf[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is loaded again
  }

  bf16* yb = y + (static_cast<int64_t>(b) * L + t0) * H * P + static_cast<int64_t>(h) * P;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* yr = yb + static_cast<int64_t>(row0 + gr + r * 8) * H * P;
#pragma unroll
    for (int j = 0; j < P / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(yr + j * 8 + 2 * qd) =
          __floats2bfloat162_rn(yacc[j][2 * r], yacc[j][2 * r + 1]);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int P, bool kSplit>
int launch_chunked(const bf16* x, const float* dt, const float* A, const bf16* Bm,
                   const bf16* Cm, const float* init, bf16* y, float* state, float* states,
                   float* fac, bf16* prev, int b, int L, int H, int G, int N, int Q,
                   long long xsb, long long xsl, long long bsb, long long bsl, long long csb,
                   long long csl, cudaStream_t stream) {
  const long long units = static_cast<long long>(b) * H * (L / Q);
  const int np4 = N * P / 4;
  const int per_bh = (np4 + kPassThreads - 1) / kPassThreads;
  if (units * (Q / kTileRows) > INT_MAX || static_cast<long long>(b) * H * per_bh > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem1 = state_smem_bytes(N, P, Q), smem3 = scan_smem_bytes(N, P, Q);
  if (smem1 > kMaxSmem || smem3 > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(ssd_state_kernel<P, kSplit>, smem1);
  if (err == cudaSuccess) err = allow_smem(ssd_chunk_scan_kernel<P, kSplit>, smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_state_kernel<P, kSplit><<<static_cast<unsigned>(units), kStateThreads, smem1, stream>>>(
      x, dt, A, Bm, states, fac, L, H, G, N, Q, xsb, xsl, bsb, bsl);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_pass_kernel<kSplit><<<static_cast<unsigned>(b * H * per_bh), kPassThreads, 0, stream>>>(
      states, fac, init, prev, state, L / Q, Q, np4, per_bh);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_scan_kernel<P, kSplit>
      <<<static_cast<unsigned>(units * (Q / kTileRows)), kScanThreads, smem3, stream>>>(
          x, fac, Bm, Cm, prev, y, L, H, G, N, Q, init == nullptr, xsb, xsl, bsb, bsl, csb, csl);
  return static_cast<int>(cudaGetLastError());
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

// the tensor-core route: bfloat16, P in {16, 32, 64, 128}, N a multiple of
// 16 up to 128, Q a multiple of 64; x, B, C 16-byte aligned with strides
// that are multiples of 8. Workspaces, from the caller: states float32
// (B·H·nc·N·P), fac float32 (B·H·nc·2·Q), prev bf16 (B·H·nc·2·N·P), nc = L/Q.
// bf16_compute: 0 takes every float32 operand as a hi/lo pair, 1 as one bf16
extern "C" int ssd_scan_bf16_chunked(const void* x, const float* dt, const float* A,
                                     const void* Bm, const void* Cm, const float* init,
                                     void* y, float* state, float* states, float* fac,
                                     void* prev, int b, int L, int H, int G, int P, int N,
                                     int Q, int bf16_compute, long long xsb, long long xsl, long long bsb,
                                     long long bsl, long long csb, long long csl,
                                     cudaStream_t stream) {
  if (b < 1 || L < 1 || H < 1 || G < 1 || H % G != 0 || N < 16 || N > kMaxNMma ||
      N % 16 != 0 || Q < kTileRows || Q % kTileRows != 0 || Q > 4 * kStateThreads ||
      L % Q != 0 ||
      states == nullptr || fac == nullptr || prev == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  using B = __nv_bfloat16;
  const B* xx = static_cast<const B*>(x);
  const B* bb = static_cast<const B*>(Bm);
  const B* cc = static_cast<const B*>(Cm);
  B* yy = static_cast<B*>(y);
  B* pv = static_cast<B*>(prev);
#define SSD_CHUNKED(PV, SPLIT)                                                                \
  launch_chunked<PV, SPLIT>(xx, dt, A, bb, cc, init, yy, state, states, fac, pv, b, L, H, G, N, Q, \
                            xsb, xsl, bsb, bsl, csb, csl, stream)
  const bool split = bf16_compute == 0;
  switch (P) {
    case 16: return split ? SSD_CHUNKED(16, true) : SSD_CHUNKED(16, false);
    case 32: return split ? SSD_CHUNKED(32, true) : SSD_CHUNKED(32, false);
    case 64: return split ? SSD_CHUNKED(64, true) : SSD_CHUNKED(64, false);
    case 128: return split ? SSD_CHUNKED(128, true) : SSD_CHUNKED(128, false);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SSD_CHUNKED
}
