// Batch-invariant float32 reductions on Hopper (sm_90a), over the middle
// axis of a contiguous x (R, M, D):
//
//     sum        out[r, d] = sum_m x[r, m, d]                    (R, D)
//     logsumexp  out[r] = log(sum_m exp(x[r, m] - max)) + max    (R, 1), D = 1
//     argmax     out[r] = the first m of the largest x[r, m]     (R, 1) int64
//
// Replaces no TPU kernel. The JAX package leaves its reductions to XLA;
// the port's task plane (federated/task.py, federated/cohort.py) runs
// every float32 sum of its two models on the card through this kernel —
// the masked loss and accuracy sums, the mean of rms_norm, the
// logsumexp of the cross-entropy, the gradients of the vector parameters
// that a client's rows share (autograd's sums over a broadcast), the
// attention gradient's row sums — because a library's reduction chooses
// its launch, and with it the order of a row's sum, by how many rows
// there are, and the loop engine must equal the vectorized engine bit for
// bit.
//
// The order of a row depends only on the positions of its elements:
//   D > 1: one thread per output (r, d) adds x[r, 0, d], x[r, 1, d], ...
//          in order (the columns of a warp are neighbouring addresses);
//   D = 1: one warp per row, lane j adds the elements j, j + 32, j + 64,
//          ... in order, then the 32 lane sums meet in a fixed tree
//          (shuffles down by 16, 8, 4, 2, 1).
// In both, element m always lands at the same place of the same chain, so
// zeros appended to a row (a padded client's masked-out samples) change
// no bit, and nothing depends on R. A chain starts at +0 and so never holds
// -0 (x + y is -0 only when both are), so adding a +0 changes no chain:
// the kernels fill what lies past a row's end with zeros and add them.
// logsumexp and argmax walk a row in one thread, in order (their rows are
// a vocabulary or a head's keys long): logsumexp the maximum (the first
// element that no later one is above(): a NaN wins and the first NaN
// stays), then, with sub the maximum or +0 for an infinite one (as
// jax.nn.logsumexp and torch.logsumexp take it), s += expf(x[m] - sub)
// for m in order from +0, then logf(s) + sub: a row holding +inf reads
// +inf, a row of -inf reads logf(0) = -inf; argmax the index of that
// first maximal element, as torch.argmax does.
//
// Bound: bytes — each input read once, each output written once. Every
// call of the task plane moves at most a few MB, so the launch and the
// chains' latency dominate.
//
// Design of the sums (the chains above, scheduled by shape on the host;
// none changes an order):
//   a warp a row (D = 1) or a thread a column (D > 1), each thread loading
//     the next 8 elements of its chain into registers before it adds them
//     in order (a chain of 8 or more steps), in blocks of 32, 64 or 256
//     threads: the smallest that still makes ~132 blocks, 256 for chains
//     shorter than 8 (there more blocks only cost their launch);
//   a block a row for D = 1 rows of kLongRow or more (the evaluation's
//     10,000 predictions a model): warp 0 adds while warps 1-4 keep the
//     row's next kStages - 1 chunks of kChunk steps (kChunk * 32
//     neighbouring elements) in flight into shared memory by cp.async, 16
//     bytes a copy where the row starts on 16 bytes, zeros past its end;
//     so 56 rows run on 56 SMs at the rate of their adds.
// Design of logsumexp and argmax (the walk above, unchanged):
//   a block stages a tile of ROWS consecutive rows (one contiguous range
//     of x) in shared memory by cp.async, neighbouring threads on
//     neighbouring addresses: 16 bytes a copy where M is a multiple of 4
//     and x starts on 16 bytes (each row's chunks land whole, at a stride
//     of M + 4 floats where M / 4 is even, so that the 8 rows a quarter
//     warp reads with one 16-byte load fill the 32 banks), else 4 bytes a
//     copy at an odd stride (M, or M + 1); then thread i walks row i from
//     shared memory. So a row is read from device memory once, in whole
//     sectors (a thread walking its row there made each warp load touch
//     32 sectors for 4 bytes of each, and logsumexp walked it twice);
//   ROWS (128, 64 or 32 threads and rows a block) is the largest whose
//     tile fits 48 KB and still makes two blocks an SM, else the smallest
//     that fits: 5,952 rows of 64 take 186 blocks of 32;
//   rows of kShortRow or fewer (the §V MLP's 10 classes) keep the walk
//     over device memory, a thread a row in blocks of 256: a warp's 32
//     rows span at most 1.5 KB, whose sectors the L1 cache holds from
//     one load to the next; on an H100 that walk reads 480,000 rows of
//     10 at its bytes bound, where a tile's copy, wait and walk in turn
//     take longer; so does a row too long for a 32-row tile (a stride
//     over 384 floats: M over 383; none is on a path).
//
// Plain C interface, loaded with ctypes; the functions return the
// cudaError_t of the launch (0 on success) and never synchronise.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;         // loads a short chain has in flight
constexpr int kChunk = 32;         // chain steps a stage of a long row
constexpr int kStages = 4;
constexpr int kCopiers = 128;      // threads of a long row's block that copy
constexpr int kRowThreads = 32 + kCopiers;     // and warp 0, which adds
constexpr int kLongRow = 32 * 32;  // M from which a row takes a block
constexpr int kTileFloats = 48 * 1024 / 4;  // the most a staged tile holds
constexpr int kShortRow = 12;      // M up to which a row is walked in place
constexpr int kSMs = 132;

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_tree(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  return acc;
}

// UNROLL: 8 loads of the chain in flight (a chain of 8 steps or more)
template <int THREADS, bool UNROLL>
__global__ void __launch_bounds__(THREADS)
sum_columns_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int64_t r, int64_t m, int64_t d) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= r * d) return;
  const int64_t row = i / d, col = i % d;
  const float* p = x + row * m * d + col;
  float acc = 0.f;
  int64_t k = 0;
  for (; UNROLL && k + kUnroll <= m; k += kUnroll) {   // the loads first, then the adds
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = p[(k + u) * d];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc += v[u];
  }
  for (; k < m; ++k) acc += p[k * d];
  out[i] = acc;
}

template <int THREADS, bool UNROLL>
__global__ void __launch_bounds__(THREADS)
sum_rows_kernel(const float* __restrict__ x, float* __restrict__ out,
                int64_t r, int64_t m) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= r) return;  // a whole warp: THREADS is a multiple of 32
  const float* p = x + row * m;
  float acc = 0.f;
  int64_t k = lane;
  for (; UNROLL && k + 32 * (kUnroll - 1) < m; k += 32 * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = p[k + 32 * u];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc += v[u];
  }
  for (; k < m; k += 32) acc += p[k];
  acc = warp_tree(acc);
  if (lane == 0) out[row] = acc;
}

// D = 1, long rows: a block a row. Lane j's step i is element 32 i + j;
// the row is walked in chunks of kChunk steps (kChunk * 32 neighbouring
// elements), which warps 1.. copy kStages - 1 chunks ahead (16 bytes a
// copy where the row starts on 16 bytes, `vec`; zeros past its end) while
// warp 0 adds the chunk that is in, then meets its lanes in the tree.
__global__ void __launch_bounds__(kRowThreads)
sum_long_rows_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t m,
                     bool vec) {
  __shared__ __align__(16) float ring[kStages][kChunk * 32];
  const float* p = x + static_cast<int64_t>(blockIdx.x) * m;
  const int tid = threadIdx.x, q = tid - 32;
  const int64_t chunks = (m + kChunk * 32 - 1) / (kChunk * 32);

  auto load = [&](int64_t c) {
    if (q < 0) return;
    float* s = ring[c % kStages];
    const int64_t e0 = c * kChunk * 32;
    if (vec) {
#pragma unroll
      for (int u = 0; u < kChunk * 8 / kCopiers; ++u) {
        const int e = 4 * (q + u * kCopiers);
        const int64_t left = m - e0 - e;
        const int bytes = left <= 0 ? 0 : left >= 4 ? 16 : static_cast<int>(4 * left);
        cp_async16(s + e, bytes ? p + e0 + e : x, bytes);
      }
    } else {
#pragma unroll
      for (int u = 0; u < kChunk * 32 / kCopiers; ++u) {
        const int e = q + u * kCopiers;
        const bool ok = e0 + e < m;
        cp_async4(s + e, ok ? p + e0 + e : x, ok ? 4 : 0);
      }
    }
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) load(c);
    cp_async_commit();
  }
  float acc = 0.f;
  for (int64_t c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk c is in; warp 0 is done with c - 1
    if (c + kStages - 1 < chunks) load(c + kStages - 1);
    cp_async_commit();
    if (tid < 32) {    // the loads first, then the adds in order
      const float* s = ring[c % kStages] + tid;
      float v[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) v[i] = s[32 * i];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) acc += v[i];
    }
  }
  if (tid >= 32) return;
  acc = warp_tree(acc);
  if (tid == 0) out[blockIdx.x] = acc;
}

__device__ __forceinline__ bool above(float v, float best) {
  return v > best || (isnan(v) && !isnan(best));
}

__global__ void __launch_bounds__(kThreads)
logsumexp_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int64_t r, int64_t m) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= r) return;
  const float* p = x + row * m;
  float mx = -INFINITY;
  for (int64_t k = 0; k < m; ++k) {
    const float v = p[k];
    if (above(v, mx)) mx = v;
  }
  const float sub = isinf(mx) ? 0.f : mx;
  float s = 0.f;
  for (int64_t k = 0; k < m; ++k) s += expf(p[k] - sub);
  out[row] = logf(s) + sub;
}

__global__ void __launch_bounds__(kThreads)
argmax_kernel(const float* __restrict__ x, int64_t* __restrict__ out,
              int64_t r, int64_t m) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= r) return;
  const float* p = x + row * m;
  float best = p[0];
  int64_t at = 0;
  for (int64_t k = 1; k < m; ++k) {
    const float v = p[k];
    if (above(v, best)) { best = v; at = k; }
  }
  out[row] = at;
}

// The tile of (at most) ROWS rows from row blockIdx.x * ROWS into shared
// memory, row i at tile + i * stride (see the design above); returns the
// rows it holds. Copy c of the tile is (row i, chunk j) with i = c / n
// taken as (c * magic) >> 32, exact while c * n < 2^32 (c, n < 2^14).
template <int ROWS, bool VEC>
__device__ __forceinline__ int stage_tile(float* tile, const float* __restrict__ x,
                                          int64_t r, int m, int stride) {
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * ROWS;
  const int rows = static_cast<int>(r - row0 < ROWS ? r - row0 : ROWS);
  const float* src = x + row0 * m;
  const int n = VEC ? m / 4 : m;       // copies a row
  const uint64_t magic = (uint64_t{1} << 32) / n + 1;
  for (int c = threadIdx.x; c < rows * n; c += ROWS) {
    const int i = static_cast<int>((static_cast<uint64_t>(c) * magic) >> 32);
    const int j = c - i * n;
    if (VEC)
      cp_async16(tile + i * stride + 4 * j, src + 4 * static_cast<int64_t>(c), 16);
    else
      cp_async4(tile + i * stride + j, src + c, 4);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  return rows;
}

// f(k, x[k]) for k = 0 .. m - 1 in order, from a staged row (16-byte
// loads where VEC)
template <bool VEC, class F>
__device__ __forceinline__ void walk(const float* row, int m, F&& f) {
  if (VEC) {
    for (int k = 0; k < m; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(row + k);
      f(k, v.x);
      f(k + 1, v.y);
      f(k + 2, v.z);
      f(k + 3, v.w);
    }
  } else {
    for (int k = 0; k < m; ++k) f(k, row[k]);
  }
}

template <int ROWS, bool VEC>
__global__ void __launch_bounds__(ROWS)
logsumexp_tile_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int64_t r, int m, int stride) {
  extern __shared__ __align__(16) float tile[];
  const int rows = stage_tile<ROWS, VEC>(tile, x, r, m, stride);
  if (static_cast<int>(threadIdx.x) >= rows) return;
  const float* row = tile + threadIdx.x * stride;
  float mx = -INFINITY;
  walk<VEC>(row, m, [&](int, float v) {
    if (above(v, mx)) mx = v;
  });
  const float sub = isinf(mx) ? 0.f : mx;
  float s = 0.f;
  walk<VEC>(row, m, [&](int, float v) { s += expf(v - sub); });
  out[static_cast<int64_t>(blockIdx.x) * ROWS + threadIdx.x] = logf(s) + sub;
}

// starts at k = 0 with x[0] as the best: x[0] is never above itself
template <int ROWS, bool VEC>
__global__ void __launch_bounds__(ROWS)
argmax_tile_kernel(const float* __restrict__ x, int64_t* __restrict__ out,
                   int64_t r, int m, int stride) {
  extern __shared__ __align__(16) float tile[];
  const int rows = stage_tile<ROWS, VEC>(tile, x, r, m, stride);
  if (static_cast<int>(threadIdx.x) >= rows) return;
  const float* row = tile + threadIdx.x * stride;
  float best = row[0];
  int at = 0;
  walk<VEC>(row, m, [&](int k, float v) {
    if (above(v, best)) {
      best = v;
      at = k;
    }
  });
  out[static_cast<int64_t>(blockIdx.x) * ROWS + threadIdx.x] = at;
}

unsigned blocks(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

template <int THREADS, bool UNROLL>
void launch_short(const float* x, float* out, int64_t r, int64_t m, int64_t d,
                  int64_t threads, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((threads + THREADS - 1) / THREADS);
  if (d == 1)
    sum_rows_kernel<THREADS, UNROLL><<<grid, THREADS, 0, s>>>(x, out, r, m);
  else
    sum_columns_kernel<THREADS, UNROLL><<<grid, THREADS, 0, s>>>(x, out, r, m, d);
}

template <bool LSE, int ROWS, bool VEC>
void launch_tile(const float* x, void* out, int64_t r, int m, int stride, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((r + ROWS - 1) / ROWS);
  const size_t bytes = sizeof(float) * ROWS * stride;
  if (LSE)
    logsumexp_tile_kernel<ROWS, VEC><<<grid, ROWS, bytes, s>>>(
        x, static_cast<float*>(out), r, m, stride);
  else
    argmax_tile_kernel<ROWS, VEC><<<grid, ROWS, bytes, s>>>(
        x, static_cast<int64_t*>(out), r, m, stride);
}

template <bool LSE, bool VEC>
void launch_tiles(const float* x, void* out, int64_t r, int m, int stride, int rows,
                  cudaStream_t s) {
  if (rows == 128)
    launch_tile<LSE, 128, VEC>(x, out, r, m, stride, s);
  else if (rows == 64)
    launch_tile<LSE, 64, VEC>(x, out, r, m, stride, s);
  else
    launch_tile<LSE, 32, VEC>(x, out, r, m, stride, s);
}

// A thread a row from a staged tile (the design above); false where a row
// is short enough or too long to stage, and the caller keeps the walk over
// device memory.
template <bool LSE>
bool launch_staged(const float* x, void* out, long long r, long long m, cudaStream_t s) {
  const bool vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long long stride = vec ? (m / 4 % 2 ? m : m + 4) : (m % 2 ? m : m + 1);
  if (m <= kShortRow || 32 * stride > kTileFloats || (r + 31) / 32 > 0x7fffffffLL)
    return false;
  int rows = 128;
  while (rows > 32 && (rows * stride > kTileFloats || (r + rows - 1) / rows < 2 * kSMs))
    rows /= 2;
  const int mi = static_cast<int>(m), st = static_cast<int>(stride);
  if (vec)
    launch_tiles<LSE, true>(x, out, r, mi, st, rows, s);
  else
    launch_tiles<LSE, false>(x, out, r, mi, st, rows, s);
  return true;
}

}  // namespace

// The route: a block a row for long rows (D = 1); else a warp a row or a
// thread a column, in blocks of 256 threads, or of 64 or 32 where chains of
// 8 or more steps would leave most of the card's 132 SMs empty.
extern "C" int bi_sum_f32(const float* x, float* out, long long r,
                          long long m, long long d, void* stream) {
  if (r <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long len = d == 1 ? (m + 31) / 32 : m;
  if (d == 1 && m >= kLongRow) {
    if (r > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && m % 4 == 0;
    sum_long_rows_kernel<<<static_cast<unsigned>(r), kRowThreads, 0, s>>>(x, out, m, vec);
  } else {
    const long long threads = d == 1 ? r * 32 : r * d;
    if (len < kUnroll)
      launch_short<kThreads, false>(x, out, r, m, d, threads, s);
    else if ((threads + kThreads - 1) / kThreads >= 132)
      launch_short<kThreads, true>(x, out, r, m, d, threads, s);
    else if ((threads + 63) / 64 >= 132)
      launch_short<64, true>(x, out, r, m, d, threads, s);
    else
      launch_short<32, true>(x, out, r, m, d, threads, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bi_logsumexp_f32(const float* x, float* out, long long r,
                                long long m, void* stream) {
  if (r <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!launch_staged<true>(x, out, r, m, s))
    logsumexp_kernel<<<blocks(r), kThreads, 0, s>>>(x, out, r, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bi_argmax_f32(const float* x, long long* out, long long r,
                             long long m, void* stream) {
  if (r <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!launch_staged<false>(x, out, r, m, s))
    argmax_kernel<<<blocks(r), kThreads, 0, s>>>(x, reinterpret_cast<int64_t*>(out), r, m);
  return static_cast<int>(cudaGetLastError());
}
