// Coordinate-wise robust aggregation on Hopper (sm_90a), the defense plane's
// trimmed mean and median over the first n of N stacked client updates:
//
//     trimmed mean  out[m] = (xs[b] + xs[b+1] + ... + xs[n-b-1]) / (n - 2b)
//     median        out[m] = (xs[(n-1)/2] + xs[n/2]) * 0.5
//
// where xs is column m of x (N, M) sorted ascending over its first n rows.
// Replaces the Pallas TPU kernel src/repro/kernels/robust_aggregate.py:31
// (`_robust_kernel`, launched by `robust_aggregate` / `_robust_call`), which
// loads an (N, block_m) tile into VMEM, marks rows >= n with +inf and runs
// a statically unrolled odd-even transposition sort of all N rows.
//
// Bound: memory. The kernel must read n*M values and write M; at the main
// path's n = 44, M = 50,890 in f32 that is 9.16 MB, 2.73 us at the H100's
// 3.35 TB/s. What holds a kernel back from it: one thread sorts one column,
// so its loads and its sort form one dependent chain, and at M = 50,890 a
// single wave holds only ~12 warps an SM to hide the loads' latency; and
// the sort's integer min/max issue at half the float32 rate.
//
// Design. One thread owns one column, and a warp reads 32 neighbouring
// columns of a row (128 contiguous bytes for f32). The kernel is a
// template on a size class C (4, 8, ..., 64 by fours, then 80, 96, 112,
// 128); the launcher picks the smallest C >= n, so at most 3 slots (15
// above 64) are padding and the network is cut close to n. Each thread
//  1. issues all of its n loads (unrolled over C, predicated on i < n)
//     before it uses any, so they are in flight together, not in batches;
//  2. turns each value into an order-preserving signed 32-bit key: the bits
//     below the sign flipped in a negative float, then rotated down by
//     kRotation so that -inf's key is INT_MIN. A NaN with its sign bit set
//     (whose flipped key would sort below -inf) wraps round to the top, and
//     any other NaN's key is above +inf's, so every NaN sorts last as numpy
//     and the host oracles put it; slots n .. C-1 hold kPadKey, the largest;
//  3. sorts the C keys in registers with Batcher's odd-even merge network
//     of the next power of two, cut to the comparators between wires < C
//     (543 at C = 64, 347 at C = 44). Every comparator puts its minimum on
//     the lower wire, so the pad keys never move and the cut network
//     sorts. The network is unrolled at compile time (`Network<C>`), so
//     every index is a constant, the array stays in registers, and each
//     compare-exchange is one integer min and one max, with no branch and
//     no shared or local memory;
//  4. adds the ranks b .. n-b-1 in ascending order, one f32 add at a time
//     (predicated on a bit mask of the run-time window), from -0.0f, the
//     exact additive identity (-0 + x = x for every x, either zero
//     included), and divides once by (float)(n - 2b): the reference's
//     `_seq_mean` order (src/repro/core/defenses.py:125-132). The median
//     selects ranks (n-1)/2 and n/2 with predicated moves. The file is built
//     without --use_fast_math, so the division is IEEE.
// bf16 input is widened to f32 on load and the result is rounded once on
// the store (round to nearest even, through the intrinsics); the type is a
// run-time switch, uniform across the grid, so a class is one instance.
// Up to C = 128 no instance spills (153 registers at C = 128, one thread a
// column).
//
// What still binds it, from single-change variant builds: without the
// network the kernel takes ~58% of its time, so the loads and the network
// run one after the other (every warp of the one wave loads, then sorts);
// two to four columns a thread with the next column's loads in flight
// during a sort, a depth-first order of the network and converting each
// key at its first comparator all failed to overlap them.
//
// Ties: the key order puts -0 before +0, where np.sort leaves equal values
// in no stated order. So ranks can differ from the reference's only in the
// sign of a zero; the values, and so the results, are the same (the checks
// compare values, which treat -0 and +0 as equal), and the result is
// bit-equal to the plain version and the host oracles otherwise.
//
// n and b are arguments: one build serves every cohort size. The Python
// mirror of the classes, the network, the key map and the reduction is
// kernels/robust_aggregate.py (`SIZE_CLASSES`, `network`, `to_keys`,
// `robust_aggregate_network`).
//
// Plain C interface, loaded with ctypes; the functions return the
// cudaError_t of the launch (0 on success) and never synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace {

constexpr int kThreads = 64;                  // columns a block
constexpr int kMaxRows = 128;                 // the largest size class
constexpr int kMaxComparators = 1471;         // Network<128>
constexpr uint32_t kRotation = 0x007FFFFFu;   // -inf's flipped bits - INT_MIN
constexpr int32_t kPadKey = 0x7FFFFFFF;       // slots n .. C-1, the largest key

// The comparators (a[t] < b[t]) of Batcher's odd-even merge sort of the
// next power of two >= c wires, in the order of these loops, those between
// wires < c only.
struct Comparators {
  int size = 0;
  int a[kMaxComparators] = {};
  int b[kMaxComparators] = {};
};

__host__ __device__ constexpr Comparators odd_even_merge_network(int c) {
  Comparators net{};
  int wires = 1;
  while (wires < c) wires <<= 1;
  for (int p = 1; p < wires; p <<= 1) {
    for (int k = p; k >= 1; k >>= 1) {
      for (int j = k % p; j + k < wires; j += 2 * k) {
        for (int i = 0; i < k && i + j + k < wires; ++i) {
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p) && i + j + k < c) {
            net.a[net.size] = i + j;
            net.b[net.size] = i + j + k;
            ++net.size;
          }
        }
      }
    }
  }
  return net;
}

template <int C>
struct Network {
  static constexpr Comparators kNet = odd_even_merge_network(C);
};

// comparator counts (kernels/robust_aggregate.py::network gives the same)
static_assert(Network<8>::kNet.size == 19, "network of 8");
static_assert(Network<44>::kNet.size == 347, "network of 44");
static_assert(Network<64>::kNet.size == 543, "network of 64");
static_assert(Network<100>::kNet.size == 1104, "network of 100");
static_assert(Network<128>::kNet.size == 1471, "network of 128");

template <int A, int B, int C>
__device__ __forceinline__ void compare_exchange(int32_t (&k)[C]) {
  const int32_t lo = k[A] < k[B] ? k[A] : k[B];
  k[B] = k[A] < k[B] ? k[B] : k[A];
  k[A] = lo;
}

template <int C, int... T>
__device__ __forceinline__ void sort_keys(int32_t (&k)[C],
                                          std::integer_sequence<int, T...>) {
  (compare_exchange<Network<C>::kNet.a[T], Network<C>::kNet.b[T]>(k), ...);
}

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// float -> key, a signed 32-bit integer in the floats' order: the bits
// below the sign flipped in a negative float, then rotated down by kRotation
// (mod 2^32) so that -inf's key is INT_MIN. A NaN with its sign bit set,
// whose key would lie below -inf's, wraps round to the top; any other NaN's
// key stays above +inf's. The map is its own inverse but for the rotation.
__device__ __forceinline__ int32_t flip(int32_t s) { return s ^ ((s >> 31) & 0x7FFFFFFF); }

__device__ __forceinline__ int32_t to_key(float v) {
  return static_cast<int32_t>(static_cast<uint32_t>(flip(__float_as_int(v))) - kRotation);
}

__device__ __forceinline__ float from_key(int32_t key) {
  return __int_as_float(flip(static_cast<int32_t>(static_cast<uint32_t>(key) + kRotation)));
}

// the keys of the first n rows of column `block * kThreads + threadIdx.x`,
// every load issued before any is used; slots n .. C-1 hold kPadKey
template <typename T, int C>
__device__ __forceinline__ void load_keys(const void* x, int64_t block, int64_t m, int n,
                                          int32_t (&k)[C]) {
  const T* base = static_cast<const T*>(x) + block * kThreads;
  float v[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    v[i] = i < n ? load_f32(base + i * m + threadIdx.x) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < C; ++i) k[i] = i < n ? to_key(v[i]) : kPadKey;
}

// the bits 0 .. b-1 of a 32-bit word, b clamped to [0, 32]
__device__ __forceinline__ uint32_t bits_below(int b) {
  return b <= 0 ? 0u : b >= 32 ? 0xFFFFFFFFu : (1u << b) - 1u;
}

// One thread a column; bf16 is a run-time switch (uniform across the
// grid), so a size class is one instance for both types.
template <int C>
__global__ void __launch_bounds__(kThreads)
robust_kernel(const void* __restrict__ x, void* __restrict__ out, int n, int64_t m,
              int trim, int median, int bf16) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= m) return;
  int32_t k[C];
  if (bf16) {
    load_keys<__nv_bfloat16, C>(x, blockIdx.x, m, n, k);
  } else {
    load_keys<float, C>(x, blockIdx.x, m, n, k);
  }

  sort_keys(k, std::make_integer_sequence<int, Network<C>::kNet.size>{});

  float res;
  if (median) {
    // ranks (n-1)/2 and n/2 lie in [0, C/2]
    const int lo = (n - 1) / 2, hi = n / 2;
    int32_t klo = 0, khi = 0;
#pragma unroll
    for (int r = 0; r <= C / 2; ++r) {
      klo = r == lo ? k[r] : klo;
      khi = r == hi ? k[r] : khi;
    }
    res = (from_key(klo) + from_key(khi)) * 0.5f;
  } else {
    // the rank window [trim, n - trim) as a bit mask, one word a 32 ranks
    uint32_t window[(C + 31) / 32];
#pragma unroll
    for (int w = 0; w < (C + 31) / 32; ++w) {
      window[w] = bits_below(n - trim - 32 * w) & ~bits_below(trim - 32 * w);
    }
    float acc = -0.0f;
#pragma unroll
    for (int r = 0; r < C; ++r) {
      if (window[r / 32] & (1u << (r % 32))) acc += from_key(k[r]);
    }
    res = acc / static_cast<float>(n - 2 * trim);
  }
  if (bf16) {
    store1(static_cast<__nv_bfloat16*>(out) + c, res);
  } else {
    store1(static_cast<float*>(out) + c, res);
  }
}

// the smallest size class C >= n of the list (kernels/robust_aggregate.py's
// SIZE_CLASSES mirrors it)
template <int C, int... Larger>
int launch_class(const void* x, void* out, int n, long long m, int trim, int median,
                 int bf16, cudaStream_t stream) {
  if constexpr (sizeof...(Larger) > 0) {
    if (n > C) return launch_class<Larger...>(x, out, n, m, trim, median, bf16, stream);
  }
  const unsigned blocks = static_cast<unsigned>((m + kThreads - 1) / kThreads);
  robust_kernel<C><<<blocks, kThreads, 0, stream>>>(x, out, n, m, trim, median != 0, bf16);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* x, void* out, int n, long long m, int trim, int median, int bf16,
           cudaStream_t stream) {
  if (n < 1 || n > kMaxRows || m < 1 || trim < 0 || 2 * trim >= n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_class<4, 8, 12, 16, 20, 24, 28, 32, 36, 40, 44, 48, 52, 56, 60, 64, 80, 96,
                      112, 128>(x, out, n, m, trim, median, bf16, stream);
}

}  // namespace

extern "C" int robust_aggregate_f32(const float* x, float* out, int n, long long m, int trim,
                                    int median, cudaStream_t stream) {
  return launch(x, out, n, m, trim, median, 0, stream);
}

extern "C" int robust_aggregate_bf16(const void* x, void* out, int n, long long m, int trim,
                                     int median, cudaStream_t stream) {
  return launch(x, out, n, m, trim, median, 1, stream);
}
