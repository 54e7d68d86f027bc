// Hash-join probe for Hopper (sm_90a): the left and right insertion points
// of every probe u64 key fingerprint in the sorted build fingerprints.
//
// Replaces the JAX package's Pallas join probe,
// spark_rapids_tpu/ops/native.py:315 `_probe_kernel_factory` (the kernel
// body) and :354 `searchsorted_u64_pair` (its launcher). There the TPU, which
// has no 64-bit compare, splits each fingerprint into (hi, lo) u32 planes
// and runs a branchless descending-power-of-two search over both planes.
// Here a fingerprint is one unsigned 64-bit load and one unsigned compare;
// the planes are gone.
//
// One thread per probe row. It loads its fingerprint (the int64 bit
// pattern read as `unsigned long long`), then runs two branchless binary
// searches over the sorted build array in device memory:
//   lo = #build <  q   (searchsorted side="left")
//   hi = #build <= q   (searchsorted side="right")
// and writes both as int32. The search halves `n` until one element is
// left, so any build length works (a 3*2^k capacity rung, a build made
// entirely of the 0xFFFF_FFFF_FFFF_FFFF sentinel), and an empty build
// gives 0 and 0. Every compare is unsigned: a fingerprint with its top bit
// set is a negative int64 and must still sort after every smaller u64.
//
// Bound. Bytes: the probe fingerprints in (8 B a row), lo and hi out (8 B a
// row), and the distinct 32-byte build sectors the searches read. The lo
// and hi searches read the same sectors until their last step, and the top
// floor(log2 cap_p) levels of the search tree (about cap_p sectors in all)
// are shared by every probe of a launch, so that is
// 32 B * min(cap_b / 4, cap_p * (ceil(log2 cap_b) - floor(log2 cap_p) + 1)):
// about 2.9 MB for q4's 8,192 probes into 6,291,456 fingerprints. Latency: each search is ceil(log2 cap_b)
// dependent loads, about 2 * 22 per row at cap_b = 4M, so the kernel needs
// many rows in flight to hide them. What the design does about that: the
// TPC-H q4 SF1 build is 6,291,456 fingerprints (48 MiB), about the H100's
// 50 MB L2, so most search steps hit L2 rather than device memory, and the
// first levels of every search read the same few lines, which stay cached
// for all threads; 256-thread blocks over the whole probe keep loads in
// flight. Making it fast (sharing the first steps of the two searches, a
// top-of-tree table in shared memory, sorting the probes) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Number of build entries e with e < q (kUpper false) or e <= q (true):
// a branchless lower/upper bound over a[0, n), n >= 1.
template <bool kUpper>
__device__ __forceinline__ int bound(const unsigned long long* __restrict__ a,
                                     int n, unsigned long long q) {
  int base = 0;
  while (n > 1) {
    const int half = n >> 1;
    const unsigned long long v = __ldg(a + base + half);
    base = (kUpper ? v <= q : v < q) ? base + half : base;
    n -= half;
  }
  const unsigned long long v = __ldg(a + base);
  return base + ((kUpper ? v <= q : v < q) ? 1 : 0);
}

__global__ void join_probe(const unsigned long long* __restrict__ build,
                           int cap_b,
                           const unsigned long long* __restrict__ probe,
                           int cap_p, int* __restrict__ lo,
                           int* __restrict__ hi) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= cap_p) return;
  const unsigned long long q = probe[i];
  if (cap_b == 0) {
    lo[i] = 0;
    hi[i] = 0;
    return;
  }
  lo[i] = bound<false>(build, cap_b, q);
  hi[i] = bound<true>(build, cap_b, q);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched); the wrapper
// reads the message through radix_rank.cu's srt_cuda_error_string. The
// caller guarantees cap_p >= 1 and cap_b, cap_p < 2^31.
int srt_join_probe(const void* build, int cap_b, const void* probe,
                   int cap_p, void* lo, void* hi, void* stream) {
  const int blocks = (cap_p + kThreads - 1) / kThreads;
  join_probe<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(build), cap_b,
      static_cast<const unsigned long long*>(probe), cap_p,
      static_cast<int*>(lo), static_cast<int*>(hi));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
