// Hash-join probe for Hopper (sm_90a): the left and right insertion points
// of every probe u64 key fingerprint in the sorted build fingerprints.
//
// Replaces the JAX package's Pallas join probe,
// spark_rapids_tpu/ops/native.py:315 `_probe_kernel_factory` (the kernel
// body) and :354 `searchsorted_u64_pair` (its launcher). There the TPU, which
// has no 64-bit compare, splits each fingerprint into (hi, lo) u32 planes
// and runs a branchless descending-power-of-two search over both planes.
// Here a fingerprint is one unsigned 64-bit load and one unsigned compare;
// the planes are gone. For each probe q:
//   lo = #build <  q   (searchsorted side="left")
//   hi = #build <= q   (searchsorted side="right")
// as int32. Every compare is unsigned: a fingerprint with its top bit set
// is a negative int64 and must still sort after every smaller u64.
//
// What bounds it. Bytes: probes in and lo/hi out (16 B a row) and the
// build sectors the searches touch, a few MB at q4's shape (6,291,456 build
// x 8,192 probe fingerprints; chip_smoke.py `probe_bound`), about 1 us at
// 3.35 TB/s. Below about 100,000 probes the time is the latency of the
// chain of dependent loads each search walks (a binary search is
// ceil(log2 cap_b) of them, and a thread a probe leaves most SMs idle);
// above it, the loads' throughput. A call's host side (the wrapper's
// allocation, checks and launch) costs more than the kernel at q4's shape.
//
// Design (the k-ary search is srt::kary_* in search.cuh), sized by
// measurement on an H100 (PERF.md, section 6):
// - Both bounds from one walk. The lo and hi searches compare the same
//   pivots until their ranges split at the probe's run of equal keys (q4's
//   build has runs of at most 7, so near the last step). Each step loads a
//   pivot once while the ranges agree and once per range after they split.
// - G lanes per probe, k-ary. The G lanes of a probe load G pivots of the
//   range at once, a ballot counts those below q (and at or below q), and
//   the range shrinks by G + 1: ceil(log_{G+1}(cap_b + 1)) dependent steps,
//   6 instead of 23 at q4's build with G = 16. The wrapper picks G per
//   launch (ops/native.py `probe_lanes`): the largest power of two with
//   cap_p * G at most half a wave of resident threads, and one lane where
//   that is below 8. Measured on an H100 from 4,096 to 4M probes, that was
//   the fastest lane count at every size: more lanes add loads and ballot
//   work faster than they cut the chain, and 2 or 4 lanes lose to the
//   binary walk below. Every pivot is an __ldg: staging the top levels in
//   shared memory measured as a tie, as L1 serves their few lines anyway.
// - G = 1 (from 16,897 probes on 132 SMs) is a branchless binary walk:
//   its halving of n does not depend on the data, so both bounds keep one
//   n and share each load until their bases part, and each step is a
//   load, a compare and a select (the k-ary bookkeeping at G = 1 measured
//   slower).
// Exact at every edge: cap_b = 0 gives 0 and 0, any build length (a
// 3 * 2^k rung included: the spans need not be equal), an all-sentinel
// build, probes 0, 2^63 and 2^64 - 1, runs longer than a pivot spacing.

#include <cstdint>
#include <cuda_runtime.h>

#include "search.cuh"

namespace {

using u64 = unsigned long long;
using srt::KaryRange;

constexpr int kThreads = 256;

// G >= 8 lanes a probe: the cooperative k-ary walk. Lanes t*G .. t*G+G-1
// of the grid search probe t; the last warp's lanes past cap_p vote too.
template <int G>
__global__ void __launch_bounds__(kThreads)
probe_kary(const u64* __restrict__ build, int cap_b,
           const u64* __restrict__ probe, int cap_p, int steps,
           int* __restrict__ lo, int* __restrict__ hi) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int i = static_cast<int>(t / G);
  const int j = threadIdx.x & (G - 1);
  const bool live = i < cap_p;
  const u64 q = live ? probe[i] : 0ull;
  KaryRange rl{0, cap_b}, ru{0, cap_b};
  for (int s = 0; s < steps; ++s) {
    const bool okl = srt::kary_live<G>(rl, j);
    const u64 vl = okl ? __ldg(build + srt::kary_pivot<G>(rl, j)) : 0ull;
    bool oku = okl;
    u64 vu = vl;
    if (ru.base != rl.base || ru.m != rl.m) {   // the walks have split
      oku = srt::kary_live<G>(ru, j);
      vu = oku ? __ldg(build + srt::kary_pivot<G>(ru, j)) : 0ull;
    }
    rl = srt::kary_narrow<G>(rl, srt::kary_votes<G>(okl && vl < q));
    ru = srt::kary_narrow<G>(ru, srt::kary_votes<G>(oku && vu <= q));
  }
  if (live && j == 0) {
    lo[i] = rl.base;
    hi[i] = ru.base;
  }
}

// One lane a probe: both bounds in one branchless binary walk over
// a[base, base + n), n halved each step whatever the data.
__global__ void __launch_bounds__(kThreads)
probe_binary(const u64* __restrict__ build, int cap_b,
             const u64* __restrict__ probe, int cap_p,
             int* __restrict__ lo, int* __restrict__ hi) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= cap_p) return;
  const u64 q = probe[i];
  int lo_i = 0, hi_i = 0;
  if (cap_b > 0) {
    int n = cap_b, bl = 0, bu = 0;
    while (n > 1) {
      const int half = n >> 1;
      const u64 vl = __ldg(build + bl + half);
      const u64 vu = bu == bl ? vl : __ldg(build + bu + half);
      bl = vl < q ? bl + half : bl;
      bu = vu <= q ? bu + half : bu;
      n -= half;
    }
    const u64 vl = __ldg(build + bl);
    const u64 vu = bu == bl ? vl : __ldg(build + bu);
    lo_i = bl + (vl < q ? 1 : 0);
    hi_i = bu + (vu <= q ? 1 : 0);
  }
  lo[i] = lo_i;
  hi[i] = hi_i;
}

// G lanes a probe, one grid thread a lane.
template <int G>
cudaError_t launch(const u64* build, int cap_b, const u64* probe, int cap_p,
                   int* lo, int* hi, cudaStream_t stream) {
  const long long threads = static_cast<long long>(cap_p) * G;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  if constexpr (G == 1) {
    probe_binary<<<blocks, kThreads, 0, stream>>>(build, cap_b, probe,
                                                  cap_p, lo, hi);
  } else {
    probe_kary<G><<<blocks, kThreads, 0, stream>>>(
        build, cap_b, probe, cap_p, srt::kary_steps<G>(cap_b), lo, hi);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K3 on `stream` with `lanes` lanes a probe: 1, 8, 16 or 32, the
// counts ops/native.py `probe_lanes` returns. Returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue for another
// lane count; the wrapper reads the message through radix_rank.cu's
// srt_cuda_error_string. The caller guarantees cap_p >= 1 and cap_b,
// cap_p < 2^31.
int srt_join_probe(const void* build, int cap_b, const void* probe,
                   int cap_p, void* lo, void* hi, int lanes, void* stream) {
  const u64* b = static_cast<const u64*>(build);
  const u64* p = static_cast<const u64*>(probe);
  int* l = static_cast<int*>(lo);
  int* h = static_cast<int*>(hi);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1:  return launch<1>(b, cap_b, p, cap_p, l, h, s);
    case 8:  return launch<8>(b, cap_b, p, cap_p, l, h, s);
    case 16: return launch<16>(b, cap_b, p, cap_p, l, h, s);
    case 32: return launch<32>(b, cap_b, p, cap_p, l, h, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
