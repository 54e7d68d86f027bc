// Cooperative k-ary search for Hopper (sm_90a), shared by the join probe
// (join_probe.cu, K3) and the RLE decode (rle_decode.cu, K4).
//
// A search looks for a count c: the number of leading elements of a sorted
// array a[0, n) that satisfy a predicate which holds on a prefix (e < q for
// a lower bound, e <= q for an upper bound). Its state is a range of
// candidates, c in [base, base + m]. A group of G lanes (G a power of two
// dividing the warp) narrows it together: lane j loads pivot j of the
// range, the G loads are independent and in flight at once, one
// __ballot_sync + __popc gives k, the number of pivots below, and the range
// shrinks to the span between pivots k - 1 and k. G pivots cut m + 1
// candidates into G + 1 spans of at most ceil((m + 1) / (G + 1)), so a
// search takes ceil(log_{G+1}(n + 1)) dependent steps instead of
// ceil(log2(n + 1)).
//
// Pivot k of a range (k in [-1, G]) sits at base + floor((k + 1)(m + 1) /
// (G + 1)) - 1 while m >= G: pivot -1 is base - 1 (known below), pivot G is
// base + m (known not below), and the G real pivots are distinct elements
// inside the range. Once m < G, lanes j < m load a[base + j], the other
// lanes take part as "not below", and one step ends the search.
//
// tests/test_torch_probe.py emulates these steps lane by lane.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace srt {

// Candidates of a search: the count lies in [base, base + m].
struct KaryRange {
  int base;
  int m;
};

// Lane j loads a pivot of r (the others take part as "not below").
template <int G>
__host__ __device__ __forceinline__ bool kary_live(KaryRange r, int j) {
  return r.m >= G || j < r.m;
}

// Position of pivot k of r, k in [-1, G]. 32-bit only: (k + 1) (m + 1) is
// split as (k + 1) q + (k + 1) rem with rem < G + 1.
template <int G>
__host__ __device__ __forceinline__ int kary_pivot(KaryRange r, int k) {
  if (r.m >= G) {
    const int q = (r.m + 1) / (G + 1);
    const int rem = (r.m + 1) % (G + 1);
    return r.base + (k + 1) * q + ((k + 1) * rem) / (G + 1) - 1;
  }
  return k < 0 ? r.base - 1 : r.base + (k < r.m ? k : r.m);
}

// The range after k of G pivots were found below: between pivots k - 1
// and k.
template <int G>
__host__ __device__ __forceinline__ KaryRange kary_narrow(KaryRange r,
                                                          int k) {
  const int before = kary_pivot<G>(r, k - 1);
  return KaryRange{before + 1, kary_pivot<G>(r, k) - before - 1};
}

// Steps that take every range of n + 1 candidates down to one.
template <int G>
__host__ __device__ inline int kary_steps(int n) {
  int s = 0;
  for (long long t = static_cast<long long>(n) + 1; t > 1;
       t = (t + G) / (G + 1)) {
    ++s;
  }
  return s;
}

// k from this lane's group's votes: the lanes of a G-lane group are
// consecutive and aligned. Every lane of the warp must call it.
template <int G>
__device__ __forceinline__ int kary_votes(bool below) {
  if constexpr (G == 1) {
    return below ? 1 : 0;
  } else {
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, below);
    if constexpr (G == 32) {
      return __popc(ballot);
    } else {
      const int first = (threadIdx.x & 31) & ~(G - 1);
      return __popc(ballot & (((1u << G) - 1u) << first));
    }
  }
}

// The count of leading elements of a[0, n) for which below(e) holds, by the
// G lanes of each group together (lane j = threadIdx.x % G). Every lane of
// the warp calls it with the same n; each group may search its own
// predicate.
template <int G, typename T, typename Below>
__device__ __forceinline__ int kary_count(const T* __restrict__ a, int n,
                                          Below below) {
  const int j = threadIdx.x & (G - 1);
  KaryRange r{0, n};
  for (int s = kary_steps<G>(n); s > 0; --s) {
    const bool live = kary_live<G>(r, j);
    const bool b = live && below(__ldg(a + kary_pivot<G>(r, j)));
    r = kary_narrow<G>(r, kary_votes<G>(b));
  }
  return r.base;
}

}  // namespace srt
