// Sorted-segment scan (K2) for Hopper (sm_90a): for every row, the running
// reduction of its segment's keys from the segment's first row up to the
// row itself. Segments are the runs of equal group id in a nondecreasing
// (cap,) int64 gid; row 0 always starts one. Kinds: wrap-around sum, and
// unsigned min and max (the total-order bit domain the wrapper encodes
// into), over u32 keys (int32 bit patterns) or u64 keys (int64 patterns).
//
// Replaces the JAX package's Pallas segmented scan,
// spark_rapids_tpu/ops/native.py:489 `_segscan_kernel_factory` (the kernel
// body) and :533 `_segscan` (its launcher), reached from
// `segment_sum_sorted` :665 and `segment_minmax_sorted` :692. There the TPU
// has no 64-bit integers, so a 64-bit key travels as (hi, lo) u32 planes
// with an explicit carry or a lexicographic compare; here it is one
// `unsigned long long`. The Pallas kernel also takes the flags `_flags_of`
// builds from gid; here each row's flag (gid[r] != gid[r - 1]) is computed
// from gid as it is loaded, so no flag array is written or read.
//
// The unordered grid. The Pallas kernel carries the open segment from one
// block to the next in VMEM scratch, which is sound only because a TPU grid
// runs its blocks in order. Blocks on Hopper run in no order, so the scan
// is three launches on one stream:
//   1. tile_scan: one block per 2,048-row tile. The tile is staged in
//      shared memory with coalesced loads; each thread scans its 8
//      consecutive rows sequentially, a warp-shuffle scan and a pass over
//      the 8 warp totals give each thread its exclusive prefix inside the
//      tile, and the rows before a thread's first segment start take that
//      prefix. Writes the tile-local running values, the tile's aggregate
//      (has a start, value since its last start) and the offset of its
//      first segment start.
//   2. carry_scan: one block of 1,024 threads scans the tile aggregates
//      into each tile's exclusive carry (2,048 tiles at 4,194,304 rows).
//   3. fixup: one block per tile after the first combines the carry into
//      the rows before the tile's first segment start; no other row is
//      read or written again.
// Every step combines over the segmented-scan monoid
//   (g1, v1) + (g2, v2) = (g1 | g2, g2 ? v2 : op(v1, v2)),
// which is associative for wrap-around sums and for unsigned min and max,
// so any grouping of rows gives the plain sequential result bit for bit.
// All arithmetic is on unsigned types, where wrap-around is defined.
//
// Bound: bytes. Each row reads its gid (8 B) and key (4 or 8 B) and writes
// its running value (4 or 8 B): 24 B a row for u64 keys, 16 B for u32, at
// 3.35 TB/s. The work is one compare or add a row. Passes 2 and 3 touch a
// few bytes a tile, plus the rows of each tile before its first segment
// start (at most one short run a tile for group-sorted data). A single-pass
// decoupled look-back scan is the faster design, for a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;      // 2,048 rows
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kSum = 0, kMin = 1, kMax = 2 };

template <typename T, int K>
struct Op;

template <typename T>
struct Op<T, kSum> {
  __device__ static T neutral() { return T(0); }
  __device__ static T apply(T a, T b) { return a + b; }
};

template <typename T>
struct Op<T, kMin> {
  __device__ static T neutral() { return ~T(0); }
  __device__ static T apply(T a, T b) { return b < a ? b : a; }
};

template <typename T>
struct Op<T, kMax> {
  __device__ static T neutral() { return T(0); }
  __device__ static T apply(T a, T b) { return b > a ? b : a; }
};

// (g, v) <- (pg, pv) + (g, v): the pair before (g, v) combined into it.
template <typename T, int K>
__device__ __forceinline__ void combine_into(int pg, T pv, int& g, T& v) {
  if (!g) v = Op<T, K>::apply(pv, v);
  g = g | pg;
}

// Exclusive block scan over the monoid: on entry (g, v) is this thread's
// aggregate, on exit the combination of every earlier thread's aggregate
// (g = 0 and the neutral value for thread 0). NT threads, NT / 32 warps.
template <typename T, int K, int NT>
__device__ void block_exclusive(int& g, T& v, int* s_wg, T* s_wv) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int ig = g;
  T iv = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T uv = __shfl_up_sync(kFull, iv, d);
    const int ug = __shfl_up_sync(kFull, ig, d);
    if (lane >= d) combine_into<T, K>(ug, uv, ig, iv);
  }
  T ev = __shfl_up_sync(kFull, iv, 1);
  int eg = __shfl_up_sync(kFull, ig, 1);
  if (lane == 0) {
    ev = Op<T, K>::neutral();
    eg = 0;
  }
  if (lane == 31) {
    s_wg[warp] = ig;
    s_wv[warp] = iv;
  }
  __syncthreads();
  int pg = 0;
  T pv = Op<T, K>::neutral();
  for (int w = 0; w < warp; ++w) {
    int wg = s_wg[w];
    T wv = s_wv[w];
    combine_into<T, K>(pg, pv, wg, wv);
    pg = wg;
    pv = wv;
  }
  combine_into<T, K>(pg, pv, eg, ev);
  g = eg;
  v = ev;
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
tile_scan(const long long* __restrict__ gid, const T* __restrict__ key,
          int n, T* __restrict__ out, T* __restrict__ agg_v,
          int* __restrict__ agg_meta) {
  // Row i of the tile sits at i + i / kItems: one pad slot per thread's
  // run of 8 spreads the per-thread accesses over the banks.
  __shared__ T s_val[kTile + kThreads];
  __shared__ unsigned char s_flag[kTile];
  __shared__ int s_wg[kThreads / 32];
  __shared__ T s_wv[kThreads / 32];
  __shared__ int s_first;
  const int tile = blockIdx.x;
  const long long base = static_cast<long long>(tile) * kTile;
  if (threadIdx.x == 0) s_first = kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long r = base + i;
    T v = Op<T, K>::neutral();
    unsigned char f = 0;
    if (r < n) {
      v = key[r];
      f = (r == 0 || gid[r - 1] != gid[r]) ? 1 : 0;
    }
    s_val[i + i / kItems] = v;
    s_flag[i] = f;
  }
  __syncthreads();

  const int t0 = threadIdx.x * kItems;
  const int p0 = t0 + threadIdx.x;
  int seen = 0;
  int first = kItems;
  T run = Op<T, K>::neutral();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const T v = s_val[p0 + j];
    if (s_flag[t0 + j]) {
      run = v;
      if (!seen) first = j;
      seen = 1;
    } else {
      run = Op<T, K>::apply(run, v);
    }
    s_val[p0 + j] = run;
  }
  if (seen) atomicMin(&s_first, t0 + first);

  int g = seen;
  T pre = run;
  block_exclusive<T, K, kThreads>(g, pre, s_wg, s_wv);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (j < first) s_val[p0 + j] = Op<T, K>::apply(pre, s_val[p0 + j]);
  }
  if (threadIdx.x == kThreads - 1) {
    agg_v[tile] = seen ? run : Op<T, K>::apply(pre, run);
    agg_meta[2 * tile] = g | seen;
  }
  __syncthreads();
  if (threadIdx.x == 0) agg_meta[2 * tile + 1] = s_first;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long r = base + i;
    if (r < n) out[r] = s_val[i + i / kItems];
  }
}

// Tile aggregates -> each tile's exclusive carry, in place in agg_v.
template <typename T, int K>
__global__ void __launch_bounds__(kScanThreads)
carry_scan(T* __restrict__ agg_v, const int* __restrict__ agg_meta,
           int ntiles) {
  __shared__ int s_wg[kScanThreads / 32];
  __shared__ T s_wv[kScanThreads / 32];
  const int per = (ntiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, ntiles);
  const int hi = min(lo + per, ntiles);
  int g = 0;
  T v = Op<T, K>::neutral();
  for (int k = lo; k < hi; ++k) {
    int kg = agg_meta[2 * k];
    T kv = agg_v[k];
    combine_into<T, K>(g, v, kg, kv);
    g = kg;
    v = kv;
  }
  block_exclusive<T, K, kScanThreads>(g, v, s_wg, s_wv);
  for (int k = lo; k < hi; ++k) {
    int kg = agg_meta[2 * k];
    T kv = agg_v[k];
    agg_v[k] = v;
    combine_into<T, K>(g, v, kg, kv);
    g = kg;
    v = kv;
  }
}

// The carry into tile blockIdx.x + 1, combined into its rows before its
// first segment start.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
fixup(const T* __restrict__ carry, const int* __restrict__ agg_meta, int n,
      T* __restrict__ out) {
  const int tile = blockIdx.x + 1;
  const int first = agg_meta[2 * tile + 1];
  const T c = carry[tile];
  const long long base = static_cast<long long>(tile) * kTile;
  for (int i = threadIdx.x; i < first; i += kThreads) {
    const long long r = base + i;
    if (r < n) out[r] = Op<T, K>::apply(c, out[r]);
  }
}

template <typename T, int K>
int run(const void* gid, const void* key, int n, void* out, void* agg_v,
        void* agg_meta, cudaStream_t stream) {
  const int ntiles = (n + kTile - 1) / kTile;
  T* av = static_cast<T*>(agg_v);
  int* am = static_cast<int*>(agg_meta);
  tile_scan<T, K><<<ntiles, kThreads, 0, stream>>>(
      static_cast<const long long*>(gid), static_cast<const T*>(key), n,
      static_cast<T*>(out), av, am);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ntiles == 1) return static_cast<int>(err);
  carry_scan<T, K><<<1, kScanThreads, 0, stream>>>(av, am, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fixup<T, K><<<ntiles - 1, kThreads, 0, stream>>>(av, am, n,
                                                   static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_kind(int kind, const void* gid, const void* key, int n, void* out,
             void* agg_v, void* agg_meta, cudaStream_t stream) {
  switch (kind) {
    case kSum: return run<T, kSum>(gid, key, n, out, agg_v, agg_meta, stream);
    case kMin: return run<T, kMin>(gid, key, n, out, agg_v, agg_meta, stream);
    case kMax: return run<T, kMax>(gid, key, n, out, agg_v, agg_meta, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int srt_seg_scan_tile_rows() { return kTile; }

// gid: (n,) int64, nondecreasing. keys/out: (n,) of key_bytes (4 or 8)
// each. agg_v: ceil(n / tile) 8-byte slots; agg_meta: 2 * ceil(n / tile)
// int32 slots (scratch). kind: 0 sum, 1 min, 2 max. Returns
// cudaGetLastError() after the launches (0 = launched); the wrapper reads
// the message through radix_rank.cu's srt_cuda_error_string. The caller
// guarantees 1 <= n < 2^31.
int srt_seg_scan(const void* gid, const void* keys, int n, int key_bytes,
                 int kind, void* out, void* agg_v, void* agg_meta,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_bytes == 4) {
    return run_kind<unsigned int>(kind, gid, keys, n, out, agg_v, agg_meta,
                                  s);
  }
  if (key_bytes == 8) {
    return run_kind<unsigned long long>(kind, gid, keys, n, out, agg_v,
                                        agg_meta, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
