// Sorted-segment reduce (K2) for Hopper (sm_90a): for nondecreasing
// (n,) int64 group ids, out[g] gets the reduction of the keys of the rows
// with group id g, for 0 <= g < capacity; every other slot keeps the
// kind's identity, and ids at or past capacity are dropped. Segments are
// the runs of equal id; row 0 always starts one. Kinds: wrap-around sum,
// and unsigned min and max (the total-order bit domain the wrapper encodes
// into), over u32 keys (int32 bit patterns) or u64 keys (int64 patterns).
//
// Replaces the JAX package's Pallas segmented scan,
// spark_rapids_tpu/ops/native.py:489 `_segscan_kernel_factory` (the kernel
// body) and :533 `_segscan` (its launcher), together with the finish that
// follows it, `_segment_finish` :645, reached from `segment_sum_sorted`
// :665 and `segment_minmax_sorted` :692. There the TPU has no 64-bit
// integers, so a 64-bit key travels as (hi, lo) u32 planes; here it is one
// `unsigned long long`. The Pallas kernel carries the open segment from
// one block to the next in VMEM scratch, which is sound only because a TPU
// grid runs its blocks in order, and it writes every row's running value
// for the finish to scatter the segments' last rows.
//
// Design: one C entry, srt_seg_reduce, issues one single-pass kernel,
// seg_reduce, on the caller's stream:
//   - A block takes its work (a fill chunk, then a 2,048-row tile) from
//     an atomic counter, not from blockIdx, so it only ever waits on
//     blocks that have already started (2,048 tiles at 4,194,304 rows
//     outnumber the resident blocks; waiting in blockIdx order can
//     deadlock).
//   - The tile is staged in shared memory with coalesced loads; each
//     thread scans its 8 consecutive rows, and a warp-shuffle scan with a
//     pass over the 8 warp totals gives each thread its exclusive prefix
//     inside the tile, over the segmented-scan monoid
//       (g1, v1) + (g2, v2) = (g1 | g2, g2 ? v2 : op(v1, v2)),
//     which is associative for wrap-around sums and for unsigned min and
//     max, so any grouping gives the sequential result bit for bit.
//   - The kernel's first blocks (the lowest ids) fill `out` with the
//     identity, 8,192 slots each, and publish a flag per chunk. The other
//     blocks take the tiles. The last row of each segment writes the
//     segment's reduction to out[gid] with a plain store, once the
//     flags of the chunks holding the tile's ids are up. Exactly one row
//     ends each segment, so each slot gets at most one result, no atomics
//     touch `out`, and the result does not depend on the order the
//     blocks run in. A segment that starts in the tile is complete there;
//     only the tile's first segment, when the tile's first row does not
//     start it, needs the carry from the tiles before.
//   - Look-back: a tile holding a segment start publishes its INCLUSIVE
//     value (the value since its last start) at once; a tile inside one
//     segment publishes its AGGREGATE, then looks back: predecessors'
//     aggregates are combined until the first inclusive value, and the
//     tile then publishes its own inclusive value. The last warp looks
//     back over 32 predecessors at a time (a long segment's tiles all
//     publish aggregates at once). Aggregate and inclusive values sit in
//     separate slots, each written once before its status: the value is
//     stored, then the status with a release store; the reader loads the
//     statuses, fences, then loads the values. A 64-bit value and its
//     status cannot share one word, and without that order a reader could
//     see a stale value now and then on multi-tile shapes.
//   - The scratch (work counter, done counter, chunk flags and status
//     words) lives across calls, one buffer per stream, zeroed once when
//     allocated. The last block to finish (by the done counter, after
//     every other block has finished its look-back) zeroes the flags, the
//     status words and both counters, so the next call on the stream
//     starts clean without a memset or a fill launch (a cudaMemsetAsync
//     a call measured about 0.01 ms slower a call at TPC-H q2's largest
//     launch on an H100).
// No per-row running value is written.
//
// Bound: bytes. Each row's gid (8 B) and key (4 or 8 B) are read once and
// each of the `capacity` slots is written once: n (8 + kb) + capacity kb
// bytes at 3.35 TB/s. The work is one compare or add a row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;      // 2,048 rows
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kAggregate = 1u;
constexpr unsigned kInclusive = 2u;

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

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// (g, v) <- (pg, pv) + (g, v): the pair before (g, v) combined into it.
template <typename T, int K>
__device__ __forceinline__ void combine_into(int pg, T pv, int& g, T& v) {
  if (!g) v = Op<T, K>::apply(pv, v);
  g = g | pg;
}

// Exclusive block scan over the monoid: on entry (g, v) is this thread's
// aggregate, on exit the combination of every earlier thread's aggregate
// (g = 0 and the neutral value for thread 0).
template <typename T, int K>
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

// Shared-memory slot of tile row i: one pad slot per thread's run of 8
// spreads the per-thread accesses over the banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 3); }

constexpr int kChunk = 8192;           // slots a fill block writes

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
seg_reduce(const long long* __restrict__ gid, const T* __restrict__ key,
           int n, long long capacity, T identity, T* __restrict__ out,
           int nchunks, unsigned* __restrict__ counters,
           unsigned* __restrict__ flags, unsigned long long* __restrict__ agg_v,
           unsigned long long* __restrict__ incl_v) {
  __shared__ T s_val[kTile + kThreads];
  // s_gid[pad(i + 1)] holds row base + i; slots 0 and kTile + 1 the rows
  // just before and after the tile.
  __shared__ long long s_gid[kTile + 2 + (kTile + 2) / 8 + 1];
  __shared__ int s_wg[kWarps];
  __shared__ T s_wv[kWarps];
  __shared__ int s_work;
  __shared__ int s_last;
  __shared__ T s_carry;
  const int tid = threadIdx.x;
  if (tid == 0) s_work = static_cast<int>(atomicAdd(&counters[0], 1u));
  __syncthreads();
  const int work = s_work;
  // flags[0, nchunks): fill chunks done; flags[nchunks + t]: tile t's
  // look-back status.
  unsigned* status = flags + nchunks;

  if (work < nchunks) {
    const long long lo = static_cast<long long>(work) * kChunk;
    const long long hi = lo + kChunk < capacity ? lo + kChunk : capacity;
    for (long long i = lo + tid; i < hi; i += kThreads) out[i] = identity;
    __threadfence();
    __syncthreads();
    if (tid == 0) st_release(&flags[work], 1u);
  } else {
    const int tile = work - nchunks;
    const long long base = static_cast<long long>(tile) * kTile;
    for (int i = tid; i < kTile; i += kThreads) {
      const long long r = base + i;
      T v = Op<T, K>::neutral();
      long long g = 0;
      if (r < n) {
        v = key[r];
        g = gid[r];
      }
      s_val[pad(i)] = v;
      s_gid[pad(i + 1)] = g;
    }
    if (tid == 0) s_gid[0] = base > 0 ? gid[base - 1] : 0;
    if (tid == 1) {
      s_gid[pad(kTile + 1)] = base + kTile < n ? gid[base + kTile] : 0;
    }
    __syncthreads();
    // Wait until the chunks holding this tile's ids [first, last] (those
    // inside [0, capacity)) are filled: results go on top of the fill.
    if (tid == 0) {
      const int rows = n - base < kTile ? static_cast<int>(n - base) : kTile;
      long long first = s_gid[pad(1)];
      long long last = s_gid[pad(rows)];
      first = first < 0 ? 0 : first;
      last = last < capacity ? last : capacity - 1;
      for (long long c = first / kChunk; first <= last && c <= last / kChunk;
           ++c) {
        while (ld_acquire(&flags[c]) == 0) {
        }
      }
    }
    __syncthreads();

    // This thread's 8 rows: run = value since the last start at or before
    // the row. An end row whose segment started at or after the thread's
    // first row writes now; the thread's first segment, when it started
    // before the thread's first row, waits for the prefix (at most one
    // such end row a thread).
    const int t0 = tid * kItems;
    int seen = 0;
    T run = Op<T, K>::neutral();
    int open_end = -1;
    T open_run = run;
    long long g_prev = s_gid[pad(t0)];
    long long g_cur = s_gid[pad(t0 + 1)];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = t0 + j;
      const long long r = base + i;
      const long long g_next = s_gid[pad(i + 2)];
      if (r < n) {
        const T v = s_val[pad(i)];
        if (r == 0 || g_prev != g_cur) {
          run = v;
          seen = 1;
        } else {
          run = Op<T, K>::apply(run, v);
        }
        if (r == n - 1 || g_next != g_cur) {
          if (seen) {
            if (static_cast<unsigned long long>(g_cur) <
                static_cast<unsigned long long>(capacity)) {
              out[g_cur] = run;
            }
          } else {
            open_end = i;
            open_run = run;
          }
        }
      }
      g_prev = g_cur;
      g_cur = g_next;
    }

    int g = seen;
    T pre = run;
    block_exclusive<T, K>(g, pre, s_wg, s_wv);
    // A segment that began earlier in the tile: its prefix is in the tile.
    if (open_end >= 0 && g) {
      const long long og = s_gid[pad(open_end + 1)];
      if (static_cast<unsigned long long>(og) <
          static_cast<unsigned long long>(capacity)) {
        out[og] = Op<T, K>::apply(pre, open_run);
      }
    }
    // The tile's first row continues a segment from the tiles before.
    const bool need_carry = base > 0 && s_gid[0] == s_gid[pad(1)];
    int tile_g = 0;
    T tile_v = Op<T, K>::neutral();
    if (tid == kThreads - 1) {
      tile_g = g | seen;
      tile_v = seen ? run : Op<T, K>::apply(pre, run);
      if (tile_g) {
        st_relaxed(&incl_v[tile], static_cast<unsigned long long>(tile_v));
        st_release(&status[tile], kInclusive);
      } else {
        st_relaxed(&agg_v[tile], static_cast<unsigned long long>(tile_v));
        st_release(&status[tile], kAggregate);
      }
    }
    if (need_carry && tid >= kThreads - 32) {
      // The last warp looks back over 32 predecessors at a time: lane l
      // reads the status of tile p - l; the lanes before the first one
      // not yet published (and up to the first inclusive one) are
      // combined, and the window moves on. The fence after the status
      // loads orders the value loads after them.
      const int lane = tid & 31;
      T acc = Op<T, K>::neutral();
      int p = tile - 1;
      while (true) {
        const int q = p - lane;
        // Tile 0 is always inclusive, so no window reads past it.
        const unsigned s = q >= 0 ? ld_relaxed(&status[q]) : kInclusive;
        const unsigned unpublished = __ballot_sync(kFull, s == 0);
        const unsigned inclusive = __ballot_sync(kFull, s == kInclusive);
        const int first_unpub = unpublished ? __ffs(unpublished) - 1 : 32;
        const int first_incl = inclusive ? __ffs(inclusive) - 1 : 32;
        const bool done = first_incl < first_unpub;
        const int take = done ? first_incl + 1 : first_unpub;
        __threadfence();
        T v = Op<T, K>::neutral();
        if (lane < take) {
          v = static_cast<T>(ld_relaxed(s == kInclusive ? &incl_v[q]
                                                         : &agg_v[q]));
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          v = Op<T, K>::apply(v, __shfl_xor_sync(kFull, v, o));
        }
        acc = Op<T, K>::apply(v, acc);
        if (done) break;
        p -= take;
      }
      if (tid == kThreads - 1) {
        s_carry = acc;
        if (!tile_g) {
          st_relaxed(&incl_v[tile], static_cast<unsigned long long>(
                                        Op<T, K>::apply(acc, tile_v)));
          st_release(&status[tile], kInclusive);
        }
      }
    }
    __syncthreads();
    if (need_carry && open_end >= 0 && !g) {
      const long long og = s_gid[pad(open_end + 1)];
      if (static_cast<unsigned long long>(og) <
          static_cast<unsigned long long>(capacity)) {
        out[og] = Op<T, K>::apply(Op<T, K>::apply(s_carry, pre), open_run);
      }
    }
  }

  // The last block to finish resets the scratch for the next call: every
  // other block has finished its waits and look-back before it counted
  // itself done.
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(&counters[1], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    for (int i = tid; i < static_cast<int>(gridDim.x); i += kThreads) {
      flags[i] = 0;
    }
    if (tid == 0) {
      counters[0] = 0;
      counters[1] = 0;
    }
  }
}

// Scratch layout for up to `max_blocks` blocks (fill chunks + tiles), in
// u32 words: the work and done counters, one flag or status word a block
// (all zero between calls), then a tile's aggregate and inclusive values
// (8 B each, not reset).
long long scratch_words(long long max_blocks) {
  return ((2 + max_blocks + 1) / 2) * 2 + 4 * max_blocks;
}

template <typename T, int K>
int run(const void* gid, const void* key, int n, long long capacity,
        void* out, unsigned long long identity, void* scratch,
        long long max_blocks, cudaStream_t stream) {
  const int ntiles = (n + kTile - 1) / kTile;
  const int nchunks = static_cast<int>((capacity + kChunk - 1) / kChunk);
  if (ntiles + static_cast<long long>(nchunks) > max_blocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned* counters = static_cast<unsigned*>(scratch);
  unsigned* flags = counters + 2;
  unsigned long long* agg_v = reinterpret_cast<unsigned long long*>(
      counters + ((2 + max_blocks + 1) / 2) * 2);
  unsigned long long* incl_v = agg_v + max_blocks;
  seg_reduce<T, K><<<ntiles + nchunks, kThreads, 0, stream>>>(
      static_cast<const long long*>(gid), static_cast<const T*>(key), n,
      capacity, static_cast<T>(identity), static_cast<T*>(out), nchunks,
      counters, flags, agg_v, incl_v);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_kind(int kind, const void* gid, const void* key, int n,
             long long capacity, void* out, unsigned long long identity,
             void* scratch, long long max_blocks, cudaStream_t stream) {
  switch (kind) {
    case kSum:
      return run<T, kSum>(gid, key, n, capacity, out, identity, scratch,
                          max_blocks, stream);
    case kMin:
      return run<T, kMin>(gid, key, n, capacity, out, identity, scratch,
                          max_blocks, stream);
    case kMax:
      return run<T, kMax>(gid, key, n, capacity, out, identity, scratch,
                          max_blocks, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int srt_seg_reduce_tile_rows() { return kTile; }

int srt_seg_reduce_chunk_slots() { return kChunk; }

// The scratch srt_seg_reduce needs for up to `max_blocks` blocks (fill
// chunks of 8,192 slots + tiles of 2,048 rows), in u32 words; it must be
// zero when first used, and each call leaves it so.
long long srt_seg_reduce_scratch_words(long long max_blocks) {
  return scratch_words(max_blocks);
}

// gid: (n,) int64, nondecreasing. keys: (n,) of key_bytes (4 or 8) each.
// out: (capacity,) of key_bytes each; every slot is written: a group's
// reduction at its id, `identity` (the low key_bytes of the bit pattern)
// where no row has that id. Ids outside [0, capacity) are dropped.
// scratch: srt_seg_reduce_scratch_words(max_blocks) words, used by one
// stream only (calls on it run one after another). kind: 0 sum, 1 min,
// 2 max. Returns the launch's CUDA error (0 = issued); the wrapper reads
// the message through radix_rank.cu's srt_cuda_error_string. The caller
// guarantees 1 <= n < 2^31 and ceil(n / tile) + ceil(capacity / chunk)
// <= max_blocks.
int srt_seg_reduce(const void* gid, const void* keys, int n, int key_bytes,
                   int kind, long long capacity, void* out,
                   unsigned long long identity, void* scratch,
                   long long max_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_bytes == 4) {
    return run_kind<unsigned int>(kind, gid, keys, n, capacity, out,
                                  identity, scratch, max_blocks, s);
  }
  if (key_bytes == 8) {
    return run_kind<unsigned long long>(kind, gid, keys, n, capacity, out,
                                        identity, scratch, max_blocks, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
