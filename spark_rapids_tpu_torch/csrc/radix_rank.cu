// Stable LSD radix sort (K1) for Hopper (sm_90a): the stable argsort of
// (n,) u32 keys, as one call that issues every kernel of the sort.
//
// Replaces the JAX package's Pallas radix rank,
// spark_rapids_tpu/ops/native.py:251-308: `_hist_kernel` (per-block
// 256-bucket histogram), `_rank_kernel` (stable rank = block base +
// within-block one-hot prefix), `_digit_rank` and `stable_argsort_u32`,
// which drive them over 4 digit passes with a permutation scatter between.
//
// Design: onesweep (Adinets and Merrill, 2022). One C entry,
// srt_radix_sort, issues on the caller's stream:
//   1. cudaMemsetAsync of the digit histograms, the tile counters and the
//      look-back status words;
//   2. digit_histograms: one read of the keys (through the optional int64
//      row permutation) builds all four 256-bin digit histograms, in
//      shared memory and then with global atomics. A digit's histogram
//      is the same in every pass (a pass only reorders rows), so the
//      four digit bases are known before the first pass;
//   3. four onesweep_pass launches, one per 8-bit digit, least
//      significant first. A block takes its tile id from an atomic
//      counter, so it only ever waits on tiles that have already started
//      (waiting on blockIdx order can deadlock when the tiles outnumber
//      the resident blocks). It ranks its 4,096 rows in row order:
//      within a warp, __match_any_sync groups lanes by digit and
//      __popc(peers & lanemask_lt) is the rank among earlier lanes, on
//      top of the warp's running count of the digit; per-digit warp
//      counts are then scanned across warps in row order. For each digit
//      the block publishes its tile count as an AGGREGATE, looks back
//      over the predecessors' status words, 8 at a time, until it meets
//      an INCLUSIVE prefix, and publishes its own inclusive prefix. A
//      status word packs the 2-bit status and a 30-bit count, so one
//      relaxed store publishes both (n < 2^30) and no fence is needed.
//      Tile 0 folds the digit's global base into its inclusive prefix, so
//      every exclusive prefix is a global position.
//      The rows are then staged in shared memory in digit order and
//      written out so neighbouring threads write neighbouring positions.
//      Pass 1 reads the caller's keys (int64-carried u32 words or int32
//      bit patterns, through the permutation when given) and makes the
//      row indices itself; pass 4 writes only the indices, or
//      perm[index] as int64.
// Stability: ranks follow row order inside a tile, and prefixes follow
// tile ids, which follow row order; so the permutation is the unique
// stable one, bit-identical to torch.sort(stable=True).
//
// Bound: device-memory bytes. The function reads each key once (4 or 8 B)
// and writes each index once (4 or 8 B). The passes move about 68 B a
// row: the histogram reads the keys, pass 1 reads them again, passes 1-3
// write and passes 2-4 read a u32 key and an int32 index, pass 4 writes
// the index. At the main path's sizes much of it stays in the 50 MB L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRadix = 256;
constexpr int kPasses = 4;
constexpr int kThreads = 256;             // one thread per digit bucket
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                // rows per thread
constexpr int kTile = kThreads * kItems;  // 4,096 rows per block
constexpr int kWarpRows = 32 * kItems;    // a warp's contiguous rows
constexpr int kLookBack = 8;              // status words read at once
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kCountMask = (1u << 30) - 1u;
constexpr unsigned kAggregate = 1u << 30;
constexpr unsigned kInclusive = 2u << 30;
constexpr unsigned kStatusMask = 3u << 30;

// A status word carries its count, so it needs no ordering against other
// memory: relaxed device-scope loads and stores, which skip the L1 cache.
__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// The u32 key of row `row` as pass 1 and the histogram read it: the low
// 32 bits of an int64-carried word or an int32 bit pattern, at perm[row]
// when a permutation is given.
template <bool kKey64, bool kPerm>
__device__ __forceinline__ uint32_t source_key(const void* keys,
                                               const long long* perm,
                                               int row) {
  const long long src = kPerm ? perm[row] : row;
  if (kKey64) {
    return static_cast<uint32_t>(
        static_cast<const unsigned long long*>(keys)[src]);
  }
  return static_cast<const uint32_t*>(keys)[src];
}

// Exclusive sum over the block's 256 threads. Every thread must call it.
__device__ __forceinline__ unsigned block_exclusive_sum(unsigned v,
                                                        unsigned* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  unsigned pre = 0;
  for (int w = 0; w < warp; ++w) pre += s_warp[w];
  __syncthreads();
  return pre + x - v;
}

template <bool kKey64, bool kPerm>
__global__ void __launch_bounds__(kThreads)
digit_histograms(const void* __restrict__ keys,
                 const long long* __restrict__ perm, int n,
                 unsigned* __restrict__ hist) {
  __shared__ unsigned s_hist[kPasses * kRadix];
  for (int i = threadIdx.x; i < kPasses * kRadix; i += kThreads) {
    s_hist[i] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int base = blockIdx.x * kTile; base < n; base += gridDim.x * kTile) {
    uint32_t k[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int row = base + j * kThreads + threadIdx.x;
      k[j] = row < n ? source_key<kKey64, kPerm>(keys, perm, row) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool valid = base + j * kThreads + threadIdx.x < n;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const unsigned d = (k[j] >> (8 * p)) & 0xffu;
        // A warp whose rows share the digit adds once: a digit with one
        // bucket (a 0/1 word's upper bytes) would otherwise put 32
        // atomics on one shared-memory word.
        const unsigned d0 = __shfl_sync(kFull, d, 0);
        if (__all_sync(kFull, valid && d == d0)) {
          if (lane == 0) atomicAdd(&s_hist[p * kRadix + d0], 32u);
        } else if (valid) {
          atomicAdd(&s_hist[p * kRadix + d], 1u);
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kPasses * kRadix; i += kThreads) {
    const unsigned c = s_hist[i];
    if (c) atomicAdd(&hist[i], c);
  }
}

// One digit pass. kFirst: keys come from the caller (kKey64, kPerm) and
// the row indices are made here; kLast: only the indices are written, to
// `out` (int64 perm[index] with kPerm, else int32 index).
template <bool kFirst, bool kLast, bool kKey64, bool kPerm>
__global__ void __launch_bounds__(kThreads)
onesweep_pass(const void* __restrict__ keys_in,
              const long long* __restrict__ perm,
              const int* __restrict__ vals_in, int n, int shift,
              const unsigned* __restrict__ hist,
              unsigned* __restrict__ tile_counter,
              unsigned* __restrict__ status,
              uint32_t* __restrict__ keys_out, int* __restrict__ vals_out,
              void* __restrict__ out) {
  __shared__ uint32_t s_keys[kTile];
  __shared__ int s_vals[kTile];
  __shared__ unsigned s_cnt[kWarps][kRadix];  // counts, then warp offsets
  __shared__ unsigned s_local[kRadix];   // digit's first slot in the tile
  __shared__ unsigned s_global[kRadix];  // digit's first global position
  __shared__ unsigned s_warp[kWarps];
  __shared__ int s_tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(tile_counter, 1u));
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_cnt[w][tid] = 0;
  __syncthreads();
  const int tile = s_tile;
  const int tile_base = tile * kTile;
  const int row0 = tile_base + warp * kWarpRows + lane;

  uint32_t key[kItems];
  int val[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int row = row0 + j * 32;
    key[j] = 0u;
    val[j] = 0;
    if (row < n) {
      if (kFirst) {
        key[j] = source_key<kKey64, kPerm>(keys_in, perm, row);
        val[j] = row;
      } else {
        key[j] = static_cast<const uint32_t*>(keys_in)[row];
        val[j] = vals_in[row];
      }
    }
  }

  // Rank within the warp, rows in order: round j covers rows
  // row0 + 32 j, lane order inside a round.
  const unsigned lt = (1u << lane) - 1u;
  unsigned rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool valid = row0 + j * 32 < n;
    const unsigned d = valid ? (key[j] >> shift) & 0xffu : kRadix;
    const unsigned peers = __match_any_sync(kFull, d);
    unsigned c = 0;
    if (valid) c = s_cnt[warp][d];
    rank[j] = c + __popc(peers & lt);
    __syncwarp();
    if (valid && (peers & lt) == 0) s_cnt[warp][d] = c + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // Thread `tid` owns digit `tid`: warp offsets in row order and the
  // tile's count of the digit.
  const int d = tid;
  unsigned count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = s_cnt[w][d];
    s_cnt[w][d] = count;
    count += c;
  }
  s_local[d] = block_exclusive_sum(count, s_warp);

  // Decoupled look-back over the tiles before this one, kLookBack status
  // words in flight at a time: the words up to the first one not yet
  // published are summed, and the window restarts there.
  unsigned* mine = status + static_cast<long long>(tile) * kRadix + d;
  unsigned excl;
  if (tile == 0) {
    excl = block_exclusive_sum(hist[d], s_warp);   // the digit's base
    st_relaxed(mine, kInclusive | (excl + count));
  } else {
    st_relaxed(mine, kAggregate | count);
    excl = 0;
    int p = tile - 1;
    bool found = false;
    while (!found) {
      unsigned s[kLookBack];
#pragma unroll
      for (int w = 0; w < kLookBack; ++w) {
        // Tile 0 is always inclusive, so no window reads past it.
        s[w] = p - w >= 0 ? ld_relaxed(status +
                                       static_cast<long long>(p - w) * kRadix +
                                       d)
                          : kInclusive;
      }
      int used = 0;
#pragma unroll
      for (int w = 0; w < kLookBack; ++w) {
        if (!found && used == w && (s[w] & kStatusMask) != 0) {
          excl += s[w] & kCountMask;
          found = (s[w] & kInclusive) != 0;
          used = w + 1;
        }
      }
      p -= used;
    }
    st_relaxed(mine, kInclusive | (excl + count));
  }
  s_global[d] = excl;
  __syncthreads();

  // Stage the tile in digit order, then write it out.
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (row0 + j * 32 < n) {
      const unsigned dg = (key[j] >> shift) & 0xffu;
      const unsigned slot = s_local[dg] + s_cnt[warp][dg] + rank[j];
      s_keys[slot] = key[j];
      s_vals[slot] = val[j];
    }
  }
  __syncthreads();
  const int rows = min(kTile, n - tile_base);
  for (int i = tid; i < rows; i += kThreads) {
    const uint32_t k = s_keys[i];
    const unsigned dg = (k >> shift) & 0xffu;
    const unsigned pos = s_global[dg] + (i - s_local[dg]);
    const int v = s_vals[i];
    if (kLast) {
      if (kPerm) {
        static_cast<long long*>(out)[pos] = perm[v];
      } else {
        static_cast<int*>(out)[pos] = v;
      }
    } else {
      keys_out[pos] = k;
      vals_out[pos] = v;
    }
  }
}

int multiprocessors() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0) {
    int c = 0;
    if (cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || c <= 0) {
      return 132;
    }
    count[dev] = c;
  }
  return count[dev];
}

template <bool kKey64, bool kPerm>
int sort(const void* keys, const long long* perm, int n, void* out,
         unsigned* work, cudaStream_t stream) {
  const int ntiles = (n + kTile - 1) / kTile;
  unsigned* hist = work;                          // kPasses x kRadix
  unsigned* counters = hist + kPasses * kRadix;   // kPasses tile counters
  unsigned* status = counters + kPasses;          // kPasses x ntiles x kRadix
  const long long words =
      kPasses * kRadix + kPasses +
      static_cast<long long>(kPasses) * ntiles * kRadix;
  uint32_t* keys_a = status + static_cast<long long>(kPasses) * ntiles * kRadix;
  uint32_t* keys_b = keys_a + n;
  int* vals_a = reinterpret_cast<int*>(keys_b + n);
  int* vals_b = vals_a + n;

  cudaError_t err = cudaMemsetAsync(work, 0, words * sizeof(unsigned), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int most = 2 * multiprocessors();
  const int hist_blocks = ntiles < most ? ntiles : most;
  digit_histograms<kKey64, kPerm><<<hist_blocks, kThreads, 0, stream>>>(
      keys, perm, n, hist);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  onesweep_pass<true, false, kKey64, kPerm><<<ntiles, kThreads, 0, stream>>>(
      keys, perm, nullptr, n, 0, hist, counters, status, keys_a, vals_a,
      nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long stride = static_cast<long long>(ntiles) * kRadix;
  onesweep_pass<false, false, false, false><<<ntiles, kThreads, 0, stream>>>(
      keys_a, nullptr, vals_a, n, 8, hist + kRadix, counters + 1,
      status + stride, keys_b, vals_b, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  onesweep_pass<false, false, false, false><<<ntiles, kThreads, 0, stream>>>(
      keys_b, nullptr, vals_b, n, 16, hist + 2 * kRadix, counters + 2,
      status + 2 * stride, keys_a, vals_a, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  onesweep_pass<false, true, false, kPerm><<<ntiles, kThreads, 0, stream>>>(
      keys_a, perm, vals_a, n, 24, hist + 3 * kRadix, counters + 3,
      status + 3 * stride, nullptr, nullptr, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int srt_radix_tile_rows() { return kTile; }

// keys: (n,) int64-carried u32 words (key_bytes 8; the low 32 bits are
// the key) or int32 bit patterns (key_bytes 4). perm: null, or an (n,)
// int64 row permutation; the sort then orders keys[perm] and `out` gets
// perm[order] as int64, else `out` gets the int32 order. work: the
// workspace of srt_radix_sort_work_words(n) u32 words. Returns the first
// CUDA error of the memset and launches (0 = all issued). The caller
// guarantees 1 <= n < 2^30.
int srt_radix_sort(const void* keys, int key_bytes, const void* perm, int n,
                   void* out, void* work, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* p = static_cast<const long long*>(perm);
  unsigned* w = static_cast<unsigned*>(work);
  if (key_bytes == 8) {
    return p ? sort<true, true>(keys, p, n, out, w, s)
             : sort<true, false>(keys, p, n, out, w, s);
  }
  if (key_bytes == 4) {
    return p ? sort<false, true>(keys, p, n, out, w, s)
             : sort<false, false>(keys, p, n, out, w, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The workspace srt_radix_sort needs for n rows, in u32 words: the
// histograms, tile counters and status words, then two ping-pong pairs
// of (key, index) arrays.
long long srt_radix_sort_work_words(int n) {
  const long long ntiles = (n + kTile - 1) / kTile;
  return kPasses * kRadix + kPasses + kPasses * ntiles * kRadix +
         4LL * n;
}

// The message of a CUDA error code, for every kernel of the port
// (ops/native.py _raise_on).
const char* srt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
