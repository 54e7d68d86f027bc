// Wire-codec RLE decode for Hopper (sm_90a): a run table expanded to the
// rows of a batch.
//
// Replaces the JAX package's Pallas RLE decode,
// spark_rapids_tpu/ops/native.py:386 `_rle_kernel_factory` (the kernel
// body, :387) and :403 `rle_decode` (its launcher), called from the wire
// decode, spark_rapids_tpu/columnar/wire.py:627-636. There each 512-row
// block builds a (rows x run_cap) interval-membership mask and sums one
// int32 bit plane at a time through it: O(rows x runs) work, which is why
// the reference gates it at 4,096 runs. Here each row finds its run by a
// search, so the work is O(rows + runs) and any run count is right.
//
// Contract (the plain version is ops/native.py `rle_decode_plain`):
// run_vals (run_cap,) of 1, 2, 4 or 8-byte elements, run_ends (run_cap,)
// int32, nondecreasing exclusive run ends. out[r] = run_vals[i] with i the
// first run whose end is above r (clamped to the last run), and 0 for
// r >= num_rows. For a table from the encoder (padding runs carry value 0
// and end cap; a full table ends at num_rows) that is the Pallas kernel's
// interval membership. Values move as raw bytes of their size, so -0.0 and
// NaN payloads are exact without bit planes; the cast to the logical type
// stays a torch op.
//
// Design. A block of 256 threads covers 4,096 rows whatever the element
// size, so its fixed cost (finding and staging its runs, two barriers) is
// paid once per 4,096 rows: at 512 rows a block, f64 ran 8 blocks a row
// range where int8 ran 1 and took twice as long (PERF.md, section 6). Output
// moves in 16-byte chunks of 16 / sizeof(T) consecutive rows; a thread
// writes sizeof(T) chunks, chunk c of thread t at chunk c * 256 + t of the
// block, so each store instruction is coalesced across the warp. The block
// stages the runs its rows fall in into shared memory, then for each chunk
// a thread does one upper-bound binary search there for its first row and
// walks forward for the rest: ends ascend, so the walk is a few compares.
// - A table of at most kSmemRuns runs (q3's o_shippriority: 8 runs, 72
//   bytes) is staged whole by every block with one coalesced read: no
//   block searches device memory.
// - A larger table: two warps find the block's window of runs, the first
//   and the last row's run, each by a 32-lane cooperative search of
//   run_ends in device memory (search.cuh `kary_count`): 4 dependent steps
//   at 917,504 runs instead of 20 for a binary search. A window of at most
//   kSmemRuns runs is staged; a longer one is read from device memory
//   through L1/L2.
//
// Bound. Bytes: the output written once (cap * sizeof(T)) plus the run
// table read once (run_cap * (sizeof(T) + 4)), at 3.35 TB/s; the compares
// are far below the ALU rate. At q3's o_shippriority (196,608 int8 rows,
// an 8-entry run table) that is 196,704 B, 0.06 us: the launch, not the
// bytes, sets the time there. At 4,194,304 rows the 16-byte stores keep
// the write at the memory rate; the staged window keeps the run table's
// reads to about one pass, plus the runs that straddle block edges.

#include <cstdint>
#include <cuda_runtime.h>

#include "search.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlockRows = 4096;             // rows per block, any type
constexpr int kSmemRuns = 2048;              // runs staged per block
// Lanes of each block-window search. search_sweep.py builds the source
// with -DSRT_RLE_WINDOW_LANES=1 (a binary search, one load a step) to time
// the cooperative search against it.
#ifndef SRT_RLE_WINDOW_LANES
#define SRT_RLE_WINDOW_LANES 32
#endif
constexpr int kWindowLanes = SRT_RLE_WINDOW_LANES;

// min(#{j : e[j] <= r}, n - 1) over nondecreasing e[0, n), n >= 1: the
// run of row r, clamped to the last run.
__device__ __forceinline__ int run_of(const int* e, int n, int r) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (e[mid] <= r) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < n - 1 ? lo : n - 1;
}

struct EndsAtMost {
  int r;
  __device__ __forceinline__ bool operator()(int e) const { return e <= r; }
};

// Values staged before ends in shared memory: the ends start at this
// 16-byte aligned offset for `slots` runs.
template <typename T>
__host__ __device__ __forceinline__ size_t ends_offset(int slots) {
  return (static_cast<size_t>(slots) * sizeof(T) + 15) & ~size_t{15};
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rle_decode(const T* __restrict__ vals, const int* __restrict__ ends,
           int run_cap, int cap, int num_rows, T* __restrict__ out,
           int slots, int vec_ok) {
  constexpr int G = 16 / sizeof(T);          // rows per 16-byte chunk
  constexpr int kChunks = kBlockRows / (kThreads * G);   // per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* vals_s = reinterpret_cast<T*>(smem);
  int* ends_s = reinterpret_cast<int*>(smem + ends_offset<T>(slots));
  __shared__ int window[2];

  const int r0 = blockIdx.x * kBlockRows;
  const int r1 = min(r0 + kBlockRows, cap);
  int i0 = 0, w = run_cap;                   // the whole table
  if (run_cap > kSmemRuns) {
    // Warp 0 finds the run of the block's first row, warp 1 its last's.
    if (threadIdx.x < 64) {
      const int r = threadIdx.x < 32 ? r0 : r1 - 1;
      const int c = srt::kary_count<kWindowLanes>(ends, run_cap,
                                                  EndsAtMost{r});
      if ((threadIdx.x & 31) == 0) {
        window[threadIdx.x >> 5] = c < run_cap - 1 ? c : run_cap - 1;
      }
    }
    __syncthreads();
    i0 = window[0];
    w = window[1] - i0 + 1;
  }
  const bool staged = w <= kSmemRuns;
  if (staged) {
    for (int j = threadIdx.x; j < w; j += kThreads) {
      vals_s[j] = vals[i0 + j];
      ends_s[j] = ends[i0 + j];
    }
  }
  __syncthreads();
  const T* v = staged ? vals_s : vals + i0;
  const int* e = staged ? ends_s : ends + i0;

  for (int c = 0; c < kChunks; ++c) {
    const int row = r0 + (c * kThreads + threadIdx.x) * G;
    if (row >= cap) return;                  // rows ascend with c
    int i = run_of(e, w, row);
    union {
      T v[G];
      uint4 q;
    } buf;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int r = row + k;
      while (i < w - 1 && e[i] <= r) ++i;
      buf.v[k] = r < num_rows ? v[i] : T(0);
    }
    if (vec_ok && row + G <= cap) {
      *reinterpret_cast<uint4*>(out + row) = buf.q;
    } else {
      for (int k = 0; k < G && row + k < cap; ++k) out[row + k] = buf.v[k];
    }
  }
}

template <typename T>
cudaError_t launch(const void* vals, const void* ends, int run_cap, int cap,
                   int num_rows, void* out, cudaStream_t stream) {
  const int blocks = (cap + kBlockRows - 1) / kBlockRows;
  // Shared memory for the runs a block stages: the whole table, or a
  // window of at most kSmemRuns.
  const int slots = run_cap < kSmemRuns ? run_cap : kSmemRuns;
  const size_t smem = ends_offset<T>(slots) + slots * sizeof(int);
  const int vec_ok = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  rle_decode<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(vals), static_cast<const int*>(ends), run_cap,
      cap, num_rows, static_cast<T*>(out), slots, vec_ok);
  return cudaGetLastError();
}

static_assert(kBlockRows % (kThreads * 16) == 0,
              "a block's rows are whole chunks for every element size");

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for an element size other than 1, 2, 4 or 8; the
// wrapper reads the message through radix_rank.cu's srt_cuda_error_string.
// The caller guarantees run_cap >= 1, 1 <= cap < 2^30 and
// 0 <= num_rows <= cap.
int srt_rle_decode(const void* vals, const void* ends, int run_cap,
                   int elem_size, int cap, int num_rows, void* out,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 1:
      return static_cast<int>(
          launch<uint8_t>(vals, ends, run_cap, cap, num_rows, out, s));
    case 2:
      return static_cast<int>(
          launch<uint16_t>(vals, ends, run_cap, cap, num_rows, out, s));
    case 4:
      return static_cast<int>(
          launch<uint32_t>(vals, ends, run_cap, cap, num_rows, out, s));
    case 8:
      return static_cast<int>(
          launch<unsigned long long>(vals, ends, run_cap, cap, num_rows,
                                     out, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Runs a table may hold to be staged whole (native.RLE_SMEM_RUNS).
int srt_rle_smem_runs() { return kSmemRuns; }

}  // extern "C"
