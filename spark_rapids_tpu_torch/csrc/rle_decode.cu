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
// Design. One thread owns 16 bytes of output: 16 / sizeof(T) consecutive
// rows, stored with one 16-byte write (coalesced across the warp). A block
// of 256 threads covers 4,096 bytes of output. Two warps find the window
// of runs the block's rows fall in (one binary search of run_ends in
// device memory each, for the block's first and last row); when the
// window holds at most kSmemRuns runs the block stages it in shared
// memory, else the searches read device memory through L1/L2. Each thread then does one upper-bound binary search for
// its first row over the window and walks forward for the rest: ends
// ascend, so the walk is a few compares.
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

namespace {

constexpr int kThreads = 256;
constexpr int kBlockBytes = kThreads * 16;   // output bytes per block
constexpr int kSmemRuns = 2048;              // runs staged per block

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
rle_decode(const T* __restrict__ vals, const int* __restrict__ ends,
           int run_cap, int cap, int num_rows, T* __restrict__ out,
           int vec_ok) {
  constexpr int G = 16 / sizeof(T);          // rows per thread
  constexpr int kBlockRows = kThreads * G;
  extern __shared__ __align__(16) unsigned char smem[];
  T* vals_s = reinterpret_cast<T*>(smem);
  int* ends_s = reinterpret_cast<int*>(smem + kSmemRuns * sizeof(T));
  __shared__ int window[2];

  const int r0 = blockIdx.x * kBlockRows;
  const int r1 = min(r0 + kBlockRows, cap);
  // The window's two searches run in two warps, side by side.
  if (threadIdx.x == 0) window[0] = run_of(ends, run_cap, r0);
  if (threadIdx.x == 32) window[1] = run_of(ends, run_cap, r1 - 1);
  __syncthreads();
  const int i0 = window[0];
  const int w = window[1] - i0 + 1;
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

  const int row = r0 + threadIdx.x * G;
  if (row >= cap) return;
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

template <typename T>
cudaError_t launch(const void* vals, const void* ends, int run_cap, int cap,
                   int num_rows, void* out, cudaStream_t stream) {
  const int blocks = (cap + kThreads * (16 / (int)sizeof(T)) - 1) /
                     (kThreads * (16 / (int)sizeof(T)));
  const size_t smem = kSmemRuns * (sizeof(T) + sizeof(int));
  const int vec_ok = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  rle_decode<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(vals), static_cast<const int*>(ends), run_cap,
      cap, num_rows, static_cast<T*>(out), vec_ok);
  return cudaGetLastError();
}

static_assert(kBlockBytes == 4096, "one block writes 4 KiB of output");

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

}  // extern "C"
