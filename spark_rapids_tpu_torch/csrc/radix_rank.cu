// Stable LSD radix rank for Hopper (sm_90a): one 8-bit digit pass of a
// stable argsort over (n,) u32 keys.
//
// Replaces the JAX package's Pallas radix rank,
// spark_rapids_tpu/ops/native.py:251-308: `_hist_kernel` (per-block
// 256-bucket histogram), `_rank_kernel` (stable rank = block base +
// within-block one-hot prefix) and the jnp permutation scatter
// `.at[rank].set(cur)` that `stable_argsort_u32` runs after them.
//
// One digit pass is two launches with a torch exclusive scan between them:
//   digit_hist    : each block takes a TILE of rows and builds a 256-bin
//                   histogram with shared-memory atomics, written
//                   digit-major as hist[digit * ntiles + tile], so one
//                   exclusive scan of the flat table gives every
//                   (digit, tile) its global output offset.
//   (torch cumsum): offsets = exclusive scan of hist.
//   digit_scatter : stable rank within the tile, fused with the scatter.
//                   Rows go in 256-row rounds, in row order. Within a warp
//                   __match_any_sync groups lanes by digit and
//                   __popc(peers & lanemask_lt) is the rank among earlier
//                   lanes; each warp's per-digit count goes to shared
//                   memory and one thread per digit prefix-sums them across
//                   warps (in row order) onto the tile's running base. The
//                   key and its row index are then written to
//                   out[offset[digit][tile] + rank].
//
// Keys travel with the permutation (keys_out/vals_out), so the next pass
// reads its digits sequentially instead of gathering keys through the
// permutation as the Pallas version does (`jnp.take(keyed, cur)`).
//
// Bound: device-memory bytes. Per pass and row: keys read by the histogram
// (4 B), keys and row indices read by the scatter (8 B), keys and row
// indices written (8 B): about 20 B per row per pass, 80 B per row for the
// 4 passes, plus 2 KiB of histogram/offset table per 4096-row tile. The
// design keeps every access but the final scatter coalesced; the scatter
// writes are grouped by digit within a round, so each warp's stores land
// in at most 32 runs. Making it fast (onesweep / decoupled look-back,
// fewer passes for narrow keys) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRadix = 256;
constexpr int kThreads = 256;             // one thread per digit bucket
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;               // rows per block (16 rounds)

__global__ void digit_hist(const uint32_t* __restrict__ keys, int n,
                           int shift, int ntiles, int* __restrict__ hist) {
  __shared__ int s_hist[kRadix];
  s_hist[threadIdx.x] = 0;
  __syncthreads();
  const int start = blockIdx.x * kTile;
  const int end = min(start + kTile, n);
  for (int i = start + threadIdx.x; i < end; i += kThreads) {
    atomicAdd(&s_hist[(keys[i] >> shift) & 0xFFu], 1);
  }
  __syncthreads();
  hist[threadIdx.x * ntiles + blockIdx.x] = s_hist[threadIdx.x];
}

__global__ void digit_scatter(const uint32_t* __restrict__ keys_in,
                              const int32_t* __restrict__ vals_in, int n,
                              int shift, int ntiles,
                              const int* __restrict__ offsets,
                              uint32_t* __restrict__ keys_out,
                              int32_t* __restrict__ vals_out) {
  __shared__ int s_cnt[kWarps][kRadix];
  __shared__ int s_run[kRadix];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  s_run[tid] = offsets[tid * ntiles + blockIdx.x];
  const int start = blockIdx.x * kTile;
  const int end = min(start + kTile, n);
  for (int base = start; base < end; base += kThreads) {
    for (int w = 0; w < kWarps; ++w) s_cnt[w][tid] = 0;
    __syncthreads();
    const int i = base + tid;
    const bool valid = i < end;
    const uint32_t k = valid ? keys_in[i] : 0u;
    // Lanes past the end share the out-of-range digit kRadix and write
    // nothing.
    const int d = valid ? static_cast<int>((k >> shift) & 0xFFu) : kRadix;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    const int rank = __popc(peers & lt_mask);
    if (valid && rank == 0) s_cnt[warp][d] = __popc(peers);
    __syncthreads();
    // Thread `tid` owns digit `tid`: exclusive scan over warps in row
    // order, on top of the tile's running offset for that digit.
    int run = s_run[tid];
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_cnt[w][tid];
      s_cnt[w][tid] = run;
      run += c;
    }
    s_run[tid] = run;
    __syncthreads();
    if (valid) {
      const int pos = s_cnt[warp][d] + rank;
      keys_out[pos] = k;
      vals_out[pos] = vals_in[i];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int srt_radix_tile_rows() { return kTile; }

// Each launcher returns cudaGetLastError() after the launch (0 = launched).
int srt_digit_hist(const void* keys, int n, int shift, int ntiles,
                   void* hist, void* stream) {
  digit_hist<<<ntiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), n, shift, ntiles,
      static_cast<int*>(hist));
  return static_cast<int>(cudaGetLastError());
}

int srt_digit_scatter(const void* keys_in, const void* vals_in, int n,
                      int shift, int ntiles, const void* offsets,
                      void* keys_out, void* vals_out, void* stream) {
  digit_scatter<<<ntiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys_in),
      static_cast<const int32_t*>(vals_in), n, shift, ntiles,
      static_cast<const int*>(offsets), static_cast<uint32_t*>(keys_out),
      static_cast<int32_t*>(vals_out));
  return static_cast<int>(cudaGetLastError());
}

// The message of a CUDA error code, for every kernel of the port
// (ops/native.py _raise_on).
const char* srt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
