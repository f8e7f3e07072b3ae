// K8: aligned bases per genome bin, for sm_90a.  Replaces _bin_kernel
// (coral_tpu/ops/pallas_kernels.py:541).
//
// For reads [s, e) (int32) and n_bins uniform, contiguous bins
// [origin + b * bin_size, origin + (b + 1) * bin_size):
//   out[b] = sum over reads of max(min(e, hi_b) - max(s, lo_b), 0).
// The TPU kernel tests every read against every bin, because its vector
// unit has no scatter.  Here a thread takes one read, finds its first bin
// with one division and walks only the bins the read touches, adding each
// overlap with an atomic: into per-block shared-memory bins (64-bit,
// flushed once per block with one global atomic per non-zero bin) while
// the bins fit there, else straight into the output.  Integer adds
// commute, so the totals are exact and the same on every run.  A read
// with e <= s (a pad, or an empty read) adds nothing; a read that starts
// before `origin` or ends past the last edge is clipped.
//
// Edges and sums are int64: the TPU kernel casts the edges to int32 and
// sums in int32, so this kernel equals it wherever neither wraps.
//
// What bounds it: 8 B read per read against 3.35 TB/s when a read touches
// one or two bins; the walk (about 10 integer operations a touched bin)
// and the atomics when bins are much shorter than reads.

#include "pair_common.cuh"

namespace {

using coral::grid_for;
using coral::kThreads;

// a block counts into shared memory up to this many bins (32 KB)
constexpr int kSharedBins = 4096;

typedef unsigned long long u64;

// `narrow`: origin-relative coordinates of the binned range fit 32 bits,
// so the one division per read is a 32-bit one.
__global__ void __launch_bounds__(kThreads)
bin_overlap_kernel(const int32_t* __restrict__ starts,
                   const int32_t* __restrict__ ends, int64_t n,
                   int64_t origin, int64_t bin_size, int32_t n_bins,
                   int narrow, u64* __restrict__ out) {
  extern __shared__ u64 acc[];
  const bool shared_bins = n_bins <= kSharedBins;
  u64* bins = shared_bins ? acc : out;
  if (shared_bins) {
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x) acc[b] = 0;
    __syncthreads();
  }
  const int64_t last_edge = origin + bin_size * n_bins;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int64_t s = starts[i];
    const int64_t e = ends[i];
    const int64_t lo = s > origin ? s : origin;
    const int64_t hi = e < last_edge ? e : last_edge;
    if (hi <= lo) continue;
    const u64 off = static_cast<u64>(lo - origin);
    int64_t b = narrow ? static_cast<int64_t>(static_cast<uint32_t>(off) /
                                              static_cast<uint32_t>(bin_size))
                       : static_cast<int64_t>(off / static_cast<u64>(bin_size));
    int64_t edge = origin + b * bin_size;   // the bin's lower edge, <= lo
    int64_t from = lo;
    while (from < hi) {
      edge += bin_size;
      const int64_t to = hi < edge ? hi : edge;
      atomicAdd(&bins[b], static_cast<u64>(to - from));
      from = to;
      ++b;
    }
  }
  if (shared_bins) {
    __syncthreads();
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
      const u64 c = acc[b];
      if (c) atomicAdd(&out[b], c);
    }
  }
}

}  // namespace

extern "C" {

// Launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (0 when the launch was accepted).  `out` holds
// n_bins 64-bit sums and is zeroed by the caller.
int coral_bin_overlap(const void* starts, const void* ends, void* out,
                      long long n, long long origin, long long bin_size,
                      int n_bins, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      n_bins <= kSharedBins ? static_cast<size_t>(n_bins) * sizeof(u64) : 0;
  const int narrow = bin_size < (1LL << 32) / n_bins;
  bin_overlap_kernel<<<grid_for(n, device, 8), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
      n, origin, bin_size, n_bins, narrow, static_cast<u64*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
