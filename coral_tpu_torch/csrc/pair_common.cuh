// Shared by the kernels (pair2.cu, pair3.cu, pair6.cu, bins.cu, match.cu):
// the junction decision chain, evaluated exactly as the TPU kernels
// evaluate it, the warp-aggregated histogram steps, and the launch helpers.
//
// The decision (coral_tpu_torch/ops/scoring.py, pair_predicate):
//   hit = qgap + cutoff >= 0 && gate
//         && (strand_diff || |qgap - grr| > max(gap, 0.2 * |qgap|))
// where `gate` is everything the layout resolves before this point (the
// shared interval, the MAPQ gate) and `grr` the same-strand reference
// jump.  int32 arithmetic wraps (done here through uint32, so no signed
// overflow is relied on), and the threshold is float32: under JAX's
// promotion int32 * 0.2 is float32, and the int32 side of the comparison
// converts to float32.  The host numpy engine works in int64/float64; the
// two agree wherever |qgap| < 2^24, which covers every read length.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace coral {

constexpr int kThreads = 256;

// a - b of two int32, wrapping
__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

// |x| of an int32 wraps at INT32_MIN, as jnp.abs and torch.abs do
__device__ __forceinline__ int32_t wrap_abs(int32_t x) {
  const uint32_t u = static_cast<uint32_t>(x);
  return static_cast<int32_t>(x < 0 ? 0u - u : u);
}

__device__ __forceinline__ bool junction_hit(int32_t qgap, int32_t grr,
                                             bool strand_diff, bool gate,
                                             int32_t cutoff, float gap) {
  const int32_t qc = static_cast<int32_t>(static_cast<uint32_t>(qgap) +
                                          static_cast<uint32_t>(cutoff));
  const int32_t ad = wrap_abs(wrap_sub(qgap, grr));
  const float thr = fmaxf(gap, __fmul_rn(__int2float_rn(wrap_abs(qgap)), 0.2f));
  return qc >= 0 && gate && (strand_diff || __int2float_rn(ad) > thr);
}

// One histogram step of a whole warp: every lane brings a bin (any value
// outside 0..bins-1 counts nothing), and each distinct bin of the warp
// is added once, by its lowest lane: add(bin, number of lanes).  All 32
// lanes must call it together.
template <typename Add>
__device__ __forceinline__ void warp_count_with(int32_t bin, uint32_t bins,
                                                Add add) {
  const int32_t b = static_cast<uint32_t>(bin) < bins ? bin : -1;
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, b);
  if (b >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
    add(b, __popc(peers));
  }
}

// K4's histogram step, with warp_count_with's contract.  When every lane
// that has a bin has the same one, as neighbouring pairs mostly do (pairs
// come in BAM order, and the hits of a stretch of the genome share an
// interval), the first of them adds their number after two ballots and a
// shuffle; otherwise warp_count_with groups the lanes by bin
// (__match_any_sync, which costs more).  A warp without a bin returns
// after one ballot.  (K2 and K6 take none: the note on the support
// kernels below says why.)
template <typename Add>
__device__ __forceinline__ void count_step(int32_t bin, uint32_t bins,
                                           Add add) {
  const int32_t b = static_cast<uint32_t>(bin) < bins ? bin : -1;
  const unsigned has = __ballot_sync(0xFFFFFFFFu, b >= 0);
  if (has == 0) return;
  const int first = __ffs(has) - 1;
  const int32_t b_first = __shfl_sync(0xFFFFFFFFu, b, first);
  if (__ballot_sync(0xFFFFFFFFu, b == b_first) == has) {
    if ((threadIdx.x & 31) == first) add(b_first, __popc(has));
    return;
  }
  warp_count_with(b, bins, add);
}

// -- the support kernels of the resolved layouts (K2, K6) ----------------
//
// A resolved layout (v3: K2, v2: K6) gives every pair its interval gate
// at pack time, so a support kernel streams its columns, decides each
// pair and counts the hit under its gate index: a histogram of at most
// kSupportBins bins (the gate has 13 bits).  What bounds it is the stream,
// 12 or 16 B a pair against 3.35 TB/s.  Each block counts in shared
// memory, one atomic per hit by its own lane, and adds its non-zero bins
// into `out` at the end; the C entry zeroes `out` first with a memset on
// the same stream.
//
// What chose this, on an NVIDIA H100 80GB HBM3 at 700 W
// (coral_tpu_torch/tools/kernel_ab.py: profiler device us with a warm L2,
// and CUDA-event ms after an L2 flush; K2 over 2^21 dense pairs at 16
// bins unless named):
// - the output: the memset costs 0.74 us of device time beside a 5.8 us
//   kernel, where a fill kernel cost 1.0 us and a launch.  The other way
//   to zero it in one launch, a workspace kept per stream that every
//   block adds into and the last block to take a ticket sums into `out`
//   and zeroes again, cost 1.3 us more than the memset at 16 bins and 14
//   us more at 8,190 (a fence, a ticket and one block's pass over the
//   workspace, all after the stream).  A block that zeroes `out` first
//   and publishes a generation that the others wait for before adding
//   was 0.5-1.0 us faster than the memset in event time at 16 bins and
//   slower at 8,190; and a generation passed from the host is frozen into
//   a captured CUDA graph, whose replays would add into an output nobody
//   zeroed.
// - the warp step: none.  With one shared-memory atomic per hit by its
//   own lane K2 took 6.7 us, and 6.8 when every hit fell on one bin: 32
//   lanes on one word queue no longer than on 32 words, so a warp step
//   has nothing to save.  With K4's step (coral::count_step) K2 took
//   11.0 us, and 8.2 on one bin; K6 with __match_any_sync in every step
//   10.1 us, without 7.5.
// - the loads: one int4 of each column a step.  Two or four a step in
//   flight before any decision, with the grid cut to one wave, were up
//   to 25 % slower and never more than 1 % faster; a ring of 8
//   shared-memory stages fed by TMA bulk copies (cp.async.bulk with an
//   mbarrier a stage, one or two persistent blocks an SM) was 1.15-1.32x
//   slower in event time and 1.6-2.9x in device time.
// - the grid: 4 blocks an SM, 2 above kWideBins.  A grid of one wave by
//   the occupancy query (5 to 8 blocks an SM) was no faster at 16 bins
//   and 1.2x slower at 8,190, where a block's own cost (n_int bins
//   zeroed, read and added into `out`) rules: with 2 blocks an SM K2
//   takes 14.3 us there against 19.2 with 4, memset included.  2 blocks
//   beat 4 at 1,024 bins (0.0222 against 0.0232 ms) and lost at 16
//   (0.0213 against 0.0194).
constexpr int kSupportBins = 8190;
constexpr int kSupportBlocksPerSm = 4;
constexpr int kWideBins = 256;
constexpr int kWideBlocksPerSm = 2;

template <int kCols>
struct Columns {
  const int32_t* __restrict__ c[kCols];
};

__device__ __forceinline__ int32_t lane_of(const int4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The body of a support kernel: `bin(p)` maps one pair's column values
// p[0..kCols) to its bin, -1 for a pair that does not hit.  A bin outside
// 0..n_int-1 counts nothing: a miss's -1 is out of range as unsigned, as
// is a gate index past the table (the TPU kernel drops both).  `vec`:
// every column is 16-byte aligned, so a thread takes four pairs a step
// through one int4 of each; a scalar loop takes the tail and unaligned
// views.  `hist`: the block's n_int words of dynamic shared memory.
// Integer adds commute, so the counts are exact whatever the order.
template <int kCols, typename Bin>
__device__ __forceinline__ void support_body(
    const Columns<kCols>& cols, int64_t n, int32_t n_int, int vec,
    const Bin& bin, int32_t* hist, int32_t* __restrict__ out) {
  for (int b = threadIdx.x; b < n_int; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const uint32_t bins = static_cast<uint32_t>(n_int);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    for (int64_t i = tid; i < n4; i += stride) {
      int4 v[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        v[c] = reinterpret_cast<const int4*>(cols.c[c])[i];
      }
      int32_t b[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int32_t p[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) p[c] = lane_of(v[c], k);
        b[k] = bin(p);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (static_cast<uint32_t>(b[k]) < bins) atomicAdd(&hist[b[k]], 1);
      }
    }
    done = n4 << 2;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    int32_t p[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) p[c] = cols.c[c][i];
    const int32_t b = bin(p);
    if (static_cast<uint32_t>(b) < bins) atomicAdd(&hist[b], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_int; b += blockDim.x) {
    const int32_t c = hist[b];
    if (c) atomicAdd(&out[b], c);
  }
}

inline bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

inline int sm_count(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess || sms <= 0) {
    sms = 132;
  }
  return sms;
}

// Blocks of `threads` of `kernel` with `smem` bytes of dynamic shared
// memory that one SM holds at once; 0 when it holds none (the launch
// would be refused) or the query fails.
template <typename Kernel>
inline int resident_blocks(Kernel kernel, int threads, size_t smem) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return per_sm;
}

// Blocks for a grid-stride loop over `work` items, capped at `per_sm`
// resident blocks per SM.
inline int grid_for(int64_t work, int device, int per_sm) {
  const int sms = sm_count(device);
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * per_sm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks);
}

// The grid of a support kernel over n pairs and n_int bins: at most
// kSupportBlocksPerSm blocks an SM (kWideBlocksPerSm above kWideBins),
// each thread taking four pairs a step (one on unaligned columns).
inline int support_grid(int64_t n, int32_t n_int, int vec, int device) {
  return grid_for(vec ? (n + 3) / 4 : n, device,
                  n_int > kWideBins ? kWideBlocksPerSm : kSupportBlocksPerSm);
}

}  // namespace coral
