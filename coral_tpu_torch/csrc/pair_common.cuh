// Shared by the kernels (pair2.cu, pair3.cu, pair6.cu, bins.cu, match.cu):
// the junction decision chain, evaluated exactly as the TPU kernels
// evaluate it, the warp-aggregated histogram step, and the launch helpers.
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
// gets one atomicAdd of its number of lanes.  All 32 lanes must call it
// together.
__device__ __forceinline__ void warp_count(int32_t* hist, int32_t bin,
                                           uint32_t bins) {
  const int32_t b = static_cast<uint32_t>(bin) < bins ? bin : -1;
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, b);
  if (b >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(&hist[b], __popc(peers));
  }
}

inline bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

// Blocks for a grid-stride loop over `work` items, capped at `per_sm`
// resident blocks per SM.
inline int grid_for(int64_t work, int device, int per_sm) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess || sms <= 0) {
    sms = 132;
  }
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * per_sm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks);
}

}  // namespace coral
