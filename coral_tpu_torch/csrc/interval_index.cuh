// The interval index of the 6-column route and its lookup, shared by the
// build (index.cu) and K3, K4 (pair6.cu).  What it is and why:
// coral_tpu_torch/ops/interval_index.py, whose first_overlap_indexed_torch
// is this lookup's plain version, step for step.
//
//   io(c, a, b) = min k : ic[k] == c && is[k] <= b && ie[k] >= a  (-1: none)
//
// R = #{start keys <= X} and c = #{end keys >= Y}: two binary searches
// side by side in fixed steps, begun in a sample of every 2^shift-th key
// that a block holds in shared memory and ended in device memory within
// 2^shift keys (one line); then at most top + 1 steps down the 4-ary
// levels, one slot of 32 bytes (one sector) a step.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace coral {

// the keys' order is (chrom, x): chrom * 2^32 + x + 2^31
__host__ __device__ __forceinline__ long long interval_key(int32_t chrom,
                                                           int32_t x) {
  return static_cast<long long>(chrom) * 4294967296LL +
         static_cast<long long>(x) + 2147483648LL;
}

// 4 children a block; a slot is {mn, c0, c01, c012} {m0, m01, m012, 0}
constexpr int kFanBits = 2;
// a block holds at most this many samples of each key column (16 KB)
constexpr int kIndexSamples = 1024;

struct IntervalIndex {
  const long long* __restrict__ skey;  // start keys, ascending
  const long long* __restrict__ ekey;  // end keys, descending
  const int4* __restrict__ lev;        // (top + 1) x n slots of 2 int4
  int32_t n;
  int32_t top;
  int32_t shift;    // the samples are keys 0, 2^shift, 2 * 2^shift, ...
  int32_t samples;  // ceil(n / 2^shift) <= kIndexSamples
};

// the sample step for n keys: the least power of two that keeps the
// samples within kIndexSamples
inline int32_t index_sample_shift(int32_t n) {
  int32_t s = 0;
  while ((static_cast<int64_t>(n) + (int64_t{1} << s) - 1) >> s >
         kIndexSamples) {
    ++s;
  }
  return s;
}

// Every thread of the block calls it; the caller synchronises after.
__device__ __forceinline__ void stage_samples(const IntervalIndex& ix,
                                              long long* s_start,
                                              long long* s_end) {
  for (int32_t k = threadIdx.x; k < ix.samples; k += blockDim.x) {
    const int64_t at = static_cast<int64_t>(k) << ix.shift;
    s_start[k] = ix.skey[at];
    s_end[k] = ix.ekey[at];
  }
}

__device__ __forceinline__ int32_t top_bit(int32_t v) {
  return v > 0 ? 1 << (31 - __clz(v)) : 0;
}

// R = the start keys <= x, C = the end keys >= y, both searches at once.
__device__ __forceinline__ void leading_counts(
    const IntervalIndex& ix, const long long* s_start, const long long* s_end,
    long long x, long long y, int32_t& R, int32_t& C) {
  int32_t r = 0, c = 0;  // samples that lead
  for (int32_t step = top_bit(ix.samples); step > 0; step >>= 1) {
    if (r + step <= ix.samples && s_start[r + step - 1] <= x) r += step;
    if (c + step <= ix.samples && s_end[c + step - 1] >= y) c += step;
  }
  // the keys between the last sample that leads and the next one
  const int32_t span = (1 << ix.shift) - 1;
  const int32_t r_end = r == 0 ? 0 : min(((r - 1) << ix.shift) + 1 + span,
                                         ix.n);
  const int32_t c_end = c == 0 ? 0 : min(((c - 1) << ix.shift) + 1 + span,
                                         ix.n);
  r = r == 0 ? 0 : ((r - 1) << ix.shift) + 1;
  c = c == 0 ? 0 : ((c - 1) << ix.shift) + 1;
  for (int32_t step = top_bit(span); step > 0; step >>= 1) {
    if (r + step <= r_end && __ldg(ix.skey + r + step - 1) <= x) r += step;
    if (c + step <= c_end && __ldg(ix.ekey + c + step - 1) >= y) c += step;
  }
  R = r;
  C = c;
}

__device__ __forceinline__ int32_t lane4(const int4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// io(chrom, a, b) on the index; s_start, s_end: the block's samples.
__device__ __forceinline__ int32_t first_overlap_indexed(
    const IntervalIndex& ix, const long long* s_start, const long long* s_end,
    int32_t chrom, int32_t a, int32_t b) {
  if (ix.n == 0) return -1;
  int32_t R, c;
  leading_counts(ix, s_start, s_end, interval_key(chrom, b),
                 interval_key(chrom, a), R, c);
  if (R == 0 || c == 0) return -1;
  int32_t best = INT_MAX;
  int32_t base = 0;
  // invariant: base < R, and the block at `level` from `base` has c >= 1
  // slots that match Y; at level 0 the block is one slot below R
  for (int32_t level = ix.top;; --level) {
    const int4* slot =
        ix.lev + 2 * (static_cast<int64_t>(level) * ix.n + base + c - 1);
    const int4 counts = __ldg(slot);
    if (R == ix.n ||
        R - base >= (int64_t{1} << (kFanBits * level))) {  // whole block
      best = min(best, counts.x);
      break;
    }
    const int32_t sh = kFanBits * (level - 1);
    const int32_t d = (R - base) >> sh;  // the child that R cuts
    if (d > 0) best = min(best, lane4(__ldg(slot + 1), d - 1));
    const int32_t before = d == 0 ? 0 : lane4(counts, d);
    const int32_t through = d == 3 ? c : lane4(counts, d + 1);
    const int32_t start = base + (d << sh);
    if (R == start || through == before) break;
    base = start;
    c = through - before;
  }
  return best == INT_MAX ? -1 : best;
}

}  // namespace coral
