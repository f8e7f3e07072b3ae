// The build of the interval index that K3 and K4 look up
// (interval_index.cuh; the structure and its plain version:
// coral_tpu_torch/ops/interval_index.py).  The TPU kernel it serves,
// _first_overlap_scan (coral_tpu/ops/pallas_kernels.py:36), has no
// pre-pass: it scans the table for every pair.
//
// Two 4-ary merges, bottom up, of the same shape.  First the table's rows
// are sorted by start key (stable): at level l each row moves into its
// block of 4^l at its rank in its own child block plus, for each of the
// other three children, the number of that child's rows that precede it
// (a binary search there; among equal keys the lower child first).  Then
// the tree over those positions: the same merge by end key descending
// gives each level's slot order, and the searches' results are the slot's
// counts c0, c01, c012; once a level's counts are in place, each slot's
// minima are those of its children's prefixes that the counts select.
//
// What bounds it: a level is n slots and three binary searches of at
// most 2 (l - 1) steps each, microseconds; the cost is the levels'
// order, one after the other.  So one launch of 1024-thread blocks takes
// the levels that fit a block (1..5: a chunk of 1024 rows) in shared
// memory, two barriers a level, and each level above is one launch over
// all rows.  The sort is part of the same chain of launches, where
// torch.sort of the start keys cost more than the rest of the build.
// For 8,200 intervals: 7 launches in one C entry, 58 us of device time
// on an NVIDIA H100 80GB HBM3 at 700 W (coral_tpu_torch/tools/
// kernel_ab.py).  The three searches side by side in fixed steps took 66
// us (80 with 64-bit steps): the local launches run 9 blocks, one an SM,
// and are bound by the instructions they issue, not by the searches'
// latency.

#include <algorithm>
#include <climits>

#include "interval_index.cuh"
#include "pair_common.cuh"

namespace {

using coral::interval_key;
using coral::kFanBits;
using coral::kThreads;

constexpr int kLocalLevels = 5;
constexpr int kChunk = 1 << (kFanBits * kLocalLevels);  // 1024

// Rows of the child block at `at` (len of them, keys in merge order) that
// precede a row of key v from another child: kDesc, keys descending (the
// tree by end key), else ascending (the sort by start key); `earlier`,
// the block is a lower child than the row's, so equal keys precede.
template <bool kDesc, typename Keys>
__device__ __forceinline__ int32_t preceding(const Keys& keys, int64_t at,
                                             int32_t len, long long v,
                                             bool earlier) {
  int32_t lo = 0, hi = len;
  while (lo < hi) {
    const int32_t mid = (lo + hi) >> 1;
    const long long q = keys(at + mid);
    const bool before = kDesc ? (earlier ? q >= v : q > v)
                              : (earlier ? q <= v : q < v);
    if (before) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Where row j of level `level - 1` goes at `level`, n rows in all: its
// slot, and cnt[k] the rows of child k that come no later than it in its
// new block (its own child's: its rank + 1).
struct Placed {
  int64_t slot;
  int32_t cnt[4];
};

template <bool kDesc, typename Keys>
__device__ __forceinline__ Placed place(const Keys& keys, int64_t j,
                                        int64_t n, int32_t level,
                                        long long v) {
  const int32_t sh = kFanBits * (level - 1);
  const int64_t sub = int64_t{1} << sh;
  const int64_t child = j >> sh;
  const int32_t own = static_cast<int32_t>(child & 3);
  const int64_t block = (child >> kFanBits) << (sh + kFanBits);
  Placed out;
  out.slot = block;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int32_t c;
    if (k == own) {
      c = static_cast<int32_t>(j - (child << sh));
      out.slot += c;
      ++c;
    } else {
      const int64_t at = block + k * sub;
      const int64_t rest = n - at;
      const int32_t len =
          static_cast<int32_t>(rest < 0 ? 0 : rest < sub ? rest : sub);
      c = preceding<kDesc>(keys, at, len, v, k < own);
      out.slot += c;
    }
    out.cnt[k] = c;
  }
  return out;
}

// A slot's minima from its counts (upto: c0, c01, c012; count: c0123)
// and the child level's mn (`child_mn(s)` at slot s): {mn, m0, m01, m012}.
template <typename ChildMn>
__device__ __forceinline__ int4 minima(const int32_t* upto, int32_t count,
                                       int64_t block, int64_t sub,
                                       const ChildMn& child_mn) {
  int32_t m[4];
  int32_t prev = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int32_t through = k < 3 ? upto[k] : count;
    m[k] = through > prev ? child_mn(block + k * sub + (through - prev) - 1)
                          : INT_MAX;
    prev = through;
  }
  const int32_t m01 = min(m[0], m[1]);
  const int32_t m012 = min(m01, m[2]);
  return make_int4(min(m012, m[3]), m[0], m01, m012);
}

__device__ __forceinline__ int4* slot_of(int4* lev, int64_t n, int32_t level,
                                         int64_t s) {
  return lev + 2 * (static_cast<int64_t>(level) * n + s);
}

// The sort by start key, levels 1..min(top, kLocalLevels), of the 1024
// rows of this block; key_out, row_out get the rows in that order.
__global__ void __launch_bounds__(kChunk)
sort_local_kernel(const int32_t* __restrict__ ic,
                  const int32_t* __restrict__ is, int32_t n, int32_t top,
                  long long* __restrict__ key_out,
                  int32_t* __restrict__ row_out) {
  __shared__ long long key[2][kChunk];
  __shared__ int32_t row[2][kChunk];
  const int32_t t = threadIdx.x;
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int64_t len = min(static_cast<int64_t>(kChunk), n - chunk);
  const bool valid = t < len;
  long long v = 0;
  int32_t r = 0;
  if (valid) {
    r = static_cast<int32_t>(chunk + t);
    v = interval_key(ic[r], is[r]);
  }
  key[0][t] = v;
  row[0][t] = r;
  __syncthreads();
  const int32_t levels = min(top, kLocalLevels);
  for (int32_t l = 1; l <= levels; ++l) {
    const int src = (l - 1) & 1, dst = l & 1;
    if (valid) {
      const Placed p = place<false>(
          [&](int64_t s) { return key[src][s]; }, t, len, l, v);
      key[dst][p.slot] = v;
      row[dst][p.slot] = r;
    }
    __syncthreads();
    if (valid) {
      v = key[dst][t];
      r = row[dst][t];
    }
    __syncthreads();
  }
  if (valid) {
    key_out[chunk + t] = v;
    row_out[chunk + t] = r;
  }
}

// One level of the sort above kLocalLevels.
__global__ void __launch_bounds__(kThreads)
sort_merge_kernel(int32_t n, int32_t level,
                  const long long* __restrict__ key_src,
                  const int32_t* __restrict__ row_src,
                  long long* __restrict__ key_dst,
                  int32_t* __restrict__ row_dst) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j >= n) return;
  const long long v = key_src[j];
  const Placed p = place<false>(
      [&](int64_t s) { return __ldg(key_src + s); }, j, n, level, v);
  key_dst[p.slot] = v;
  row_dst[p.slot] = row_src[j];
}

// The tree, levels 0..min(top, kLocalLevels), of the 1024 positions of
// this block (order: the table row at each position); e_out gets each
// position's end key at the last of those levels.
__global__ void __launch_bounds__(kChunk)
tree_local_kernel(const int32_t* __restrict__ ic,
                  const int32_t* __restrict__ ie,
                  const int32_t* __restrict__ order, int32_t n, int32_t top,
                  int4* __restrict__ lev, long long* __restrict__ e_out) {
  __shared__ long long e[2][kChunk];
  __shared__ int32_t mn[2][kChunk];
  __shared__ int32_t upto[3][kChunk];
  const int32_t t = threadIdx.x;
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int64_t len = min(static_cast<int64_t>(kChunk), n - chunk);
  const bool valid = t < len;
  int32_t k = 0;
  long long v = 0;
  if (valid) {
    k = order[chunk + t];
    v = interval_key(ic[k], ie[k]);
    int4* s = slot_of(lev, n, 0, chunk + t);
    s[0] = make_int4(k, 0, 0, 0);
    s[1] = make_int4(INT_MAX, INT_MAX, INT_MAX, 0);
  }
  e[0][t] = v;
  mn[0][t] = k;
  __syncthreads();
  const int32_t levels = min(top, kLocalLevels);
  for (int32_t l = 1; l <= levels; ++l) {
    const int src = (l - 1) & 1, dst = l & 1;
    if (valid) {
      const Placed p = place<true>(
          [&](int64_t s) { return e[src][s]; }, t, len, l, v);
      e[dst][p.slot] = v;
      upto[0][p.slot] = p.cnt[0];
      upto[1][p.slot] = p.cnt[0] + p.cnt[1];
      upto[2][p.slot] = p.cnt[0] + p.cnt[1] + p.cnt[2];
    }
    __syncthreads();
    if (valid) {
      const int32_t sh = kFanBits * (l - 1);
      const int64_t block = (t >> (sh + kFanBits)) << (sh + kFanBits);
      const int32_t u[3] = {upto[0][t], upto[1][t], upto[2][t]};
      const int4 m = minima(u, static_cast<int32_t>(t - block + 1), block,
                            int64_t{1} << sh,
                            [&](int64_t s) { return mn[src][s]; });
      mn[dst][t] = m.x;
      int4* s = slot_of(lev, n, l, chunk + t);
      s[0] = make_int4(m.x, u[0], u[1], u[2]);
      s[1] = make_int4(m.y, m.z, m.w, 0);
      v = e[dst][t];
    }
    __syncthreads();
  }
  if (valid) e_out[chunk + t] = v;
}

// One level of the tree above kLocalLevels: with `merge` > 0, level
// `merge` from the level below (end keys e_src -> e_dst, and the
// counts); with `fill` > 0, the minima of level `fill`, whose counts and
// the level below's minima are in place.
__global__ void __launch_bounds__(kThreads)
tree_merge_kernel(int32_t n, int32_t merge, int32_t fill,
                  const long long* __restrict__ e_src,
                  long long* __restrict__ e_dst, int4* __restrict__ lev) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j >= n) return;
  if (merge > 0) {
    const long long v = e_src[j];
    const Placed p = place<true>(
        [&](int64_t s) { return __ldg(e_src + s); }, j, n, merge, v);
    e_dst[p.slot] = v;
    int32_t* counts = reinterpret_cast<int32_t*>(slot_of(lev, n, merge,
                                                         p.slot));
    counts[1] = p.cnt[0];
    counts[2] = p.cnt[0] + p.cnt[1];
    counts[3] = p.cnt[0] + p.cnt[1] + p.cnt[2];
  }
  if (fill > 0) {
    const int32_t sh = kFanBits * (fill - 1);
    const int64_t block = (j >> (sh + kFanBits)) << (sh + kFanBits);
    int4* s = slot_of(lev, n, fill, j);
    const int4 c = s[0];
    const int32_t u[3] = {c.y, c.z, c.w};
    const int4* below = slot_of(lev, n, fill - 1, 0);
    const int4 m = minima(u, static_cast<int32_t>(j - block + 1), block,
                          int64_t{1} << sh,
                          [&](int64_t q) { return below[2 * q].x; });
    s[0] = make_int4(m.x, c.y, c.z, c.w);
    s[1] = make_int4(m.y, m.z, m.w, 0);
  }
}

int blocks_for(int64_t n, int threads) {
  return static_cast<int>(std::max<int64_t>((n + threads - 1) / threads, 1));
}

}  // namespace

extern "C" {

// Launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (0 when every launch was accepted).
// ic, is, ie: the int32 table; skey, ekey: int64 (n,); lev: int32
// (top + 1, n, 8); scratch: int64 (3 n,).
int coral_interval_index_build(const void* ic, const void* is, const void* ie,
                               int n, int top, void* skey, void* ekey,
                               void* lev, void* scratch, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* chrom = static_cast<const int32_t*>(ic);
  auto* levels = static_cast<int4*>(lev);
  auto* keys_out = static_cast<long long*>(skey);
  auto* ends_out = static_cast<long long*>(ekey);
  long long* key[2] = {static_cast<long long*>(scratch),
                       static_cast<long long*>(scratch) + n};
  int32_t* row[2] = {reinterpret_cast<int32_t*>(key[1] + n),
                     reinterpret_cast<int32_t*>(key[1] + n) + n};
  const int grid = blocks_for(n, kThreads);
  // the sort by start key; the rows' order ends in row[cur]
  int cur = 0;
  sort_local_kernel<<<blocks_for(n, kChunk), kChunk, 0, s>>>(
      chrom, static_cast<const int32_t*>(is), n, top,
      top <= kLocalLevels ? keys_out : key[0], row[0]);
  err = cudaGetLastError();
  for (int l = kLocalLevels + 1; err == cudaSuccess && l <= top; ++l) {
    const int next = cur ^ 1;
    sort_merge_kernel<<<grid, kThreads, 0, s>>>(
        n, l, key[cur], row[cur], l == top ? keys_out : key[next],
        row[next]);
    err = cudaGetLastError();
    cur = next;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // the tree over those positions; the key buffers are free again
  const int32_t* order = row[cur];
  long long* e = top <= kLocalLevels ? ends_out : key[0];
  tree_local_kernel<<<blocks_for(n, kChunk), kChunk, 0, s>>>(
      chrom, static_cast<const int32_t*>(ie), order, n, top, levels, e);
  err = cudaGetLastError();
  for (int l = kLocalLevels + 1;
       top > kLocalLevels && err == cudaSuccess && l <= top + 1; ++l) {
    const bool merge = l <= top;
    long long* dst = l == top ? ends_out : (e == key[0] ? key[1] : key[0]);
    tree_merge_kernel<<<grid, kThreads, 0, s>>>(
        n, merge ? l : 0, l - 1 > kLocalLevels ? l - 1 : 0, e, dst, levels);
    err = cudaGetLastError();
    if (merge) e = dst;
  }
  return static_cast<int>(err);
}

}  // extern "C"
