// Junction-predicate kernels over the packed 6-column pair layout, for
// sm_90a: the route for interval lists too long for the resolved v3
// layout (more than 8190 intervals), at any number of intervals.
//
// Layout (coral_tpu/ops/scoring.py, PACKED_COL_ORDER): six int32 columns
// per adjacent-alignment pair,
//   qgap, r1_i, r2_i, r1_j, r2_j   (read gap; reference ends, storage
//                                   order: r1 > r2 on the '-' strand)
//   meta = side_i << 14 | side_j,  side = (chrom+1) << 9 | mapq << 1 | plus
// and the interval table as three int32 rows (chrom, start, end).  Zero
// pad rows carry chrom -1, which matches no interval.
//
// Per pair, the kernel finds the first interval that overlaps each side,
//   io = min k : chrom == ic[k] && r1 <= ie[k] && is[k] <= r2
// (storage order, not sorted: the reference's minus-strand quirk), and
// then decides junction_hit (pair_common.cuh) with the gate
//   io_i >= 0 && io_i == io_j && mapq_i >= min_mapq && mapq_j >= min_mapq.
// Two routes find it; the wrapper picks one by the table's length
// (coral_tpu_torch/ops/kernels.py, PAIR6_SCAN_MAX_INTERVALS):
//
// - up to 64 intervals, a scan.  The TPU kernel scans the whole table
//   backwards with a select per step; here the scan runs forwards and
//   ends where side i is found: io_j can only equal io_i if side j was
//   found by then, so nothing later matters.  A block stages the table
//   through shared memory 512 intervals (8 KB, one 16-byte word per
//   interval, read as a broadcast) at a time, each thread holding one
//   pair across the tiles; the block leaves the tile loop as soon as all
//   of its pairs are done.  What bounds it: at 16 intervals the 24 B read
//   and 5 B written per pair (K3) against 3.35 TB/s; past that the scan,
//   about 8 integer operations per interval per pair: 11.7 ms at 8,200
//   intervals and 2^21 pairs, against 0.4 ms for the index.
// - above, lookups in the table's interval index (interval_index.cuh,
//   built by index.cu before the launch): side i for every pair (K4: for
//   the pairs that could hit, as it counts nothing else), side j only
//   where the gate can still pass, since io_j == io_i needs interval io_i
//   to overlap side j.  A lookup is two binary searches side by side
//   (2 log2 n steps, most in shared memory) and a walk of at most
//   ceil(log4 n) + 1 slots of the 4-ary levels in L2.  What bounds it is
//   the issue and latency of those steps, not bytes: on the WGS-like
//   pairs, where a warp's lanes walk one path and share every load, the
//   lookups take 0.12 ms for 3 M of them.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (coral_tpu_torch/tools/kernel_ab.py
// --only pair6_routes: 2^21 dense pairs, CUDA events after an L2 flush
// and a 0.1 ms wait, the index's build included), K3 took 0.046 ms by
// the scan and 0.087 by the index at 16 intervals, 0.069 and 0.104 at 32,
// 0.115 and 0.112 at 64, 0.206 and 0.131 at 128, 0.386 and 0.144 at 256:
// the two tie at 64.
//
// K4 adds a histogram of the hits by interval, and what bounds it beyond
// K3 is where the counts go.  Counted straight into the output above 8190
// intervals (K2's limit from its 14-bit packed meta, not a limit of
// shared memory), the WGS sample's hits, which fall on 10 intervals, sent
// every warp's atomic to 10 addresses in device memory: K4 took 2.2x K3's
// time.  So a block keeps a direct-mapped cache of 2048 bins in shared
// memory above 8190 intervals (16 KB of tags and counts: hot bins stay on
// the SM at any number of intervals, and with the 8 KB tile a block takes
// 24 KB, so the SM still holds K3's 8 blocks, which beat 4, 2 and 1 an SM
// on the card at 16 and 8,200 intervals; the index's 16 KB of samples
// make it 32 KB, 7 blocks).  A slot is claimed by the first bin that
// reaches it and kept; a bin whose slot holds another bin goes to device
// memory, so many hot bins on one slot cost what device-memory atomics
// cost.  On an NVIDIA H100 80GB HBM3 at 700 W
// (coral_tpu_torch/tools/kernel_ab.py) K4 takes 0.0292 ms on the WGS-like
// decoys-last shape against K3's 0.0245 (the device-memory counts took
// 0.0530): 1.19x, on the scan.  What it still pays beyond K3 is the
// zeroed output (a memset on the stream, from the C entry) and the flush,
// 1,056 blocks adding to 10 bins on one line of L2.  Clusters of 8 blocks
// that add their bins together through distributed shared memory before
// the flush made every shape slower (a cluster launch holds fewer blocks
// on the card), so K4 does not use them.

#include <algorithm>
#include <atomic>

#include "interval_index.cuh"
#include "pair_common.cuh"

namespace {

using coral::grid_for;
using coral::kThreads;
using coral::wrap_sub;

constexpr int kTile = 512;
// K4: a block holds every bin in shared memory up to this many intervals
// (32 KB), and a cache of kCacheSlots bins (16 KB) above it
constexpr int kSharedBins = 8190;
constexpr int kCacheSlots = 2048;
// K3's grid: 8 resident blocks of 256 threads an SM, a whole SM's threads
constexpr int kBlocksPerSm = 8;

struct Table {
  const int32_t* __restrict__ chrom;
  const int32_t* __restrict__ start;
  const int32_t* __restrict__ end;
  int32_t n;
};

struct Cols {
  const int32_t* __restrict__ qgap;
  const int32_t* __restrict__ r1_i;
  const int32_t* __restrict__ r2_i;
  const int32_t* __restrict__ r1_j;
  const int32_t* __restrict__ r2_j;
  const int32_t* __restrict__ meta;
};

// One pair per thread, for the block's 256 pairs starting at `base`.
// Every thread of the block calls this (it synchronises); a thread past
// the end of the columns carries no pair.  `staged` is the first interval
// of the tile now in shared memory (the same in every thread).  Returns
// hit; *io_i gets the first interval of side i, -1 if none.
__device__ __forceinline__ bool pair6_decide(
    const Table& tb, const Cols& c, int4* tile, int32_t& staged,
    int64_t base, int64_t n, int32_t cutoff, int32_t min_mapq, float gap,
    int32_t* io_out) {
  const int64_t p = base + threadIdx.x;
  const bool valid = p < n;
  int32_t qgap = 0, r1_i = 0, r2_i = 0, r1_j = 0, r2_j = 0, meta = 0;
  if (valid) {
    qgap = c.qgap[p];
    r1_i = c.r1_i[p];
    r2_i = c.r2_i[p];
    r1_j = c.r1_j[p];
    r2_j = c.r2_j[p];
    meta = c.meta[p];
  }
  const int32_t side_i = meta >> 14;
  const int32_t side_j = meta & 0x3FFF;
  const int32_t chrom_i = (side_i >> 9) - 1;
  const int32_t chrom_j = (side_j >> 9) - 1;
  int32_t io_i = -1, io_j = -1;
  bool done = !valid;
  for (int32_t t0 = 0; t0 < tb.n; t0 += kTile) {
    const int32_t m = min(kTile, tb.n - t0);
    if (staged != t0) {
      // every thread is past the barrier that ended the last tile's scan
      for (int32_t k = threadIdx.x; k < m; k += blockDim.x) {
        tile[k] = make_int4(tb.chrom[t0 + k], tb.start[t0 + k],
                            tb.end[t0 + k], 0);
      }
      staged = t0;
      __syncthreads();
    }
    if (!done) {
      for (int32_t k = 0; k < m; ++k) {
        const int4 iv = tile[k];
        if (io_j < 0 && chrom_j == iv.x && r1_j <= iv.z && iv.y <= r2_j) {
          io_j = t0 + k;
        }
        if (chrom_i == iv.x && r1_i <= iv.z && iv.y <= r2_i) {
          io_i = t0 + k;
          done = true;
          break;
        }
      }
    }
    if (__syncthreads_and(done)) break;
  }
  *io_out = io_i;
  const int32_t mapq_i = (side_i >> 1) & 0xFF;
  const int32_t mapq_j = (side_j >> 1) & 0xFF;
  const bool plus_j = (side_j & 1) != 0;
  const bool gate = io_i >= 0 && io_i == io_j && mapq_i >= min_mapq &&
                    mapq_j >= min_mapq;
  const int32_t grr = plus_j ? wrap_sub(r1_j, r2_i) : wrap_sub(r2_i, r1_j);
  return valid && coral::junction_hit(qgap, grr, (side_i & 1) != (side_j & 1),
                                      gate, cutoff, gap);
}

// The decision of pair p (past the end of the columns: no pair) on the
// interval index; the result and *io_out as pair6_decide's.  Side i is
// looked up for every pair (kSupport: only where the pair could hit, as
// K4 counts nothing else).  Side j is looked up only where the gate can
// still pass: the pair could hit, side i was found, and interval io_i
// itself overlaps side j, since io_j == io_i needs that.
template <bool kSupport>
__device__ __forceinline__ bool pair6_decide_indexed(
    const Table& tb, const coral::IntervalIndex& ix, const long long* s_start,
    const long long* s_end, const Cols& c, int64_t p, int64_t n,
    int32_t cutoff, int32_t min_mapq, float gap, int32_t* io_out) {
  const bool valid = p < n;
  int32_t qgap = 0, r1_i = 0, r2_i = 0, r1_j = 0, r2_j = 0, meta = 0;
  if (valid) {
    qgap = c.qgap[p];
    r1_i = c.r1_i[p];
    r2_i = c.r2_i[p];
    r1_j = c.r1_j[p];
    r2_j = c.r2_j[p];
    meta = c.meta[p];
  }
  const int32_t side_i = meta >> 14;
  const int32_t side_j = meta & 0x3FFF;
  const int32_t chrom_i = (side_i >> 9) - 1;
  const int32_t chrom_j = (side_j >> 9) - 1;
  const int32_t mapq_i = (side_i >> 1) & 0xFF;
  const int32_t mapq_j = (side_j >> 1) & 0xFF;
  const bool plus_j = (side_j & 1) != 0;
  const int32_t grr = plus_j ? wrap_sub(r1_j, r2_i) : wrap_sub(r2_i, r1_j);
  const bool could = valid && mapq_i >= min_mapq && mapq_j >= min_mapq &&
                     coral::junction_hit(qgap, grr,
                                         (side_i & 1) != (side_j & 1), true,
                                         cutoff, gap);
  int32_t io_i = -1;
  if (kSupport ? could : valid) {
    io_i = coral::first_overlap_indexed(ix, s_start, s_end, chrom_i, r1_i,
                                        r2_i);
  }
  bool gate = false;
  if (could && io_i >= 0 && __ldg(tb.chrom + io_i) == chrom_j &&
      r1_j <= __ldg(tb.end + io_i) && __ldg(tb.start + io_i) <= r2_j) {
    gate = coral::first_overlap_indexed(ix, s_start, s_end, chrom_j, r1_j,
                                        r2_j) == io_i;
  }
  *io_out = io_i;
  return gate;
}

// K3 on the interval index: a thread a pair, no barrier after the samples.
__global__ void __launch_bounds__(kThreads)
pair6_hitmask_indexed_kernel(Table tb, coral::IntervalIndex ix, Cols c,
                             uint8_t* __restrict__ hit,
                             int32_t* __restrict__ io, int64_t n,
                             int32_t cutoff, int32_t min_mapq, float gap) {
  __shared__ long long samples[2 * coral::kIndexSamples];
  coral::stage_samples(ix, samples, samples + coral::kIndexSamples);
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       p < n; p += stride) {
    int32_t io_i;
    hit[p] = pair6_decide_indexed<false>(
        tb, ix, samples, samples + coral::kIndexSamples, c, p, n, cutoff,
        min_mapq, gap, &io_i);
    io[p] = io_i;
  }
}

// K3: hit mask and first interval of side i.  Replaces _pair_kernel
// (coral_tpu/ops/pallas_kernels.py:87, with _first_overlap_scan :36).
__global__ void __launch_bounds__(kThreads)
pair6_hitmask_kernel(Table tb, Cols c, uint8_t* __restrict__ hit,
                     int32_t* __restrict__ io, int64_t n, int32_t cutoff,
                     int32_t min_mapq, float gap) {
  __shared__ int4 tile[kTile];
  int32_t staged = -1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads; base < n;
       base += stride) {
    int32_t io_i;
    const bool h = pair6_decide(tb, c, tile, staged, base, n, cutoff,
                                min_mapq, gap, &io_i);
    const int64_t p = base + threadIdx.x;
    if (p < n) {
      hit[p] = h;
      io[p] = io_i;
    }
  }
}

// K4: K3 fused with the per-interval support histogram of
// hit & (io_i == k).  Replaces _pair_hist_kernel
// (coral_tpu/ops/pallas_kernels.py:659).  The TPU kernel adds each grid
// step's counts into one VMEM block in grid order; CUDA blocks run in no
// order, so each block counts on the SM and adds its counts into `out`
// once at the end, one atomic per distinct bin of a warp on the way in.
// Up to kSharedBins intervals a block holds every bin in shared memory.
// Above that it holds a direct-mapped cache of kCacheSlots bins: slot
// bin % kCacheSlots, claimed by the first bin that reaches it (atomicCAS
// on its tag) and kept for the rest of the block; a bin whose slot holds
// another bin is added straight into `out`.  Integer adds commute, so the
// counts are exact whatever the order.  `out` is zeroed by the C entry.
// kIndexed: the pairs are decided on the interval index, whose samples
// (16 KB) take the place of the scan's tile (8 KB).
template <bool kIndexed>
__global__ void __launch_bounds__(kThreads)
pair6_support_kernel(Table tb, coral::IntervalIndex ix, Cols c, int64_t n,
                     int32_t cutoff, int32_t min_mapq, float gap,
                     int32_t* __restrict__ out) {
  __shared__ __align__(16) long long
      stage[kIndexed ? 2 * coral::kIndexSamples : 2 * kTile];
  int4* tile = reinterpret_cast<int4*>(stage);
  long long* s_start = stage;
  long long* s_end = stage + coral::kIndexSamples;
  if constexpr (kIndexed) coral::stage_samples(ix, s_start, s_end);
  extern __shared__ int32_t hist[];
  // exact: hist[k] counts bin k; cached: tags, then counts, per slot
  const bool exact = tb.n <= kSharedBins;
  const int32_t slots = exact ? tb.n : kCacheSlots;
  int32_t* tag = hist;
  int32_t* cnt = hist + kCacheSlots;
  for (int32_t b = threadIdx.x; b < slots; b += blockDim.x) {
    if (exact) {
      hist[b] = 0;
    } else {
      tag[b] = -1;
      cnt[b] = 0;
    }
  }
  __syncthreads();
  const uint32_t bins = static_cast<uint32_t>(tb.n);
  int32_t staged = -1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads; base < n;
       base += stride) {
    int32_t io_i;
    bool h;
    if constexpr (kIndexed) {
      h = pair6_decide_indexed<true>(tb, ix, s_start, s_end, c,
                                     base + threadIdx.x, n, cutoff, min_mapq,
                                     gap, &io_i);
    } else {
      h = pair6_decide(tb, c, tile, staged, base, n, cutoff, min_mapq, gap,
                       &io_i);
    }
    // all 32 lanes are here together: every lane takes each step of the
    // loop (pair6_decide ends on a barrier), and `exact` is the same in
    // the whole block
    if (exact) {
      coral::count_step(h ? io_i : -1, bins,
                        [&](int32_t b, int32_t k) { atomicAdd(&hist[b], k); });
    } else {
      coral::count_step(h ? io_i : -1, bins, [&](int32_t b, int32_t k) {
        const int32_t s = b & (kCacheSlots - 1);
        int32_t t = static_cast<volatile int32_t*>(tag)[s];
        if (t < 0) {
          t = atomicCAS(&tag[s], -1, b);
          if (t < 0) t = b;
        }
        atomicAdd(t == b ? &cnt[s] : &out[b], k);
      });
    }
  }
  __syncthreads();
  for (int32_t b = threadIdx.x; b < slots; b += blockDim.x) {
    if (exact) {
      if (hist[b]) atomicAdd(&out[b], hist[b]);
    } else if (cnt[b]) {
      atomicAdd(&out[tag[b]], cnt[b]);
    }
  }
}

Table table_of(const void* ic, const void* is, const void* ie, int n_int) {
  return Table{static_cast<const int32_t*>(ic),
               static_cast<const int32_t*>(is),
               static_cast<const int32_t*>(ie), n_int};
}

Cols cols_of(const void* qgap, const void* r1_i, const void* r2_i,
             const void* r1_j, const void* r2_j, const void* meta) {
  return Cols{static_cast<const int32_t*>(qgap),
              static_cast<const int32_t*>(r1_i),
              static_cast<const int32_t*>(r2_i),
              static_cast<const int32_t*>(r1_j),
              static_cast<const int32_t*>(r2_j),
              static_cast<const int32_t*>(meta)};
}

// The index as K3 and K4 take it: null `lev`, the scan route.
coral::IntervalIndex index_of(const void* skey, const void* ekey,
                              const void* lev, int n_int, int top) {
  const int32_t shift = coral::index_sample_shift(n_int);
  const int64_t step = int64_t{1} << shift;
  return coral::IntervalIndex{
      static_cast<const long long*>(skey), static_cast<const long long*>(ekey),
      static_cast<const int4*>(lev), n_int, top, shift,
      static_cast<int32_t>((n_int + step - 1) / step)};
}

// K4's blocks an SM for `smem` bytes of dynamic shared memory (at most 32
// KB): K3's grid where the SM holds it.  Asked of the CUDA runtime once
// per route, device and KB of shared memory (rounded up), then kept, so
// that a launch asks nothing; 0 when the SM holds no block.
template <bool kIndexed>
int support_blocks_per_sm(int device, size_t smem) {
  constexpr int kDevices = 64;
  constexpr int kKb = (kSharedBins * 4 + 1023) / 1024 + 1;
  static std::atomic<int> known[kDevices][kKb];  // blocks + 1; 0: not asked
  const int kb = static_cast<int>((smem + 1023) / 1024);
  const auto ask = [&] {
    return std::min(kBlocksPerSm,
                    coral::resident_blocks(pair6_support_kernel<kIndexed>,
                                           kThreads,
                                           static_cast<size_t>(kb) * 1024));
  };
  if (device < 0 || device >= kDevices || kb >= kKb) return ask();
  int v = known[device][kb].load(std::memory_order_relaxed);
  if (v == 0) {
    v = ask() + 1;
    known[device][kb].store(v, std::memory_order_relaxed);
  }
  return v - 1;
}

}  // namespace

extern "C" {

// Each entry launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() (0 when the launch was accepted).

// skey, ekey, lev, top: the interval index of the table
// (ops/interval_index.py); lev null: the scan route.
int coral_pair6_hitmask(const void* ic, const void* is, const void* ie,
                        const void* qgap, const void* r1_i, const void* r2_i,
                        const void* r1_j, const void* r2_j, const void* meta,
                        void* hit, void* io, long long n, int n_int,
                        int cutoff, int min_mapq, float gap, const void* skey,
                        const void* ekey, const void* lev, int top,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const Table tb = table_of(ic, is, ie, n_int);
  const Cols c = cols_of(qgap, r1_i, r2_i, r1_j, r2_j, meta);
  const int grid = grid_for(n, device, kBlocksPerSm);
  if (lev != nullptr) {
    pair6_hitmask_indexed_kernel<<<grid, kThreads, 0, s>>>(
        tb, index_of(skey, ekey, lev, n_int, top), c,
        static_cast<uint8_t*>(hit), static_cast<int32_t*>(io), n, cutoff,
        min_mapq, gap);
  } else {
    pair6_hitmask_kernel<<<grid, kThreads, 0, s>>>(
        tb, c, static_cast<uint8_t*>(hit), static_cast<int32_t*>(io), n,
        cutoff, min_mapq, gap);
  }
  return static_cast<int>(cudaGetLastError());
}

// Zeroes `out` (n_int int32) with a memset on the stream, then counts
// into it.
int coral_pair6_support(const void* ic, const void* is, const void* ie,
                        const void* qgap, const void* r1_i, const void* r2_i,
                        const void* r1_j, const void* r2_j, const void* meta,
                        void* out, long long n, int n_int, int cutoff,
                        int min_mapq, float gap, const void* skey,
                        const void* ekey, const void* lev, int top,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, static_cast<size_t>(n_int) * sizeof(int32_t),
                        s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      static_cast<size_t>(n_int <= kSharedBins ? n_int : 2 * kCacheSlots) *
      sizeof(int32_t);
  const Table tb = table_of(ic, is, ie, n_int);
  const coral::IntervalIndex ix = index_of(skey, ekey, lev, n_int, top);
  const Cols c = cols_of(qgap, r1_i, r2_i, r1_j, r2_j, meta);
  auto* counts = static_cast<int32_t*>(out);
  if (lev != nullptr) {
    const int per_sm = support_blocks_per_sm<true>(device, smem);
    pair6_support_kernel<true><<<grid_for(n, device, std::max(per_sm, 1)),
                                 kThreads, smem, s>>>(
        tb, ix, c, n, cutoff, min_mapq, gap, counts);
  } else {
    const int per_sm = support_blocks_per_sm<false>(device, smem);
    pair6_support_kernel<false><<<grid_for(n, device, std::max(per_sm, 1)),
                                  kThreads, smem, s>>>(
        tb, ix, c, n, cutoff, min_mapq, gap, counts);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
