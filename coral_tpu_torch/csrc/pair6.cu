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
// The TPU kernel scans the whole table backwards with a select per step;
// here the scan runs forwards and ends where side i is found: io_j can
// only equal io_i if side j was found by then, so nothing later matters.
//
// What bounds it: at 16 intervals the 24 B read and 5 B written per pair
// (K3) against 3.35 TB/s; at thousands of intervals the scan, about 8
// integer operations per interval per pair, so the integer rate of the
// SMs.  The table does not fit one shared-memory tile at the sizes this
// route exists for, so a block stages it through shared memory 512
// intervals (8 KB, one 16-byte word per interval, read as a broadcast)
// at a time, each thread holding one pair across the tiles; the block
// leaves the tile loop as soon as all of its pairs are done.
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
// on the card at 16 and 8,200 intervals).  A slot is claimed by the first
// bin that reaches it and kept; a bin whose slot holds another bin goes to
// device memory, so many hot bins on one slot cost what device-memory
// atomics cost.  On an NVIDIA H100 80GB HBM3 at 700 W
// (coral_tpu_torch/tools/kernel_ab.py) K4 takes 0.0292 ms on the WGS-like
// decoys-last shape against K3's 0.0245 (the device-memory counts took
// 0.0530): 1.19x.  What it still
// pays beyond K3 is the zeroed output, a kernel and a launch of its own
// (the floor of one timed call is 0.005 ms), and the flush, 1,056 blocks
// adding to 10 bins on one line of L2.  Clusters of 8 blocks that add
// their bins together through distributed shared memory before the flush
// made every shape slower (a cluster launch holds fewer blocks on the
// card), so K4 does not use them.

#include <algorithm>
#include <atomic>

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
// counts are exact whatever the order.  `out` is zeroed by the caller.
__global__ void __launch_bounds__(kThreads)
pair6_support_kernel(Table tb, Cols c, int64_t n, int32_t cutoff,
                     int32_t min_mapq, float gap, int32_t* __restrict__ out) {
  __shared__ int4 tile[kTile];
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
    const bool h = pair6_decide(tb, c, tile, staged, base, n, cutoff,
                                min_mapq, gap, &io_i);
    // all 32 lanes are here together: pair6_decide ends on a barrier, and
    // `exact` is the same in the whole block
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

// K4's blocks an SM for `smem` bytes of dynamic shared memory (at most 32
// KB): K3's grid where the SM holds it.  Asked of the CUDA runtime once
// per device and KB of shared memory (rounded up), then kept, so that a
// launch asks nothing; 0 when the SM holds no block.
int support_blocks_per_sm(int device, size_t smem) {
  constexpr int kDevices = 64;
  constexpr int kKb = (kSharedBins * 4 + 1023) / 1024 + 1;
  static std::atomic<int> known[kDevices][kKb];  // blocks + 1; 0: not asked
  const int kb = static_cast<int>((smem + 1023) / 1024);
  const auto ask = [&] {
    return std::min(kBlocksPerSm,
                    coral::resident_blocks(pair6_support_kernel, kThreads,
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

int coral_pair6_hitmask(const void* ic, const void* is, const void* ie,
                        const void* qgap, const void* r1_i, const void* r2_i,
                        const void* r1_j, const void* r2_j, const void* meta,
                        void* hit, void* io, long long n, int n_int,
                        int cutoff, int min_mapq, float gap, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair6_hitmask_kernel<<<grid_for(n, device, kBlocksPerSm), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      table_of(ic, is, ie, n_int), cols_of(qgap, r1_i, r2_i, r1_j, r2_j, meta),
      static_cast<uint8_t*>(hit), static_cast<int32_t*>(io), n, cutoff,
      min_mapq, gap);
  return static_cast<int>(cudaGetLastError());
}

int coral_pair6_support(const void* ic, const void* is, const void* ie,
                        const void* qgap, const void* r1_i, const void* r2_i,
                        const void* r1_j, const void* r2_j, const void* meta,
                        void* out, long long n, int n_int, int cutoff,
                        int min_mapq, float gap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      static_cast<size_t>(n_int <= kSharedBins ? n_int : 2 * kCacheSlots) *
      sizeof(int32_t);
  const int per_sm = support_blocks_per_sm(device, smem);
  pair6_support_kernel<<<grid_for(n, device, std::max(per_sm, 1)), kThreads,
                         smem,
                         static_cast<cudaStream_t>(stream)>>>(
      table_of(ic, is, ie, n_int), cols_of(qgap, r1_i, r2_i, r1_j, r2_j, meta),
      n, cutoff, min_mapq, gap, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
