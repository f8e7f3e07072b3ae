// K8: aligned bases per genome bin, for sm_90a.  Replaces _bin_kernel
// (coral_tpu/ops/pallas_kernels.py:541).
//
// For reads [s, e) (int32) and n_bins uniform, contiguous bins
// [origin + b * bin_size, origin + (b + 1) * bin_size):
//   out[b] = sum over reads of max(min(e, hi_b) - max(s, lo_b), 0).
// The TPU kernel tests every read against every bin, because its vector
// unit has no scatter.  Here a read costs a fixed number of updates however
// many bins it spans.  Clipped to [lo, hi), it touches bins b0..b1:
//   b0 == b1:  partial[b0] += hi - lo;
//   otherwise: partial[b0] += (lower edge of b0 + 1) - lo,
//              partial[b1] += hi - (lower edge of b1),
//              and the whole bins b0+1..b1-1 go into a difference array
//              of counts, +1 at b0 + 1 and -1 at b1 (nothing if b1 = b0+1);
//   out[b] = partial[b] + bin_size * (count[0] + ... + count[b]).
// That is at most four updates a read (the first port made one atomic per
// touched bin: about eleven a read at 65,536 bins over the bench reads).
// A read with e <= s (a pad, or an empty read) adds nothing; a read that
// starts before `origin` or ends past the last edge is clipped.
//
// What bounds it on this card: the 8 B read per read against 3.35 TB/s,
// once the updates stay on the SM; the first port was 5-26x that bound,
// held back by its atomics.  So the updates are merged before they are
// made: a thread takes kRun contiguous reads (one int4 load a column) and
// keeps running sums of the partials in a window of two bins (b, b + 1:
// sorted reads that straddle one edge, as the junction records piled on
// an amplicon's edge do, fill both without an atomic), handing a sum on
// with one atomic only when it leaves the window; at the end of the run
// the warp hands on its lanes' windows, with one atomic a bin when all 32
// start at the same bin (sorted reads) and one a lane and bin otherwise.
// A block whose reads cannot sum to 2^32 in one bin (its reads times
// bin_size below it, as on every chromosome) does not wait for the old
// value of its shared-memory adds.  (Combining the lanes at every
// hand-on with __match_any_sync, as K4 does, cost 4x the first port's
// time over random reads at 256 bins, where nothing combines.)  A read's
// bins come from a 32-bit multiply-high by a precomputed reciprocal
// (Granlund and Montgomery) wherever the binned range is shorter than
// 2^32 (every chromosome), and everything after the clip is then 32-bit.
// What still holds it above that bound (numbers below): over random reads
// the shared-memory atomics, whose old value the carry needs, with the
// lanes of a warp on different bins (about 14 us of device time for 2^21
// reads into 256 bins, bound 5 us); past one tile, a pass over the reads
// per tile and the flushes; on one chromosome, the floor of a launch.
//
// Where the sums live (`plan_for`): the bins are cut into tiles of at
// most what a block may hold in shared memory (the card's opt-in limit,
// 227 KB on an H100; 8 B a bin: a 32-bit partial whose rare carries go
// straight to `out`, and an int32 count: 28,928 bins a tile).  A block
// owns one tile and a contiguous run of chunks of the reads, and takes
// from each read only the updates that fall in its tile (counts before
// the tile go into a carry).  It tracks the bins its reads reach, and
// scans the counts and adds partial + bin_size * prefix into `out` over
// those alone, one 64-bit atomic per non-zero bin (a block of sorted reads
// reaches a few bins of a tile of thousands, and one warp scans them; a
// block none of whose reads spans a whole bin adds its partials without a
// scan).  The grid is one wave of resident blocks of 1024 threads (from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor), cut into tiles x
// blocks, every block with the same number of chunks.  Beyond the reads
// it costs a pass over them per tile and the flush, at most blocks x
// n_bins atomics (random reads), far fewer over sorted ones.
//
// Measured and not kept (coral_tpu_torch/tools/kernel_ab.py, NVIDIA H100
// 80GB HBM3 at 700 W, device time of a call from the profiler):
// - a second route, partials and counts in device memory with global
//   atomics and a scan kernel after it, chosen by a price rule fitted to
//   random reads (it won there only past ~340,000 bins: 0.219 against
//   0.269 ms at 549,632).  Over the sorted reads every caller passes it
//   never won: on the WGS sample's first chromosome, 517,992 reads, it
//   took 155 us against 7.2 at 100 kb bins, 88 against 7.9 at 10 kb, 121
//   against 32.6 at 1 kb and 381 against 178 at 100 bp (where the rule
//   chose it; the first port took 278), its atomics piling onto the
//   amplicon's bins;
// - blocks of 512 threads: equal on that chromosome, 76 against 55 us at
//   2^21 reads x 65,536 bins and 232 against 178 at 100 bp bins; blocks
//   of 256 were slower still;
// - a 64-register cap (__launch_bounds__(1024, 1)) in place of 32: equal
//   at every shape (7.25 against 7.17 us on the chromosome);
// - a running sum of one bin in place of the window: 7.0 us against 4.9
//   on the chromosome in 100 kb bins (where the first port took 6.8),
//   but 52.0 against 57.5 at 2^21 random reads x 65,536 bins and 13.7
//   against 14.4 at 256 bins (the window's 64-bit instance spills 68 B,
//   its 32-bit one none).
//
// On the same card (kernel_ab.py, the same inputs through the first
// port's kernel, a thread a read and one atomic a touched bin, in one
// run; device time of a call, zeroing of `out` included): the WGS
// sample's first chromosome in 1,594 bins 4.9 us (6.8), in 15,935 bins
// 5.6 (220), 159,346 bins 23.7 (239), 1,593,460 bins 153 (276); 2^21
// random reads x 256 bins 14.4 (18.3), x 65,536 bins 57.5 (392).
//
// Edges and sums are int64: the TPU kernel casts the edges to int32 and
// sums in int32, so this kernel equals it wherever neither wraps.  Counts
// are taken modulo 2^32; a prefix is a number of reads, so n < 2^32.

#include <algorithm>

#include "pair_common.cuh"

namespace {

typedef unsigned long long u64;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kBlock = 1024;         // threads a block
constexpr int kRun = 4;              // contiguous reads a thread, one int4
constexpr int kBytesPerBin = 8;      // partial (u32) + count (int32)
constexpr int kStaticSmem = 1024;    // left for the kernel's static arrays

struct Bins {
  int64_t origin;
  int64_t bin_size;
  int64_t last_edge;
  int32_t n_bins;
  // bin = (t + ((x - t) >> sh1)) >> sh2 with t = umulhi(magic, x), for x
  // below 2^32 (Granlund and Montgomery's round-up multiplier): set when
  // the binned range is shorter than 2^32, so offsets are 32-bit
  uint32_t magic;
  int sh1, sh2;

  __device__ __forceinline__ uint32_t div32(uint32_t x) const {
    const uint32_t t = __umulhi(magic, x);
    return (t + ((x - t) >> sh1)) >> sh2;
  }
};

// The updates of one read: partials (b0, v0) and (b1, v1) (bin -1: none)
// and, if `whole`, the count difference +1 at b0 + 1 and -1 at b1.
struct Events {
  int32_t b0, b1;
  u64 v0, v1;
  bool whole;
};

// kNarrow: the range is shorter than 2^32 (Bins::magic), so everything
// after the clip is 32-bit: offsets, bins, edges and overlaps.
template <bool kNarrow>
__device__ __forceinline__ Events read_events(const Bins& g, int64_t s,
                                              int64_t e) {
  Events ev{-1, -1, 0, 0, false};
  const int64_t lo = s > g.origin ? s : g.origin;
  const int64_t hi = e < g.last_edge ? e : g.last_edge;
  if (hi <= lo) return ev;
  if (kNarrow) {
    const uint32_t rlo = static_cast<uint32_t>(lo - g.origin);
    const uint32_t rhi = static_cast<uint32_t>(hi - g.origin);
    const uint32_t bs = static_cast<uint32_t>(g.bin_size);
    const uint32_t b0 = g.div32(rlo), b1 = g.div32(rhi - 1);
    ev.b0 = static_cast<int32_t>(b0);
    if (b1 == b0) {
      ev.v0 = rhi - rlo;
      return ev;
    }
    ev.v0 = (b0 + 1) * bs - rlo;
    ev.b1 = static_cast<int32_t>(b1);
    ev.v1 = rhi - b1 * bs;
    ev.whole = b1 > b0 + 1;
    return ev;
  }
  const u64 bs = static_cast<u64>(g.bin_size);
  const u64 rlo = static_cast<u64>(lo - g.origin);
  const u64 rhi = static_cast<u64>(hi - g.origin);
  const u64 b0 = rlo / bs, b1 = (rhi - 1) / bs;
  ev.b0 = static_cast<int32_t>(b0);
  if (b1 == b0) {
    ev.v0 = rhi - rlo;
    return ev;
  }
  ev.v0 = (b0 + 1) * bs - rlo;
  ev.b1 = static_cast<int32_t>(b1);
  ev.v1 = rhi - b1 * bs;
  ev.whole = b1 > b0 + 1;
  return ev;
}

// For i < tn, emit(i, carry + count(0) + ... + count(i)) (uint32): the
// block's warps take consecutive segments, the lanes consecutive bins,
// and a warp scan with shuffles carries the running count.  Every thread
// of the block calls it (it synchronises).
template <typename Count, typename Emit>
__device__ __forceinline__ void block_scan(int32_t tn, uint32_t carry,
                                           Count count, Emit emit,
                                           uint32_t* warp_sums) {
  const int nw = blockDim.x / 32;
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int64_t seg = ((static_cast<int64_t>(tn) + nw - 1) / nw + 31) & ~31LL;
  const int64_t a64 = w * seg;
  const int32_t a = static_cast<int32_t>(a64 < tn ? a64 : tn);
  const int32_t z = static_cast<int32_t>(a64 + seg < tn ? a64 + seg : tn);
  uint32_t sum = 0;
  for (int32_t i = a + lane; i < z; i += 32) {
    sum += static_cast<uint32_t>(count(i));
  }
  sum = __reduce_add_sync(kFull, sum);
  if (lane == 0) warp_sums[w] = sum;
  __syncthreads();
  uint32_t run = carry;
  for (int k = 0; k < w; ++k) run += warp_sums[k];
  for (int32_t i0 = a; i0 < z; i0 += 128) {
    uint32_t x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int32_t i = i0 + 32 * q + lane;
      x[q] = i < z ? static_cast<uint32_t>(count(i)) : 0u;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(kFull, x[q], d);
        if (lane >= d) x[q] += y;
      }
      const int32_t i = i0 + 32 * q + lane;
      if (i < z) emit(i, run + x[q]);
      run += __shfl_sync(kFull, x[q], 31);
    }
  }
}

// kRun reads from `first` ([0, 0), which adds nothing, at or past `last`)
template <int kRun_>
__device__ __forceinline__ void load_run(const int32_t* __restrict__ starts,
                                         const int32_t* __restrict__ ends,
                                         int64_t last, int64_t first, int vec,
                                         int32_t* s, int32_t* e) {
  if (vec && first + kRun_ <= last) {
    const int4* s4 = reinterpret_cast<const int4*>(starts + first);
    const int4* e4 = reinterpret_cast<const int4*>(ends + first);
#pragma unroll
    for (int q = 0; q < kRun_ / 4; ++q) {
      const int4 a = s4[q], b = e4[q];
      s[4 * q] = a.x; s[4 * q + 1] = a.y; s[4 * q + 2] = a.z;
      s[4 * q + 3] = a.w;
      e[4 * q] = b.x; e[4 * q + 1] = b.y; e[4 * q + 2] = b.z;
      e[4 * q + 3] = b.w;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kRun_; ++k) {
    const bool in = first + k < last;
    s[k] = in ? starts[first + k] : 0;
    e[k] = in ? ends[first + k] : 0;
  }
}

// Block (x, y) takes the chunks [x * runs, x * runs + runs) of
// kBlock * kRun reads and owns the tile of bins [y * tile, y * tile +
// tile).  `no_carry`: no partial of a block can reach 2^32 (its reads
// times bin_size is below it), so the shared-memory adds need not wait
// for the old value.
template <bool kNarrow>
__global__ void __launch_bounds__(kBlock, 2)
bin_overlap_kernel(const int32_t* __restrict__ starts,
                   const int32_t* __restrict__ ends, int64_t n, Bins g,
                   int32_t tile, int32_t runs, int vec, int no_carry,
                   u64* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t warp_sums[kBlock / 32];
  __shared__ uint32_t carry_total;
  __shared__ int32_t reach_lo, reach_hi;
  const int32_t t0 = static_cast<int32_t>(blockIdx.y) * tile;
  const int32_t tn = min(tile, g.n_bins - t0);
  uint32_t* part = smem;
  int32_t* cnt = reinterpret_cast<int32_t*>(smem + tile);
  const int64_t chunk = static_cast<int64_t>(kBlock) * kRun;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * runs * chunk;
  const int64_t last = min(n, first + runs * chunk);
  int32_t s[kRun], e[kRun];
  load_run<kRun>(starts, ends, last, first + threadIdx.x * kRun, vec, s, e);
  if (threadIdx.x == 0) {
    carry_total = 0;
    reach_lo = INT32_MAX;
    reach_hi = -1;
  }
  for (int32_t i = threadIdx.x; i < tn; i += blockDim.x) {
    part[i] = 0;
    cnt[i] = 0;
  }
  __syncthreads();
  uint32_t carry = 0;  // count differences before the tile
  bool counted = false;  // the thread made a count difference
  int32_t lo_bin = INT32_MAX, hi_bin = -1;  // the bins the reads reach
  auto add_part = [&](int32_t b, u64 v) {
    const int32_t i = b - t0;
    const uint32_t v_lo = static_cast<uint32_t>(v);
    if (no_carry) {
      atomicAdd(&part[i], v_lo);
      return;
    }
    const uint32_t old = atomicAdd(&part[i], v_lo);
    const u64 h = (v >> 32) + (old + v_lo < old ? 1u : 0u);
    if (h) atomicAdd(&out[b], h << 32);
  };
  auto add_count = [&](int32_t b, int32_t d) {
    if (b < t0) {
      carry += static_cast<uint32_t>(d);
    } else if (b - t0 < tn) {
      atomicAdd(&cnt[b - t0], d);
    }
  };
  // the lane's running partial: bin rb (-1: none) holds rv; a partial in
  // another bin hands it on with one atomic
  // the lane's window of two bins: rb holds rv0 and rb + 1 holds rv1, so
  // that sorted reads that straddle one edge add nothing until the window
  // moves; a sum is handed on with one atomic when it leaves the window
  int32_t rb = -2;
  u64 rv0 = 0, rv1 = 0;
  auto hand_on = [&](int32_t b, u64 v) {
    if (v && b >= t0 && b - t0 < tn) add_part(b, v);
  };
  for (int64_t base = first; base < last; base += chunk) {
    if (base != first) {
      load_run<kRun>(starts, ends, last, base + threadIdx.x * kRun, vec, s,
                     e);
    }
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const Events ev = read_events<kNarrow>(g, s[k], e[k]);
      if (ev.b0 < 0) continue;
      lo_bin = min(lo_bin, ev.b0);
      hi_bin = max(hi_bin, ev.b1 >= 0 ? ev.b1 : ev.b0);
      if (ev.b0 != rb) {
        hand_on(rb, rv0);
        if (ev.b0 == rb + 1) {
          rv0 = rv1;
        } else {
          hand_on(rb + 1, rv1);
          rv0 = 0;
        }
        rv1 = 0;
        rb = ev.b0;
      }
      rv0 += ev.v0;
      if (ev.b1 == rb + 1) {
        rv1 += ev.v1;
      } else if (ev.b1 >= 0) {
        hand_on(ev.b1, ev.v1);
      }
      if (ev.whole) {
        counted = true;
        add_count(ev.b0 + 1, 1);
        add_count(ev.b1, -1);
      }
    }
    // hand on the run's window, all lanes together: one atomic a bin for
    // the warp when every lane's window starts at the same bin (sorted
    // reads), else one a lane and bin.  A lane's sum is at most 2 kRun
    // partials of < 2^32 bases each.
    const int32_t b_0 = __shfl_sync(kFull, rb, 0);
    if (__all_sync(kFull, rb == b_0)) {
      const uint32_t low0 = __reduce_add_sync(
          kFull, static_cast<uint32_t>(rv0 & 0xFFFFFF));
      const uint32_t top0 = __reduce_add_sync(
          kFull, static_cast<uint32_t>(rv0 >> 24));
      const uint32_t low1 = __reduce_add_sync(
          kFull, static_cast<uint32_t>(rv1 & 0xFFFFFF));
      const uint32_t top1 = __reduce_add_sync(
          kFull, static_cast<uint32_t>(rv1 >> 24));
      if ((threadIdx.x & 31) == 0) {
        hand_on(b_0, low0 + (static_cast<u64>(top0) << 24));
        hand_on(b_0 + 1, low1 + (static_cast<u64>(top1) << 24));
      }
    } else {
      hand_on(rb, rv0);
      hand_on(rb + 1, rv1);
    }
    rb = -2;
    rv0 = 0;
    rv1 = 0;
  }
  carry = __reduce_add_sync(kFull, carry);
  lo_bin = __reduce_min_sync(kFull, lo_bin);
  hi_bin = __reduce_max_sync(kFull, hi_bin);
  if ((threadIdx.x & 31) == 0) {
    if (carry) atomicAdd(&carry_total, carry);
    if (hi_bin >= 0) {
      atomicMin(&reach_lo, lo_bin);
      atomicMax(&reach_hi, hi_bin);
    }
  }
  const bool any_count = __syncthreads_or(counted);
  // the tile's bins [ra, rz) that the block's reads reach: before ra no
  // count difference (a read before the tile makes ra 0), past rz none
  const int32_t ra = reach_hi < 0 ? 0 : min(max(reach_lo - t0, 0), tn);
  const int32_t rz = reach_hi < 0 ? 0 : max(min(reach_hi + 1 - t0, tn), ra);
  const u64 bin_size = static_cast<u64>(g.bin_size);
  auto flush = [&](int32_t i, uint32_t prefix) {
    const u64 v = part[i] + bin_size * prefix;
    if (v) atomicAdd(&out[t0 + i], v);
  };
  if (!any_count) {
    // no read of the block spans a whole bin (reads much shorter than
    // bins, as on a chromosome in 100 kb bins): the partials alone
    for (int32_t i = ra + threadIdx.x; i < rz; i += kBlock) flush(i, 0);
    return;
  }
  if (rz - ra <= 32) {
    // a few bins (sorted reads): the first warp scans them alone
    if (threadIdx.x < 32) {
      const int32_t i = ra + static_cast<int32_t>(threadIdx.x);
      uint32_t x = i < rz ? static_cast<uint32_t>(cnt[i]) : 0u;
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(kFull, x, d);
        if (threadIdx.x >= d) x += y;
      }
      if (i < rz) flush(i, carry_total + x);
    }
    return;
  }
  block_scan(
      rz - ra, carry_total, [&](int32_t i) { return cnt[ra + i]; },
      [&](int32_t i, uint32_t prefix) { flush(ra + i, prefix); }, warp_sums);
}

struct Plan {
  int tiles;    // tiles of bins (grid y)
  int tile;     // bins a tile
  int blocks;   // blocks a tile (grid x), each a run of chunks of the reads
};

// The grid for n reads over n_bins bins: tiles of at most what a block
// may hold in shared memory, and one wave of resident blocks cut into
// tiles x blocks, each block with the same number of chunks (a block
// with one chunk more than the others would double the time of a short
// run).  Also lets the kernel's blocks take all the shared memory a block
// may opt in to.
Plan plan_for(int64_t n, int32_t n_bins, int device) {
  Plan p{};
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess || optin <= 0) {
    cudaGetLastError();
    optin = 48 * 1024;
  }
  const int64_t per_tile = (optin - kStaticSmem) / kBytesPerBin;
  const int most = static_cast<int>(per_tile * kBytesPerBin);
  cudaFuncSetAttribute(bin_overlap_kernel<true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  cudaFuncSetAttribute(bin_overlap_kernel<false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  p.tiles = static_cast<int>((n_bins + per_tile - 1) / per_tile);
  p.tile = static_cast<int>((n_bins + p.tiles - 1) / p.tiles);
  const size_t smem = static_cast<size_t>(p.tile) * kBytesPerBin;
  const int64_t wave = static_cast<int64_t>(coral::sm_count(device)) *
      coral::resident_blocks(bin_overlap_kernel<true>, kBlock, smem);
  const int64_t chunk = static_cast<int64_t>(kBlock) * kRun;
  const int64_t chunks = std::max<int64_t>(1, (n + chunk - 1) / chunk);
  const int64_t most_blocks = std::max<int64_t>(1, wave / p.tiles);
  const int64_t runs = (chunks + most_blocks - 1) / most_blocks;
  p.blocks = static_cast<int>((chunks + runs - 1) / runs);
  return p;
}

}  // namespace

extern "C" {

// The plan for these sizes (see plan_for): out[0..3) = tiles, bins a
// tile, blocks a tile.  The caller keeps it and hands it to
// coral_bin_overlap, so that a launch asks the CUDA runtime nothing.
// Returns cudaGetLastError().
int coral_bin_overlap_plan(long long n, int n_bins, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = plan_for(n, n_bins, device);
  out[0] = p.tiles;
  out[1] = p.tile;
  out[2] = p.blocks;
  return static_cast<int>(cudaGetLastError());
}

// Launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (0 when the launch was accepted; a launch refused
// for its shared memory or its grid returns the error).  `out` holds
// n_bins 64-bit sums and is zeroed by the caller; tiles, tile and blocks
// are coral_bin_overlap_plan's for this device, n and n_bins.
int coral_bin_overlap(const void* starts, const void* ends, void* out,
                      long long n, long long origin, long long bin_size,
                      int n_bins, int tiles, int tile, int blocks,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n >= (1LL << 32) || tiles < 1 || blocks < 1 ||
      static_cast<long long>(tiles) * tile < n_bins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Bins g{origin, bin_size, origin + bin_size * n_bins, n_bins, 0, 0, 0};
  const bool narrow = bin_size < (1LL << 32) / n_bins;
  if (narrow) {
    int l = 0;
    while ((1LL << l) < bin_size) ++l;
    g.magic = static_cast<uint32_t>(
        (((1ULL << l) - static_cast<u64>(bin_size)) << 32) /
            static_cast<u64>(bin_size) + 1);
    g.sh1 = l < 1 ? l : 1;
    g.sh2 = l > 1 ? l - 1 : 0;
  }
  const int vec = coral::aligned(starts, 16) && coral::aligned(ends, 16);
  const int64_t chunk = static_cast<int64_t>(kBlock) * kRun;
  const int64_t chunks = std::max<int64_t>(1, (n + chunk - 1) / chunk);
  const int32_t runs = static_cast<int32_t>((chunks + blocks - 1) / blocks);
  const int no_carry =
      bin_size < (1LL << 32) / (static_cast<int64_t>(runs) * chunk);
  const size_t smem = static_cast<size_t>(tile) * kBytesPerBin;
  const auto kernel = narrow ? bin_overlap_kernel<true>
                             : bin_overlap_kernel<false>;
  kernel<<<dim3(blocks, tiles), kBlock, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
      n, g, tile, runs, vec, no_carry, static_cast<u64*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
