// Junction-predicate kernels over the packed v2 pair layout, for sm_90a.
//
// Layout (coral_tpu/ops/scoring.py, PACKED2_COL_ORDER): four int32
// columns per adjacent-alignment pair,
//   qgap = qj_start - qi_end      (read gap)
//   r2_i, r1_j                    (the facing reference ends)
//   meta = (iog + 1) << 18 | mapq_i << 10 | plus_i << 9 | mapq_j << 1
//          | plus_j               (iog: the interval gate, resolved at pack
//                                  time; 13 bits, so at most 8190 intervals)
// Zero pad rows carry meta 0, which decodes to iog -1 and never hits.
//
// What v3 resolves at pack time happens here, per pair: the MAPQ gate
//   gate = iog >= 0 && mapq_i >= min_mapq && mapq_j >= min_mapq
// and the same-strand reference jump, in wrapping int32 as on the TPU,
//   grr = plus_j ? r1_j - r2_i : r2_i - r1_j.
// The decision is junction_hit (pair_common.cuh), the chain K1-K4 share.
// `iog` goes out as it was packed: unlike v3's iogm it is not gated by
// MAPQ, and a hit bins by it.
//
// K5 reads 16 B and writes 5 B per pair, K6 reads 16 B per pair and writes
// the counts; both do ~30 integer/float operations on them, so they are
// bound by device-memory bandwidth (H100 SXM: 3.35 TB/s).  Each thread
// takes four pairs per step through 16-byte loads when the columns are
// 16-byte aligned (the entry passes `vec`), with a scalar loop for the
// tail and for unaligned views.

#include "pair_common.cuh"

namespace {

using coral::aligned;
using coral::grid_for;
using coral::kThreads;
using coral::wrap_sub;

// hit of one pair; *iog gets the packed interval gate (-1: none)
__device__ __forceinline__ bool pair2_decide(int32_t qgap, int32_t r2_i,
                                             int32_t r1_j, int32_t meta,
                                             int32_t cutoff, int32_t min_mapq,
                                             float gap, int32_t* iog) {
  const int32_t g = ((meta >> 18) & 0x1FFF) - 1;
  const int32_t mapq_i = (meta >> 10) & 0xFF;
  const int32_t mapq_j = (meta >> 1) & 0xFF;
  const bool plus_i = ((meta >> 9) & 1) != 0;
  const bool plus_j = (meta & 1) != 0;
  const int32_t grr = plus_j ? wrap_sub(r1_j, r2_i) : wrap_sub(r2_i, r1_j);
  *iog = g;
  return coral::junction_hit(
      qgap, grr, plus_i != plus_j,
      g >= 0 && mapq_i >= min_mapq && mapq_j >= min_mapq, cutoff, gap);
}

// Histogram bin (iog) of a pair that hits, -1 for a pair that does not.
__device__ __forceinline__ int32_t pair2_bin(int32_t qgap, int32_t r2_i,
                                             int32_t r1_j, int32_t meta,
                                             int32_t cutoff, int32_t min_mapq,
                                             float gap) {
  int32_t iog;
  return pair2_decide(qgap, r2_i, r1_j, meta, cutoff, min_mapq, gap, &iog)
             ? iog : -1;
}

// K5: hit mask and interval gate.  Replaces _pair2_kernel
// (coral_tpu/ops/pallas_kernels.py:238).
__global__ void __launch_bounds__(kThreads)
pair2_hitmask_kernel(const int32_t* __restrict__ qgap,
                     const int32_t* __restrict__ r2_i,
                     const int32_t* __restrict__ r1_j,
                     const int32_t* __restrict__ meta,
                     uint8_t* __restrict__ hit, int32_t* __restrict__ iog,
                     int64_t n, int32_t cutoff, int32_t min_mapq, float gap,
                     int vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    const int4* q4 = reinterpret_cast<const int4*>(qgap);
    const int4* a4 = reinterpret_cast<const int4*>(r2_i);
    const int4* b4 = reinterpret_cast<const int4*>(r1_j);
    const int4* m4 = reinterpret_cast<const int4*>(meta);
    uchar4* h4 = reinterpret_cast<uchar4*>(hit);
    int4* g4 = reinterpret_cast<int4*>(iog);
    for (int64_t i = tid; i < n4; i += stride) {
      const int4 q = q4[i];
      const int4 a = a4[i];
      const int4 b = b4[i];
      const int4 m = m4[i];
      uchar4 h;
      int4 g;
      h.x = pair2_decide(q.x, a.x, b.x, m.x, cutoff, min_mapq, gap, &g.x);
      h.y = pair2_decide(q.y, a.y, b.y, m.y, cutoff, min_mapq, gap, &g.y);
      h.z = pair2_decide(q.z, a.z, b.z, m.z, cutoff, min_mapq, gap, &g.z);
      h.w = pair2_decide(q.w, a.w, b.w, m.w, cutoff, min_mapq, gap, &g.w);
      h4[i] = h;
      g4[i] = g;
    }
    done = n4 << 2;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    int32_t g;
    hit[i] = pair2_decide(qgap[i], r2_i[i], r1_j[i], meta[i], cutoff,
                          min_mapq, gap, &g);
    iog[i] = g;
  }
}

// K6: K5 fused with the per-interval support histogram of
// hit & (iog == k), k < n_int.  Replaces _pair_hist2_kernel
// (coral_tpu/ops/pallas_kernels.py:282).  The TPU kernel carries its
// counts in VMEM across a sequential grid and loops over the bins; here,
// as in K2, a block counts into a shared-memory histogram (n_int <= 8190
// bins = 32 KB) and then adds each non-zero bin into the output with one
// global atomic, and, as in K4, a warp issues one shared-memory atomic per
// distinct bin among its lanes.  For that the loops below run a
// warp-uniform number of steps: a lane past the end carries no pair and
// counts nothing.  A gate index past n_int is dropped, as the TPU kernel's
// range(n_int) loop drops it.  Integer adds commute, so the counts are
// exact whatever the order.  `out` is zeroed by the caller.
__global__ void __launch_bounds__(kThreads)
pair2_support_kernel(const int32_t* __restrict__ qgap,
                     const int32_t* __restrict__ r2_i,
                     const int32_t* __restrict__ r1_j,
                     const int32_t* __restrict__ meta, int64_t n,
                     int32_t n_int, int32_t cutoff, int32_t min_mapq,
                     float gap, int vec, int32_t* __restrict__ out) {
  extern __shared__ int32_t hist[];
  for (int b = threadIdx.x; b < n_int; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const uint32_t bins = static_cast<uint32_t>(n_int);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    const int4* q4 = reinterpret_cast<const int4*>(qgap);
    const int4* a4 = reinterpret_cast<const int4*>(r2_i);
    const int4* b4 = reinterpret_cast<const int4*>(r1_j);
    const int4* m4 = reinterpret_cast<const int4*>(meta);
    for (int64_t base = first; base < n4; base += stride) {
      const int64_t i = base + threadIdx.x;
      int32_t b0 = -1, b1 = -1, b2 = -1, b3 = -1;
      if (i < n4) {
        const int4 q = q4[i];
        const int4 a = a4[i];
        const int4 b = b4[i];
        const int4 m = m4[i];
        b0 = pair2_bin(q.x, a.x, b.x, m.x, cutoff, min_mapq, gap);
        b1 = pair2_bin(q.y, a.y, b.y, m.y, cutoff, min_mapq, gap);
        b2 = pair2_bin(q.z, a.z, b.z, m.z, cutoff, min_mapq, gap);
        b3 = pair2_bin(q.w, a.w, b.w, m.w, cutoff, min_mapq, gap);
      }
      coral::warp_count(hist, b0, bins);
      coral::warp_count(hist, b1, bins);
      coral::warp_count(hist, b2, bins);
      coral::warp_count(hist, b3, bins);
    }
    done = n4 << 2;
  }
  for (int64_t base = done + first; base < n; base += stride) {
    const int64_t i = base + threadIdx.x;
    const int32_t b = i < n ? pair2_bin(qgap[i], r2_i[i], r1_j[i], meta[i],
                                        cutoff, min_mapq, gap)
                            : -1;
    coral::warp_count(hist, b, bins);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_int; b += blockDim.x) {
    const int32_t c = hist[b];
    if (c) atomicAdd(&out[b], c);
  }
}

}  // namespace

extern "C" {

// Each entry launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() (0 when the launch was accepted).

int coral_pair2_hitmask(const void* qgap, const void* r2_i, const void* r1_j,
                        const void* meta, void* hit, void* iog, long long n,
                        int cutoff, int min_mapq, float gap, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = aligned(qgap, 16) && aligned(r2_i, 16) &&
                  aligned(r1_j, 16) && aligned(meta, 16) &&
                  aligned(hit, 4) && aligned(iog, 16);
  const int blocks = grid_for(vec ? (n + 3) / 4 : n, device, 16);
  pair2_hitmask_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qgap), static_cast<const int32_t*>(r2_i),
      static_cast<const int32_t*>(r1_j), static_cast<const int32_t*>(meta),
      static_cast<uint8_t*>(hit), static_cast<int32_t*>(iog), n, cutoff,
      min_mapq, gap, vec);
  return static_cast<int>(cudaGetLastError());
}

int coral_pair2_support(const void* qgap, const void* r2_i, const void* r1_j,
                        const void* meta, void* out, long long n, int n_int,
                        int cutoff, int min_mapq, float gap, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = aligned(qgap, 16) && aligned(r2_i, 16) &&
                  aligned(r1_j, 16) && aligned(meta, 16);
  const int blocks = grid_for(vec ? (n + 3) / 4 : n, device, 4);
  const size_t smem = static_cast<size_t>(n_int) * sizeof(int32_t);
  pair2_support_kernel<<<blocks, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qgap), static_cast<const int32_t*>(r2_i),
      static_cast<const int32_t*>(r1_j), static_cast<const int32_t*>(meta),
      n, n_int, cutoff, min_mapq, gap, vec, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
