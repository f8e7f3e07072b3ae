// Junction-predicate kernels over the packed v3 pair layout, for sm_90a.
//
// Layout (coral_tpu/ops/scoring.py, PACKED3_COL_ORDER): three int32
// columns per adjacent-alignment pair,
//   qgap = qj_start - qi_end               (read gap)
//   grr  = the same-strand reference jump  (pre-derived at pack time)
//   meta = (iogm + 1) << 1 | strand_diff   (interval + MAPQ gate resolved)
// Zero pad rows carry meta 0, which decodes to iogm -1 and never hits.
//
// The decision per pair is junction_hit (pair_common.cuh) with the gate
// iogm >= 0.
//
// K1 and K2 read 12 B per pair and do ~15 integer/float operations on
// it, so they are bound by device-memory bandwidth (H100 SXM: 3.35 TB/s).
// K7 reads the same 12 B on K1's grid with no decision at all: it is the
// measuring stick K1 and K2 are read against.
// Each thread takes four pairs per step through 16-byte loads when the
// three columns are 16-byte aligned (the wrapper passes `vec`), with a
// scalar loop for the tail and for unaligned views.

#include "pair_common.cuh"

namespace {

using coral::aligned;
using coral::grid_for;
using coral::kThreads;

// Histogram bin (iogm) of a pair that hits, -1 for a pair that does not.
__device__ __forceinline__ int32_t pair3_bin(int32_t qgap, int32_t grr,
                                             int32_t meta, int32_t cutoff,
                                             float gap) {
  const int32_t iogm = (meta >> 1) - 1;
  return coral::junction_hit(qgap, grr, (meta & 1) != 0, iogm >= 0, cutoff,
                             gap) ? iogm : -1;
}

// K1: the hit mask.  Replaces _pair3_kernel
// (coral_tpu/ops/pallas_kernels.py:378).  Writes 1 B per pair.
__global__ void __launch_bounds__(kThreads)
pair3_hitmask_kernel(const int32_t* __restrict__ qgap,
                     const int32_t* __restrict__ grr,
                     const int32_t* __restrict__ meta,
                     uint8_t* __restrict__ hit, int64_t n, int32_t cutoff,
                     float gap, int vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    const int4* q4 = reinterpret_cast<const int4*>(qgap);
    const int4* g4 = reinterpret_cast<const int4*>(grr);
    const int4* m4 = reinterpret_cast<const int4*>(meta);
    uchar4* h4 = reinterpret_cast<uchar4*>(hit);
    for (int64_t i = tid; i < n4; i += stride) {
      const int4 q = q4[i];
      const int4 g = g4[i];
      const int4 m = m4[i];
      uchar4 h;
      h.x = pair3_bin(q.x, g.x, m.x, cutoff, gap) >= 0;
      h.y = pair3_bin(q.y, g.y, m.y, cutoff, gap) >= 0;
      h.z = pair3_bin(q.z, g.z, m.z, cutoff, gap) >= 0;
      h.w = pair3_bin(q.w, g.w, m.w, cutoff, gap) >= 0;
      h4[i] = h;
    }
    done = n4 << 2;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    hit[i] = pair3_bin(qgap[i], grr[i], meta[i], cutoff, gap) >= 0;
  }
}

// K2: the predicate fused with the per-interval support histogram.
// Replaces _pair_hist3_kernel (coral_tpu/ops/pallas_kernels.py:473).  The
// TPU kernel carries its counts in VMEM across a sequential grid; CUDA
// blocks run in no order, so the body is coral::support_body
// (pair_common.cuh, where its design and the numbers that chose it are):
// counts in shared memory, added into `out` once a block is done, after
// the entry's memset.  A gate index past n_int is dropped, as the TPU
// kernel's range(n_int) loop drops it.
struct Pair3Bin {
  int32_t cutoff;
  float gap;
  __device__ __forceinline__ int32_t operator()(const int32_t* p) const {
    return pair3_bin(p[0], p[1], p[2], cutoff, gap);
  }
};

__global__ void __launch_bounds__(kThreads)
pair3_support_kernel(coral::Columns<3> cols, int64_t n, int32_t n_int,
                     Pair3Bin bin, int vec, int32_t* __restrict__ out) {
  extern __shared__ int32_t hist[];
  coral::support_body(cols, n, n_int, vec, bin, hist, out);
}

// K7: the zero-compute copy control.  Replaces _stream_control_kernel
// (coral_tpu/ops/pallas_kernels.py:420): qgap + grr + meta (wrapping) on
// K1's grid and block, reading K1's three columns and writing one int32.
__device__ __forceinline__ int32_t wrap_add3(int32_t a, int32_t b, int32_t c) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b) +
                              static_cast<uint32_t>(c));
}

__global__ void __launch_bounds__(kThreads)
stream_control_kernel(const int32_t* __restrict__ qgap,
                      const int32_t* __restrict__ grr,
                      const int32_t* __restrict__ meta,
                      int32_t* __restrict__ out, int64_t n, int vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    const int4* q4 = reinterpret_cast<const int4*>(qgap);
    const int4* g4 = reinterpret_cast<const int4*>(grr);
    const int4* m4 = reinterpret_cast<const int4*>(meta);
    int4* o4 = reinterpret_cast<int4*>(out);
    for (int64_t i = tid; i < n4; i += stride) {
      const int4 q = q4[i];
      const int4 g = g4[i];
      const int4 m = m4[i];
      o4[i] = make_int4(wrap_add3(q.x, g.x, m.x), wrap_add3(q.y, g.y, m.y),
                        wrap_add3(q.z, g.z, m.z), wrap_add3(q.w, g.w, m.w));
    }
    done = n4 << 2;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    out[i] = wrap_add3(qgap[i], grr[i], meta[i]);
  }
}

}  // namespace

extern "C" {

// Each entry launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() (0 when the launch was accepted).

int coral_pair3_hitmask(const void* qgap, const void* grr, const void* meta,
                        void* hit, long long n, int cutoff, float gap,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = aligned(qgap, 16) && aligned(grr, 16) &&
                  aligned(meta, 16) && aligned(hit, 4);
  const int blocks = grid_for(vec ? (n + 3) / 4 : n, device, 16);
  pair3_hitmask_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qgap), static_cast<const int32_t*>(grr),
      static_cast<const int32_t*>(meta), static_cast<uint8_t*>(hit), n,
      cutoff, gap, vec);
  return static_cast<int>(cudaGetLastError());
}

int coral_pair3_support(const void* qgap, const void* grr, const void* meta,
                        void* out, long long n, int n_int, int cutoff,
                        float gap, int device, void* stream) {
  if (n < 0 || n_int < 1 || n_int > coral::kSupportBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = aligned(qgap, 16) && aligned(grr, 16) && aligned(meta, 16);
  // `out`, and the shared-memory histogram of a block
  const size_t bytes = static_cast<size_t>(n_int) * sizeof(int32_t);
  err = cudaMemsetAsync(out, 0, bytes, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  pair3_support_kernel<<<coral::support_grid(n, n_int, vec, device),
                         kThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      coral::Columns<3>{{static_cast<const int32_t*>(qgap),
                         static_cast<const int32_t*>(grr),
                         static_cast<const int32_t*>(meta)}},
      n, n_int, Pair3Bin{cutoff, gap}, vec, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

int coral_stream_control(const void* qgap, const void* grr, const void* meta,
                         void* out, long long n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = aligned(qgap, 16) && aligned(grr, 16) &&
                  aligned(meta, 16) && aligned(out, 16);
  const int blocks = grid_for(vec ? (n + 3) / 4 : n, device, 16);
  stream_control_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qgap), static_cast<const int32_t*>(grr),
      static_cast<const int32_t*>(meta), static_cast<int32_t*>(out), n, vec);
  return static_cast<int>(cudaGetLastError());
}

const char* coral_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
