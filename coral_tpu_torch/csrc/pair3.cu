// Junction-predicate kernels over the packed v3 pair layout, for sm_90a.
//
// Layout (coral_tpu/ops/scoring.py, PACKED3_COL_ORDER): three int32
// columns per adjacent-alignment pair,
//   qgap = qj_start - qi_end               (read gap)
//   grr  = the same-strand reference jump  (pre-derived at pack time)
//   meta = (iogm + 1) << 1 | strand_diff   (interval + MAPQ gate resolved)
// Zero pad rows carry meta 0, which decodes to iogm -1 and never hits.
//
// The decision per pair (coral_tpu_torch/ops/scoring.py,
// pair_predicate_packed3):
//   hit = qgap + cutoff >= 0 && iogm >= 0
//         && (strand_diff || |qgap - grr| > max(gap_, 0.2 * |qgap|))
// evaluated exactly as the TPU kernels evaluate it: int32 arithmetic that
// wraps (done here through uint32, so no signed overflow is relied on),
// and the threshold in float32 (under JAX's promotion int32 * 0.2 is
// float32, and the int32 side of the comparison converts to float32).
// The host numpy engine works in int64/float64; the two agree wherever
// |qgap| < 2^24, which covers every read length.
//
// Both kernels read 12 B per pair and do ~15 integer/float operations on
// it, so they are bound by device-memory bandwidth (H100 SXM: 3.35 TB/s).
// Each thread takes four pairs per step through 16-byte loads when the
// three columns are 16-byte aligned (the wrapper passes `vec`), with a
// scalar loop for the tail and for unaligned views.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Histogram bin (iogm) of a pair that hits, -1 for a pair that does not.
__device__ __forceinline__ int32_t pair3_bin(int32_t qgap, int32_t grr,
                                             int32_t meta, int32_t cutoff,
                                             float gap) {
  const int32_t iogm = (meta >> 1) - 1;
  const int32_t sdiff = meta & 1;
  const int32_t qc = static_cast<int32_t>(static_cast<uint32_t>(qgap) +
                                          static_cast<uint32_t>(cutoff));
  const uint32_t ud = static_cast<uint32_t>(qgap) - static_cast<uint32_t>(grr);
  // |x| of an int32 wraps at INT32_MIN, as jnp.abs and torch.abs do
  const int32_t ad = static_cast<int32_t>(
      static_cast<int32_t>(ud) < 0 ? 0u - ud : ud);
  const uint32_t uq = static_cast<uint32_t>(qgap);
  const int32_t aq = static_cast<int32_t>(qgap < 0 ? 0u - uq : uq);
  const float thr = fmaxf(gap, __fmul_rn(__int2float_rn(aq), 0.2f));
  const bool hit = qc >= 0 && iogm >= 0 &&
                   (sdiff != 0 || __int2float_rn(ad) > thr);
  return hit ? iogm : -1;
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
// blocks run in no order, so each block counts into a shared-memory
// histogram (n_int <= 8190 bins = 32 KB) and then adds each non-zero bin
// into the output with one global atomic.  Integer adds commute, so the
// counts are exact whatever the order.  `out` is zeroed by the caller.
__global__ void __launch_bounds__(kThreads)
pair3_support_kernel(const int32_t* __restrict__ qgap,
                     const int32_t* __restrict__ grr,
                     const int32_t* __restrict__ meta, int64_t n,
                     int32_t n_int, int32_t cutoff, float gap, int vec,
                     int32_t* __restrict__ out) {
  extern __shared__ int32_t hist[];
  for (int b = threadIdx.x; b < n_int; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const uint32_t bins = static_cast<uint32_t>(n_int);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    const int4* q4 = reinterpret_cast<const int4*>(qgap);
    const int4* g4 = reinterpret_cast<const int4*>(grr);
    const int4* m4 = reinterpret_cast<const int4*>(meta);
    for (int64_t i = tid; i < n4; i += stride) {
      const int4 q = q4[i];
      const int4 g = g4[i];
      const int4 m = m4[i];
      const int32_t b0 = pair3_bin(q.x, g.x, m.x, cutoff, gap);
      const int32_t b1 = pair3_bin(q.y, g.y, m.y, cutoff, gap);
      const int32_t b2 = pair3_bin(q.z, g.z, m.z, cutoff, gap);
      const int32_t b3 = pair3_bin(q.w, g.w, m.w, cutoff, gap);
      // a miss is -1, which is out of range as unsigned, as is a gate
      // index past the table (the TPU kernel drops both)
      if (static_cast<uint32_t>(b0) < bins) atomicAdd(&hist[b0], 1);
      if (static_cast<uint32_t>(b1) < bins) atomicAdd(&hist[b1], 1);
      if (static_cast<uint32_t>(b2) < bins) atomicAdd(&hist[b2], 1);
      if (static_cast<uint32_t>(b3) < bins) atomicAdd(&hist[b3], 1);
    }
    done = n4 << 2;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    const int32_t b = pair3_bin(qgap[i], grr[i], meta[i], cutoff, gap);
    if (static_cast<uint32_t>(b) < bins) atomicAdd(&hist[b], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_int; b += blockDim.x) {
    const int32_t c = hist[b];
    if (c) atomicAdd(&out[b], c);
  }
}

bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

// Blocks for a grid-stride loop over `work` items, capped at `per_sm`
// resident blocks per SM.
int grid_for(int64_t work, int device, int per_sm) {
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = aligned(qgap, 16) && aligned(grr, 16) && aligned(meta, 16);
  const int blocks = grid_for(vec ? (n + 3) / 4 : n, device, 4);
  const size_t smem = static_cast<size_t>(n_int) * sizeof(int32_t);
  pair3_support_kernel<<<blocks, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qgap), static_cast<const int32_t*>(grr),
      static_cast<const int32_t*>(meta), n, n_int, cutoff, gap, vec,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* coral_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
