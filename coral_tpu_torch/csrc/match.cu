// K9: the pairwise breakpoint-match matrix of one clustering group, for
// sm_90a.  Replaces _match_kernel (coral_tpu/ops/pallas_kernels.py:609).
//
//   M[i, j] = |p1_i - p1_j| < cutoff && |p2_i - p2_j| < cutoff
// for int32 positions p1, p2 of n breakpoints, any n (the TPU kernel pads
// to a multiple of 128; here the ragged edge is masked).  One byte per
// cell: the host's first-fit rule only asks which cells are non-zero.
//
// The differences are the true ones: |a - b| is taken as max - min in
// uint32, which holds every difference of two int32 exactly, where the
// TPU kernel's int32 subtraction wraps once |a - b| >= 2^31.  So this
// kernel agrees with the host clustering (int64) on every int32 input,
// and with the TPU kernel wherever that one does not wrap, which
// includes all non-negative genome coordinates.
//
// What bounds it: n^2 bytes written (16.8 MB at the group cap of 4096,
// 5 us at 3.35 TB/s) against about 9 integer operations a cell (9 us at
// 16.75 T/s): operations, narrowly.  A block of 8 warps covers 128
// columns by 64 rows: a lane keeps the positions of its 4 neighbouring
// columns in registers, its warp walks 8 rows (their positions are one
// broadcast load each), and a lane writes its 4 cells of a row as one
// 4-byte store, a warp 128 contiguous bytes, when n is a multiple of 4.

#include "pair_common.cuh"

namespace {

using coral::aligned;

constexpr int kWarps = 8;
constexpr int kColsPerLane = 4;
constexpr int kTileCols = 32 * kColsPerLane;   // 128
constexpr int kRowsPerWarp = 8;
constexpr int kTileRows = kWarps * kRowsPerWarp;   // 64

// |a - b| < cutoff on the true difference; cutoff >= 0
__device__ __forceinline__ bool within(int32_t a, int32_t b,
                                       uint32_t cutoff) {
  const uint32_t hi = static_cast<uint32_t>(max(a, b));
  const uint32_t lo = static_cast<uint32_t>(min(a, b));
  return hi - lo < cutoff;
}

__global__ void __launch_bounds__(32 * kWarps)
match_matrix_kernel(const int32_t* __restrict__ p1,
                    const int32_t* __restrict__ p2, int32_t n,
                    uint32_t cutoff, int vec, uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int32_t col0 = blockIdx.x * kTileCols + lane * kColsPerLane;
  const int32_t row0 = blockIdx.y * kTileRows + warp * kRowsPerWarp;
  if (col0 >= n || row0 >= n) return;
  int32_t c1[kColsPerLane], c2[kColsPerLane];
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) {
    const bool live = col0 + k < n;
    c1[k] = live ? p1[col0 + k] : 0;
    c2[k] = live ? p2[col0 + k] : 0;
  }
  const int32_t row_end = min(row0 + kRowsPerWarp, n);
  for (int32_t r = row0; r < row_end; ++r) {
    const int32_t a1 = p1[r];
    const int32_t a2 = p2[r];
    uint8_t m[kColsPerLane];
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) {
      m[k] = within(a1, c1[k], cutoff) && within(a2, c2[k], cutoff);
    }
    uint8_t* cell = out + static_cast<int64_t>(r) * n + col0;
    if (vec) {
      // n is a multiple of 4 and col0 < n, so all four columns are live
      *reinterpret_cast<uchar4*>(cell) = make_uchar4(m[0], m[1], m[2], m[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kColsPerLane; ++k) {
        if (col0 + k < n) cell[k] = m[k];
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (0 when the launch was accepted).  `out` holds n * n
// bytes, row-major; every cell is written.  n >= 1, cutoff >= 0.
int coral_match_matrix(const void* p1, const void* p2, void* out, int n,
                       int cutoff, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = n % 4 == 0 && aligned(out, 4);
  const dim3 grid((n + kTileCols - 1) / kTileCols,
                  (n + kTileRows - 1) / kTileRows);
  match_matrix_kernel<<<grid, 32 * kWarps, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(p1), static_cast<const int32_t*>(p2), n,
      static_cast<uint32_t>(cutoff), vec, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
