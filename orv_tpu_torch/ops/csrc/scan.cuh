// One-block exclusive prefix sum over int32, shared by voxelize.cu and
// gaussian_raster.cu (names in an anonymous namespace: one copy per source).
//
// The factory's scans are short (a frame's points or gaussians, at most a
// few hundred thousand), so one block of 1024 threads walks the array in
// tiles of 1024 consecutive elements (coalesced), scans each tile with warp
// shuffles and carries the tile's total to the next.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 1024;

// out[i] = sum of in[0..i); *total = sum of in[0..n). Launch <<<1, 1024>>>.
__global__ void __launch_bounds__(kScanThreads)
exclusive_scan_kernel(const int* __restrict__ in, int n, int* __restrict__ out,
                      int* __restrict__ total) {
  __shared__ int warp_sums[32];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  int carry = 0;
  for (int base = 0; base < n; base += kScanThreads) {
    const int i = base + t;
    const int x = i < n ? in[i] : 0;
    int v = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (lane == 31) warp_sums[w] = v;
    __syncthreads();
    if (w == 0) {
      int s = warp_sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += y;
      }
      warp_sums[lane] = s;
    }
    __syncthreads();
    if (i < n) out[i] = carry + v - x + (w ? warp_sums[w - 1] : 0);
    carry += warp_sums[31];
    __syncthreads();  // warp_sums is rewritten by the next tile
  }
  if (t == 0) *total = carry;
}

}  // namespace
