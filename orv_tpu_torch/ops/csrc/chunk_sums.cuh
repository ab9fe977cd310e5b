// The second pass of the adaLN backward kernels' per-row sums over S.
//
// The TPU kernels accumulate [R, D] sums across the sequential grid steps
// of S. CUDA blocks run in no order, so each block of a backward kernel
// writes the partial sum of its chunk of rows, part [R, n_chunks, M] f32,
// and this kernel adds the chunks in a fixed order: out [R, M] f32. The
// sum is the same from run to run.

#pragma once

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
sum_chunks_kernel(const float* __restrict__ part, float* __restrict__ out, int n_chunks, int m) {
  const int r = blockIdx.y;
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < m; c += gridDim.x * blockDim.x) {
    float t = 0.0f;
    for (int k = 0; k < n_chunks; ++k) t += part[((size_t)r * n_chunks + k) * m + c];
    out[(size_t)r * m + c] = t;
  }
}

inline cudaError_t launch_sum_chunks(const float* part, float* out, int r, int n_chunks, int m,
                                     cudaStream_t stream) {
  dim3 grid((m + 255) / 256, r);
  sum_chunks_kernel<<<grid, 256, 0, stream>>>(part, out, n_chunks, m);
  return cudaGetLastError();
}

}  // namespace
