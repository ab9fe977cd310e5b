// The device-wide exclusive scan of scan.cuh behind a C entry point, so that
// the tests can hold it against torch.cumsum on its own (ops/scan.py). The
// data factory's kernels call the same scan inside their own entry points
// (voxelize.cu, gaussian_raster.cu).

#include <cuda_runtime.h>

#include "scan.cuh"

// in, out [n] int32; total [1] int32; block_sums: scratch of
// ceil(n / 2048) int32 (ops/scan.py:scan_blocks).
extern "C" int orv_exclusive_scan(const void* in, int n, void* out, void* total,
                                  void* block_sums, void* stream) {
  exclusive_scan((const int*)in, n, (int*)out, (int*)total, (int*)block_sums,
                 (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
