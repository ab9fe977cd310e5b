// Point-cloud voxelization (hard and dynamic) for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the counterpart of the JAX package's host
// C++ op orv_tpu/ops/native/voxelize.cpp (dynamic_voxelize :59-91,
// hard_voxelize :94-137), which the data factory runs per frame
// (prepare_dataset.py:points_to_voxels). Same observable semantics:
//   - a point's cell is floor((p - lo) / vs) in f32, the grid round((hi - lo)
//     / vs) in f32 (computed by the wrapper); a point outside the grid gets
//     (-1, -1, -1); coordinates come out reversed (z, y, x);
//   - hard mode: voxel ids first come, first served in input order, later
//     new voxels dropped past max_voxels, a voxel keeps its first max_points
//     points.
//
// Bound on the H100: bytes (each point read once or twice, a voxel written
// once; a handful of integer operations a point). Design: the C++ walks the
// points serially through a hash map; here
//   1. voxel_keys_kernel, one thread a point: its cell, its linear key
//      (LLONG_MAX outside the grid) and a cleared head flag;
//   2. the wrapper sorts the keys stably on the device (torch.sort), which
//      groups each voxel's points in input order;
//   3. voxel_heads_kernel marks, in input order, the first point of each run
//      of equal keys, and an exclusive scan over those marks gives each
//      voxel its id (the rank of its first point), and the voxel count;
//   4. the wrapper allocates the outputs by that count (not max_voxels x
//      max_points), and voxel_scatter_kernel, one thread a run, copies the
//      run's first max_points points into their slots and zero-fills the
//      rest of the row.
// The points' cells are computed with IEEE division and floorf, so with no
// contraction possible (a subtraction then a division) they are the C++'s
// bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr long long kInvalid = 0x7fffffffffffffffLL;

struct Grid {
  float vs[3];
  float lo[3];
  int dim[3];  // x, y, z cells
};

__global__ void __launch_bounds__(256)
voxel_keys_kernel(const float* __restrict__ pts, int n, int nf, Grid g,
                  int* __restrict__ coors, long long* __restrict__ keys,
                  int* __restrict__ head) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* p = pts + (long long)i * nf;
  int c[3];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    // compared as a float: a NaN or a cell past int range is outside
    const float f = floorf(__fdiv_rn(__fsub_rn(p[j], g.lo[j]), g.vs[j]));
    if (!(f >= 0.0f && f < (float)g.dim[j])) ok = false;
    c[2 - j] = ok ? (int)f : -1;  // reversed (z, y, x)
  }
  int* out = coors + 3LL * i;
  if (ok) {
    out[0] = c[0];
    out[1] = c[1];
    out[2] = c[2];
    keys[i] = ((long long)c[0] * g.dim[1] + c[1]) * g.dim[0] + c[2];
  } else {
    out[0] = out[1] = out[2] = -1;
    keys[i] = kInvalid;
  }
  head[i] = 0;
}

// skeys, perm: the keys sorted stably and their input indices.
__global__ void __launch_bounds__(256)
voxel_heads_kernel(const long long* __restrict__ skeys, const long long* __restrict__ perm, int n,
                   int* __restrict__ head) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long k = skeys[i];
  if (k != kInvalid && (i == 0 || skeys[i - 1] != k)) head[perm[i]] = 1;
}

__global__ void __launch_bounds__(256)
voxel_scatter_kernel(const float* __restrict__ pts, int nf, const long long* __restrict__ skeys,
                     const long long* __restrict__ perm, const int* __restrict__ vid_of,
                     const int* __restrict__ coors_pp, int n, int max_points, int max_voxels,
                     float* __restrict__ voxels, int* __restrict__ coors,
                     int* __restrict__ nppv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long k = skeys[i];
  if (k == kInvalid || (i > 0 && skeys[i - 1] == k)) return;  // not a run's first point
  const long long first = perm[i];
  const int vid = vid_of[first];
  if (vid >= max_voxels) return;
  float* row = voxels + (long long)vid * max_points * nf;
  int cnt = 0;
  for (int j = i; j < n && cnt < max_points && skeys[j] == k; ++j, ++cnt) {
    const float* src = pts + perm[j] * nf;
    for (int f = 0; f < nf; ++f) row[cnt * nf + f] = src[f];
  }
  for (int e = cnt * nf; e < max_points * nf; ++e) row[e] = 0.0f;
  for (int d = 0; d < 3; ++d) coors[3LL * vid + d] = coors_pp[3 * first + d];
  nppv[vid] = cnt;
}

inline unsigned blocks_for(int n) { return (unsigned)((n + 255) / 256); }

Grid make_grid(const float* vs, const float* lo, const int* dim) {
  Grid g;
  for (int j = 0; j < 3; ++j) {
    g.vs[j] = vs[j];
    g.lo[j] = lo[j];
    g.dim[j] = dim[j];
  }
  return g;
}

}  // namespace

// points [n, nf] f32 (xyz first); vs, lo: 3 floats, dim: 3 ints (host
// memory); out coors [n, 3] int32, keys [n] int64, head [n] int32.
extern "C" int orv_voxel_keys(const void* points, int n, int nf, const float* vs, const float* lo,
                              const int* dim, void* coors, void* keys, void* head, void* stream) {
  if (n > 0) {
    voxel_keys_kernel<<<blocks_for(n), 256, 0, (cudaStream_t)stream>>>(
        (const float*)points, n, nf, make_grid(vs, lo, dim), (int*)coors, (long long*)keys,
        (int*)head);
  }
  return (int)cudaGetLastError();
}

// After the stable sort: head flags in input order, then each point's voxel
// id (an exclusive scan; valid at the runs' first points) and the voxel
// count in total[0].
extern "C" int orv_voxel_number(const void* skeys, const void* perm, int n, void* head,
                                void* vid_of, void* total, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    voxel_heads_kernel<<<blocks_for(n), 256, 0, s>>>((const long long*)skeys,
                                                     (const long long*)perm, n, (int*)head);
  }
  exclusive_scan_kernel<<<1, kScanThreads, 0, s>>>((const int*)head, n, (int*)vid_of,
                                                   (int*)total);
  return (int)cudaGetLastError();
}

// voxels [min(count, max_voxels), max_points, nf], coors [.., 3], nppv [..].
extern "C" int orv_voxel_scatter(const void* points, int nf, const void* skeys, const void* perm,
                                 const void* vid_of, const void* coors_pp, int n, int max_points,
                                 int max_voxels, void* voxels, void* coors, void* nppv,
                                 void* stream) {
  if (n > 0) {
    voxel_scatter_kernel<<<blocks_for(n), 256, 0, (cudaStream_t)stream>>>(
        (const float*)points, nf, (const long long*)skeys, (const long long*)perm,
        (const int*)vid_of, (const int*)coors_pp, n, max_points, max_voxels, (float*)voxels,
        (int*)coors, (int*)nppv);
  }
  return (int)cudaGetLastError();
}
