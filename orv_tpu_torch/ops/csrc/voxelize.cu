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
//     points in input order, the rest of its row zero.
//
// Bound on the H100: bytes (the points read, the voxels' rows written: at
// the factory's 153,600 points and about 76,000 voxels of 16 x 4 floats,
// 23 MB, 0.007 ms at 3.35 TB/s). The C++ walks the points serially through a
// hash map; here the grouping is a hash table in device memory (2n slots of
// 16 bytes, 4.9 MB at the factory's size: it stays in the 50 MB L2), with no
// sort:
//   1. voxel_insert_kernel, one thread a point: its cell (the C++'s f32
//      arithmetic), then its cell's slot (linear probing on the 64-bit key,
//      claimed by atomicCAS); atomicMin keeps the slot's smallest point index
//      (the voxel's first point) and atomicAdd counts its points, the old
//      count being the point's place in an unordered bucket (the lanes of a
//      warp in one cell take their places with one atomicAdd);
//   2. a device-wide scan (scan.cuh) over the points in input order of
//      (is the first point of its voxel, that voxel's point count) gives each
//      voxel its id (first come, first served) and its bucket's start;
//   3. voxel_fill_kernel writes each point's index into its voxel's bucket;
//   4. the wrapper reads the voxel count to size the outputs, then
//      voxel_scatter_kernel, 8 lanes a voxel (4 voxels a warp: a voxel of
//      the factory's holds 1 to 4 points), orders the bucket's indices (a
//      rank by shuffles up to 8 points; past 8, the max_points smallest one
//      at a time) and writes the first max_points points, the zero fill as
//      16-byte stores.
// The order of the atomics changes nothing the outputs show: a voxel's id,
// count, first point and row order are functions of the input order alone.
// The cells are computed with IEEE division and floorf, so with no
// contraction possible (a subtraction then a division) they are the C++'s
// bit for bit.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr long long kInvalid = 0x7fffffffffffffffLL;
constexpr unsigned long long kEmpty = ~0ull;

struct Grid {
  float vs[3];
  float lo[3];
  int dim[3];  // x, y, z cells
};

// One point's cell: coordinates (z, y, x) into out (-1 outside the grid) and
// its linear key (kInvalid outside).
__device__ __forceinline__ long long point_cell(const float* __restrict__ p, const Grid& g,
                                                int* __restrict__ out) {
  int c[3];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    // compared as a float: a NaN or a cell past int range is outside
    const float f = floorf(__fdiv_rn(__fsub_rn(p[j], g.lo[j]), g.vs[j]));
    if (!(f >= 0.0f && f < (float)g.dim[j])) ok = false;
    c[2 - j] = ok ? (int)f : -1;  // reversed (z, y, x)
  }
  if (!ok) {
    out[0] = out[1] = out[2] = -1;
    return kInvalid;
  }
  out[0] = c[0];
  out[1] = c[1];
  out[2] = c[2];
  return ((long long)c[0] * g.dim[1] + c[1]) * g.dim[0] + c[2];
}

__global__ void __launch_bounds__(256)
voxel_cells_kernel(const float* __restrict__ pts, int n, int nf, Grid g,
                   int* __restrict__ coors) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) point_cell(pts + (long long)i * nf, g, coors + 3LL * i);
}

// A hash-table slot. Every field starts at all ones (one memset): key empty,
// first the largest index, count one less than the points it has seen.
struct Slot {
  unsigned long long key;
  unsigned first;  // the smallest index of the cell's points
  unsigned count;  // points - 1
};

__device__ __forceinline__ unsigned slot_hash(unsigned long long key, unsigned size) {
  key ^= key >> 33;
  key *= 0xff51afd7ed558ccdull;
  key ^= key >> 33;
  return (unsigned)(((key >> 32) * (unsigned long long)size) >> 32);
}

// slot_of[i]: the point's slot (-1 outside the grid); pos_of[i]: its place
// in the voxel's bucket (unordered). The lanes of a warp in one cell act as
// one (neighbouring pixels often share a voxel): the lowest, which holds
// their smallest index, probes and takes their places with one atomicAdd.
// Every lane reaches the match.
__global__ void __launch_bounds__(256)
voxel_insert_kernel(const float* __restrict__ pts, int n, int nf, Grid g,
                    int* __restrict__ coors, Slot* __restrict__ table, unsigned size,
                    int* __restrict__ slot_of, int* __restrict__ pos_of) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const long long key =
      i < n ? point_cell(pts + (long long)i * nf, g, coors + 3LL * i) : kInvalid;
  const unsigned peers = __match_any_sync(0xffffffffu, (unsigned long long)key);
  const int leader = __ffs(peers) - 1;
  unsigned s = 0, base = 0;
  if (key != kInvalid && lane == leader) {
    s = slot_hash((unsigned long long)key, size);
    for (;;) {  // the table has more slots than points: a free one comes
      const unsigned long long old = atomicCAS(&table[s].key, kEmpty, (unsigned long long)key);
      if (old == kEmpty || old == (unsigned long long)key) break;
      s = s + 1 == size ? 0 : s + 1;
    }
    atomicMin(&table[s].first, (unsigned)i);
    base = atomicAdd(&table[s].count, (unsigned)__popc(peers)) + 1u;
  }
  s = __shfl_sync(0xffffffffu, s, leader);
  base = __shfl_sync(0xffffffffu, base, leader);
  if (i >= n) return;
  if (key == kInvalid) {
    slot_of[i] = -1;
    return;
  }
  pos_of[i] = (int)(base + __popc(peers & ((1u << lane) - 1)));
  slot_of[i] = (int)s;
}

// The scan's element of point i: (1, the voxel's point count) at a voxel's
// first point, else (0, 0).
struct HeadLoad {
  const int* slot_of;
  const Slot* table;
  __device__ __forceinline__ Int2 operator()(int i) const {
    const int s = slot_of[i];
    if (s < 0) return {0, 0};
    const Slot e = table[s];
    if (e.first != (unsigned)i) return {0, 0};
    return {1, (int)(e.count + 1u)};
  }
};

// At a voxel's first point: its bucket's start by slot (-1 past max_voxels)
// and, by voxel id, (start, count, first point).
struct HeadStore {
  const int* slot_of;
  int max_voxels;
  int* start_of_slot;
  int4* vinfo;
  __device__ __forceinline__ void operator()(int i, Int2 excl, Int2 x) const {
    if (!x.x) return;
    const bool kept = excl.x < max_voxels;
    start_of_slot[slot_of[i]] = kept ? excl.y : -1;
    if (kept) vinfo[excl.x] = make_int4(excl.y, x.y, i, 0);
  }
};

__global__ void __launch_bounds__(256)
voxel_fill_kernel(int n, const int* __restrict__ slot_of, const int* __restrict__ pos_of,
                  const int* __restrict__ start_of_slot, int* __restrict__ bucket) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = slot_of[i];
  if (s < 0) return;
  const int start = start_of_slot[s];
  if (start >= 0) bucket[start + pos_of[i]] = i;
}

constexpr int kGroup = 8;  // lanes a voxel

// kGroup lanes a voxel v < m: vinfo[v] = (bucket start, count, first point).
__global__ void __launch_bounds__(256)
voxel_scatter_kernel(const float* __restrict__ pts, int nf, const int4* __restrict__ vinfo,
                     const int* __restrict__ bucket, const int* __restrict__ coors_pp, int m,
                     int max_points, float* __restrict__ voxels, int* __restrict__ coors,
                     int* __restrict__ nppv) {
  const long long v = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kGroup;
  const int gl = threadIdx.x % kGroup;
  const unsigned gmask = 0xffu << ((threadIdx.x & 31) & ~(kGroup - 1));
  if (v >= m) return;  // whole groups: the shuffles below name the group's lanes only
  const int4 info = vinfo[v];
  const int start = info.x, cnt = info.y;
  const int kept = min(cnt, max_points);
  float* row = voxels + v * max_points * nf;
  // vector stores where every row and point is 16-byte aligned
  const bool vec = (nf & 3) == 0 && (reinterpret_cast<uintptr_t>(voxels) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(pts) & 15) == 0;
  if (cnt <= kGroup) {
    // each lane one point; its rank in input order among the voxel's
    const int idx = gl < cnt ? bucket[start + gl] : INT_MAX;
    int rank = 0;
#pragma unroll
    for (int o = 0; o < kGroup; ++o) rank += __shfl_sync(gmask, idx, o, kGroup) < idx;
    if (gl < cnt && rank < max_points) {
      const float* src = pts + (long long)idx * nf;
      float* dst = row + rank * nf;
      if (vec) {
        for (int f = 0; f < nf; f += 4)
          *reinterpret_cast<float4*>(dst + f) = *reinterpret_cast<const float4*>(src + f);
      } else {
        for (int f = 0; f < nf; ++f) dst[f] = src[f];
      }
    }
  } else {
    // a long bucket: its max_points smallest indices, smallest first
    int last = -1;
    for (int r = 0; r < kept; ++r) {
      int best = INT_MAX;
      for (int k = gl; k < cnt; k += kGroup) {
        const int x = bucket[start + k];
        if (x > last && x < best) best = x;
      }
#pragma unroll
      for (int o = kGroup / 2; o > 0; o >>= 1)
        best = min(best, __shfl_xor_sync(gmask, best, o, kGroup));
      const float* src = pts + (long long)best * nf;
      for (int f = gl; f < nf; f += kGroup) row[r * nf + f] = src[f];
      last = best;
    }
  }
  // the rest of the row: zeros
  if (vec) {
    float4* row4 = reinterpret_cast<float4*>(row);
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int e = kept * nf / 4 + gl; e < max_points * nf / 4; e += kGroup) row4[e] = z;
  } else {
    for (int e = kept * nf + gl; e < max_points * nf; e += kGroup) row[e] = 0.0f;
  }
  if (gl < 3) coors[3 * v + gl] = coors_pp[3LL * info.z + gl];
  if (gl == 0) nppv[v] = kept;
}

inline unsigned blocks_for(long long n) { return (unsigned)((n + 255) / 256); }

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

// Dynamic mode: points [n, nf] f32 (xyz first); vs, lo: 3 floats, dim: 3
// ints (host memory); out coors [n, 3] int32.
extern "C" int orv_voxel_cells(const void* points, int n, int nf, const float* vs,
                               const float* lo, const int* dim, void* coors, void* stream) {
  if (n > 0) {
    voxel_cells_kernel<<<blocks_for(n), 256, 0, (cudaStream_t)stream>>>(
        (const float*)points, n, nf, make_grid(vs, lo, dim), (int*)coors);
  }
  return (int)cudaGetLastError();
}

// Hard mode, steps 1-3: coors [n, 3] int32 (each point's cell); table
// [table_size] slots of 16 bytes (table_size > n); slot_of, pos_of [n];
// start_of_slot [table_size]; vinfo [n, 4]; bucket [n] int32; block_sums
// [scan_blocks(n), 2] int32; total [2] int32: the voxel count and the points
// inside the grid.
extern "C" int orv_voxel_group(const void* points, int n, int nf, const float* vs,
                               const float* lo, const int* dim, int max_voxels, void* coors,
                               void* table, int table_size, void* slot_of, void* pos_of,
                               void* start_of_slot, void* vinfo, void* bucket,
                               void* block_sums, void* total, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(table, 0xff, (size_t)table_size * sizeof(Slot), s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    voxel_insert_kernel<<<blocks_for(n), 256, 0, s>>>(
        (const float*)points, n, nf, make_grid(vs, lo, dim), (int*)coors, (Slot*)table,
        (unsigned)table_size, (int*)slot_of, (int*)pos_of);
  }
  device_scan<Int2>(HeadLoad{(const int*)slot_of, (const Slot*)table},
                    HeadStore{(const int*)slot_of, max_voxels, (int*)start_of_slot,
                              (int4*)vinfo},
                    n, (Int2*)block_sums, (Int2*)total, s);
  if (n > 0) {
    voxel_fill_kernel<<<blocks_for(n), 256, 0, s>>>(n, (const int*)slot_of, (const int*)pos_of,
                                                     (const int*)start_of_slot, (int*)bucket);
  }
  return (int)cudaGetLastError();
}

// Hard mode, step 4: voxels [m, max_points, nf], coors [m, 3], nppv [m] for
// m = min(voxel count, max_voxels).
extern "C" int orv_voxel_scatter(const void* points, int nf, const void* vinfo,
                                 const void* bucket, const void* coors_pp, int m, int max_points,
                                 void* voxels, void* coors, void* nppv, void* stream) {
  if (m > 0) {
    voxel_scatter_kernel<<<blocks_for((long long)kGroup * m), 256, 0, (cudaStream_t)stream>>>(
        (const float*)points, nf, (const int4*)vinfo, (const int*)bucket, (const int*)coors_pp,
        m, max_points, (float*)voxels, (int*)coors, (int*)nppv);
  }
  return (int)cudaGetLastError();
}
