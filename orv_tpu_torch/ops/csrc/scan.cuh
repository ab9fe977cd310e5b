// Device-wide exclusive prefix sum over int32 (or two int32 sums at once),
// shared by voxelize.cu, gaussian_raster.cu and scan.cu (names in an
// anonymous namespace: one copy per source).
//
// Two launches over tiles of kScanTile = 2048 consecutive elements, 256
// threads a block, 8 consecutive elements a thread (two 16-byte loads where
// the input is a plain int array):
//   1. scan_reduce_kernel: each tile but the last writes its sum;
//   2. scan_apply_kernel: block b adds the sums of tiles 0..b-1 (at most a
//      few hundred at the factory's sizes, read from the L2), scans its own
//      tile with warp shuffles and hands each element its exclusive prefix;
//      the last block writes the total.
// One tile (n <= 2048) is one launch. The sums are integers, so the result
// is the same bits whatever the order of the additions.
//
// The element and the write are functors, so a caller can scan values it
// computes on the fly (voxelize.cu's head flags) and write each prefix where
// it is needed (only at a voxel's first point, or into two arrays).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 256;
constexpr int kScanItems = 8;  // consecutive elements a thread
constexpr int kScanTile = kScanThreads * kScanItems;

inline int scan_blocks(int n) { return (n + kScanTile - 1) / kScanTile; }

// two sums in one pass
struct Int2 {
  int x, y;
};
__device__ __forceinline__ Int2 operator+(Int2 a, Int2 b) { return {a.x + b.x, a.y + b.y}; }

__device__ __forceinline__ int shfl_up(int v, int o) { return __shfl_up_sync(0xffffffffu, v, o); }
__device__ __forceinline__ Int2 shfl_up(Int2 v, int o) {
  return {__shfl_up_sync(0xffffffffu, v.x, o), __shfl_up_sync(0xffffffffu, v.y, o)};
}
__device__ __forceinline__ int shfl_down(int v, int o) {
  return __shfl_down_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ Int2 shfl_down(Int2 v, int o) {
  return {__shfl_down_sync(0xffffffffu, v.x, o), __shfl_down_sync(0xffffffffu, v.y, o)};
}

// the element of a plain int array
struct ArrayLoad {
  const int* p;
  __device__ __forceinline__ int operator()(int i) const { return p[i]; }
};

// out[i] = the exclusive prefix
struct ArrayStore {
  int* out;
  __device__ __forceinline__ void operator()(int i, int excl, int) const { out[i] = excl; }
};

template <class T, class Load>
__device__ __forceinline__ void scan_load(const Load& load, int i0, int n, T (&v)[kScanItems]) {
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) v[j] = i0 + j < n ? load(i0 + j) : T{};
}

// a plain array: two 16-byte loads where the thread's 8 elements are whole
// and aligned
__device__ __forceinline__ void scan_load(const ArrayLoad& load, int i0, int n,
                                          int (&v)[kScanItems]) {
  const int* p = load.p + i0;
  if (i0 + kScanItems <= n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const int4 a = reinterpret_cast<const int4*>(p)[0], b = reinterpret_cast<const int4*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z,
    v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) v[j] = i0 + j < n ? p[j] : 0;
  }
}

// The block's sum of x (every thread gets it). red: kScanThreads / 32 slots.
template <class T>
__device__ __forceinline__ T block_sum(T x, T* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = x + shfl_down(x, o);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[w] = x;
  __syncthreads();
  T s = red[0];
#pragma unroll
  for (int k = 1; k < kScanThreads / 32; ++k) s = s + red[k];
  return s;
}

template <class T, class Load>
__global__ void __launch_bounds__(kScanThreads)
scan_reduce_kernel(Load load, int n, T* __restrict__ block_sums) {
  __shared__ T red[kScanThreads / 32];
  T v[kScanItems];
  scan_load(load, blockIdx.x * kScanTile + threadIdx.x * kScanItems, n, v);
  T s = v[0];
#pragma unroll
  for (int j = 1; j < kScanItems; ++j) s = s + v[j];
  s = block_sum(s, red);
  if (threadIdx.x == 0) block_sums[blockIdx.x] = s;
}

template <class T, class Load, class Store>
__global__ void __launch_bounds__(kScanThreads)
scan_apply_kernel(Load load, Store store, int n, const T* __restrict__ block_sums,
                  T* __restrict__ total) {
  __shared__ T red[kScanThreads / 32];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  // the tiles before this one
  T carry{};
  for (int k = t; k < (int)blockIdx.x; k += kScanThreads) carry = carry + block_sums[k];
  carry = block_sum(carry, red);

  const int i0 = blockIdx.x * kScanTile + t * kScanItems;
  T v[kScanItems];
  scan_load(load, i0, n, v);
  T incl[kScanItems];
  incl[0] = v[0];
#pragma unroll
  for (int j = 1; j < kScanItems; ++j) incl[j] = incl[j - 1] + v[j];
  // the threads' totals, scanned across the warp, then across the warps
  T s = incl[kScanItems - 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = shfl_up(s, o);
    if (lane >= o) s = s + y;
  }
  __syncthreads();  // red was read by block_sum
  if (lane == 31) red[w] = s;
  __syncthreads();
  T before = carry;  // the tiles before and this tile's warps before this one
  for (int k = 0; k < w; ++k) before = before + red[k];
  // s is the inclusive sum over lanes 0..lane: the lanes before add theirs
  T base = before;
  const T prev = shfl_up(s, 1);
  if (lane > 0) base = base + prev;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int i = i0 + j;
    if (i < n) store(i, j ? base + incl[j - 1] : base, v[j]);
  }
  // the last thread's inclusive sum is the whole array's
  if (blockIdx.x == gridDim.x - 1 && t == kScanThreads - 1) *total = before + s;
}

// Launches the scan of load(0..n) on stream s: store(i, prefix, element) for
// each i < n, *total = the sum. block_sums: scratch of scan_blocks(n) sums.
template <class T, class Load, class Store>
inline void device_scan(const Load& load, const Store& store, int n, T* block_sums, T* total,
                        cudaStream_t s) {
  const int blocks = scan_blocks(n);
  if (blocks > 1)
    scan_reduce_kernel<T, Load><<<blocks - 1, kScanThreads, 0, s>>>(load, n, block_sums);
  scan_apply_kernel<T, Load, Store>
      <<<blocks > 0 ? blocks : 1, kScanThreads, 0, s>>>(load, store, n, block_sums, total);
}

// out[i] = sum of in[0..i); *total = sum of in[0..n).
inline void exclusive_scan(const int* in, int n, int* out, int* total, int* block_sums,
                           cudaStream_t s) {
  device_scan<int>(ArrayLoad{in}, ArrayStore{out}, n, block_sums, total, s);
}

}  // namespace
