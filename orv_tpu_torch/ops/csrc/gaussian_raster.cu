// Tile-based 3D Gaussian splat rasterizer, forward and backward, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: it is the counterpart of the JAX package's host
// C++ op orv_tpu/ops/native/gaussian_raster.cpp (rasterize_gaussians
// :205-259, rasterize_gaussians_backward :264-538), which the data factory
// runs once a frame and view (prepare_dataset.py:render_episode). Outputs:
// color [3,H,W] (+ background), feature [12,H,W], alpha-weighted view depth
// [H,W], alpha [H,W] and radii [N]; the backward gives the six input
// gradients.
//
// Bound on the H100: bytes at the factory's sizes (a few tens of thousands
// of splats of a few pixels each: the gaussians read once, the 17 output
// planes written once); the blend's f32 operations (about 60 a blended
// (pixel, splat) pair forward, 130 backward, an exp counted as 8:
// chip_smoke.py RASTER_FWD_PAIR_OPS) come to a quarter (forward) and a
// third (backward) of the bytes' time at frame 0. Design, in the C++'s
// order of operations:
//   (a) preprocess_kernel, one thread a gaussian: gaussian_raster.cpp:87-176
//       in f32 (near cull at tz < 0.2, EWA with the 1.3 tan-fov clamp and
//       the 0.3 low-pass, det <= 0 cull, radius ceil(3 sqrt(lambda)), the
//       pixel rectangle with C's (int) truncation of pix_x), the number of
//       16x16 tiles it touches, and the tiles' key counts (one atomicAdd for
//       the lanes of a warp that touch a tile); one device-wide scan (scan.cuh) of (tiles touched,
//       tile count) pairs gives each gaussian its first key slot and each
//       tile its range of the key list: a counting sort by tile, no library
//       sort;
//   (b) after one read of the key count to size the list, tile_fill_kernel
//       writes each (depth bits, gaussian) key into its tiles' ranges
//       (unordered: an atomicSub on the tile's count a warp), and
//       tile_sort_kernel, one block a tile, sorts the tile's keys as 64-bit
//       words in shared memory (bitonic): by depth, equal depths in
//       gaussian-index order (the C++'s std::sort leaves them unspecified),
//       the order the plain version's stable sort gives. A list longer than kSortCap keys is
//       sorted in chunks of kSortCap, written back, and merged by rank (each
//       key's place in its chunk plus its lower bound in every other chunk).
//       The block also writes the tile's range and, for the backward, each
//       key's sorted place by the slot its gaussian's keys take in gaussian
//       order (slot_of);
//   (c) forward_kernel, one 256-thread block a tile, one thread a pixel (a
//       warp an 8x4 pixel block): each batch of 256 splats is staged in
//       shared memory whole (position, conic, opacity, depth, colour, the 12
//       features), so a pixel reads nothing of a splat from device memory;
//       with it, the power below which opacity * exp(power) < 1/255 for sure
//       (a 1% margin in the exponent) and that region's bounding box (1%
//       and one pixel wider): each warp lists, by ballot, the batch's
//       splats whose box meets its 8x4 pixels and walks only those, and a
//       pixel whose power lies below skips the exp. Both skip only splats
//       the C++ skips (power > 0 or alpha < 1/255), so the blended splats,
//       and the arithmetic on them, are the C++'s
//       (:228-255: alpha = min(0.99, o exp(power)), stop after the splat that
//       takes T below 1e-4, background on color only); the block leaves when
//       every pixel is done. Under autograd it also writes each pixel's
//       final transmittance and the list position of its last blended
//       splat, the backward's state;
//   (d) backward_kernel, one block a tile, a warp an 8x4 pixel block as in
//       (c): one pass a pixel (:308-384) back to front from the forward's
//       state, the transmittance before a splat recovered as the one after
//       it over 1 - alpha and the payload behind it carried; the splats
//       staged and culled as in (c). Each splat's gradients are summed
//       over a warp's lanes by a transpose-reduce (31 shuffles for its 22
//       values), then over the warps that hit it in warp order, once a round
//       of kBwdBatch splats, into the splat's slot of the sorted key list,
//       one slot a (tile, gaussian), every slot written;
//       backward_sum_kernel, one warp a gaussian (a lane a value), adds its
//       slots in its tiles' order, row by row, found through the slot map
//       of (b). No atomics: two runs give the same bits, as the C++'s
//       serial scatter does (:264). backward_geom_kernel, one thread a
//       gaussian, recomputes the preprocess and takes conic -> cov2D ->
//       cov3D -> quaternion, scale and means (:390-537).
// Built with -fmad=false (ops/_build.py:SOURCE_FLAGS) and expf, not __expf:
// the 1/255 and 1e-4 thresholds turn ulps into whole splats.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;
constexpr int kFeat = 12;  // semantic channels (reference config.h)

struct Cam {
  float V[16];  // world -> camera, row-major
  float P[16];  // world -> clip, row-major
  float bg[3];
  float tan_fovx, tan_fovy, scale_modifier;
  int height, width, tiles_x, tiles_y;
};

// One gaussian's preprocess (gaussian_raster.cpp:87-176), kept whole for the
// backward's chain.
struct Geo {
  bool valid;
  int radius, x0, x1, y0, y1;
  float px, py, tx, ty, tz, cx, cy, cw, qlen;
  float conic[3], T[6], c3[6], M[9], R[9], qn[4];
  float clampsx, clampsy;  // +-1 where the frustum clamp hit, else 0
};

__device__ __forceinline__ void quat_to_rotmat(const float* q, float* R) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1.0f - 2.0f * (y * y + z * z);
  R[1] = 2.0f * (x * y - w * z);
  R[2] = 2.0f * (x * z + w * y);
  R[3] = 2.0f * (x * y + w * z);
  R[4] = 1.0f - 2.0f * (x * x + z * z);
  R[5] = 2.0f * (y * z - w * x);
  R[6] = 2.0f * (x * z - w * y);
  R[7] = 2.0f * (y * z + w * x);
  R[8] = 1.0f - 2.0f * (x * x + y * y);
}

__device__ void preprocess_one(const float* __restrict__ means3d,
                               const float* __restrict__ scales,
                               const float* __restrict__ rotations, int i, const Cam& c,
                               Geo& g) {
  g.valid = false;
  g.radius = 0;
  const float* V = c.V;
  const float* P = c.P;
  const float focal_x = c.width / (2.0f * c.tan_fovx);
  const float focal_y = c.height / (2.0f * c.tan_fovy);
  const float* p = means3d + 3LL * i;
  const float tx = V[0] * p[0] + V[1] * p[1] + V[2] * p[2] + V[3];
  const float ty = V[4] * p[0] + V[5] * p[1] + V[6] * p[2] + V[7];
  const float tz = V[8] * p[0] + V[9] * p[1] + V[10] * p[2] + V[11];
  if (!(tz >= 0.2f)) return;  // near culling (tz < 0.2f)

  const float cx = P[0] * p[0] + P[1] * p[1] + P[2] * p[2] + P[3];
  const float cy = P[4] * p[0] + P[5] * p[1] + P[6] * p[2] + P[7];
  const float cw = P[12] * p[0] + P[13] * p[1] + P[14] * p[2] + P[15];
  const float inv_w = 1.0f / (cw + 1e-7f);
  const float pix_x = ((cx * inv_w + 1.0f) * c.width - 1.0f) * 0.5f;
  const float pix_y = ((cy * inv_w + 1.0f) * c.height - 1.0f) * 0.5f;

  const float* q = rotations + 4LL * i;
  const float qlen = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]) + 1e-12f;
  for (int k = 0; k < 4; ++k) g.qn[k] = q[k] / qlen;
  quat_to_rotmat(g.qn, g.R);
  const float* s = scales + 3LL * i;
  const float sm[3] = {s[0] * c.scale_modifier, s[1] * c.scale_modifier,
                       s[2] * c.scale_modifier};
  float* M = g.M;
  for (int r = 0; r < 3; ++r)
    for (int k = 0; k < 3; ++k) M[r * 3 + k] = g.R[r * 3 + k] * sm[k];
  float* c3 = g.c3;
  c3[0] = M[0] * M[0] + M[1] * M[1] + M[2] * M[2];
  c3[1] = M[0] * M[3] + M[1] * M[4] + M[2] * M[5];
  c3[2] = M[0] * M[6] + M[1] * M[7] + M[2] * M[8];
  c3[3] = M[3] * M[3] + M[4] * M[4] + M[5] * M[5];
  c3[4] = M[3] * M[6] + M[4] * M[7] + M[5] * M[8];
  c3[5] = M[6] * M[6] + M[7] * M[7] + M[8] * M[8];

  const float limx = 1.3f * c.tan_fovx, limy = 1.3f * c.tan_fovy;
  const float txz = tx / tz, tyz = ty / tz;
  g.clampsx = txz > limx ? 1.0f : (txz < -limx ? -1.0f : 0.0f);
  g.clampsy = tyz > limy ? 1.0f : (tyz < -limy ? -1.0f : 0.0f);
  const float ctx = fminf(limx, fmaxf(-limx, txz)) * tz;
  const float cty = fminf(limy, fmaxf(-limy, tyz)) * tz;
  const float J[6] = {focal_x / tz, 0.0f, -(focal_x * ctx) / (tz * tz),
                      0.0f, focal_y / tz, -(focal_y * cty) / (tz * tz)};
  const float W9[9] = {V[0], V[1], V[2], V[4], V[5], V[6], V[8], V[9], V[10]};
  float* T = g.T;
  for (int r = 0; r < 2; ++r)
    for (int k = 0; k < 3; ++k)
      T[r * 3 + k] = J[r * 3 + 0] * W9[k] + J[r * 3 + 1] * W9[3 + k] + J[r * 3 + 2] * W9[6 + k];
  const float S9[9] = {c3[0], c3[1], c3[2], c3[1], c3[3], c3[4], c3[2], c3[4], c3[5]};
  float TS[6];
  for (int r = 0; r < 2; ++r)
    for (int k = 0; k < 3; ++k)
      TS[r * 3 + k] =
          T[r * 3 + 0] * S9[k] + T[r * 3 + 1] * S9[3 + k] + T[r * 3 + 2] * S9[6 + k];
  const float a = TS[0] * T[0] + TS[1] * T[1] + TS[2] * T[2] + 0.3f;  // low-pass
  const float b = TS[0] * T[3] + TS[1] * T[4] + TS[2] * T[5];
  const float d = TS[3] * T[3] + TS[4] * T[4] + TS[5] * T[5] + 0.3f;

  const float det = a * d - b * b;
  if (!(det > 0.0f)) return;
  const float inv_det = 1.0f / det;
  g.conic[0] = d * inv_det;
  g.conic[1] = -b * inv_det;
  g.conic[2] = a * inv_det;

  const float mid = 0.5f * (a + d);
  const float lam = mid + sqrtf(fmaxf(0.1f, mid * mid - det));
  const int radius = (int)ceilf(3.0f * sqrtf(lam));
  if (radius <= 0) return;

  const int ix = (int)pix_x, iy = (int)pix_y;  // C's truncation toward zero
  g.x0 = max(0, min(c.width, ix - radius));
  g.x1 = max(0, min(c.width, ix + radius + 1));
  g.y0 = max(0, min(c.height, iy - radius));
  g.y1 = max(0, min(c.height, iy + radius + 1));
  if (g.x0 >= g.x1 || g.y0 >= g.y1) return;

  g.valid = true;
  g.radius = radius;
  g.px = pix_x;
  g.py = pix_y;
  g.tx = tx;
  g.ty = ty;
  g.tz = tz;
  g.cx = cx;
  g.cy = cy;
  g.cw = cw;
  g.qlen = qlen;
}

// Lane l's k-th tile of rect r (row by row), -1 past its count. The warp's
// lanes that name the same tile act as one: the lowest adds their number
// (a splat's neighbours in index order are mostly its neighbours on the
// image, so a warp names a few tiles where it would add 32 times).
__device__ __forceinline__ int rect_tile(int4 r, int cnt, int k, int tiles_x) {
  if (k >= cnt) return -1;
  const int w = r.y - r.x + 1;
  return (r.z + k / w) * tiles_x + r.x + k % w;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// xy [n, 2], conic_op [n, 4] (conic, opacity), depth [n], rect [n, 4]
// (tile x0, x1, y0, y1 inclusive), touched [n]; tile_count [tiles] (zero on
// entry) counts each tile's keys. Every lane reaches the warp's tile counts.
__global__ void __launch_bounds__(256)
preprocess_kernel(const float* __restrict__ means3d, const float* __restrict__ scales,
                  const float* __restrict__ rotations, const float* __restrict__ opacities, int n,
                  Cam c, int* __restrict__ radii, float2* __restrict__ xy,
                  float4* __restrict__ conic_op, float* __restrict__ depth,
                  int4* __restrict__ rect, int* __restrict__ touched,
                  int* __restrict__ tile_count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int4 r = make_int4(0, 0, 0, 0);
  int cnt = 0;
  if (i < n) {
    Geo g;
    preprocess_one(means3d, scales, rotations, i, c, g);
    radii[i] = g.radius;
    if (g.valid) {
      xy[i] = make_float2(g.px, g.py);
      conic_op[i] = make_float4(g.conic[0], g.conic[1], g.conic[2], opacities[i]);
      depth[i] = g.tz;
      r = make_int4(g.x0 / kTile, (g.x1 - 1) / kTile, g.y0 / kTile, (g.y1 - 1) / kTile);
      rect[i] = r;
      cnt = (r.y - r.x + 1) * (r.w - r.z + 1);
    }
    touched[i] = cnt;
  }
  const int lane = threadIdx.x & 31, most = warp_max(cnt);
  for (int k = 0; k < most; ++k) {
    const int t = rect_tile(r, cnt, k, c.tiles_x);
    const unsigned peers = __match_any_sync(0xffffffffu, t);
    if (t >= 0 && lane == __ffs(peers) - 1) atomicAdd(&tile_count[t], __popc(peers));
  }
}

// The scan's element k: (tiles gaussian k touches, keys of tile k).
struct BinLoad {
  const int* touched;
  const int* tile_count;
  int n, n_tiles;
  __device__ __forceinline__ Int2 operator()(int k) const {
    return {k < n ? touched[k] : 0, k < n_tiles ? tile_count[k] : 0};
  }
};

// offsets[k]: gaussian k's first key slot; tile_start[k]: tile k's first key
// (k <= n_tiles: tile_start[n_tiles] is the key count).
struct BinStore {
  int* offsets;
  int* tile_start;
  int n, n_tiles;
  __device__ __forceinline__ void operator()(int k, Int2 excl, Int2) const {
    if (k < n) offsets[k] = excl.x;
    if (k <= n_tiles) tile_start[k] = excl.y;
  }
};

// One (depth bits << 32 | gaussian) key a touched tile, into the tile's
// range in no particular order (tile_count counts down to 0; the lanes of
// a warp that name one tile take one atomicSub). Every lane reaches it.
__global__ void __launch_bounds__(256)
tile_fill_kernel(int n, const int* __restrict__ touched, const int4* __restrict__ rect,
                 const float* __restrict__ depth, int tiles_x, const int* __restrict__ tile_start,
                 int* __restrict__ tile_count, unsigned long long* __restrict__ list) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int cnt = i < n ? touched[i] : 0;
  const int4 r = cnt ? rect[i] : make_int4(0, 0, 0, 0);
  // depth >= 0.2: its bits order as the floats do
  const unsigned long long key =
      cnt ? ((unsigned long long)__float_as_uint(depth[i]) << 32) | (unsigned)i : 0ull;
  const int lane = threadIdx.x & 31, most = warp_max(cnt);
  for (int k = 0; k < most; ++k) {
    const int t = rect_tile(r, cnt, k, tiles_x);
    const unsigned peers = __match_any_sync(0xffffffffu, t);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (t >= 0 && lane == leader) base = atomicSub(&tile_count[t], __popc(peers)) - __popc(peers);
    base = __shfl_sync(0xffffffffu, base, leader);
    if (t >= 0) list[tile_start[t] + base + __popc(peers & ((1u << lane) - 1))] = key;
  }
}

constexpr int kSortThreads = 256;
constexpr int kSortCap = 4096;  // keys a block sorts in shared memory (32 KB)

// Ascending bitonic sort of s[0..cap), cap a power of two, by the block.
// Thread p mod blockDim swaps pair p; at a distance j <= 32 the pairs
// 32q..32q+31 hold keys 64q..64q+63 only, all of one warp's, so two such
// steps in a row need only the warp's barrier.
__device__ void bitonic_sort(unsigned long long* s, int cap) {
  for (int k = 2; k <= cap; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < cap >> 1; p += blockDim.x) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int l = i | j;
        const unsigned long long a = s[i], b = s[l];
        if ((a > b) == ((i & k) == 0)) {
          s[i] = b;
          s[l] = a;
        }
      }
      const int next = j > 1 ? j >> 1 : k;  // the next step's distance
      if (j <= 32 && next <= 32) __syncwarp();
      else __syncthreads();
    }
}

// The key at sorted place p of tile (tx, ty): its gaussian into point_list
// and, for the backward, p into the slot its gaussian's keys take in
// gaussian order (its tiles row by row).
__device__ __forceinline__ void emit_key(int p, unsigned long long key, int tx, int ty,
                                         const int* __restrict__ offsets,
                                         const int4* __restrict__ rect,
                                         int* __restrict__ point_list, int* __restrict__ slot_of) {
  const int idx = (int)(unsigned)key;
  point_list[p] = idx;
  if (slot_of) {
    const int4 r = rect[idx];
    slot_of[offsets[idx] + (ty - r.z) * (r.y - r.x + 1) + (tx - r.x)] = p;
  }
}

// One block a tile: its keys list[start, end) sorted (see (b) above);
// ranges[tile] = (start, end). slot_of may be null (no backward).
__global__ void __launch_bounds__(kSortThreads)
tile_sort_kernel(const int* __restrict__ tile_start, unsigned long long* list, int tiles_x,
                 const int* __restrict__ offsets, const int4* __restrict__ rect,
                 int2* __restrict__ ranges, int* __restrict__ point_list,
                 int* __restrict__ slot_of) {
  __shared__ unsigned long long s[kSortCap];
  const int t = blockIdx.x, tx = t % tiles_x, ty = t / tiles_x;
  const int start = tile_start[t], len = tile_start[t + 1] - start;
  if (threadIdx.x == 0) ranges[t] = make_int2(start, start + len);
  const bool chunked = len > kSortCap;
  for (int c0 = 0; c0 < len; c0 += kSortCap) {
    const int clen = min(kSortCap, len - c0);
    int cap = 1;
    while (cap < clen) cap <<= 1;
    __syncthreads();  // the previous chunk is out of s
    for (int k = threadIdx.x; k < cap; k += blockDim.x)
      s[k] = k < clen ? list[start + c0 + k] : ~0ull;
    __syncthreads();
    bitonic_sort(s, cap);
    for (int k = threadIdx.x; k < clen; k += blockDim.x) {
      if (chunked) list[start + c0 + k] = s[k];
      else emit_key(start + k, s[k], tx, ty, offsets, rect, point_list, slot_of);
    }
  }
  if (!chunked) return;
  // a long list: each key's place is its place in its chunk plus, in every
  // other chunk, the number of keys below it (keys are distinct)
  __syncthreads();  // the sorted chunks in list, written by this block
  const int n_chunks = (len + kSortCap - 1) / kSortCap;
  for (int k = threadIdx.x; k < len; k += blockDim.x) {
    const unsigned long long key = list[start + k];
    const int c = k / kSortCap;
    int pos = k - c * kSortCap;
    for (int c2 = 0; c2 < n_chunks; ++c2) {
      if (c2 == c) continue;
      const unsigned long long* q = list + start + c2 * kSortCap;
      int lo = 0, hi = min(kSortCap, len - c2 * kSortCap);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (q[mid] < key) lo = mid + 1;
        else hi = mid;
      }
      pos += lo;
    }
    emit_key(start + pos, key, tx, ty, offsets, rect, point_list, slot_of);
  }
}

// power of a splat at pixel (x, y), in the C++'s order (:229-231)
__device__ __forceinline__ float splat_power(float2 p, float4 co, float x, float y, float& dx,
                                             float& dy) {
  dx = p.x - x;
  dy = p.y - y;
  return -0.5f * (co.x * dx * dx + co.z * dy * dy) - co.y * dx * dy;
}

// A batch of kN splats in shared memory: all a pixel reads of a splat.
template <int kN>
struct BlendBatch {
  float4 box[kN];    // x lo, x hi, y lo, y hi of the region a splat can reach
  float4 pos[kN];    // pix_x, pix_y, the skip power, opacity
  float4 conic[kN];  // conic (3), depth
  float4 color[kN];  // rgb, unused
  float4 feat[kN][kFeat / 4];
};

constexpr float kSkipMargin = 0.01f;  // of the skip power's exponent

// Stages splat k of the tile's list into slot j. Where opacity o
// is finite and >= 1/255, o * exp(power) < 1/255 for every power below
// log((1/255) / o) - kSkipMargin: the skip power; the pixels with power at
// least that lie in the ellipse d' C d <= -2 * skip power, whose bounding box
// (1% and one pixel wider) is the splat's box. A finite o below 1/255 never
// reaches 1/255 (an empty box); a NaN or infinite o is never skipped.
template <int kN>
__device__ __forceinline__ void load_blend(BlendBatch<kN>& sb, int j,
                                           const int* __restrict__ point_list,
                                           const float2* __restrict__ xy,
                                           const float4* __restrict__ conic_op,
                                           const float* __restrict__ depth,
                                           const float* __restrict__ colors,
                                           const float* __restrict__ features, bool feat_vec,
                                           int k, int end) {
  if (k >= end) return;
  const int id = point_list[k];
  const float2 p = xy[id];
  const float4 co = conic_op[id];
  const float o = co.w;
  const float kInf = __int_as_float(0x7f800000);
  float skip = -kInf;
  float4 box = make_float4(-kInf, kInf, -kInf, kInf);
  if (isfinite(o)) {
    if (o < 1.0f / 255.0f) {
      skip = kInf;
      box = make_float4(kInf, -kInf, kInf, -kInf);
    } else {
      skip = logf((1.0f / 255.0f) / o) - kSkipMargin;
      const float det = co.x * co.z - co.y * co.y;
      if (det > 0.0f) {
        const float r2 = -2.0f * skip;
        const float hx = 1.01f * sqrtf(r2 * co.z / det) + 1.0f;
        const float hy = 1.01f * sqrtf(r2 * co.x / det) + 1.0f;
        if (isfinite(hx) && isfinite(hy)) box = make_float4(p.x - hx, p.x + hx, p.y - hy, p.y + hy);
      }
    }
  }
  sb.box[j] = box;
  sb.pos[j] = make_float4(p.x, p.y, skip, o);
  sb.conic[j] = make_float4(co.x, co.y, co.z, depth[id]);
  const float* col = colors + 3LL * id;
  sb.color[j] = make_float4(col[0], col[1], col[2], 0.0f);
  if (features) {
    const float* f = features + (long long)kFeat * id;
    if (feat_vec) {
#pragma unroll
      for (int q = 0; q < kFeat / 4; ++q) sb.feat[j][q] = reinterpret_cast<const float4*>(f)[q];
    } else {
#pragma unroll
      for (int q = 0; q < kFeat / 4; ++q)
        sb.feat[j][q] = make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
    }
  }
}

// out_T and out_last (the backward's state) may be null: not written.
__global__ void __launch_bounds__(kBlock)
forward_kernel(const int2* __restrict__ ranges, const int* __restrict__ point_list,
               const float2* __restrict__ xy, const float4* __restrict__ conic_op,
               const float* __restrict__ depth, const float* __restrict__ colors,
               const float* __restrict__ features, Cam c, float* __restrict__ out_color,
               float* __restrict__ out_feature, float* __restrict__ out_depth,
               float* __restrict__ out_alpha, float* __restrict__ out_T,
               int* __restrict__ out_last) {
  __shared__ BlendBatch<kBlock> sb;
  __shared__ unsigned short meets[kBlock / 32][kBlock];  // a warp's splats of the batch
  const int tile = blockIdx.x;
  // a warp an 8x4 block of the tile's pixels
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wx0 = (tile % c.tiles_x) * kTile + (warp & 1) * 8;
  const int wy0 = (tile / c.tiles_x) * kTile + (warp >> 1) * 4;
  const int x = wx0 + (lane & 7), y = wy0 + (lane >> 3);
  const float fwx0 = (float)wx0, fwx1 = (float)(wx0 + 7), fwy0 = (float)wy0,
              fwy1 = (float)(wy0 + 3);
  const bool inside = x < c.width && y < c.height;
  const bool feat_vec = (reinterpret_cast<uintptr_t>(features) & 15) == 0;
  const int2 range = ranges[tile];
  bool done = !inside;
  int last = -1;  // list position of the last splat blended
  float T = 1.0f, acc_c[3] = {0.0f, 0.0f, 0.0f}, acc_f[kFeat], acc_d = 0.0f;
#pragma unroll
  for (int k = 0; k < kFeat; ++k) acc_f[k] = 0.0f;
  const float fx = (float)x, fy = (float)y;
  for (int base = range.x; base < range.y; base += kBlock) {
    if (__syncthreads_count(done) == kBlock) break;
    load_blend(sb, threadIdx.x, point_list, xy, conic_op, depth, colors, features, feat_vec,
               base + threadIdx.x, range.y);
    __syncthreads();
    const int m = min(kBlock, range.y - base);
    // the batch's splats whose box meets the warp's pixels, in list order
    int nw = 0;
    if (!__all_sync(0xffffffffu, done)) {
      for (int c0 = 0; c0 < m; c0 += 32) {
        const int j = c0 + lane;
        bool hit = false;
        if (j < m) {
          const float4 b = sb.box[j];
          hit = !(fwx1 < b.x || fwx0 > b.y || fwy1 < b.z || fwy0 > b.w);
        }
        const unsigned ball = __ballot_sync(0xffffffffu, hit);
        if (hit) meets[warp][nw + __popc(ball & ((1u << lane) - 1))] = (unsigned short)j;
        nw += __popc(ball);
      }
      __syncwarp();
    }
    for (int q = 0; q < nw && !done; ++q) {
      const int j = meets[warp][q];
      const float4 p = sb.pos[j];
      const float4 co = sb.conic[j];
      float dx, dy;
      const float power = splat_power(make_float2(p.x, p.y), co, fx, fy, dx, dy);
      if (power > 0.0f || power < p.z) continue;
      const float alpha = fminf(0.99f, p.w * expf(power));
      if (alpha < 1.0f / 255.0f) continue;
      const float w = alpha * T;
      const float4 col = sb.color[j];
      acc_c[0] += w * col.x;
      acc_c[1] += w * col.y;
      acc_c[2] += w * col.z;
      if (features) {
#pragma unroll
        for (int k = 0; k < kFeat / 4; ++k) {
          const float4 f = sb.feat[j][k];
          acc_f[4 * k] += w * f.x;
          acc_f[4 * k + 1] += w * f.y;
          acc_f[4 * k + 2] += w * f.z;
          acc_f[4 * k + 3] += w * f.w;
        }
      }
      acc_d += w * co.w;
      T *= (1.0f - alpha);
      last = base + j;
      if (T < 1e-4f) done = true;
    }
  }
  if (!inside) return;
  const long long hw = (long long)c.height * c.width, pix = (long long)y * c.width + x;
  if (out_T) {
    out_T[pix] = T;
    out_last[pix] = last;
  }
  for (int k = 0; k < 3; ++k) out_color[k * hw + pix] = acc_c[k] + T * c.bg[k];
  if (features)
    for (int k = 0; k < kFeat; ++k) out_feature[k * hw + pix] = acc_f[k];
  out_depth[pix] = acc_d;
  out_alpha[pix] = 1.0f - T;
}

// A splat's gradients from one pixel, or from one tile: d color (3), d
// opacity, d pix_x, d pix_y, d tz, d conic (3), d feature (kFeat); without
// features the first kGeomGrad of them.
constexpr int kGrad = 3 + 1 + 6 + kFeat;
constexpr int kGeomGrad = 3 + 1 + 6;  // the entries before the features
constexpr int kWarps = kBlock / 32;
constexpr int kBwdBatch = 128;  // splats the backward stages a round

// One step of transpose_sum: lanes with bit kO set keep v[kO..2 kO), the
// others v[0..kO), each adding its partner's (lane ^ kO) copy, into
// v[0..kO). kO is a constant so that every index is one: an index the
// compiler cannot resolve would put v in local memory.
template <int kO, int kV>
__device__ __forceinline__ void transpose_step(float (&v)[kV], int lane) {
  const bool upper = (lane & kO) != 0;
#pragma unroll
  for (int i = 0; i < kO; ++i) {
    const float lo = v[i], hi = v[i + kO];
    v[i] = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, upper ? lo : hi, kO);
  }
}

// The sum over the warp's lanes of v[0..kV) (kV = 16 or 32), lane l left
// with the sum of value l % kV: a butterfly that halves the values a lane
// holds at each step (kV - 1 shuffles; for kV = 16 one more adds the two
// half-warps). A fixed tree: the same bits every run.
template <int kV>
__device__ __forceinline__ float transpose_sum(float (&v)[kV], int lane) {
  if constexpr (kV == 32) transpose_step<16>(v, lane);
  transpose_step<8>(v, lane);
  transpose_step<4>(v, lane);
  transpose_step<2>(v, lane);
  transpose_step<1>(v, lane);
  float s = v[0];
  if constexpr (kV == 16) s += __shfl_xor_sync(0xffffffffu, s, 16);
  return s;
}

template <int kG>
struct BackwardShared {
  BlendBatch<kBwdBatch> sb;
  float wsum[kWarps][kBwdBatch][kG];         // a warp's sum of a splat it hit
  unsigned char meets[kWarps][kBwdBatch];    // a warp's splats of the batch, in list order
  unsigned char hit[kWarps][kBwdBatch];      // whether the warp wrote wsum of a splat
  int last[kWarps];                          // a warp's last splat
};

template <bool kWithFeat>
constexpr size_t backward_smem() {
  return sizeof(BackwardShared<kWithFeat ? kGrad : kGeomGrad>);
}

// One 256-thread block a tile, a warp an 8x4 pixel block, as the forward.
// Each pixel walks its splats back to front, from the last the forward
// blended (last_of, list positions; -1 for none) to the first, from the
// forward's final transmittance (final_T): the transmittance before a splat
// is the one after it over 1 - alpha (alpha <= 0.99), and the payload of
// the splats behind it is carried (the C++ takes total - prefix: the last
// bits differ, within the tolerance). The splats are staged kBwdBatch a
// round, as the forward stages them, with its box and skip power; a warp
// walks the round's splats whose box meets its pixels, at or before its
// last splat, and skips what the C++ skips (power > 0, alpha < 1/255).
// A warp that hits a splat sums its gradients over its lanes
// (transpose_sum) into wsum; once a round the block adds the warps that hit
// each splat, in warp order, into the splat's slot of the sorted key list
// (partial [keys, kG]): every slot of the tile is written, zeros where no
// pixel blends the splat. No atomics: two runs give the same bits.
template <bool kWithFeat>
__global__ void __launch_bounds__(kBlock, 2)  // two blocks a multiprocessor at least
backward_kernel(const int2* __restrict__ ranges, const int* __restrict__ point_list,
                const float2* __restrict__ xy, const float4* __restrict__ conic_op,
                const float* __restrict__ depth, const float* __restrict__ colors,
                const float* __restrict__ features, Cam c, const float* __restrict__ grad_color,
                const float* __restrict__ grad_feature, const float* __restrict__ grad_depth,
                const float* __restrict__ grad_alpha, const float* __restrict__ final_T,
                const int* __restrict__ last_of, float* __restrict__ partial) {
  constexpr int kG = kWithFeat ? kGrad : kGeomGrad;
  constexpr int kV = kWithFeat ? 32 : 16;
  extern __shared__ __align__(16) unsigned char smem[];
  BackwardShared<kG>& s = *reinterpret_cast<BackwardShared<kG>*>(smem);
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wx0 = (tile % c.tiles_x) * kTile + (warp & 1) * 8;
  const int wy0 = (tile / c.tiles_x) * kTile + (warp >> 1) * 4;
  const int x = wx0 + (lane & 7), y = wy0 + (lane >> 3);
  const float fwx0 = (float)wx0, fwx1 = (float)(wx0 + 7), fwy0 = (float)wy0,
              fwy1 = (float)(wy0 + 3);
  const bool inside = x < c.width && y < c.height;
  const bool feat_vec = (reinterpret_cast<uintptr_t>(features) & 15) == 0;
  const int2 range = ranges[tile];
  const long long hw = (long long)c.height * c.width, pix = (long long)y * c.width + x;
  float dC[3] = {0.0f, 0.0f, 0.0f}, dF[kFeat], dD = 0.0f, dA = 0.0f, T_final = 1.0f;
#pragma unroll
  for (int k = 0; k < kFeat; ++k) dF[k] = 0.0f;
  int last = -1;
  if (inside) {
    for (int k = 0; k < 3; ++k) dC[k] = grad_color[k * hw + pix];
    if constexpr (kWithFeat)
      for (int k = 0; k < kFeat; ++k) dF[k] = grad_feature[k * hw + pix];
    dD = grad_depth[pix];
    dA = grad_alpha[pix];
    T_final = final_T[pix];
    last = last_of[pix];
  }
  const float bg_dot = c.bg[0] * dC[0] + c.bg[1] * dC[1] + c.bg[2] * dC[2];
  const float fx = (float)x, fy = (float)y;
  const int warp_last = warp_max(last);
  if (lane == 0) s.last[warp] = warp_last;
  __syncthreads();
  int block_last = s.last[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) block_last = max(block_last, s.last[w]);
  const int top = block_last < range.x ? -1 : (block_last - range.x) / kBwdBatch;
  // no pixel reaches the slots past the top round
  for (long long e = (long long)(range.x + (top + 1) * kBwdBatch) * kG + threadIdx.x;
       e < (long long)range.y * kG; e += kBlock)
    partial[e] = 0.0f;

  float T_run = T_final, suffix = 0.0f;
  for (int b = top; b >= 0; --b) {
    const int base = range.x + b * kBwdBatch;
    const int m = min(kBwdBatch, range.y - base);
    __syncthreads();  // the last round's sums are read
    if (threadIdx.x < kBwdBatch)
      load_blend(s.sb, threadIdx.x, point_list, xy, conic_op, depth, colors,
                 kWithFeat ? features : nullptr, feat_vec, base + threadIdx.x, range.y);
    for (int j = lane; j < kBwdBatch; j += 32) s.hit[warp][j] = 0;
    __syncthreads();
    const int mw = min(m, warp_last - base + 1);
    int nw = 0;
    for (int c0 = 0; c0 < mw; c0 += 32) {
      const int j = c0 + lane;
      bool meet = false;
      if (j < mw) {
        const float4 bx = s.sb.box[j];
        meet = !(fwx1 < bx.x || fwx0 > bx.y || fwy1 < bx.z || fwy0 > bx.w);
      }
      const unsigned ball = __ballot_sync(0xffffffffu, meet);
      if (meet) s.meets[warp][nw + __popc(ball & ((1u << lane) - 1))] = (unsigned char)j;
      nw += __popc(ball);
    }
    __syncwarp();
    for (int q = nw - 1; q >= 0; --q) {
      const int j = s.meets[warp][q];
      float v[kV];
#pragma unroll
      for (int i = 0; i < kV; ++i) v[i] = 0.0f;
      bool hit = false;
      if (base + j <= last) {
        const float4 p = s.sb.pos[j];
        const float4 co = s.sb.conic[j];
        float dx, dy;
        const float power = splat_power(make_float2(p.x, p.y), co, fx, fy, dx, dy);
        if (!(power > 0.0f || power < p.z)) {
          const float G = expf(power);
          const float alpha = fminf(0.99f, p.w * G);
          if (alpha >= 1.0f / 255.0f) {
            hit = true;
            const float one_m = 1.0f - alpha;  // >= 0.01: the C++'s max(1 - alpha, 1e-6)
            const float T = T_run / one_m;     // before this splat
            const float w = alpha * T;
            const float4 col = s.sb.color[j];
            float payload = col.x * dC[0] + col.y * dC[1] + col.z * dC[2] + co.w * dD;
            v[0] = w * dC[0];
            v[1] = w * dC[1];
            v[2] = w * dC[2];
            v[6] = w * dD;  // the expected-depth payload
            if constexpr (kWithFeat) {
#pragma unroll
              for (int k4 = 0; k4 < kFeat / 4; ++k4) {
                const float4 f = s.sb.feat[j][k4];
                const float fk[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  payload += fk[i] * dF[4 * k4 + i];
                  v[kGeomGrad + 4 * k4 + i] = w * dF[4 * k4 + i];
                }
              }
            }
            const float d_alpha =
                T * payload - (suffix + T_final * bg_dot) / one_m + (T_final / one_m) * dA;
            if (p.w * G < 0.99f) {  // alpha = min(0.99, o G): the clamp kills local gradients
              v[3] = d_alpha * G;
              const float d_power = d_alpha * p.w * G;
              v[7] = d_power * (-0.5f * dx * dx);
              v[8] = d_power * (-dx * dy);
              v[9] = d_power * (-0.5f * dy * dy);
              v[4] = d_power * (-(co.x * dx + co.y * dy));
              v[5] = d_power * (-(co.z * dy + co.y * dx));
            }
            suffix += w * payload;
            T_run = T;
          }
        }
      }
      if (__any_sync(0xffffffffu, hit)) {
        const float sum = transpose_sum<kV>(v, lane);
        if (lane < kG) s.wsum[warp][j][lane] = sum;
        if (lane == 0) s.hit[warp][j] = 1;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < m * kG; e += kBlock) {
      const int j = e / kG, q = e - j * kG;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (s.hit[w][j]) sum += s.wsum[w][j][q];
      partial[(long long)base * kG + e] = sum;
    }
  }
}

// One warp a gaussian, lane q its value q: its tiles' partial sums added in
// the order its keys were written (offsets[i] on, touched[i] of them), each
// slot's row read whole by the warp. accum [n, 6]: d pix_x, d pix_y, d tz,
// d conic (3); g_colors [n, 3], g_opacities [n], g_features [n, kFeat]
// (kWithFeat only); every one written whole.
template <bool kWithFeat>
__global__ void __launch_bounds__(256)
backward_sum_kernel(int n, const int* __restrict__ touched, const int* __restrict__ offsets,
                    const int* __restrict__ slot_of, const float* __restrict__ partial,
                    float* __restrict__ accum, float* __restrict__ g_colors,
                    float* __restrict__ g_opacities, float* __restrict__ g_features) {
  constexpr int kG = kWithFeat ? kGrad : kGeomGrad;
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int q = threadIdx.x & 31;
  if (i >= n || q >= kG) return;
  const int first = offsets[i], count = touched[i];
  float sum = 0.0f;
  for (int u = first; u < first + count; ++u) sum += partial[(long long)slot_of[u] * kG + q];
  if (q < 3) g_colors[3 * i + q] = sum;
  else if (q == 3) g_opacities[i] = sum;
  else if (q < kGeomGrad) accum[6 * i + q - 4] = sum;
  else g_features[kFeat * i + q - kGeomGrad] = sum;
}

// The geometry chain of one gaussian (gaussian_raster.cpp:390-537).
__global__ void __launch_bounds__(256)
backward_geom_kernel(const float* __restrict__ means3d, const float* __restrict__ scales,
                     const float* __restrict__ rotations, int n, Cam c,
                     const float* __restrict__ accum, float* __restrict__ g_means3d,
                     float* __restrict__ g_scales, float* __restrict__ g_rotations) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  for (int k = 0; k < 3; ++k) g_means3d[3LL * i + k] = 0.0f;
  for (int k = 0; k < 3; ++k) g_scales[3LL * i + k] = 0.0f;
  for (int k = 0; k < 4; ++k) g_rotations[4LL * i + k] = 0.0f;
  Geo g;
  preprocess_one(means3d, scales, rotations, i, c, g);
  if (!g.valid) return;
  const float* a6 = accum + 6LL * i;
  const float g_px = a6[0], g_py = a6[1], g_tz = a6[2];
  const float g_conic[3] = {a6[3], a6[4], a6[5]};
  if (!(g_px != 0 || g_py != 0 || g_tz != 0 || g_conic[0] != 0 || g_conic[1] != 0 ||
        g_conic[2] != 0))
    return;
  const float* V = c.V;
  const float* P = c.P;
  const float focal_x = c.width / (2.0f * c.tan_fovx);
  const float focal_y = c.height / (2.0f * c.tan_fovy);

  const float* co = g.conic;
  const float G00 = g_conic[0], G11 = g_conic[2];
  const float G01 = 0.5f * g_conic[1];
  const float C00 = co[0], C01 = co[1], C11 = co[2];
  const float CG00 = C00 * G00 + C01 * G01, CG01 = C00 * G01 + C01 * G11;
  const float CG10 = C01 * G00 + C11 * G01, CG11 = C01 * G01 + C11 * G11;
  const float dS2_00 = -(CG00 * C00 + CG01 * C01);
  const float dS2_01 = -(CG00 * C01 + CG01 * C11);
  const float dS2_10 = -(CG10 * C00 + CG11 * C01);
  const float dS2_11 = -(CG10 * C01 + CG11 * C11);
  const float dS2s01 = 0.5f * (dS2_01 + dS2_10);

  const float* T = g.T;
  const float* c3 = g.c3;
  const float S9[9] = {c3[0], c3[1], c3[2], c3[1], c3[3], c3[4], c3[2], c3[4], c3[5]};
  float dS3[9];
  for (int r = 0; r < 3; ++r)
    for (int k = 0; k < 3; ++k)
      dS3[r * 3 + k] = T[r] * (dS2_00 * T[k] + dS2s01 * T[3 + k]) +
                       T[3 + r] * (dS2s01 * T[k] + dS2_11 * T[3 + k]);
  float TS3[6];
  for (int r = 0; r < 2; ++r)
    for (int k = 0; k < 3; ++k)
      TS3[r * 3 + k] = T[r * 3] * S9[k] + T[r * 3 + 1] * S9[3 + k] + T[r * 3 + 2] * S9[6 + k];
  float dT[6];
  for (int k = 0; k < 3; ++k) {
    dT[k] = 2.0f * (dS2_00 * TS3[k] + dS2s01 * TS3[3 + k]);
    dT[3 + k] = 2.0f * (dS2s01 * TS3[k] + dS2_11 * TS3[3 + k]);
  }
  const float W9[9] = {V[0], V[1], V[2], V[4], V[5], V[6], V[8], V[9], V[10]};
  float dJ[6];
  for (int r = 0; r < 2; ++r)
    for (int k = 0; k < 3; ++k)
      dJ[r * 3 + k] = dT[r * 3] * W9[k * 3] + dT[r * 3 + 1] * W9[k * 3 + 1] +
                      dT[r * 3 + 2] * W9[k * 3 + 2];

  const float tx = g.tx, ty = g.ty, tz = g.tz;
  const float limx = 1.3f * c.tan_fovx, limy = 1.3f * c.tan_fovy;
  const float ctx = fminf(limx, fmaxf(-limx, tx / tz)) * tz;
  const float cty = fminf(limy, fmaxf(-limy, ty / tz)) * tz;
  float dtx = 0.0f, dty = 0.0f, dtz = g_tz;
  dtz += dJ[0] * (-focal_x / (tz * tz));
  dtz += dJ[4] * (-focal_y / (tz * tz));
  const float dctx = dJ[2] * (-focal_x / (tz * tz));
  dtz += dJ[2] * (2.0f * focal_x * ctx / (tz * tz * tz));
  const float dcty = dJ[5] * (-focal_y / (tz * tz));
  dtz += dJ[5] * (2.0f * focal_y * cty / (tz * tz * tz));
  if (g.clampsx != 0.0f) dtz += dctx * g.clampsx * limx;
  else dtx += dctx;
  if (g.clampsy != 0.0f) dtz += dcty * g.clampsy * limy;
  else dty += dcty;

  const float* M = g.M;
  const float* R = g.R;
  float dM[9];
  for (int r = 0; r < 3; ++r)
    for (int k = 0; k < 3; ++k)
      dM[r * 3 + k] =
          2.0f * (dS3[r * 3] * M[k] + dS3[r * 3 + 1] * M[3 + k] + dS3[r * 3 + 2] * M[6 + k]);
  const float* s = scales + 3LL * i;
  float dRm[9];
  for (int k = 0; k < 3; ++k) {
    const float smc = s[k] * c.scale_modifier;
    float ds = 0.0f;
    for (int r = 0; r < 3; ++r) {
      ds += dM[r * 3 + k] * R[r * 3 + k];
      dRm[r * 3 + k] = dM[r * 3 + k] * smc;
    }
    g_scales[3LL * i + k] = ds * c.scale_modifier;
  }

  const float* q = g.qn;
  const float w = q[0], xq = q[1], yq = q[2], zq = q[3];
  float dqn[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  dqn[2] += dRm[0] * (-4 * yq); dqn[3] += dRm[0] * (-4 * zq);
  dqn[0] += dRm[1] * (-2 * zq); dqn[1] += dRm[1] * (2 * yq);
  dqn[2] += dRm[1] * (2 * xq);  dqn[3] += dRm[1] * (-2 * w);
  dqn[0] += dRm[2] * (2 * yq);  dqn[1] += dRm[2] * (2 * zq);
  dqn[2] += dRm[2] * (2 * w);   dqn[3] += dRm[2] * (2 * xq);
  dqn[0] += dRm[3] * (2 * zq);  dqn[1] += dRm[3] * (2 * yq);
  dqn[2] += dRm[3] * (2 * xq);  dqn[3] += dRm[3] * (2 * w);
  dqn[1] += dRm[4] * (-4 * xq); dqn[3] += dRm[4] * (-4 * zq);
  dqn[0] += dRm[5] * (-2 * xq); dqn[1] += dRm[5] * (-2 * w);
  dqn[2] += dRm[5] * (2 * zq);  dqn[3] += dRm[5] * (2 * yq);
  dqn[0] += dRm[6] * (-2 * yq); dqn[1] += dRm[6] * (2 * zq);
  dqn[2] += dRm[6] * (-2 * w);  dqn[3] += dRm[6] * (2 * xq);
  dqn[0] += dRm[7] * (2 * xq);  dqn[1] += dRm[7] * (2 * w);
  dqn[2] += dRm[7] * (2 * zq);  dqn[3] += dRm[7] * (2 * yq);
  dqn[1] += dRm[8] * (-4 * xq); dqn[2] += dRm[8] * (-4 * yq);
  const float dot = dqn[0] * w + dqn[1] * xq + dqn[2] * yq + dqn[3] * zq;
  for (int k = 0; k < 4; ++k) g_rotations[4LL * i + k] = (dqn[k] - q[k] * dot) / g.qlen;

  const float inv_w = 1.0f / (g.cw + 1e-7f);
  const float dcx = g_px * 0.5f * c.width * inv_w;
  const float dcy = g_py * 0.5f * c.height * inv_w;
  const float dcw = -(g_px * 0.5f * c.width * g.cx + g_py * 0.5f * c.height * g.cy) * inv_w * inv_w;
  float dp[3];
  for (int k = 0; k < 3; ++k) dp[k] = dcx * P[k] + dcy * P[4 + k] + dcw * P[12 + k];
  dp[0] += dtx * V[0] + dty * V[4] + dtz * V[8];
  dp[1] += dtx * V[1] + dty * V[5] + dtz * V[9];
  dp[2] += dtx * V[2] + dty * V[6] + dtz * V[10];
  for (int k = 0; k < 3; ++k) g_means3d[3LL * i + k] = dp[k];
}

inline unsigned blocks_for(long long n) { return (unsigned)((n + 255) / 256); }

// params: V (16), P (16), bg (3), tan_fovx, tan_fovy, scale_modifier
Cam make_cam(const float* params, int height, int width) {
  Cam c;
  for (int k = 0; k < 16; ++k) c.V[k] = params[k];
  for (int k = 0; k < 16; ++k) c.P[k] = params[16 + k];
  for (int k = 0; k < 3; ++k) c.bg[k] = params[32 + k];
  c.tan_fovx = params[35];
  c.tan_fovy = params[36];
  c.scale_modifier = params[37];
  c.height = height;
  c.width = width;
  c.tiles_x = (width + kTile - 1) / kTile;
  c.tiles_y = (height + kTile - 1) / kTile;
  return c;
}

}  // namespace

// (a) preprocess, the tiles' key counts and the scan: params is host memory
// (38 floats); radii, touched, offsets [n] int32; xy [n, 2], conic_op [n,
// 4], depth [n] f32; rect [n, 4] int32; tile_count [tiles], tile_start
// [tiles + 1] int32; block_sums [scan_blocks(max(n, tiles + 1)), 2] int32;
// total [2] int32 (the key count, twice).
extern "C" int orv_raster_preprocess(const void* means3d, const void* scales,
                                     const void* rotations, const void* opacities, int n,
                                     const float* params, int height, int width, void* radii,
                                     void* xy, void* conic_op, void* depth, void* rect,
                                     void* touched, void* offsets, void* tile_count,
                                     void* tile_start, void* block_sums, void* total,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Cam c = make_cam(params, height, width);
  const int n_tiles = c.tiles_x * c.tiles_y;
  cudaError_t err = cudaMemsetAsync(tile_count, 0, sizeof(int) * (size_t)n_tiles, s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    preprocess_kernel<<<blocks_for(n), 256, 0, s>>>(
        (const float*)means3d, (const float*)scales, (const float*)rotations,
        (const float*)opacities, n, c, (int*)radii, (float2*)xy, (float4*)conic_op,
        (float*)depth, (int4*)rect, (int*)touched, (int*)tile_count);
  }
  device_scan<Int2>(BinLoad{(const int*)touched, (const int*)tile_count, n, n_tiles},
                    BinStore{(int*)offsets, (int*)tile_start, n, n_tiles},
                    n > n_tiles + 1 ? n : n_tiles + 1, (Int2*)block_sums, (Int2*)total, s);
  return (int)cudaGetLastError();
}

// (b) the tiles' sorted key lists: list [keys] (the keys, in no order, then
// scratch); ranges [tiles] int32 x 2, point_list [keys] int32 and, where not
// null, slot_of [keys] int32 (the backward's slot map).
extern "C" int orv_raster_bin(int n, const void* touched, const void* offsets, const void* rect,
                              const void* depth, int height, int width, const void* tile_start,
                              void* tile_count, void* list, void* ranges, void* point_list,
                              void* slot_of, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles_x = (width + kTile - 1) / kTile, tiles_y = (height + kTile - 1) / kTile;
  if (n > 0) {
    tile_fill_kernel<<<blocks_for(n), 256, 0, s>>>(
        n, (const int*)touched, (const int4*)rect, (const float*)depth, tiles_x,
        (const int*)tile_start, (int*)tile_count, (unsigned long long*)list);
  }
  tile_sort_kernel<<<tiles_x * tiles_y, kSortThreads, 0, s>>>(
      (const int*)tile_start, (unsigned long long*)list, tiles_x, (const int*)offsets,
      (const int4*)rect, (int2*)ranges, (int*)point_list, (int*)slot_of);
  return (int)cudaGetLastError();
}

// (c) the blend: features and out_feature may be null; out_T [H, W] f32 and
// out_last [H, W] int32, the backward's state (each pixel's final
// transmittance and the list position of the last splat it blends, -1 for
// none), may be null: not written.
extern "C" int orv_raster_forward(const void* ranges, const void* point_list, const void* xy,
                                  const void* conic_op, const void* depth, const void* colors,
                                  const void* features, const float* params, int height,
                                  int width, void* out_color, void* out_feature, void* out_depth,
                                  void* out_alpha, void* out_T, void* out_last, void* stream) {
  const Cam c = make_cam(params, height, width);
  forward_kernel<<<c.tiles_x * c.tiles_y, kBlock, 0, (cudaStream_t)stream>>>(
      (const int2*)ranges, (const int*)point_list, (const float2*)xy, (const float4*)conic_op,
      (const float*)depth, (const float*)colors, (const float*)features, c, (float*)out_color,
      (float*)out_feature, (float*)out_depth, (float*)out_alpha, (float*)out_T,
      (int*)out_last);
  return (int)cudaGetLastError();
}

namespace {

template <bool kWithFeat>
cudaError_t launch_backward(const Cam& c, int n, const void* ranges, const void* point_list,
                            const void* xy, const void* conic_op, const void* depth,
                            const void* means3d, const void* scales, const void* rotations,
                            const void* colors, const void* features, const void* grad_color,
                            const void* grad_feature, const void* grad_depth,
                            const void* grad_alpha, const void* final_T, const void* last_of,
                            void* accum, void* g_means3d, void* g_colors, void* g_features,
                            void* g_opacities, void* g_scales, void* g_rotations,
                            const void* touched, const void* offsets, const void* slot_of,
                            void* partial, cudaStream_t s) {
  constexpr size_t smem = backward_smem<kWithFeat>();
  static bool sized = false;  // the shared-memory limit raised once a process
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        backward_kernel<kWithFeat>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  backward_kernel<kWithFeat><<<c.tiles_x * c.tiles_y, kBlock, smem, s>>>(
      (const int2*)ranges, (const int*)point_list, (const float2*)xy, (const float4*)conic_op,
      (const float*)depth, (const float*)colors, (const float*)features, c,
      (const float*)grad_color, (const float*)grad_feature, (const float*)grad_depth,
      (const float*)grad_alpha, (const float*)final_T, (const int*)last_of, (float*)partial);
  if (n > 0) {
    backward_sum_kernel<kWithFeat><<<blocks_for(32LL * n), 256, 0, s>>>(
        n, (const int*)touched, (const int*)offsets, (const int*)slot_of,
        (const float*)partial, (float*)accum, (float*)g_colors, (float*)g_opacities,
        (float*)g_features);
    backward_geom_kernel<<<blocks_for(n), 256, 0, s>>>(
        (const float*)means3d, (const float*)scales, (const float*)rotations, n, c,
        (const float*)accum, (float*)g_means3d, (float*)g_scales, (float*)g_rotations);
  }
  return cudaGetLastError();
}

}  // namespace

// (d) the backward: final_T [H, W] and last_of [H, W], the forward's state
// (orv_raster_forward's out_T and out_last); accum [n, 6] scratch; g_colors,
// g_opacities, g_means3d, g_scales, g_rotations written whole, g_features
// too where features and grad_feature are given (else it is not touched).
// touched and offsets [n] are the preprocess's, slot_of [keys] the
// binning's; partial [keys, 22] f32 ([keys, 10] without features) scratch,
// written whole.
extern "C" int orv_raster_backward(const void* ranges, const void* point_list, const void* xy,
                                   const void* conic_op, const void* depth, const void* means3d,
                                   const void* scales, const void* rotations, const void* colors,
                                   const void* features, int n, const float* params, int height,
                                   int width, const void* grad_color, const void* grad_feature,
                                   const void* grad_depth, const void* grad_alpha,
                                   const void* final_T, const void* last_of, void* accum,
                                   void* g_means3d, void* g_colors, void* g_features,
                                   void* g_opacities, void* g_scales, void* g_rotations,
                                   const void* touched, const void* offsets, const void* slot_of,
                                   void* partial, void* stream) {
  const Cam c = make_cam(params, height, width);
  const bool with_feat = features != nullptr && grad_feature != nullptr;
  return (int)(with_feat ? launch_backward<true> : launch_backward<false>)(
      c, n, ranges, point_list, xy, conic_op, depth, means3d, scales, rotations, colors,
      features, grad_color, grad_feature, grad_depth, grad_alpha, final_T, last_of, accum,
      g_means3d, g_colors, g_features, g_opacities, g_scales, g_rotations, touched, offsets,
      slot_of, partial, (cudaStream_t)stream);
}

// The backward kernel's residency: blocks[0] its blocks a multiprocessor
// can hold, blocks[1] its dynamic shared memory in bytes (with features
// where with_feat, else without).
extern "C" int orv_raster_backward_occupancy(int with_feat, void* blocks) {
  int* out = (int*)blocks;
  const int smem = (int)(with_feat ? backward_smem<true>() : backward_smem<false>());
  cudaError_t err = with_feat
      ? cudaFuncSetAttribute(backward_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
      : cudaFuncSetAttribute(backward_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  err = with_feat ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], backward_kernel<true>,
                                                                  kBlock, smem)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], backward_kernel<false>,
                                                                  kBlock, smem);
  out[1] = smem;
  return (int)err;
}
