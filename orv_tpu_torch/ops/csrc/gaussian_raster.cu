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
// planes written once); the blend's exp and multiply-adds are small beside
// them. Design, in the C++'s order of operations:
//   (a) preprocess_kernel, one thread a gaussian: gaussian_raster.cpp:87-176
//       in f32 (near cull at tz < 0.2, EWA with the 1.3 tan-fov clamp and
//       the 0.3 low-pass, det <= 0 cull, radius ceil(3 sqrt(lambda)), the
//       pixel rectangle with C's (int) truncation of pix_x), and the number
//       of 16x16 tiles it touches; a one-block scan gives each gaussian its
//       first key slot;
//   (b) emit_keys_kernel writes one (tile << 32 | depth bits) key a touched
//       tile, in gaussian order; the wrapper sorts them stably (torch.sort),
//       so equal depths keep gaussian-index order (the C++'s std::sort leaves
//       them unspecified); tile_ranges_kernel finds each tile's run;
//   (c) forward_kernel, one 256-thread block a tile, one thread a pixel:
//       splats staged through shared memory in batches of 256, blended front
//       to back exactly as :228-255 (skip power > 0 or alpha < 1/255, alpha
//       = min(0.99, o exp(power)), stop after the splat that takes T below
//       1e-4, background on color only); the block leaves when every pixel
//       is done;
//   (d) backward_kernel walks each pixel's splats twice (:308-384): once for
//       the final transmittance and the total payload, once for each splat's
//       gradients. Each splat's gradients are summed over the tile's pixels
//       in a fixed order (a shuffle tree in each warp, then the warps in
//       order through shared memory) into the splat's slot of the sorted key
//       list, one slot a (tile, gaussian); backward_sum_kernel, one thread a
//       gaussian, adds its slots in the order emit_keys_kernel wrote them
//       (its tiles row by row), found through the inverse of the sort's
//       permutation. No atomics: two runs give the same bits, as the C++'s
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

// xy [n, 2], conic_op [n, 4] (conic, opacity), depth [n], rect [n, 4]
// (tile x0, x1, y0, y1 inclusive), touched [n].
__global__ void __launch_bounds__(256)
preprocess_kernel(const float* __restrict__ means3d, const float* __restrict__ scales,
                  const float* __restrict__ rotations, const float* __restrict__ opacities, int n,
                  Cam c, int* __restrict__ radii, float2* __restrict__ xy,
                  float4* __restrict__ conic_op, float* __restrict__ depth,
                  int4* __restrict__ rect, int* __restrict__ touched) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Geo g;
  preprocess_one(means3d, scales, rotations, i, c, g);
  radii[i] = g.radius;
  if (!g.valid) {
    touched[i] = 0;
    return;
  }
  xy[i] = make_float2(g.px, g.py);
  conic_op[i] = make_float4(g.conic[0], g.conic[1], g.conic[2], opacities[i]);
  depth[i] = g.tz;
  const int4 r = make_int4(g.x0 / kTile, (g.x1 - 1) / kTile, g.y0 / kTile, (g.y1 - 1) / kTile);
  rect[i] = r;
  touched[i] = (r.y - r.x + 1) * (r.w - r.z + 1);
}

__global__ void __launch_bounds__(256)
emit_keys_kernel(int n, const int* __restrict__ touched, const int* __restrict__ offsets,
                 const int4* __restrict__ rect, const float* __restrict__ depth, int tiles_x,
                 long long* __restrict__ keys, int* __restrict__ vals) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || touched[i] == 0) return;
  int off = offsets[i];
  const int4 r = rect[i];
  const long long dbits = (long long)__float_as_uint(depth[i]);  // depth >= 0.2: ordered bits
  for (int ty = r.z; ty <= r.w; ++ty)
    for (int tx = r.x; tx <= r.y; ++tx) {
      keys[off] = ((long long)(ty * tiles_x + tx) << 32) | dbits;
      vals[off] = i;
      ++off;
    }
}

__global__ void __launch_bounds__(256)
clear_ranges_kernel(int n_tiles, int2* __restrict__ ranges) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n_tiles) ranges[t] = make_int2(0, 0);
}

// skeys sorted, perm their positions before the sort: point_list[k] is the
// gaussian of sorted key k, ranges[tile] its [start, end).
__global__ void __launch_bounds__(256)
tile_ranges_kernel(const long long* __restrict__ skeys, const long long* __restrict__ perm,
                   const int* __restrict__ vals, int total, int2* __restrict__ ranges,
                   int* __restrict__ point_list) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= total) return;
  point_list[k] = vals[perm[k]];
  const int tile = (int)(skeys[k] >> 32);
  if (k == 0 || (int)(skeys[k - 1] >> 32) != tile) ranges[tile].x = k;
  if (k == total - 1 || (int)(skeys[k + 1] >> 32) != tile) ranges[tile].y = k + 1;
}

// One batch of splats in shared memory.
struct Batch {
  int id[kBlock];
  float2 xy[kBlock];
  float4 conic_op[kBlock];
  float depth[kBlock];
};

__device__ __forceinline__ void load_batch(Batch& sb, const int* __restrict__ point_list,
                                           const float2* __restrict__ xy,
                                           const float4* __restrict__ conic_op,
                                           const float* __restrict__ depth, int k, int end) {
  if (k < end) {
    const int id = point_list[k];
    sb.id[threadIdx.x] = id;
    sb.xy[threadIdx.x] = xy[id];
    sb.conic_op[threadIdx.x] = conic_op[id];
    sb.depth[threadIdx.x] = depth[id];
  }
}

// power of a splat at pixel (x, y), in the C++'s order (:229-231)
__device__ __forceinline__ float splat_power(float2 p, float4 co, float x, float y, float& dx,
                                             float& dy) {
  dx = p.x - x;
  dy = p.y - y;
  return -0.5f * (co.x * dx * dx + co.z * dy * dy) - co.y * dx * dy;
}

__global__ void __launch_bounds__(kBlock)
forward_kernel(const int2* __restrict__ ranges, const int* __restrict__ point_list,
               const float2* __restrict__ xy, const float4* __restrict__ conic_op,
               const float* __restrict__ depth, const float* __restrict__ colors,
               const float* __restrict__ features, Cam c, float* __restrict__ out_color,
               float* __restrict__ out_feature, float* __restrict__ out_depth,
               float* __restrict__ out_alpha) {
  __shared__ Batch sb;
  const int tile = blockIdx.x;
  const int x = (tile % c.tiles_x) * kTile + threadIdx.x % kTile;
  const int y = (tile / c.tiles_x) * kTile + threadIdx.x / kTile;
  const bool inside = x < c.width && y < c.height;
  const int2 range = ranges[tile];
  bool done = !inside;
  float T = 1.0f, acc_c[3] = {0.0f, 0.0f, 0.0f}, acc_f[kFeat], acc_d = 0.0f;
#pragma unroll
  for (int k = 0; k < kFeat; ++k) acc_f[k] = 0.0f;
  const float fx = (float)x, fy = (float)y;
  for (int base = range.x; base < range.y; base += kBlock) {
    if (__syncthreads_count(done) == kBlock) break;
    load_batch(sb, point_list, xy, conic_op, depth, base + threadIdx.x, range.y);
    __syncthreads();
    const int m = min(kBlock, range.y - base);
    for (int j = 0; j < m && !done; ++j) {
      const float4 co = sb.conic_op[j];
      float dx, dy;
      const float power = splat_power(sb.xy[j], co, fx, fy, dx, dy);
      if (power > 0.0f) continue;
      const float alpha = fminf(0.99f, co.w * expf(power));
      if (alpha < 1.0f / 255.0f) continue;
      const float w = alpha * T;
      const int id = sb.id[j];
      const float* col = colors + 3LL * id;
      acc_c[0] += w * col[0];
      acc_c[1] += w * col[1];
      acc_c[2] += w * col[2];
      if (features) {
        const float* f = features + (long long)kFeat * id;
#pragma unroll
        for (int k = 0; k < kFeat; ++k) acc_f[k] += w * f[k];
      }
      acc_d += w * sb.depth[j];
      T *= (1.0f - alpha);
      if (T < 1e-4f) done = true;
    }
  }
  if (!inside) return;
  const long long hw = (long long)c.height * c.width, pix = (long long)y * c.width + x;
  for (int k = 0; k < 3; ++k) out_color[k * hw + pix] = acc_c[k] + T * c.bg[k];
  if (features)
    for (int k = 0; k < kFeat; ++k) out_feature[k * hw + pix] = acc_f[k];
  out_depth[pix] = acc_d;
  out_alpha[pix] = 1.0f - T;
}

// A splat's gradients from one pixel, or from one tile: d color (3), d
// opacity, d pix_x, d pix_y, d tz, d conic (3), d feature (kFeat).
constexpr int kGrad = 3 + 1 + 6 + kFeat;
constexpr int kGeomGrad = 3 + 1 + 6;  // the entries before the features
constexpr int kRound = 32;  // splats summed over the block per round
constexpr int kWarps = kBlock / 32;

// partial [keys, kGrad]: a slot per sorted key, zero on entry; a tile writes
// the slots of the splats its pixels reach.
__global__ void __launch_bounds__(kBlock)
backward_kernel(const int2* __restrict__ ranges, const int* __restrict__ point_list,
                const float2* __restrict__ xy, const float4* __restrict__ conic_op,
                const float* __restrict__ depth, const float* __restrict__ colors,
                const float* __restrict__ features, Cam c, const float* __restrict__ grad_color,
                const float* __restrict__ grad_feature, const float* __restrict__ grad_depth,
                const float* __restrict__ grad_alpha, float* __restrict__ partial) {
  __shared__ Batch sb;
  __shared__ float wsum[kWarps][kRound][kGrad];
  const int tile = blockIdx.x;
  const int x = (tile % c.tiles_x) * kTile + threadIdx.x % kTile;
  const int y = (tile / c.tiles_x) * kTile + threadIdx.x / kTile;
  const bool inside = x < c.width && y < c.height;
  const int2 range = ranges[tile];
  const long long hw = (long long)c.height * c.width, pix = (long long)y * c.width + x;
  const bool with_feat = features != nullptr && grad_feature != nullptr;
  float dC[3] = {0.0f, 0.0f, 0.0f}, dF[kFeat], dD = 0.0f, dA = 0.0f;
#pragma unroll
  for (int k = 0; k < kFeat; ++k) dF[k] = 0.0f;
  if (inside) {
    for (int k = 0; k < 3; ++k) dC[k] = grad_color[k * hw + pix];
    if (with_feat)
      for (int k = 0; k < kFeat; ++k) dF[k] = grad_feature[k * hw + pix];
    dD = grad_depth[pix];
    dA = grad_alpha[pix];
  }
  const float fx = (float)x, fy = (float)y;

  // pass A: the forward's transmittance, the total payload and the last
  // splat (list position) this pixel blends
  bool done = !inside;
  float T = 1.0f, total = 0.0f;
  int last = range.x - 1;
  for (int base = range.x; base < range.y; base += kBlock) {
    if (__syncthreads_count(done) == kBlock) break;
    load_batch(sb, point_list, xy, conic_op, depth, base + threadIdx.x, range.y);
    __syncthreads();
    const int m = min(kBlock, range.y - base);
    for (int j = 0; j < m && !done; ++j) {
      const float4 co = sb.conic_op[j];
      float dx, dy;
      const float power = splat_power(sb.xy[j], co, fx, fy, dx, dy);
      if (power > 0.0f) continue;
      const float alpha = fminf(0.99f, co.w * expf(power));
      if (alpha < 1.0f / 255.0f) continue;
      const float w = alpha * T;
      const int id = sb.id[j];
      const float* col = colors + 3LL * id;
      float payload = col[0] * dC[0] + col[1] * dC[1] + col[2] * dC[2] + sb.depth[j] * dD;
      if (with_feat) {
        const float* f = features + (long long)kFeat * id;
        for (int k = 0; k < kFeat; ++k) payload += f[k] * dF[k];
      }
      total += w * payload;
      last = base + j;
      T *= (1.0f - alpha);
      if (T < 1e-4f) done = true;
    }
  }
  const float T_final = T;
  const float bg_dot = c.bg[0] * dC[0] + c.bg[1] * dC[1] + c.bg[2] * dC[2];

  // pass B: front to back again, each blended splat's gradients
  int block_last = last;
  {
    __shared__ int red[kBlock / 32];
    for (int o = 16; o > 0; o >>= 1) block_last = max(block_last, __shfl_xor_sync(~0u, block_last, o));
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = block_last;
    __syncthreads();
    block_last = red[0];
    for (int w = 1; w < kBlock / 32; ++w) block_last = max(block_last, red[w]);
  }
  // the block walks every splat up to block_last together (a pixel past its
  // own last splat adds zeros), kRound splats a round: each warp's sum of
  // a splat goes to wsum, then the block adds the warps in order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_grad = with_feat ? kGrad : kGeomGrad;  // the features' sums stay zero
  float T_run = 1.0f, prefix = 0.0f;
  for (int base = range.x; base <= block_last; base += kBlock) {
    __syncthreads();
    load_batch(sb, point_list, xy, conic_op, depth, base + threadIdx.x, range.y);
    __syncthreads();
    const int m = min(kBlock, block_last + 1 - base);
    for (int j0 = 0; j0 < m; j0 += kRound) {
      const int mr = min(kRound, m - j0);
      for (int r = 0; r < mr; ++r) {
        const int j = j0 + r;
        float gr[kGrad];
#pragma unroll
        for (int q = 0; q < kGrad; ++q) gr[q] = 0.0f;
        bool hit = false;
        if (base + j <= last) {
          const float4 co = sb.conic_op[j];
          float dx, dy;
          const float power = splat_power(sb.xy[j], co, fx, fy, dx, dy);
          const float G = expf(power);
          const float alpha = fminf(0.99f, co.w * G);
          if (power <= 0.0f && alpha >= 1.0f / 255.0f) {
            hit = true;
            const float w = alpha * T_run;
            const int id = sb.id[j];
            const float* col = colors + 3LL * id;
            float payload = col[0] * dC[0] + col[1] * dC[1] + col[2] * dC[2] + sb.depth[j] * dD;
            if (with_feat) {
              const float* f = features + (long long)kFeat * id;
              for (int k = 0; k < kFeat; ++k) payload += f[k] * dF[k];
            }
            prefix += w * payload;
            const float suffix = total - prefix;
            for (int k = 0; k < 3; ++k) gr[k] = w * dC[k];
            if (with_feat)
              for (int k = 0; k < kFeat; ++k) gr[kGeomGrad + k] = w * dF[k];
            gr[6] = w * dD;  // the expected-depth payload
            const float one_m = fmaxf(1.0f - alpha, 1e-6f);
            const float d_alpha =
                T_run * payload - (suffix + T_final * bg_dot) / one_m + (T_final / one_m) * dA;
            if (co.w * G < 0.99f) {  // alpha = min(0.99, o G): the clamp kills local gradients
              gr[3] = d_alpha * G;
              const float d_power = d_alpha * co.w * G;
              gr[7] = d_power * (-0.5f * dx * dx);
              gr[8] = d_power * (-dx * dy);
              gr[9] = d_power * (-0.5f * dy * dy);
              gr[4] = d_power * (-(co.x * dx + co.y * dy));
              gr[5] = d_power * (-(co.z * dy + co.y * dx));
            }
            T_run *= (1.0f - alpha);
          }
        }
        if (__any_sync(~0u, hit)) {
#pragma unroll
          for (int q = 0; q < kGrad; ++q) {
            if (q >= n_grad) break;
            float x = gr[q];
            for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(~0u, x, o);
            if (lane == 0) wsum[warp][r][q] = x;
          }
        } else if (lane == 0) {
          for (int q = 0; q < n_grad; ++q) wsum[warp][r][q] = 0.0f;
        }
      }
      __syncthreads();
      for (int e = threadIdx.x; e < mr * n_grad; e += kBlock) {
        const int r = e / n_grad, q = e % n_grad;
        float x = wsum[0][r][q];
        for (int w = 1; w < kWarps; ++w) x += wsum[w][r][q];
        partial[(long long)(base + j0 + r) * kGrad + q] = x;
      }
      __syncthreads();
    }
  }
}

// slot_of[perm[k]] = k: the sorted position of each key emit_keys_kernel wrote.
__global__ void __launch_bounds__(256)
invert_perm_kernel(const long long* __restrict__ perm, int total, int* __restrict__ slot_of) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < total) slot_of[perm[k]] = k;
}

// One thread a gaussian: its tiles' partial sums added in the order its keys
// were written (offsets[i] on, touched[i] of them). accum [n, 6]: d pix_x,
// d pix_y, d tz, d conic (3); g_colors [n, 3], g_opacities [n], g_features
// [n, kFeat] (null: not written); every one written whole.
__global__ void __launch_bounds__(256)
backward_sum_kernel(int n, const int* __restrict__ touched, const int* __restrict__ offsets,
                    const int* __restrict__ slot_of, const float* __restrict__ partial,
                    float* __restrict__ accum, float* __restrict__ g_colors,
                    float* __restrict__ g_opacities, float* __restrict__ g_features) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sum[kGrad];
#pragma unroll
  for (int q = 0; q < kGrad; ++q) sum[q] = 0.0f;
  const int first = offsets[i], count = touched[i];
  for (int u = first; u < first + count; ++u) {
    const float* p = partial + (long long)slot_of[u] * kGrad;
#pragma unroll
    for (int q = 0; q < kGrad; ++q) sum[q] += p[q];
  }
  for (int k = 0; k < 3; ++k) g_colors[3LL * i + k] = sum[k];
  g_opacities[i] = sum[3];
  for (int k = 0; k < 6; ++k) accum[6LL * i + k] = sum[4 + k];
  if (g_features)
    for (int k = 0; k < kFeat; ++k) g_features[(long long)kFeat * i + k] = sum[kGeomGrad + k];
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

// (a) preprocess and the key offsets: params is host memory (38 floats);
// radii, touched, offsets [n] int32; xy [n, 2], conic_op [n, 4], depth [n]
// f32; rect [n, 4] int32; total [1] int32 (the key count).
extern "C" int orv_raster_preprocess(const void* means3d, const void* scales,
                                     const void* rotations, const void* opacities, int n,
                                     const float* params, int height, int width, void* radii,
                                     void* xy, void* conic_op, void* depth, void* rect,
                                     void* touched, void* offsets, void* total, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Cam c = make_cam(params, height, width);
  if (n > 0) {
    preprocess_kernel<<<blocks_for(n), 256, 0, s>>>(
        (const float*)means3d, (const float*)scales, (const float*)rotations,
        (const float*)opacities, n, c, (int*)radii, (float2*)xy, (float4*)conic_op,
        (float*)depth, (int4*)rect, (int*)touched);
  }
  exclusive_scan_kernel<<<1, kScanThreads, 0, s>>>((const int*)touched, n, (int*)offsets,
                                                   (int*)total);
  return (int)cudaGetLastError();
}

// (b) the keys of every touched tile: keys [total] int64, vals [total] int32.
extern "C" int orv_raster_keys(int n, const void* touched, const void* offsets, const void* rect,
                               const void* depth, int width, void* keys, void* vals,
                               void* stream) {
  if (n > 0) {
    emit_keys_kernel<<<blocks_for(n), 256, 0, (cudaStream_t)stream>>>(
        n, (const int*)touched, (const int*)offsets, (const int4*)rect, (const float*)depth,
        (width + kTile - 1) / kTile, (long long*)keys, (int*)vals);
  }
  return (int)cudaGetLastError();
}

// (b) after the stable sort: ranges [tiles] int32 x 2 and point_list [total].
extern "C" int orv_raster_ranges(const void* skeys, const void* perm, const void* vals, int total,
                                 int height, int width, void* ranges, void* point_list,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = ((width + kTile - 1) / kTile) * ((height + kTile - 1) / kTile);
  clear_ranges_kernel<<<blocks_for(n_tiles), 256, 0, s>>>(n_tiles, (int2*)ranges);
  if (total > 0) {
    tile_ranges_kernel<<<blocks_for(total), 256, 0, s>>>(
        (const long long*)skeys, (const long long*)perm, (const int*)vals, total, (int2*)ranges,
        (int*)point_list);
  }
  return (int)cudaGetLastError();
}

// (c) the blend: features and out_feature may be null.
extern "C" int orv_raster_forward(const void* ranges, const void* point_list, const void* xy,
                                  const void* conic_op, const void* depth, const void* colors,
                                  const void* features, const float* params, int height,
                                  int width, void* out_color, void* out_feature, void* out_depth,
                                  void* out_alpha, void* stream) {
  const Cam c = make_cam(params, height, width);
  forward_kernel<<<c.tiles_x * c.tiles_y, kBlock, 0, (cudaStream_t)stream>>>(
      (const int2*)ranges, (const int*)point_list, (const float2*)xy, (const float4*)conic_op,
      (const float*)depth, (const float*)colors, (const float*)features, c, (float*)out_color,
      (float*)out_feature, (float*)out_depth, (float*)out_alpha);
  return (int)cudaGetLastError();
}

// (d) the backward: accum [n, 6] scratch; g_colors, g_opacities,
// g_means3d, g_scales, g_rotations written whole, g_features too where
// features and grad_feature are given (else it is not touched). perm [total]
// int64 is the key sort's permutation, touched and offsets [n] the
// preprocess's, partial [total, 22] f32 zeroed by the caller and slot_of
// [total] int32 scratch.
extern "C" int orv_raster_backward(const void* ranges, const void* point_list, const void* xy,
                                   const void* conic_op, const void* depth, const void* means3d,
                                   const void* scales, const void* rotations, const void* colors,
                                   const void* features, int n, const float* params, int height,
                                   int width, const void* grad_color, const void* grad_feature,
                                   const void* grad_depth, const void* grad_alpha, void* accum,
                                   void* g_means3d, void* g_colors, void* g_features,
                                   void* g_opacities, void* g_scales, void* g_rotations,
                                   const void* perm, const void* touched, const void* offsets,
                                   int total, void* partial, void* slot_of, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Cam c = make_cam(params, height, width);
  const bool with_feat = features != nullptr && grad_feature != nullptr;
  backward_kernel<<<c.tiles_x * c.tiles_y, kBlock, 0, s>>>(
      (const int2*)ranges, (const int*)point_list, (const float2*)xy, (const float4*)conic_op,
      (const float*)depth, (const float*)colors, (const float*)features, c,
      (const float*)grad_color, (const float*)grad_feature, (const float*)grad_depth,
      (const float*)grad_alpha, (float*)partial);
  if (total > 0)
    invert_perm_kernel<<<blocks_for(total), 256, 0, s>>>((const long long*)perm, total,
                                                        (int*)slot_of);
  if (n > 0) {
    backward_sum_kernel<<<blocks_for(n), 256, 0, s>>>(
        n, (const int*)touched, (const int*)offsets, (const int*)slot_of,
        (const float*)partial, (float*)accum, (float*)g_colors, (float*)g_opacities,
        with_feat ? (float*)g_features : nullptr);
    backward_geom_kernel<<<blocks_for(n), 256, 0, s>>>(
        (const float*)means3d, (const float*)scales, (const float*)rotations, n, c,
        (const float*)accum, (float*)g_means3d, (float*)g_scales, (float*)g_rotations);
  }
  return (int)cudaGetLastError();
}
