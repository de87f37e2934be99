// W1: resampling of one source image under a batch of homographies.
//
// Replaces the jitted jnp program s2p_tpu/ops/interp.py warp_homography
// (:145), vmapped over a batch of homographies in
// s2p_tpu/ops/homography.py _warp_batch_jit (:81): the dense warps of
// stage 3 (epipolar rectification) and of stage 5's clr colours.  It is
// not a Pallas kernel, but in eager PyTorch an order-5 warp is about 700
// small operations, so it gets a kernel of its own.
//
// out[b, y, x] = sample(src, hinv[b] @ (x, y, 1)), one thread per output
// pixel of the (B, out_h, out_w) batch; orders 1 (bilinear), 3
// (Catmull-Rom) and 5 (the quintic B-spline on prefiltered coefficients,
// with an optional NaN mask of the original image) are instantiations of
// one template.
//
// Every float32 operation is the reference's, in its order, so the result
// equals the plain version (s2p_tpu_torch/ops/interp.py) bitwise.  The
// library is built with --fmad=false and without fast math: no multiply
// and add fuse, and both divisions are IEEE divisions.
//
//   z  = (h20 x + h21 y) + h22,  sx = ((h00 x + h01 y) + h02) / z, sy alike
//   inside: 0 <= sx <= w - 1 and 0 <= sy <= h - 1 (order 3: 1 .. w - 2)
//   order 5 weight of offset o:  v = (t - o) + 3,
//       acc = sum_k from +0 of (-1)^k C(6, k) * u * ((u u) (u u)),
//       u = max(v - k, 0);  w = acc / 120
//   taps: row_j = sum_i from +0 of wx[i] * src[clamp(y0 + j - 2),
//         clamp(x0 + i - 2)], out = sum_j from +0 of wy[j] * row_j
//   mask: the maximum of 0 and the 36 taps of the mask; the sample is
//         NaN unless it is 0
//
// The reference computes x + 3.0 once for each k; it is the same value
// each time, so the kernel computes it once.  A pixel outside its source
// (also one whose z is 0 or near it: its coordinates are inf or NaN, and
// every comparison with them is false) is NaN and reads nothing; the
// integer parts of the others lie in the source, and each tap's index is
// clamped as _gather2d clamps it.
//
// Bound: operations.  An order-5 pixel inside the source takes about 730
// float32 operations (the weights about 620 of them) against 4 bytes
// written and 36 taps read, mostly from L1 and L2: neighbouring threads
// read overlapping 6 x 6 footprints.  This first version reads the taps
// through the read-only cache; staging the footprint of a block in
// shared memory is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BX = 32, BY = 8;

__device__ __forceinline__ float tap(const float* __restrict__ src, int H,
                                     int W, int iy, int ix) {
  iy = min(max(iy, 0), H - 1);
  ix = min(max(ix, 0), W - 1);
  return __ldg(src + (size_t)iy * W + ix);
}

__device__ __forceinline__ void weights5(float t, float* w) {
  const float c[7] = {1.f, -6.f, 15.f, -20.f, 15.f, -6.f, 1.f};
#pragma unroll
  for (int o = -2; o <= 3; ++o) {
    float v = (t - (float)o) + 3.0f;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      float u = fmaxf(v - (float)k, 0.0f);
      float p = u * ((u * u) * (u * u));
      acc = acc + c[k] * p;
    }
    w[o + 2] = acc / 120.0f;
  }
}

__device__ __forceinline__ void weights3(float t, float* w) {
  float t2 = t * t;
  float t3 = t2 * t;
  w[0] = ((-0.5f * t3) + t2) - (0.5f * t);
  w[1] = ((1.5f * t3) - (2.5f * t2)) + 1.0f;
  w[2] = ((-1.5f * t3) + (2.0f * t2)) + (0.5f * t);
  w[3] = (0.5f * t3) - (0.5f * t2);
}

template <int ORDER>
__global__ void __launch_bounds__(BX * BY)
warp_kernel(const float* __restrict__ src, const float* __restrict__ mask,
            const float* __restrict__ hinv, float* __restrict__ out, int H,
            int W, int out_h, int out_w) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= out_w || y >= out_h) return;
  const float* m = hinv + 9 * b;
  const float fx = (float)x, fy = (float)y;
  const float z = (m[6] * fx + m[7] * fy) + m[8];
  const float sx = (m[0] * fx + m[1] * fy + m[2]) / z;
  const float sy = (m[3] * fx + m[4] * fy + m[5]) / z;
  float* dst = out + ((size_t)b * out_h + y) * out_w + x;
  const float lo = ORDER == 3 ? 1.0f : 0.0f;
  const float edge = ORDER == 3 ? 2.0f : 1.0f;
  const bool inside = (sx >= lo) & (sy >= lo) & (sx <= (float)(W - edge)) &
                      (sy <= (float)(H - edge));
  if (!inside) {
    *dst = __int_as_float(0x7fc00000);
    return;
  }
  const int x0 = (int)floorf(sx), y0 = (int)floorf(sy);
  const float tx = sx - (float)x0, ty = sy - (float)y0;
  float res;
  if constexpr (ORDER == 1) {
    float v00 = tap(src, H, W, y0, x0), v01 = tap(src, H, W, y0, x0 + 1);
    float v10 = tap(src, H, W, y0 + 1, x0);
    float v11 = tap(src, H, W, y0 + 1, x0 + 1);
    float ux = 1.0f - tx, uy = 1.0f - ty;
    res = (((v00 * uy) * ux + (v01 * uy) * tx) + (v10 * ty) * ux) +
          (v11 * ty) * tx;
  } else {
    constexpr int N = ORDER + 1, OFF = ORDER == 5 ? 2 : 1;
    float wx[N], wy[N];
    if constexpr (ORDER == 5) {
      weights5(tx, wx);
      weights5(ty, wy);
    } else {
      weights3(tx, wx);
      weights3(ty, wy);
    }
    float acc = 0.0f;
    bool bad = false;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float row = 0.0f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        row = row + wx[i] * tap(src, H, W, y0 + j - OFF, x0 + i - OFF);
        if (ORDER == 5 && mask != nullptr)
          bad |= !(tap(mask, H, W, y0 + j - OFF, x0 + i - OFF) <= 0.0f);
      }
      acc = acc + wy[j] * row;
    }
    res = bad ? __int_as_float(0x7fc00000) : acc;
  }
  *dst = res;
}

template <int ORDER>
cudaError_t launch(const float* src, const float* mask, const float* hinv,
                   float* out, int B, int H, int W, int out_h, int out_w,
                   cudaStream_t stream) {
  dim3 block(BX, BY);
  dim3 grid((out_w + BX - 1) / BX, (out_h + BY - 1) / BY, B);
  warp_kernel<ORDER><<<grid, block, 0, stream>>>(src, mask, hinv, out, H, W,
                                                 out_h, out_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" int s2p_warp(const void* src, const void* mask, const void* hinv,
                        void* out, int B, int H, int W, int out_h, int out_w,
                        int order, cudaStream_t stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || out_h < 1 || out_w < 1)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<const float*>(src);
  auto m = static_cast<const float*>(mask);
  auto h = static_cast<const float*>(hinv);
  auto o = static_cast<float*>(out);
  cudaError_t rc;
  switch (order) {
    case 1: rc = launch<1>(s, nullptr, h, o, B, H, W, out_h, out_w, stream);
      break;
    case 3: rc = launch<3>(s, nullptr, h, o, B, H, W, out_h, out_w, stream);
      break;
    case 5: rc = launch<5>(s, m, h, o, B, H, W, out_h, out_w, stream);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)rc;
}

extern "C" const char* s2p_warp_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
