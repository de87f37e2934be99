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
// Every float32 result equals the plain version's
// (s2p_tpu_torch/ops/interp.py) bitwise.  The library is built with
// --fmad=false and without fast math: no multiply and add fuse unless
// written as __fmaf_rn, and the coordinates' divisions are IEEE divisions.
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
// every comparison with them is false) is NaN and reads nothing.
//
// Bound: operations, not bytes.  An order-5 pixel reads 36 taps, mostly
// from L1 (neighbouring threads' 6 x 6 footprints overlap), and writes 4
// bytes; the first version spent about 1,100 instructions on it.  Three
// facts let most of them go without changing a bit of the output:
//
// 1. Half of the weights' terms are exactly zero.  For t in [0, 1],
//    t - o <= 1 - o, and rounding is monotone, so v = fl(fl(t - o) + 3)
//    <= 4 - o and u = max(v - k, 0) = 0 for every k >= 4 - o.  Such a
//    term is c * 0 = +-0, and adding +-0 to the accumulator, which starts
//    at +0 and is never -0 (a sum of float32 values is -0 only when both
//    are), leaves it unchanged bit for bit.  So offset o sums k = 0 ..
//    3 - o: 21 terms an axis instead of 42.  The maximum stays as the
//    reference writes it (at k = 3 - o, v - k may be exactly 0).
// 2. Division by 120 without a division.  With R = RN(1/120), q0 = x R,
//    e = fma(-q0, 120, x) is exact and q = fma(e, R, q0) is the correctly
//    rounded x / 120 (Markstein's correction) for 2^-123 <= |x| <= FLT_MAX.
//    Below that the quotient is subnormal and the correction can miss by
//    an ulp; -0 gives +0 and inf gives NaN.  Those inputs take the IEEE
//    division (the weights' sums never reach them).  chip_smoke.py runs
//    all 2^32 float32 bit patterns through div120 and __fdiv_rn(x, 120)
//    on the card and requires 0 mismatches among non-NaN results.
// 3. Interior pixels need no clamps.  When the whole support lies inside
//    the source (order 5: x0 - 2 >= 0, x0 + 3 <= W - 1, and the same in
//    y; order 3 its 4 x 4), the taps are read at constant offsets from
//    one pointer; pixels whose support meets a border clamp their rows
//    and columns once and read through row pointers.  Both read the same
//    taps.  On an H100 the clamped path alone takes about 1.3x as long
//    at orders 3 and 5, whose 36 or 16 taps then each need an address of
//    their own; order 1's four taps gained about 2%, so order 1 always
//    clamps.
//
// The NaN mask is dilated once per source by warp_dilate_kernel into a
// byte map bad6[y, x]: 1 where a mask value m with !(m <= 0) lies in rows
// clamp(y - 2 .. y + 3) and columns clamp(x - 2 .. x + 3), the clamped
// 6 x 6 support of a pixel with integer parts (x0, y0) = (x, y).  A
// masked pixel then reads one byte instead of 36 floats, and a bad one
// skips its weights and taps: its output is NaN whatever they are.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BX = 32, BY = 8;
// the dilation's window around a pixel: rows and columns -2 .. +3
constexpr int DLO = 2, DHI = 3;

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}

// x / 120, correctly rounded (see 2. above)
__device__ __forceinline__ float div120(float x) {
  const float R = 0x1.111112p-7f;  // RN(1 / 120)
  const float a = fabsf(x);
  if (a >= 0x1p-123f && a <= 0x1.fffffep127f) {
    const float q0 = x * R;
    const float e = __fmaf_rn(-q0, 120.0f, x);
    return __fmaf_rn(e, R, q0);
  }
  return x / 120.0f;
}

__device__ __forceinline__ void weights5(float t, float* w) {
  const float c[6] = {1.f, -6.f, 15.f, -20.f, 15.f, -6.f};
#pragma unroll
  for (int o = -2; o <= 3; ++o) {
    const float v = (t - (float)o) + 3.0f;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k <= 3 - o; ++k) {
      const float u = fmaxf(v - (float)k, 0.0f);
      const float p = u * ((u * u) * (u * u));
      acc = acc + c[k] * p;
    }
    w[o + 2] = div120(acc);
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

// sum_j wy[j] * sum_i wx[i] * tap(j, i), each sum from +0 in order
template <int N, class Tap>
__device__ __forceinline__ float sum_taps(const float* wx, const float* wy,
                                          Tap tap) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float row = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) row = row + wx[i] * tap(j, i);
    acc = acc + wy[j] * row;
  }
  return acc;
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

template <int ORDER>
__global__ void __launch_bounds__(BX * BY)
warp_kernel(const float* __restrict__ src, const uint8_t* __restrict__ bad6,
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
  constexpr float lo = ORDER == 3 ? 1.0f : 0.0f;
  constexpr float edge = ORDER == 3 ? 2.0f : 1.0f;
  const bool inside = (sx >= lo) & (sy >= lo) & (sx <= (float)(W - edge)) &
                      (sy <= (float)(H - edge));
  if (!inside) {
    *dst = __int_as_float(0x7fc00000);
    return;
  }
  const int x0 = (int)floorf(sx), y0 = (int)floorf(sy);
  if (ORDER == 5 && bad6 != nullptr &&
      __ldg(bad6 + (size_t)y0 * W + x0)) {
    *dst = __int_as_float(0x7fc00000);
    return;
  }
  const float tx = sx - (float)x0, ty = sy - (float)y0;
  float res;
  if constexpr (ORDER == 1) {
    const float* r0 = src + (size_t)y0 * W;
    const float* r1 = src + (size_t)clampi(y0 + 1, H - 1) * W;
    const int x1 = clampi(x0 + 1, W - 1);
    const float v00 = ld(r0 + x0), v01 = ld(r0 + x1);
    const float v10 = ld(r1 + x0), v11 = ld(r1 + x1);
    float ux = 1.0f - tx, uy = 1.0f - ty;
    res = (((v00 * uy) * ux + (v01 * uy) * tx) + (v10 * ty) * ux) +
          (v11 * ty) * tx;
  } else {
    // the support: rows and columns x0 - OFF .. x0 - OFF + N - 1
    constexpr int N = ORDER + 1, OFF = ORDER == 5 ? 2 : 1;
    const bool interior = (x0 >= OFF) & (y0 >= OFF) &
                          (x0 - OFF + N <= W) & (y0 - OFF + N <= H);
    float wx[N], wy[N];
    if constexpr (ORDER == 5) {
      weights5(tx, wx);
      weights5(ty, wy);
    } else {
      weights3(tx, wx);
      weights3(ty, wy);
    }
    if (interior) {
      const float* p = src + (size_t)(y0 - OFF) * W + (x0 - OFF);
      res = sum_taps<N>(wx, wy,
                        [&](int j, int i) { return ld(p + j * W + i); });
    } else {
      int cols[N];
      const float* rows[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        cols[i] = clampi(x0 + i - OFF, W - 1);
        rows[i] = src + (size_t)clampi(y0 + i - OFF, H - 1) * W;
      }
      res = sum_taps<N>(wx, wy,
                        [&](int j, int i) { return ld(rows[j] + cols[i]); });
    }
  }
  *dst = res;
}

// bad6 of one source, a tile of DW x DH pixels a block: the tile's
// (DH + 5) x (DW + 5) clamped window of mask verdicts in shared memory,
// ORed along rows, then along columns
constexpr int DW = 32, DH = 32;

__global__ void __launch_bounds__(BX * BY)
warp_dilate_kernel(const float* __restrict__ mask, uint8_t* __restrict__ bad6,
                   int H, int W) {
  constexpr int SH = DH + DLO + DHI, SW = DW + DLO + DHI;
  __shared__ uint8_t s[SH][SW];
  __shared__ uint8_t r[SH][DW];
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int y_base = blockIdx.y * DH - DLO, x_base = blockIdx.x * DW - DLO;
  for (int k = tid; k < SH * SW; k += BX * BY) {
    const int iy = clampi(y_base + k / SW, H - 1);
    const int ix = clampi(x_base + k % SW, W - 1);
    s[k / SW][k % SW] = !(__ldg(mask + (size_t)iy * W + ix) <= 0.0f);
  }
  __syncthreads();
  for (int k = tid; k < SH * DW; k += BX * BY) {
    const int row = k / DW, col = k % DW;
    uint8_t v = 0;
#pragma unroll
    for (int i = 0; i <= DLO + DHI; ++i) v |= s[row][col + i];
    r[row][col] = v;
  }
  __syncthreads();
  const int x = blockIdx.x * DW + threadIdx.x;
  if (x >= W) return;
  for (int ty = threadIdx.y; ty < DH; ty += BY) {
    const int y = blockIdx.y * DH + ty;
    if (y >= H) return;
    uint8_t v = 0;
#pragma unroll
    for (int j = 0; j <= DLO + DHI; ++j) v |= r[ty + j][threadIdx.x];
    bad6[(size_t)y * W + x] = v;
  }
}

// the exhaustive check of div120: every float32 bit pattern against the
// IEEE division; counts[0] the mismatches among non-NaN results, counts[1]
// those of the correction alone, without div120's guard
__global__ void div120_check_kernel(unsigned long long* counts) {
  const float R = 0x1.111112p-7f;
  unsigned long long bad = 0, bad_fast = 0;
  for (uint64_t u = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
       u < (1ull << 32); u += (uint64_t)gridDim.x * blockDim.x) {
    const float x = __uint_as_float((uint32_t)u);
    const float want = __fdiv_rn(x, 120.0f);
    const float got = div120(x);
    const float q0 = x * R;
    const float fast = __fmaf_rn(__fmaf_rn(-q0, 120.0f, x), R, q0);
    bad += !(isnan(got) && isnan(want)) &&
           __float_as_uint(got) != __float_as_uint(want);
    bad_fast += !(isnan(fast) && isnan(want)) &&
                __float_as_uint(fast) != __float_as_uint(want);
  }
  atomicAdd(counts, bad);
  atomicAdd(counts + 1, bad_fast);
}

template <int ORDER>
cudaError_t launch(const float* src, const uint8_t* bad6, const float* hinv,
                   float* out, int B, int H, int W, int out_h, int out_w,
                   cudaStream_t stream) {
  dim3 block(BX, BY);
  dim3 grid((out_w + BX - 1) / BX, (out_h + BY - 1) / BY, B);
  warp_kernel<ORDER><<<grid, block, 0, stream>>>(src, bad6, hinv, out, H, W,
                                                 out_h, out_w);
  return cudaGetLastError();
}

}  // namespace

// mask: for order 5, null or the (H, W) uint8 map of s2p_warp_dilate
extern "C" int s2p_warp(const void* src, const void* mask, const void* hinv,
                        void* out, int B, int H, int W, int out_h, int out_w,
                        int order, cudaStream_t stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || out_h < 1 || out_w < 1)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<const float*>(src);
  auto m = static_cast<const uint8_t*>(mask);
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

// bad6 (H, W) uint8 from the (H, W) float32 NaN mask of one source
extern "C" int s2p_warp_dilate(const void* mask, void* bad6, int H, int W,
                               cudaStream_t stream) {
  if (H < 1 || W < 1 || (H + DH - 1) / DH > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 block(BX, BY);
  dim3 grid((W + DW - 1) / DW, (H + DH - 1) / DH);
  warp_dilate_kernel<<<grid, block, 0, stream>>>(
      static_cast<const float*>(mask), static_cast<uint8_t*>(bad6), H, W);
  return (int)cudaGetLastError();
}

// counts: 2 unsigned 64-bit integers on the device, zeroed by the caller
extern "C" int s2p_warp_div120_check(void* counts, cudaStream_t stream) {
  div120_check_kernel<<<132 * 16, 256, 0, stream>>>(
      static_cast<unsigned long long*>(counts));
  return (int)cudaGetLastError();
}

extern "C" const char* s2p_warp_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
