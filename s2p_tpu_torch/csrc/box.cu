// B1: box sums along one axis, the window means of the msmw matcher.
//
// Replaces the prefix-sum box filter of s2p_tpu/ops/msmw.py _box (:42), a
// jnp program (two jnp.cumsum and four shifted differences), not a Pallas
// kernel.  The prefix sums of a full tile's squared differences reach
// about 2.6e10, where a float32 ulp is 2048: the box differences taken of
// them lose several digits, and each order of summation (XLA's rewrite of
// a long cumsum on the CPU, numpy's, torch's parallel scan on the card)
// gives other costs.  So the port sums each window directly, in one fixed
// order that the card and the CPU both run:
//
//   out[b, y, x] = (((0 + v[-r]) + v[-r + 1]) + ... + v[r]) * scale
//
// with v[k] the input at y + k (vertical) or x + k (horizontal), 0 outside
// the image (the zero padding of the JAX package's _box), and the product
// only where scale != 0.  A window mean of (2ry + 1) x (2rx + 1) is a
// vertical pass with no scale, then a horizontal pass times f32(1 / area):
// XLA's CPU run of _box divides by the area so, as a product with the
// rounded reciprocal.  The plain version (s2p_tpu_torch/ops/msmw.py
// box_sum_plain) adds the same shifted planes in the same order and
// multiplies by the same float32, so the two agree bit for bit; the build
// disables FMA contraction.
//
// One thread per output element of a (B, H, W) float32 volume; the
// vertical pass reads 2r + 1 rows that neighbouring threads share along
// x (coalesced), the horizontal pass 2r + 1 consecutive values that
// neighbouring threads share through L1.  Bound: bytes (each input read
// once, each output written once, from the cache), 8 bytes an element.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kVertical>
__global__ void __launch_bounds__(kThreads)
box_kernel(const float* __restrict__ in, float* __restrict__ out,
           long long n, int H, int W, int r, float scale) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % W);
  const long long row = i / W;             // b * H + y
  const int y = (int)(row % H);
  float s = 0.f;
  if (kVertical) {
    const float* const p = in + (row - y) * W + x;
    for (int k = -r; k <= r; ++k) {
      const int yy = y + k;
      const float v = yy >= 0 && yy < H ? __ldg(p + (long long)yy * W) : 0.f;
      s = s + v;
    }
  } else {
    const float* const p = in + row * W;
    for (int k = -r; k <= r; ++k) {
      const int xx = x + k;
      const float v = xx >= 0 && xx < W ? __ldg(p + xx) : 0.f;
      s = s + v;
    }
  }
  if (scale != 0.f) s = s * scale;
  out[i] = s;
}

}  // namespace

// in, out: (B, H, W) float32, contiguous, distinct.  vertical: sum along
// H (else along W); scale 0 for none.
extern "C" int s2p_box(const void* in, void* out, int B, int H, int W, int r,
                       int vertical, float scale, void* stream) {
  if (B < 0 || H < 0 || W < 0 || r < 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * H * W;
  if (n == 0) return (int)cudaGetLastError();
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (vertical)
    box_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const float*)in, (float*)out, n, H, W, r, scale);
  else
    box_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const float*)in, (float*)out, n, H, W, r, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* s2p_box_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
