// Winner-take-all with subpixel offset over the summed aggregation
// partials.
//
// Replaces s2p_tpu/ops/sgm_pallas.py _wta_kernel (:358, wrapper
// _wta_pallas :445) in two of its modes:
//
//   * s2p_wta (K3, the mgm flow): emit_offset, without the right-reference
//     map (with_dr=False), with big_guard, and the two knobs of the
//     single-tile flow's refinement (s2p_tpu/ops/mgm_flow.py _wta_refine,
//     :191), which the TPU kernel does not have: edge_subpix (refine next
//     to out-of-range neighbours too) and plateau_zero (no refinement
//     where the fit's denominator is not above 1e-9);
//   * s2p_wta_dr (K5, the classic SGM matcher): the disparity composed in
//     the kernel (emit_offset=False), no big_guard, and the right-reference
//     disparity dR (with_dr=True).
//
// Per pixel (y, x):
//
//   S[k]  = part0[y, k, x] + part1[y, k, x]
//   mn    = min_k S[k],  d = lowest k with S[k] == mn
//   c0/c2 = S[d - 1] / S[d + 1] (inf off the ends; non-finite -> mn + 1e6)
//   off   = vfit:     (c0 - c2) / max(2 (max(c0, c2) - mn), 1e-9)
//           parabola: 0.5 (c0 - c2) / max((c0 - 2 mn) + c2, 1e-9)
//   off   = clip(off, -0.5, 0.5), and 0 with plateau_zero where the
//           denominator is not above 1e-9
//   off   = off where d is interior (and, with big_guard and without
//           edge_subpix, c0, c2 < big_guard), else 0
//   K3:  off, NaN where mn >= big_guard;   K5:  disp = (dmin + d) + off
//
// K5 also reduces the right-reference volume S_R[k, x] = S[k, x - dmin - k]
// (inf where that column leaves [0, W)) the same way, its neighbours c0/c2
// taken along k of S_R, and writes dR = -((dmin + kR) + offR).  A column
// whose S_R is all inf gives kR = 0 and offR = 0.  The TPU kernel builds
// S_R with a log-step lane roll; here each thread reads it directly.
//
// The division is IEEE (no fast math).  Each part is a strided view, so
// the horizontal partial is read in its own (W, D, H) layout without a
// transposed copy.
//
// Bound: bytes (two f32 volumes read once).  One thread per pixel with x
// fastest: part0 reads coalesce; the transposed part1 reads one 4-byte
// word per 32-byte sector.  K5 reads both volumes a second time for S_R
// (mostly from L2: neighbouring threads read neighbouring diagonals).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Part {
  const float* p;
  long long sb, sy, sk, sx;
};

__device__ __forceinline__ float sum_at(const Part& a, const Part& c,
                                        int n_parts, int b, int y, int k,
                                        int x) {
  float v = a.p[b * a.sb + y * a.sy + k * a.sk + x * a.sx];
  if (n_parts == 2) v = v + c.p[b * c.sb + y * c.sy + k * c.sk + x * c.sx];
  return v;
}

__device__ __forceinline__ float subpix_offset(float c0, float c1, float c2,
                                              int subpix, int plateau_zero) {
  float o = 0.f, den = 1.f;
  if (subpix == 1) {                 // vfit
    den = 2.0f * (fmaxf(c0, c2) - c1);
    o = (c0 - c2) / fmaxf(den, 1e-9f);
    o = fminf(fmaxf(o, -0.5f), 0.5f);
  } else if (subpix == 2) {          // parabola
    den = (c0 - 2.0f * c1) + c2;
    o = (0.5f * (c0 - c2)) / fmaxf(den, 1e-9f);
    o = fminf(fmaxf(o, -0.5f), 0.5f);
  }
  if (plateau_zero && !(den > 1e-9f)) o = 0.f;
  return o;
}

__global__ void wta_kernel(Part a, Part c, int n_parts, float* __restrict__ off,
                           int* __restrict__ dint, int B, int H, int D, int W,
                           int subpix, int edge_subpix, int plateau_zero,
                           float big_guard) {
  const long long total = (long long)B * H * W;
  const float inf = __int_as_float(0x7f800000);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int x = (int)(i % W);
    const int y = (int)((i / W) % H);
    const int b = (int)(i / ((long long)W * H));
    float mn = sum_at(a, c, n_parts, b, y, 0, x);
    int d = 0;
    for (int k = 1; k < D; ++k) {
      const float v = sum_at(a, c, n_parts, b, y, k, x);
      if (v < mn) {
        mn = v;
        d = k;
      }
    }
    float c0 = d > 0 ? sum_at(a, c, n_parts, b, y, d - 1, x) : inf;
    float c2 = d < D - 1 ? sum_at(a, c, n_parts, b, y, d + 1, x) : inf;
    const float guard = mn + 1e6f;
    if (!isfinite(c0)) c0 = guard;
    if (!isfinite(c2)) c2 = guard;
    const bool interior = d > 0 && d < D - 1 &&
                          (edge_subpix || (c0 < big_guard && c2 < big_guard));
    float o = subpix_offset(c0, mn, c2, subpix, plateau_zero);
    if (!interior) o = 0.f;
    off[i] = mn < big_guard ? o : __int_as_float(0x7fc00000);
    dint[i] = d;
  }
}

// K5: one pixel of the left map and one of the right-reference map.
__global__ void wta_dr_kernel(Part a, Part c, int n_parts,
                              float* __restrict__ disp, int* __restrict__ dint,
                              float* __restrict__ dr, int B, int H, int D,
                              int W, int disp_min, int subpix) {
  const long long total = (long long)B * H * W;
  const float inf = __int_as_float(0x7f800000);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int x = (int)(i % W);
    const int y = (int)((i / W) % H);
    const int b = (int)(i / ((long long)W * H));
    // left reference
    float mn = sum_at(a, c, n_parts, b, y, 0, x);
    int d = 0;
    for (int k = 1; k < D; ++k) {
      const float v = sum_at(a, c, n_parts, b, y, k, x);
      if (v < mn) {
        mn = v;
        d = k;
      }
    }
    float c0 = d > 0 ? sum_at(a, c, n_parts, b, y, d - 1, x) : inf;
    float c2 = d < D - 1 ? sum_at(a, c, n_parts, b, y, d + 1, x) : inf;
    float guard = mn + 1e6f;
    if (!isfinite(c0)) c0 = guard;
    if (!isfinite(c2)) c2 = guard;
    float o = subpix_offset(c0, mn, c2, subpix, 0);
    if (!(d > 0 && d < D - 1)) o = 0.f;
    disp[i] = ((float)disp_min + (float)d) + o;
    dint[i] = d;
    // right reference: S_R[k] = S[k, x - dmin - k], inf outside [0, W)
    float mnr = inf;
    int kr = 0;                          // every S_R[k] inf: k = 0
    for (int k = 0; k < D; ++k) {
      const int xs = x - disp_min - k;
      const float v =
          xs >= 0 && xs < W ? sum_at(a, c, n_parts, b, y, k, xs) : inf;
      if (k == 0 || v < mnr) {
        mnr = v;
        kr = k;
      }
    }
    int xs = x - disp_min - (kr - 1);
    c0 = kr > 0 && xs >= 0 && xs < W
             ? sum_at(a, c, n_parts, b, y, kr - 1, xs) : inf;
    xs = x - disp_min - (kr + 1);
    c2 = kr < D - 1 && xs >= 0 && xs < W
             ? sum_at(a, c, n_parts, b, y, kr + 1, xs) : inf;
    guard = mnr + 1e6f;
    if (!isfinite(c0)) c0 = guard;
    if (!isfinite(c2)) c2 = guard;
    o = subpix_offset(c0, mnr, c2, subpix, 0);
    if (!(kr > 0 && kr < D - 1)) o = 0.f;
    dr[i] = -(((float)disp_min + (float)kr) + o);
  }
}

}  // namespace

extern "C" int s2p_wta(const void* p0, long long s0b, long long s0y,
                       long long s0k, long long s0x, const void* p1,
                       long long s1b, long long s1y, long long s1k,
                       long long s1x, int n_parts, void* off, void* dint,
                       int B, int H, int D, int W, int subpix, int edge_subpix,
                       int plateau_zero, float big_guard, void* stream) {
  const long long total = (long long)B * H * W;
  if (n_parts < 1 || n_parts > 2) return (int)cudaErrorInvalidValue;
  if (total > 0 && D > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > (1LL << 30)) blocks = 1LL << 30;
    Part a{(const float*)p0, s0b, s0y, s0k, s0x};
    Part c{(const float*)(n_parts == 2 ? p1 : p0), s1b, s1y, s1k, s1x};
    wta_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        a, c, n_parts, (float*)off, (int*)dint, B, H, D, W, subpix,
        edge_subpix, plateau_zero, big_guard);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* s2p_wta_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int s2p_wta_dr(const void* p0, long long s0b, long long s0y,
                          long long s0k, long long s0x, const void* p1,
                          long long s1b, long long s1y, long long s1k,
                          long long s1x, int n_parts, void* disp, void* dint,
                          void* dr, int B, int H, int D, int W, int disp_min,
                          int subpix, void* stream) {
  const long long total = (long long)B * H * W;
  if (n_parts < 1 || n_parts > 2) return (int)cudaErrorInvalidValue;
  if (total > 0 && D > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > (1LL << 30)) blocks = 1LL << 30;
    Part a{(const float*)p0, s0b, s0y, s0k, s0x};
    Part c{(const float*)(n_parts == 2 ? p1 : p0), s1b, s1y, s1k, s1x};
    wta_dr_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        a, c, n_parts, (float*)disp, (int*)dint, (float*)dr, B, H, D, W,
        disp_min, subpix);
  }
  return (int)cudaGetLastError();
}
