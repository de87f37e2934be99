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
// K3 and K5 follow the reference's NaN rules: a NaN anywhere in S[.]
// (or, for dR, anywhere in S_R[.]) makes mn NaN and no index equal to
// it, so d = D, which is never interior: K3's offset is NaN (mn is not
// below big_guard), K5's offset 0; the fit's maximum and clip return NaN
// for a NaN operand (reachable only from non-finite partials, where mn
// is -inf).
//
// The division is IEEE (no fast math).  Each part is a strided view, so
// the horizontal partial is read in its own (W, D, H) layout without a
// transposed copy.
//
// K3 bound: bytes (two f32 volumes read once, two maps written).  A block
// owns a tile of 32 x-positions by 32 rows, one thread per x and four rows
// (blockDim (32, 8)), and sweeps k in chunks.  A part whose x stride is
// the smaller one (S_v) is read directly, coalesced along x; the other
// (S_h, whose rows are contiguous along y) is staged chunk by chunk
// through shared memory, read along y and consumed along x (a row stride
// of 33 floats keeps both sides free of bank conflicts).  Each thread
// keeps (mn, d, c0, c2) of its pixels in one sweep over k: when a new
// strict minimum appears at k, c0 is the value at k - 1 and c2 waits for
// k + 1, so no candidate is read twice.  The sweep has no branch: a
// chunk's candidates past D read inf, which changes nothing.  Before,
// one thread per pixel read the transposed part one 4-byte word per
// 32-byte sector and re-read both parts at d - 1 and d + 1.
//
// K5 bound: bytes as K3.  One thread per pixel with x fastest: part0
// reads coalesce; the transposed part1 reads one 4-byte word per 32-byte
// sector.  K5 reads both volumes a second time for S_R (mostly from L2:
// neighbouring threads read neighbouring diagonals).
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

// fmaxf / fminf, or (kNan) the reference's maximum / clip, which return
// NaN where an operand is NaN
template <bool kNan>
__device__ __forceinline__ float max_(float a, float b) {
  if (kNan && (isnan(a) || isnan(b))) return __int_as_float(0x7fc00000);
  return fmaxf(a, b);
}

template <bool kNan>
__device__ __forceinline__ float min_(float a, float b) {
  if (kNan && (isnan(a) || isnan(b))) return __int_as_float(0x7fc00000);
  return fminf(a, b);
}

// kNan: propagate NaN as the reference does (only reachable from
// non-finite partials); without it, fmaxf / fminf.
template <bool kNan>
__device__ __forceinline__ float subpix_offset(float c0, float c1, float c2,
                                              int subpix, int plateau_zero) {
  float o = 0.f, den = 1.f;
  if (subpix == 1) {                 // vfit
    den = 2.0f * (max_<kNan>(c0, c2) - c1);
    o = (c0 - c2) / max_<kNan>(den, 1e-9f);
    o = min_<kNan>(max_<kNan>(o, -0.5f), 0.5f);
  } else if (subpix == 2) {          // parabola
    den = (c0 - 2.0f * c1) + c2;
    o = (0.5f * (c0 - c2)) / max_<kNan>(den, 1e-9f);
    o = min_<kNan>(max_<kNan>(o, -0.5f), 0.5f);
  }
  if (plateau_zero && !(den > 1e-9f)) o = 0.f;
  return o;
}

constexpr int kTX = 32;                  // x-positions per tile
constexpr int kTY = 32;                  // rows per tile
constexpr int kRows = kTY / 8;           // rows per thread

// One K3 tile.  kStage0 / kStage1: the part is staged through shared
// memory (read along y) instead of read directly (along x).
template <bool kStage0, bool kStage1>
__global__ void __launch_bounds__(256)
wta_tile_kernel(Part a, Part c, int n_parts, float* __restrict__ off,
                int* __restrict__ dint, int H, int D, int W, int subpix,
                int edge_subpix, int plateau_zero, float big_guard) {
  constexpr int kNS = (kStage0 ? 1 : 0) + (kStage1 ? 1 : 0);
  constexpr int kKC = kNS == 2 ? 4 : 8;  // candidates per chunk
  __shared__ float sh[kNS > 0 ? kNS : 1][kKC][kTX][kTY + 1];
  const float inf = __int_as_float(0x7f800000);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int b = blockIdx.z;
  const int x = x0 + tx;
  float mn[kRows], c0[kRows], c2[kRows], prev[kRows];
  int d[kRows];
  bool pend[kRows], nan[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    mn[i] = c0[i] = c2[i] = prev[i] = inf;
    d[i] = 0;
    pend[i] = nan[i] = false;
  }

  // a staged part's (kc, 32 x, 32 y) slab: a warp reads 32 rows of one
  // x; every load is issued before the first store
  // offsets inside one tile are ints (s2p_wta checks that they fit)
  auto stage = [&](const Part& p, int slot, int k0, int kc) {
    const int y = y0 + tx;
    const float* const pb = p.p + b * p.sb;
    const int sy = (int)p.sy, sk = (int)p.sk, sx = (int)p.sx;
    float t[kRows][kKC];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int xx = ty + 8 * i;
      const bool in = x0 + xx < W && y < H;
      const int o = y * sy + (x0 + xx) * sx + k0 * sk;
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk)
        t[i][kk] = kk >= kc ? inf : in ? pb[o + kk * sk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) sh[slot][kk][ty + 8 * i][tx] = t[i][kk];
  };
  // a direct part's values of this thread's pixels, read along x
  auto direct = [&](const Part& p, float (&t)[kRows][kKC], int k0, int kc) {
    const float* const pb = p.p + b * p.sb;
    const int sy = (int)p.sy, sk = (int)p.sk, sx = (int)p.sx;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int y = y0 + ty + 8 * i;
      const bool in = x < W && y < H;
      const int o = y * sy + x * sx + k0 * sk;
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk)
        t[i][kk] = kk >= kc ? inf : in ? pb[o + kk * sk] : 0.f;
    }
  };

  float va[kRows][kKC], vc[kRows][kKC];
  for (int k0 = 0; k0 < D; k0 += kKC) {
    const int kc = D - k0 < kKC ? D - k0 : kKC;
    // the direct loads first: the whole chunk in flight before any use
    if (!kStage0) direct(a, va, k0, kc);
    if (!kStage1 && n_parts == 2) direct(c, vc, k0, kc);
    if (kNS > 0) {
      if (k0 > 0) __syncthreads();       // the last chunk is consumed
      if (kStage0) stage(a, 0, k0, kc);
      if (kStage1 && n_parts == 2) stage(c, kStage0 ? 1 : 0, k0, kc);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int yl = ty + 8 * i;
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) {
        // a candidate past D reads inf (both parts), which changes
        // nothing: no new minimum, no NaN, and c2 = inf stays right
        float v = kStage0 ? sh[0][kk][tx][yl] : va[i][kk];
        if (n_parts == 2)
          v = v + (kStage1 ? sh[kStage0 ? 1 : 0][kk][tx][yl] : vc[i][kk]);
        // branch-free: a new strict minimum (or the first candidate)
        // takes c0 from k - 1 and leaves c2 pending until k + 1
        const bool newmin = (kk == 0 && k0 == 0) || v < mn[i];
        if (pend[i]) c2[i] = v;
        pend[i] = newmin;
        c0[i] = newmin ? prev[i] : c0[i];
        c2[i] = newmin ? inf : c2[i];
        mn[i] = newmin ? v : mn[i];
        d[i] = newmin ? k0 + kk : d[i];
        nan[i] = nan[i] || isnan(v);
        prev[i] = v;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int y = y0 + ty + 8 * i;
    if (x >= W || y >= H) continue;
    float m = mn[i], lo = c0[i], hi = c2[i];
    int k = d[i];
    if (nan[i]) {
      m = __int_as_float(0x7fc00000);
      k = D;
    }
    const float guard = m + 1e6f;
    if (!isfinite(lo)) lo = guard;
    if (!isfinite(hi)) hi = guard;
    const bool interior = k > 0 && k < D - 1 &&
                          (edge_subpix || (lo < big_guard && hi < big_guard));
    float o = subpix_offset<true>(lo, m, hi, subpix, plateau_zero);
    if (!interior) o = 0.f;
    const long long px = ((long long)b * H + y) * W + x;
    off[px] = m < big_guard ? o : __int_as_float(0x7fc00000);
    dint[px] = k;
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
    bool nan = isnan(mn);
    for (int k = 1; k < D; ++k) {
      const float v = sum_at(a, c, n_parts, b, y, k, x);
      nan = nan || isnan(v);
      if (v < mn) {
        mn = v;
        d = k;
      }
    }
    if (nan) {
      mn = __int_as_float(0x7fc00000);
      d = D;
    }
    float c0 = d > 0 ? sum_at(a, c, n_parts, b, y, d - 1, x) : inf;
    float c2 = d < D - 1 ? sum_at(a, c, n_parts, b, y, d + 1, x) : inf;
    float guard = mn + 1e6f;
    if (!isfinite(c0)) c0 = guard;
    if (!isfinite(c2)) c2 = guard;
    float o = subpix_offset<true>(c0, mn, c2, subpix, 0);
    if (!(d > 0 && d < D - 1)) o = 0.f;
    disp[i] = ((float)disp_min + (float)d) + o;
    dint[i] = d;
    // right reference: S_R[k] = S[k, x - dmin - k], inf outside [0, W)
    float mnr = inf;
    int kr = 0;                          // every S_R[k] inf: k = 0
    nan = false;
    for (int k = 0; k < D; ++k) {
      const int xs = x - disp_min - k;
      const float v =
          xs >= 0 && xs < W ? sum_at(a, c, n_parts, b, y, k, xs) : inf;
      nan = nan || isnan(v);
      if (k == 0 || v < mnr) {
        mnr = v;
        kr = k;
      }
    }
    if (nan) {
      mnr = __int_as_float(0x7fc00000);
      kr = D;
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
    o = subpix_offset<true>(c0, mnr, c2, subpix, 0);
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
  if (n_parts < 1 || n_parts > 2) return (int)cudaErrorInvalidValue;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  if (B > 0 && H > 0 && W > 0 && D > 0) {
    Part a{(const float*)p0, s0b, s0y, s0k, s0x};
    Part c{(const float*)(n_parts == 2 ? p1 : p0), s1b, s1y, s1k, s1x};
    // 32-bit offsets inside one tile (non-negative strides)
    for (const Part* p : {&a, &c}) {
      if (p->sy < 0 || p->sk < 0 || p->sx < 0 ||
          (H - 1) * p->sy + (D - 1) * p->sk + (W - 1) * p->sx +
                  kTY * p->sy + kTX * p->sx >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    }
    // stage the part whose rows run along y
    const auto along_y = [](long long sy, long long sx) {
      return (sy < 0 ? -sy : sy) < (sx < 0 ? -sx : sx);
    };
    const bool st0 = along_y(s0y, s0x);
    const bool st1 = n_parts == 2 && along_y(s1y, s1x);
    const dim3 grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY, B);
    const dim3 block(32, 8);
    const cudaStream_t st = (cudaStream_t)stream;
#define S2P_WTA_ARGS                                                     \
  a, c, n_parts, (float*)off, (int*)dint, H, D, W, subpix, edge_subpix, \
      plateau_zero, big_guard
    if (st0 && st1)
      wta_tile_kernel<true, true><<<grid, block, 0, st>>>(S2P_WTA_ARGS);
    else if (st0)
      wta_tile_kernel<true, false><<<grid, block, 0, st>>>(S2P_WTA_ARGS);
    else if (st1)
      wta_tile_kernel<false, true><<<grid, block, 0, st>>>(S2P_WTA_ARGS);
    else
      wta_tile_kernel<false, false><<<grid, block, 0, st>>>(S2P_WTA_ARGS);
#undef S2P_WTA_ARGS
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
