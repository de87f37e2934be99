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
// S_R with a log-step lane roll; here S_R[k, x] is read from the same
// staged row of S as the left map's S[k, x].
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
// K5 bound: bytes (two f32 volumes read once, three maps written).  S_R
// needs no second pass over device memory: at candidate k, S_R[k, x] =
// S[k, x - dmin - k] lies in the same row and candidate as S[k, .], so
// a block that owns whole rows (a band: 4 rows up to 512 columns, 2 rows
// up to 1024) reduces both maps from one staged copy.  A chunk of 4
// candidates of the band's rows is copied into shared memory with
// cp.async, both parts, the horizontal one along y (a warp reads 32 / 4
// runs of 4 contiguous words), into two buffers, so the next chunk is in
// flight while this one is consumed; 512 threads then advance the sweep
// above for 4 left and 4 right pixels each.  (16-byte copies and a third
// buffer were both slower on the H100: the copies are not the limit.)  Past 1024 columns a band
// does not fit: the windowed instantiation gives a block 128 columns of
// 4 rows and stages, per chunk, a second window of the 131 columns its
// pixels' diagonals cross at those candidates (read twice overall, the
// second time mostly from L2).  Before, one thread per pixel read the
// transposed part one 4-byte word per 32-byte sector, re-read both
// parts at d +- 1 and read them a second time for S_R.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Part {
  const float* p;
  long long sb, sy, sk, sx;
};

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

// The sweep of one pixel's WTA over its candidates, in order (K3, K5).  When
// a new strict minimum appears at k (or k is the first candidate), c0 is
// the value at k - 1 and c2 waits for k + 1, so no candidate is read
// twice; ties keep the lowest index.
struct Sweep {
  float mn, c0, c2, prev;
  int d;
  bool pend, nan;

  __device__ __forceinline__ void init() {
    const float inf = __int_as_float(0x7f800000);
    mn = c0 = c2 = prev = inf;
    d = 0;
    pend = nan = false;
  }
  __device__ __forceinline__ void step(float v, int k) {
    const bool newmin = k == 0 || v < mn;
    if (pend) c2 = v;
    pend = newmin;
    c0 = newmin ? prev : c0;
    c2 = newmin ? __int_as_float(0x7f800000) : c2;
    mn = newmin ? v : mn;
    d = newmin ? k : d;
    nan = nan || isnan(v);
    prev = v;
  }
  // (d, offset): a NaN among the candidates gives d = D and offset 0
  __device__ __forceinline__ float finish(int D, int subpix, int& k) const {
    float m = mn, lo = c0, hi = c2;
    k = d;
    if (nan) {
      m = __int_as_float(0x7fc00000);
      k = D;
    }
    const float guard = m + 1e6f;
    if (!isfinite(lo)) lo = guard;
    if (!isfinite(hi)) hi = guard;
    const float o = subpix_offset<true>(lo, m, hi, subpix, 0);
    return k > 0 && k < D - 1 ? o : 0.f;
  }
};

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
  Sweep sw[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) sw[i].init();

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
        sw[i].step(v, k0 + kk);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int y = y0 + ty + 8 * i;
    if (x >= W || y >= H) continue;
    float m = sw[i].mn, lo = sw[i].c0, hi = sw[i].c2;
    int k = sw[i].d;
    if (sw[i].nan) {
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

constexpr int kNT5 = 512;   // threads of a K5 block
constexpr int kKC5 = 4;     // candidates per staged chunk
constexpr int kTX5 = 128;   // columns of a windowed block

// One 4-byte asynchronous copy into shared memory; zeros where ``in`` is
// false (nothing is read then).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(in ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage columns c0 .. c0 + n - 1 of one part, rows y0 .. y0 + kR - 1 and
// candidates k0 .. k0 + kKC5 - 1, into buf[kk][r][i] (row stride SW),
// zero outside the volume.  A part read along y (the horizontal partial,
// whose rows are contiguous along y) gives a thread one row and a warp
// 32 / kR columns of kR contiguous words; one read along x gives a thread
// one column.
template <int kR>
__device__ __forceinline__ void stage5(float* buf, const Part& p,
                                       bool along_y, int b, int y0, int k0,
                                       int c0, int n, int H, int D, int W,
                                       int SW) {
  const float* const pb = p.p + b * p.sb;
  const int sy = (int)p.sy, sk = (int)p.sk, sx = (int)p.sx;
  const int t = threadIdx.x;
  if (along_y) {
    const int r = t % kR;
    const int y = y0 + r;
    for (int i = t / kR; i < n; i += kNT5 / kR) {
      const int x = c0 + i;
      const bool xin = x >= 0 && x < W && y < H;
#pragma unroll
      for (int kk = 0; kk < kKC5; ++kk) {
        const bool in = xin && k0 + kk < D;
        cp_async4(buf + (kk * kR + r) * SW + i,
                  in ? pb + (y * sy + x * sx + (k0 + kk) * sk) : pb, in);
      }
    }
  } else {
    for (int i = t; i < n; i += kNT5) {
      const int x = c0 + i;
      const bool xin = x >= 0 && x < W;
#pragma unroll
      for (int kk = 0; kk < kKC5; ++kk)
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const bool in = xin && y0 + r < H && k0 + kk < D;
          cp_async4(buf + (kk * kR + r) * SW + i,
                    in ? pb + ((y0 + r) * sy + x * sx + (k0 + kk) * sk) : pb,
                    in);
        }
    }
  }
}

// K5.  kBand: a block owns kR rows across the full width (W <= kPPT *
// kNT5 / kR); each chunk of kKC5 candidates of those rows is staged once
// (both parts, cp.async, two buffers so the next chunk is in flight
// while this one is consumed), and each thread advances both reductions
// of its kPPT pixels from shared memory: the left one at its column x,
// the right one at S[k, x - dmin - k] (inf outside [0, W)).  Otherwise
// (windowed): a block owns kTX5 columns of kR rows (kPPT = 1) and stages
// a second window per chunk for the right map, the kTX5 + kKC5 - 1
// columns its diagonals cross at those candidates.
template <bool kBand, int kR, int kPPT>
__global__ void __launch_bounds__(kNT5, 1)
wta_dr_kernel(Part a, Part c, int n_parts, int along0, int along1,
              float* __restrict__ disp, int* __restrict__ dint,
              float* __restrict__ dr, int H, int D, int W, int disp_min,
              int subpix, int SW) {
  extern __shared__ float smem[];
  constexpr int kWin = kBand ? 1 : 2;       // windows staged per part
  const int slab = kKC5 * kR * SW;          // one window of one part
  const int stage_size = n_parts * kWin * slab;
  const int t = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kR;
  const int x0 = kBand ? 0 : blockIdx.x * kTX5;
  const int tw = kBand ? W : kTX5;          // columns of the block
  const int wr = kTX5 + kKC5 - 1;           // columns of the right window

  // this thread's pixels: row r, column x0 + xl
  int rb[kPPT], xl[kPPT];
#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    int p = t + kNT5 * j;
    p = p < kR * tw ? p : kR * tw - 1;
    const int r = p / tw;
    rb[j] = r * SW;
    xl[j] = p - r * tw;
  }
  Sweep L[kPPT], R[kPPT];
#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    L[j].init();
    R[j].init();
  }

  // one part's windows of the chunk at k0 (the part is named, not
  // selected at run time, so no kernel parameter is copied to the stack)
  auto stage_part = [&](float* w, const Part& p, bool ay, int k0) {
    stage5<kR>(w, p, ay, b, y0, k0, x0, tw, H, D, W, SW);
    if (!kBand)
      stage5<kR>(w + slab, p, ay, b, y0, k0,
                 x0 - disp_min - k0 - (kKC5 - 1), wr, H, D, W, SW);
  };
  auto stage = [&](int k0, int buf) {
    float* s = smem + buf * stage_size;
    stage_part(s, a, along0 != 0, k0);
    if (n_parts == 2) stage_part(s + kWin * slab, c, along1 != 0, k0);
  };

  const int n_chunks = (D + kKC5 - 1) / kKC5;
  stage(0, 0);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) stage((ch + 1) * kKC5, (ch + 1) & 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const float* s0 = smem + (ch & 1) * stage_size;
    const float* s1 = s0 + kWin * slab;
    const int k0 = ch * kKC5;
#pragma unroll
    for (int kk = 0; kk < kKC5; ++kk) {
      const int k = k0 + kk;
      if (k >= D) break;
      const int ko = kk * kR * SW;
#pragma unroll
      for (int j = 0; j < kPPT; ++j) {
        const int ol = rb[j] + ko + xl[j];
        float v = s0[ol];
        if (n_parts == 2) v = v + s1[ol];
        L[j].step(v, k);
        // the right map's column in S, and where it was staged
        const int xs = x0 + xl[j] - disp_min - k;
        const bool in = (unsigned)xs < (unsigned)W;
        const int orr =
            kBand ? rb[j] + ko + min(max(xs, 0), W - 1)
                  : slab + rb[j] + ko + xl[j] + (kKC5 - 1 - kk);
        float vr = s0[orr];
        if (n_parts == 2) vr = vr + s1[orr];
        R[j].step(in ? vr : __int_as_float(0x7f800000), k);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    const int y = y0 + rb[j] / SW;
    const int x = x0 + xl[j];
    if (t + kNT5 * j >= kR * tw || x >= W || y >= H) continue;
    const long long px = ((long long)b * H + y) * W + x;
    int k;
    const float o = L[j].finish(D, subpix, k);
    disp[px] = ((float)disp_min + (float)k) + o;
    dint[px] = k;
    const float orr = R[j].finish(D, subpix, k);
    dr[px] = -(((float)disp_min + (float)k) + orr);
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
  if (n_parts < 1 || n_parts > 2) return (int)cudaErrorInvalidValue;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  if (B > 0 && H > 0 && W > 0 && D > 0) {
    Part a{(const float*)p0, s0b, s0y, s0k, s0x};
    Part c{(const float*)(n_parts == 2 ? p1 : p0), s1b, s1y, s1k, s1x};
    // 32-bit offsets inside one tile (non-negative strides)
    for (const Part* p : {&a, &c}) {
      if (p->sy < 0 || p->sk < 0 || p->sx < 0 ||
          (H - 1) * p->sy + (D - 1) * p->sk + (W - 1) * p->sx >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    }
    const int along0 = s0y < s0x;
    const int along1 = n_parts == 2 && s1y < s1x;
    const cudaStream_t st = (cudaStream_t)stream;
    // a band of 4 rows up to 512 columns, of 2 rows up to 1024 (4 pixels
    // a thread); past that the windowed instantiation.  A row of the
    // staged slab is padded to 8 mod 32 words: a warp staging kR rows of
    // 32 / kR columns writes 32 banks.
    const auto pad = [](int n) { return (n + 31) / 32 * 32 + 8; };
    const auto run = [&](auto kernel, int rows, int win, dim3 grid,
                         int SW) {
      const size_t bytes =
          (size_t)2 * n_parts * win * kKC5 * rows * SW * sizeof(float);
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (e != cudaSuccess) return (int)e;
      kernel<<<grid, kNT5, bytes, st>>>(a, c, n_parts, along0, along1,
                                        (float*)disp, (int*)dint, (float*)dr,
                                        H, D, W, disp_min, subpix, SW);
      return (int)cudaGetLastError();
    };
    if (W <= 512)
      return run(wta_dr_kernel<true, 4, 4>, 4, 1,
                 dim3(1, (H + 3) / 4, B), pad(W));
    if (W <= 1024)
      return run(wta_dr_kernel<true, 2, 4>, 2, 1,
                 dim3(1, (H + 1) / 2, B), pad(W));
    return run(wta_dr_kernel<false, 4, 1>, 4, 2,
               dim3((W + kTX5 - 1) / kTX5, (H + 3) / 4, B),
               pad(kTX5 + kKC5 - 1));
  }
  return (int)cudaGetLastError();
}
