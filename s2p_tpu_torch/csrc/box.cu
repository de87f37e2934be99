// B1: the window costs of the msmw matcher, one launch a battery.
//
// Replaces s2p_tpu/ops/msmw.py _window_costs (:71) with its box filter
// _box (:42) and its diagonal shear _shear (:54): jnp programs, not Pallas
// kernels.  For a reference image a (h, w), candidates b (D, h, w) and the
// mask fin (D, h, w) of the pairs that count it returns, for every
// candidate, the minimum over the five windows of _WINDOWS_5 of the
// mean-removed SSD, and with need_var the 9 x 9 variance of a:
//
//   d1 = fin ? a - b : 0,  d2 = fin ? (a - b)^2 : 0,  cnt = fin ? 1 : 0
//   for (ry, rx) in (4, 4), (1, 4), (4, 1), diag+ (1, 4), diag- (1, 4):
//     m2, m1, mc = the window means of d2, d1, cnt
//     mc = max(mc, 1e-6); q = m1 / mc
//     cost = fma(-q, q, m2 / mc)          (one rounding, as XLA's CPU run)
//     best = minimum(best, cost)          (NaN propagates, as torch's)
//   var9 = fma(S(a a), 1/81, -(ma ma)),  ma = S(a) / 81  (4 x 4 windows)
//
// A window mean is the vertical sums of 2ry + 1 rows, each from +0 in
// window order, then the horizontal sums of 2rx + 1 of them from +0 in
// window order, times f32(1 / area); zero outside the image.  The JAX
// package differences two jnp.cumsum prefix sums instead.  On a full tile
// those reach about 2.6e10, where a float32 ulp is 2048, and every order
// of summation (XLA's on the CPU, numpy's, torch's parallel scan on the
// card) gives other costs; so the port sums each window directly, in one
// order that the card and the CPU share.  The plain version
// (s2p_tpu_torch/ops/msmw.py _window_costs_plain) adds the same values in
// the same order, and the build disables FMA contraction: the two agree
// bit for bit.
//
// The diagonal windows.  _shear rolls row y by s_y = (y - h / 2) sgn
// columns, the box runs over the sheared plane with its zero padding in
// the sheared frame, and the result is rolled back.  In the original
// frame the window of output (y, x) is then
//
//   sum over dx = -4 .. 4 of [0 <= X + dx < w] Vd[y, (x + dx) mod w],
//   Vd[y, c] = ((0 + v[y - 1, (c + sgn) mod w]) + v[y, c])
//              + v[y + 1, (c - sgn) mod w]        (rows outside: 0)
//
// with X = (x + s_y) mod w, the output's column in the sheared frame: the
// columns wrap around with real data, and the padding is where the
// sheared column leaves [0, w), a seam at x = -s_y (mod w) inside most
// rows.
//
// Bound: operations.  At msmw's finest battery of a scene tile (16 x 820
// x 900) the call reads b (4 bytes an element) and fin (1), writes the
// cost (4) and reads a once: about 9 bytes an element, 0.033 ms at 3.35
// TB/s.  The arithmetic the output needs (msmw.window_costs_work counts
// it exactly, no identity counted: no add to +0 and no add of a padded
// zero) is, in the interior, 213 float32 operations an element: 5 for
// d1, d2 and cnt; per quantity 14 vertical adds (8 for the 9-row sums
// that the (4, 4) and (4, 1) windows share, 2 each for the 3-row sums
// of (1, 4) and the two diagonals) and 34 horizontal adds with 5
// products by 1 / area; per window a maximum, the reciprocal's index,
// two quotients of 3 (see 3. below) and the fused multiply-add, and
// from the second window on a minimum: 49.  Built with --fmad=false the
// adds and multiplies issue one by one, at 33.5e12/s (132 SMs x 128
// lanes x 1.98 GHz): about 0.075 ms.
//
// The design.  The jnp program and its first port took each window mean
// as two passes through device memory (30 launches a battery), sheared
// by gathers, with about 230 other launches around them.  Here one block
// computes a tile of TH x TW outputs of one candidate plane:
//
//  1. it stages d2, d1 and cnt of its tile with a halo of 4 rows and 5
//     columns (4 for the windows, 1 for the diagonals' shear) in shared
//     memory, formed as a, b and fin arrive: each thread issues the loads
//     of its 13 elements before it stores any, one round trip to device
//     memory instead of several; the staged columns wrap around the
//     image as the shear does, and rows outside are 0;
//  2. it forms the vertical sums of 9 rows and of 3 rows once per column
//     (the box windows' padding: columns outside the image hold 0), each
//     thread a column of 8 rows from registers;
//  3. each thread owns 4 consecutive outputs of a row: it reads the 12
//     vertical sums they need as three 16-byte loads and takes the
//     horizontal sums, the costs and the running minimum in registers.
//     A window's two quotients share their divisor, its count mean, of
//     which there are 110 (k / 81 and k / 27 for k pairs, floored at
//     1e-6): with r = RN(1 / mc) from a table, x / mc is x r corrected
//     once by the exact residual (div_rcp), three operations where the
//     IEEE division issues about ten, two of them on the special
//     function and check pipes.  For 2^-100 <= |x| <= 2^100 and 0 this
//     equals the IEEE quotient bit for bit: s2p_box_div_check compares
//     the two for every float32 numerator and each of the 110 divisors
//     (chip_smoke.py runs it; it counts 0 mismatches there, and 4.2e9
//     without the guard).  Other numerators, inf and NaN take the IEEE
//     division;
//  4. it forms the diagonals' vertical sums along the sheared columns in
//     the same buffers.  A row of at least NV columns has at most one
//     seam among a tile's NV columns: the columns past it are written 8
//     further on, behind 8 zeros, so that every output's 9 terms are 9
//     consecutive values with the padding in place, and only a thread
//     whose 4 outputs straddle the seam reads two sets of 12.  Narrower
//     images test each term of the outputs near a seam or an edge;
//  5. it writes the minimum once.
//
// Every intermediate stays in shared memory or registers, the shear is
// addressing, offsets inside a tile are 32-bit and nothing divides by a
// run-time value but the wrap of the halo columns at the image's edges
// and one modulo a row for the shear.  Blocks of blockIdx.z == D compute
// var9 the same way, with a a and a in place of d2 and d1.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 128;            // output columns of a block
constexpr int TH = 16;             // output rows of a block
constexpr int kThreads = 256;
constexpr int SR = TH + 8;         // staged rows: y0 - 4 .. y0 + TH + 3
constexpr int SC = TW + 10;        // staged columns: x0 - 5 .. x0 + TW + 4
constexpr int NV = TW + 8;         // vertical sums' columns: x0 - 4 ..
constexpr int VC = NV + 8;         // their rows' pitch: room for a seam's gap
constexpr int RG = 8;              // rows of a vertical-sum task
constexpr int kStaged = 3 * SR * SC;
constexpr int kSums = 2 * 3 * TH * VC;
constexpr int kSmemBytes = (kStaged + kSums) * 4;
static_assert(kStaged % 4 == 0 && VC % 4 == 0, "16-byte aligned rows");
static_assert(TH % RG == 0 && TW == 4 * 32 && kThreads == 32 * TH / 2,
              "a warp covers two rows of 4 outputs a thread");

// torch.minimum on the card: a NaN of either side, else the minimum
__device__ __forceinline__ float nanmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// x / y with r = RN(1 / y): q0 = x r, e = x - q0 y (exact, one fma) and
// q0 + e r rounded once (Markstein's correction).  The residual is taken
// as -(q0 y - x) so that x = -0 gives -0.
__device__ __forceinline__ float div_rcp(float x, float y, float r) {
  const float q0 = x * r;
  const float e = -__fmaf_rn(q0, y, -x);
  return __fmaf_rn(e, r, q0);
}

// the numerators that div_rcp divides exactly by every window's count
// mean (3. above); the others, inf and NaN take the IEEE division
__device__ __forceinline__ bool div_rcp_ok(float x) {
  const float ax = fabsf(x);
  return ax <= 0x1p100f && (ax >= 0x1p-100f || ax == 0.f);
}

// f32(k * scale) floored at 1e-6, a window's count mean for k of its
// pairs: the divisors of the costs
__device__ __forceinline__ float count_mean(float k, float scale) {
  return fmaxf(k * scale, 1e-6f);  // a count's mean is never NaN
}

// the mean-removed SSD of one window from its three sums (s2 of d2, s1
// of d1, k of cnt, an integer from 0 to 81) and its 1 / area; rcp[k]
// holds RN(1 / count_mean(k, scale))
__device__ __forceinline__ float ssd(float s2, float s1, float k, float scale,
                                     const float* rcp) {
  const float m2 = s2 * scale, m1 = s1 * scale;
  const float mc = count_mean(k, scale);
  float q, c;
  if (div_rcp_ok(m1) && div_rcp_ok(m2)) {
    const float r = rcp[__float_as_int(k + 0x1p23f) - 0x4B000000];
    q = div_rcp(m1, mc, r);
    c = div_rcp(m2, mc, r);
  } else {
    q = __fdiv_rn(m1, mc);
    c = __fdiv_rn(m2, mc);
  }
  return __fmaf_rn(-q, q, c);
}

// a row's 12 vertical sums at columns 4 lane .. 4 lane + 11
__device__ __forceinline__ void load12(const float* row, int lane,
                                       float (&v)[12]) {
  const float4* p = reinterpret_cast<const float4*>(row) + lane;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float4 t = p[k];
    v[4 * k] = t.x;
    v[4 * k + 1] = t.y;
    v[4 * k + 2] = t.z;
    v[4 * k + 3] = t.w;
  }
}

// the sum over dx = -R .. R of output i's terms, from +0 in order
template <int R>
__device__ __forceinline__ float hsum(const float (&v)[12], int i) {
  float s = 0.f;
#pragma unroll
  for (int k = 4 - R; k <= 4 + R; ++k) s = s + v[i + k];
  return s;
}

// hsum<4> with the terms whose sheared column X + dx leaves [0, w) as 0
__device__ __forceinline__ float hsum_sheared(const float (&v)[12], int i,
                                              int X, int w) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k <= 8; ++k) {
    const int u = X + k - 4;
    s = s + (u >= 0 && u < w ? v[i + k] : 0.f);
  }
  return s;
}

__global__ void __launch_bounds__(kThreads, 2)
window_costs_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const uint8_t* __restrict__ fin, float* __restrict__ best,
                    float* __restrict__ var9, int D, int h, int w,
                    long long a_row, long long b_plane, long long b_row,
                    long long f_plane, long long f_row, float r81,
                    float r27) {
  extern __shared__ float4 smem4[];
  float* const S = reinterpret_cast<float*>(smem4);   // [3][SR][SC]
  float* const V = S + kStaged;                        // [2][3][TH][VC]
  // RN(1 / count_mean(k, 1 / 81)) for k = 0 .. 81, then 1 / 27's
  __shared__ float rcp[82 + 28];
  // with gaps: the first column of the second sheared period in each row's
  // vertical sums of diag+ and diag- (NV: none)
  __shared__ int seam[2][TH];
  const bool gapped = w >= NV;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int z = blockIdx.z;
  const bool var = z == D;         // this tile's variance of a
  const int tid = threadIdx.x;
  if (tid < 82 + 28)
    rcp[tid] = __frcp_rn(tid < 82 ? count_mean((float)tid, r81)
                                  : count_mean((float)(tid - 82), r27));
  if (gapped && tid >= 128 && tid < 128 + 2 * TH) {
    const int g = (tid - 128) / TH, r = (tid - 128) % TH;
    int sp = (y0 + r - h / 2) % w;           // s_y of diag+, mod w
    if (sp < 0) sp += w;
    const int s_y = g == 0 ? sp : w - sp;    // diag-: -s_y mod w
    int m = (x0 - 4 + s_y) % w;              // column 0's sheared column
    if (m < 0) m += w;
    seam[g][r] = m == 0 ? NV : min(w - m, NV);
  }

  // 1. stage d2, d1, cnt (or a a, a) of rows y0 - 4 .. y0 + TH + 3 and
  //    columns x0 - 5 .. x0 + TW + 4, wrapped around the image
  const float* const bz = var ? b : b + z * b_plane;
  const uint8_t* const fz = var ? fin : fin + z * f_plane;
  constexpr int kIters = (SR * SC + kThreads - 1) / kThreads;
  float av[kIters], bv[kIters];
  uint8_t fv[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = tid + it * kThreads;
    av[it] = 0.f;
    bv[it] = 0.f;
    fv[it] = 0;
    const int r = i / SC, c = i - r * SC;
    const int gy = y0 - 4 + r;
    if (i < SR * SC && gy >= 0 && gy < h) {
      int gx = x0 - 5 + c;
      if (gx < 0 || gx >= w) {
        gx %= w;
        if (gx < 0) gx += w;
      }
      av[it] = __ldg(a + gy * a_row + gx);
      if (!var) {
        bv[it] = __ldg(bz + gy * b_row + gx);
        fv[it] = __ldg(fz + gy * f_row + gx);
      }
    }
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = tid + it * kThreads;
    if (i < SR * SC) {
      float q0, q1, q2 = 0.f;
      if (var) {
        q0 = av[it] * av[it];
        q1 = av[it];
      } else {
        const float d = av[it] - bv[it];
        const bool f = fv[it] != 0;
        q0 = f ? d * d : 0.f;
        q1 = f ? d : 0.f;
        q2 = f ? 1.f : 0.f;
      }
      S[i] = q0;
      S[SR * SC + i] = q1;
      S[2 * SR * SC + i] = q2;
    }
  }
  __syncthreads();

  // 2. the vertical sums of 9 rows (V[0]) and 3 rows (V[1]) of every
  //    column x0 - 4 .. x0 + TW + 3; 0 at columns outside the image
  for (int t = tid; t < 3 * NV * (TH / RG); t += kThreads) {
    const int c = t % NV, rest = t / NV;
    const int q = rest % 3, r0 = rest / 3 * RG;
    const float* const s = S + (q * SR + r0) * SC + c + 1;
    float col[RG + 8];
#pragma unroll
    for (int k = 0; k < RG + 8; ++k) col[k] = s[k * SC];
    const int gx = x0 - 4 + c;
    const bool in = gx >= 0 && gx < w;
    float* const v9 = V + (q * TH + r0) * VC + c;
    float* const v3 = V + ((3 + q) * TH + r0) * VC + c;
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      float s9 = 0.f;
#pragma unroll
      for (int k = 0; k < 9; ++k) s9 = s9 + col[r + k];
      const float s3 = ((0.f + col[r + 3]) + col[r + 4]) + col[r + 5];
      v9[r * VC] = in ? s9 : 0.f;
      v3[r * VC] = in ? s3 : 0.f;
    }
  }
  __syncthreads();

  // 3. the box windows: each thread 4 outputs of rows wid and wid + 8
  const int lane = tid & 31, wid = tid >> 5;
  const int xa = x0 + 4 * lane;
  float bst[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = wid + 8 * j;
    if (var) {
      float v[12], saa[4], ma[4];
      load12(V + r * VC, lane, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) saa[i] = hsum<4>(v, i);
      load12(V + (TH + r) * VC, lane, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ma[i] = hsum<4>(v, i) * r81;
        bst[j][i] = __fmaf_rn(saa[i], r81, -(ma[i] * ma[i]));
      }
      continue;
    }
    float s44[3][4], s14[3][4], s41[3][4];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float v[12];
      load12(V + (q * TH + r) * VC, lane, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s44[q][i] = hsum<4>(v, i);
        s41[q][i] = hsum<1>(v, i);
      }
      load12(V + ((3 + q) * TH + r) * VC, lane, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) s14[q][i] = hsum<4>(v, i);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c0 = ssd(s44[0][i], s44[1][i], s44[2][i], r81, rcp);
      const float c1 = ssd(s14[0][i], s14[1][i], s14[2][i], r27, rcp + 82);
      const float c2 = ssd(s41[0][i], s41[1][i], s41[2][i], r27, rcp + 82);
      bst[j][i] = nanmin(nanmin(c0, c1), c2);
    }
  }

  if (!var) {
    __syncthreads();
    // 4. the diagonals' vertical sums along the sheared columns: V[0]
    //    diag+ (sgn 1), V[1] diag- (sgn -1), at every column (wrapped);
    //    with gaps, the columns past a row's seam 8 further on
    for (int t = tid; t < 3 * NV * (TH / RG); t += kThreads) {
      const int c = t % NV, rest = t / NV;
      const int q = rest % 3, r0 = rest / 3 * RG;
      // staged column c holds the column left of V's column c
      const float* const s = S + (q * SR + r0 + 3) * SC + c;
      float lft[RG + 2], mid[RG], rgt[RG + 2];
#pragma unroll
      for (int k = 0; k < RG + 2; ++k) {
        lft[k] = s[k * SC];
        rgt[k] = s[k * SC + 2];
      }
#pragma unroll
      for (int k = 0; k < RG; ++k) mid[k] = s[(k + 1) * SC + 1];
      float* const vp = V + (q * TH + r0) * VC + c;
      float* const vm = V + ((3 + q) * TH + r0) * VC + c;
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int gp = gapped && c >= seam[0][r0 + r] ? 8 : 0;
        const int gm = gapped && c >= seam[1][r0 + r] ? 8 : 0;
        vp[r * VC + gp] = ((0.f + rgt[r]) + mid[r]) + lft[r + 2];
        vm[r * VC + gm] = ((0.f + lft[r]) + mid[r]) + rgt[r + 2];
      }
    }
    // the gaps: 8 zeros at each row's seam
    if (gapped) {
      for (int t = tid; t < 2 * 3 * TH * 8; t += kThreads) {
        const int k = t & 7, rest = t >> 3;
        const int r = rest % TH, gq = rest / TH;   // gq: 3 g + q
        const int cs = seam[gq / 3][r];
        if (cs < NV) V[(gq * TH + r) * VC + cs + k] = 0.f;
      }
    }
    __syncthreads();

    // the diagonals' horizontal sums with the sheared frame's padding
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = wid + 8 * j;
      const int y = y0 + r;
      int sp = (y - h / 2) % w;    // s_y of diag+, mod w
      if (sp < 0) sp += w;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        float m[3][4];
        const float* const row = V + (3 * g * TH + r) * VC;
        if (gapped) {
          // outputs i >= is lie past the seam, 8 columns further on
          const int is = seam[g][r] - 4 - 4 * lane;
          if (is <= 0 || is >= 4) {
            const int off = is <= 0 ? 8 : 0;
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              float v[12];
              load12(row + q * TH * VC + off, lane, v);
#pragma unroll
              for (int i = 0; i < 4; ++i) m[q][i] = hsum<4>(v, i);
            }
          } else {
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              float v[12], u[12];
              load12(row + q * TH * VC, lane, v);
              load12(row + q * TH * VC + 8, lane, u);
#pragma unroll
              for (int i = 0; i < 4; ++i)
                m[q][i] = i < is ? hsum<4>(v, i) : hsum<4>(u, i);
            }
          }
        } else {
          const int s_y = g == 0 ? sp : w - sp;   // diag-: -s_y mod w
          const int X0 = (xa + s_y) % w;
          // all 4 outputs' 9 terms inside the sheared frame's row
          const bool clear = X0 >= 4 && X0 + 7 < w;
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            float v[12];
            load12(row + q * TH * VC, lane, v);
            if (clear) {
#pragma unroll
              for (int i = 0; i < 4; ++i) m[q][i] = hsum<4>(v, i);
            } else {
              int X = X0;
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                m[q][i] = hsum_sheared(v, i, X, w);
                X = X + 1 == w ? 0 : X + 1;
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          bst[j][i] = nanmin(bst[j][i], ssd(m[0][i], m[1][i], m[2][i], r27,
                                            rcp + 82));
      }
    }
  }

  // 5. the minimum (or var9) of each output inside the image
  float* const out = var ? var9 : best + (long long)z * h * w;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int y = y0 + wid + 8 * j;
    if (y >= h) continue;
    float* const o = out + (long long)y * w;
    if ((w & 3) == 0 && xa + 3 < w) {
      *reinterpret_cast<float4*>(o + xa) =
          make_float4(bst[j][0], bst[j][1], bst[j][2], bst[j][3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (xa + i < w) o[xa + i] = bst[j][i];
    }
  }
}

// the exhaustive check of the costs' division: for each of the 110 count
// means and every float32 numerator x that div_rcp_ok admits, div_rcp
// against the IEEE division; counts[0] the mismatches, counts[1] those of
// div_rcp over all non-NaN results without the guard
__global__ void div_check_kernel(float r81, float r27,
                                 unsigned long long* counts) {
  __shared__ float ys[82 + 28], rs[82 + 28];
  if (threadIdx.x < 82 + 28) {
    const int k = threadIdx.x;
    ys[k] = k < 82 ? count_mean((float)k, r81) : count_mean((float)(k - 82),
                                                            r27);
    rs[k] = __frcp_rn(ys[k]);
  }
  __syncthreads();
  unsigned long long bad = 0, bad_fast = 0;
  for (uint64_t u = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
       u < (1ull << 32); u += (uint64_t)gridDim.x * blockDim.x) {
    const float x = __uint_as_float((uint32_t)u);
    const bool ok = div_rcp_ok(x);
    for (int k = 0; k < 82 + 28; ++k) {
      const float want = __fdiv_rn(x, ys[k]);
      const float fast = div_rcp(x, ys[k], rs[k]);
      const bool differ = !(isnan(fast) && isnan(want)) &&
                          __float_as_uint(fast) != __float_as_uint(want);
      bad += ok && differ;
      bad_fast += differ;
    }
  }
  atomicAdd(counts, bad);
  atomicAdd(counts + 1, bad_fast);
}

}  // namespace

// a: (h, w) float32, rows a_row apart; b: (D, h, w) float32 and fin: (D,
// h, w) uint8 (0 or 1), planes and rows the given strides apart (elements),
// columns contiguous; best: (D, h, w) float32, contiguous; var9: (h, w)
// float32, contiguous, or null.  r81, r27: f32(1 / 81), f32(1 / 27).
extern "C" int s2p_window_costs(const void* a, const void* b, const void* fin,
                                void* best, void* var9, int D, int h, int w,
                                long long a_row, long long b_plane,
                                long long b_row, long long f_plane,
                                long long f_row, float r81, float r27,
                                void* stream) {
  if (D < 0 || h < 0 || w < 0) return (int)cudaErrorInvalidValue;
  const int planes = D + (var9 != nullptr);
  if (planes == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
  const unsigned gy = (unsigned)((h + TH - 1) / TH);
  if (gy > 65535u || planes > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      window_costs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((w + TW - 1) / TW), gy, (unsigned)planes);
  window_costs_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const uint8_t*)fin, (float*)best,
      (float*)var9, D, h, w, a_row, b_plane, b_row, f_plane, f_row, r81,
      r27);
  return (int)cudaGetLastError();
}

// counts: 2 unsigned 64-bit integers on the device, zeroed by the caller
extern "C" int s2p_box_div_check(float r81, float r27, void* counts,
                                 void* stream) {
  div_check_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(
      r81, r27, static_cast<unsigned long long*>(counts));
  return (int)cudaGetLastError();
}

extern "C" const char* s2p_box_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
