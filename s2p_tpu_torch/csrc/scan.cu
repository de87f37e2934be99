// One SGM scan pass with one lateral carry offset per direction.
//
// Replaces s2p_tpu/ops/sgm_pallas.py _scan_kernel (:81, wrapper
// _scan_pass_pallas :244) in two of its modes, which differ only in where
// a step's cost row comes from:
//
//   * cost mode (s2p_scan): the uint8 pre-pass volume, cv == 255 meaning
//     invalid_cost (the mgm flow, K2);
//   * signature mode (s2p_scan_sig): the cost of (step, lane, k) is built
//     in the kernel from bit-packed census signatures (the classic SGM
//     matcher, K4a):
//
//       a     = s1[n, x]
//       s     = vertical:   s2[n, x + dmin + k]        (ix = x + dmin + k)
//               horizontal: s2[n + dmin + pad + k, x]  (ix = n + dmin + k)
//       cost  = pad bit of a ? 0
//             : (valid(a) && valid(s) && 0 <= ix < sec_len && allowed[k])
//               ? popcount((a ^ s) & mask) : invalid_cost
//
//     The TPU kernel builds the shifted rows with Hankel lane rolls
//     (vertical) or a sublane window of the padded transposed secondary
//     (horizontal); both wrap, and both equal this direct indexing under
//     the [0, sec_len) mask, so the kernel indexes directly.
//
//     Its lane-fold mode (seg_w, the TPU kernel's sgm_pallas.py:116-123)
//     scans several tiles side by side on the lane axis, each a segment
//     of seg_w lanes with its own row of allowed[].
//
// Per scan step s (row n = s, or N - 1 - s in reverse), lane x and
// direction d with lateral offset lat[d]:
//
//   Lp    = L_d of step s - 1 at lane x - lat[d]
//   m     = min_k Lp
//   L_d   = cost + (dead ? 0 : min(min(Lp[k], min(Lp[k-1], Lp[k+1]) + p1),
//                                  m + p2[n, x]) - m)
//   S     = ((L_0 + L_1) + L_2) - sub * cost + accum
//   votes = lowest k of min_k L_d
//
// "dead" is step 0 and every lane whose predecessor x - lat[d] lies
// outside the image, or, in the lane-fold mode, in another segment (a dead
// carry restarts fresh: a fresh carry is zero and minconv(0) == 0, which
// is how the TPU kernel masks the segment edges).  The f32 operations run
// in exactly this order, and the build disables FMA contraction, so the
// sums round as the reference's do around BIG = 1e9.
//
// Design.  The TPU kernel carries L in VMEM across sequential grid steps;
// CUDA blocks run in no order.  For one direction, lane x at step s
// depends only on lane x - lat at step s - 1, so the positions
// x = (q + lat * s) mod lanes form independent chains, one per lane, and
// a block can own any set of chains for all steps: where a chain wraps,
// its predecessor leaves the image and the step is dead (the rule above),
// so every thread works at every step.  A block owns C consecutive chains
// (threadIdx.x, so loads and stores coalesce along the lanes) and splits
// the D candidates of each chain over T groups of 8 (threadIdx.y).  Each
// thread keeps its candidates' carry in registers; per step it publishes
// its partial minimum, argmin and edge values in shared memory
// (double-buffered: one __syncthreads per step), from which the next step
// reads m, the vote (the lowest-index minimum over the groups, strict <,
// groups in order) and the neighbouring candidates of its edges.
// Directions run as successive launches on the stream in direction order:
// the first writes S = L_0, the next ones S = S + L_d, the last also
// subtracts sub * cost and adds accum -- the reference's order of f32
// operations.
//
// Bound: bytes -- the cost (u8 volume or signatures), p2 and accum in, S
// out, once each -- plus, with one launch per direction, the S round trip
// between a pass's directions (about 9 GB per side at 8 x 448 x 512 x 80,
// 2.7 ms at 3.35 TB/s).  What bounds it on the card is each step's serial
// path, a chain's steps running in order with a barrier at the end of
// each.  So the kernel:
//   * issues step s + 1's loads (the cost source's, p2, S, accum) before
//     step s's exchange, into the other of two register slots (the step
//     loop is unrolled by two, so every slot index is a constant).  None
//     of those loads depends on the carry, and each element of S is read
//     and written by one thread at one step, so prefetching it is safe.
//     A prefetch two steps deep was measured slower on the flow's path:
//     it costs registers, hence blocks per SM, when a bucket's launches
//     share the SMs (PERF.md);
//   * runs a group without a branch (kFull: every group full; otherwise a
//     candidate past D costs inf and is not stored), with 32-bit offsets
//     inside a tile, and turns a uint8 cost into f32 exactly by
//     2^23 + v - 2^23;
//   * lays a step's partial minima out chain by chain (padded to a
//     multiple of 4 groups) so that a thread reads its chain's as float4s,
//     and folds the vote into the next step's reduction, which the step
//     needs for m anyway;
//   * holds a slot's S and accum arrays only in the launches that read
//     them (kMode).
// With at most 512 threads a block (C = min(32, 512 / T)) and one block
// an SM allowed, every instantiation of scan_kernel (D up to 4096) stays
// within 128 registers: no spill.  A wider D, up to 16384 (a tile wider
// than 4096 columns with its full range), runs scan_wide_kernel: the same
// loop with 32 candidates a thread and the loads issued at their step,
// whose carry and slot do not fit in registers (it spills; PERF.md).
// The uint8 cost may be any strided view.  The Python layer runs the
// flow's four independent chains of launches (two sides, two
// orientations) on four streams at once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;               // chains x groups per block
constexpr int kK = 8;                       // candidates per thread
constexpr int kWideK = 32;                  // ... in scan_wide_kernel
constexpr int kMaxD = kK * kThreads;        // scan_kernel: one chain a block
constexpr int kWideMaxD = kWideK * kThreads;
// shared slots per buffer: C * Tp <= kThreads + 3 * 32
constexpr int kShared = kThreads + 96;
constexpr long long kInt = 1LL << 31;       // offsets inside a tile below
constexpr int kValidBit = 24;
constexpr int kPadBit = 25;

// ------------------------------------------------------------------ //
// Cost sources.  tile(b) is tile b of the batch with int offsets inside
// it; load() issues one step's loads for kN candidates from k0 into a Raw,
// which nothing reads before the step; cost() is candidate j's f32 cost.
// fits() says whether a tile's offsets fit in an int.
// ------------------------------------------------------------------ //

// cost mode: the uint8 pre-pass volume through its strides
struct CostU8 {
  const uint8_t* cost;
  long long sb, sn, sk, sl;
  float invalid;
  template <int kN>
  struct Raw {
    uint8_t v[kN];
  };
  struct Tile {
    const uint8_t* c;
    int sn, sk, sl;
    float invalid;
    template <int kN, bool kFull>
    __device__ __forceinline__ void load(Raw<kN>& r, int n, int x, int k0,
                                         int cnt) const {
      const uint8_t* const p = c + (n * sn + x * sl + k0 * sk);
#pragma unroll
      for (int j = 0; j < kN; ++j)
        r.v[j] = kFull || j < cnt ? __ldg(p + j * sk) : 0;
    }
    template <int kN>
    __device__ __forceinline__ float cost(const Raw<kN>& r, int j) const {
      // 2^23 + v - 2^23 is exact
      return r.v[j] == 255
                 ? invalid
                 : __int_as_float(0x4B000000 | r.v[j]) - 8388608.f;
    }
  };
  bool fits(int N, int D, int lanes) const {
    return sn >= 0 && sl >= 0 && sk >= 0 &&
           (N - 1) * sn + (lanes - 1) * sl + (D - 1) * sk < kInt;
  }
  __device__ __forceinline__ Tile tile(int b) const {
    return Tile{cost + b * sb, (int)sn, (int)sk, (int)sl, invalid};
  }
};

// signature mode: the census cost built from the packed signatures
struct CostSig {
  const uint32_t* s1;       // (B, N, lanes)
  const uint32_t* s2;       // vertical (B, N, len2); horizontal (B, len2, lanes)
  const int32_t* allowed;   // (B, lanes / seg_w, D) or null
  int N, lanes, len2, D, dmin, pad, sec_len, horizontal, seg_w;
  uint32_t mask;
  float invalid;
  template <int kN>
  struct Raw {
    uint32_t a;             // the reference's signature
    uint32_t s[kN];         // the candidates' (0, not valid, out of range)
    int al[kN];             // allowed[k] (1 without allowed)
  };
  struct Tile {
    const uint32_t* s1;
    const uint32_t* s2;     // horizontal: from row pad
    const int32_t* al;
    int lanes, len2, D, dmin, sec_len, horizontal, seg_w;
    uint32_t mask;
    float invalid;
    template <int kN, bool kFull>
    __device__ __forceinline__ void load(Raw<kN>& r, int n, int x, int k0,
                                         int cnt) const {
      r.a = __ldg(s1 + n * lanes + x);
      // candidate k0 + j at position ix0 + j: the column x + dmin + k
      // (vertical) or the row n + dmin + k (horizontal) of the secondary
      const int ix0 = (horizontal ? n : x) + dmin + k0;
      const uint32_t* const p = horizontal ? s2 + x : s2 + n * len2;
      const int step = horizontal ? lanes : 1;
      const int32_t* const ap =
          al != nullptr ? al + (x / seg_w) * D + k0 : nullptr;
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const bool in = kFull || j < cnt;
        const int ix = ix0 + j;
        r.s[j] = in && ix >= 0 && ix < sec_len ? __ldg(p + ix * step) : 0u;
        r.al[j] = in && ap != nullptr ? __ldg(ap + j) : 1;
      }
    }
    template <int kN>
    __device__ __forceinline__ float cost(const Raw<kN>& r, int j) const {
      if ((r.a >> kPadBit) & 1u) return 0.f;
      const uint32_t s = r.s[j];
      const bool ok = ((r.a >> kValidBit) & 1u) && ((s >> kValidBit) & 1u) &&
                      r.al[j] == 1;
      return ok ? (float)__popc((r.a ^ s) & mask) : invalid;
    }
  };
  bool fits(int N, int D, int lanes) const {
    return (long long)N * lanes < kInt &&
           (long long)len2 * (horizontal ? lanes : N) < kInt &&
           (long long)(lanes / seg_w) * D < kInt;
  }
  __device__ __forceinline__ Tile tile(int b) const {
    return Tile{s1 + (long long)b * N * lanes,
                horizontal ? s2 + ((long long)b * len2 + pad) * lanes
                           : s2 + (long long)b * N * len2,
                allowed != nullptr
                    ? allowed + (long long)b * (lanes / seg_w) * D
                    : nullptr,
                lanes, len2, D, dmin, sec_len, horizontal, seg_w, mask,
                invalid};
  }
};

// one direction's launch
struct Pass {
  const float* p2;          // (B, N, lanes)
  const float* accum;       // (B, N, D, lanes) or null
  float* S;                 // (B, N, D, lanes)
  int* votes;               // (B, n_dirs, N, lanes) or null
  int N, D, lanes, seg_w, lat, dir, n_dirs, last;
  float p1, sub;
  int reverse;
};

// One step's loads.  kMode bit 0: the launch reads S (a later direction);
// bit 1: it reads accum (the last direction of a pass with accum).
template <class Src, int kN, int kMode>
struct Slot {
  typename Src::template Raw<kN> raw;
  float sp[(kMode & 1) ? kN : 1];
  float ac[(kMode & 2) ? kN : 1];
  float p2v;
};

// The chain loop: kN candidates a thread, a step's loads issued kP (1 or
// 0) steps ahead; kFull: D is a multiple of kN.
template <class Src, int kN, int kP, int kMode, bool kFull>
__device__ __forceinline__ void scan_chains(const Src& src, const Pass& a) {
  // per buffer (2): a chain's T groups side by side, padded to Tp, a
  // multiple of 4, so that a thread reads them as float4s
  __shared__ __align__(16) float s_best[2 * kShared];
  __shared__ __align__(16) int s_arg[2 * kShared];
  __shared__ float s_lo[2 * kShared];
  __shared__ float s_hi[2 * kShared];
  constexpr int R = kP + 1;                  // ring slots
  const int N = a.N, D = a.D, lanes = a.lanes, seg_w = a.seg_w,
            lat = a.lat;
  const int C = blockDim.x, T = blockDim.y;
  const int Tp = (T + 3) & ~3;
  const float inf = __int_as_float(0x7f800000);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int me = tx * Tp + ty;               // this thread's slot
  for (int g = T + ty; g < Tp; g += T)       // the padding never wins
    s_best[tx * Tp + g] = s_best[kShared + tx * Tp + g] = inf;
  const int b = blockIdx.y;
  const int q = blockIdx.x * C + tx;
  const int k0 = ty * kN;
  const int cnt = kFull ? kN : (D - k0 < kN ? D - k0 : kN);
  // chain q is at lane (q + lat * s) mod lanes at step s
  const bool valid = q < lanes;
  const int adv = ((lat % lanes) + lanes) % lanes;
  auto next = [&](int x) {
    return x + adv >= lanes ? x + adv - lanes : x + adv;
  };
  int xf = q;                                // lane of the next fetch
  const int n0 = a.reverse ? N - 1 : 0, dn = a.reverse ? -1 : 1;
  const typename Src::Tile t = src.tile(b);
  // the tile's bases; offsets from them are ints
  const long long tile = (long long)b * N * D * lanes;
  float* const Sb = a.S + tile;
  const float* const ab = a.accum + (a.accum != nullptr ? tile : 0);
  const float* const pb = a.p2 + (long long)b * N * lanes;
  int* const vb = a.votes + (a.votes != nullptr
                             ? ((long long)b * a.n_dirs + a.dir) * N * lanes
                             : 0);
  const float sub_l = a.last ? a.sub : 0.f;
  const float p1 = a.p1;
  Slot<Src, kN, kMode> ring[R];
  float Lp[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) Lp[j] = j < cnt ? 0.f : inf;

  // issue step s's loads into sl; nothing waits for them until step s
  auto fetch = [&](Slot<Src, kN, kMode>& sl, int s) {
    const int x = xf;
    xf = next(xf);
    if (!valid) return;
    const int n = n0 + dn * s;
    const int o = (n * D + k0) * lanes + x;
    sl.p2v = __ldg(pb + n * lanes + x);
    t.template load<kN, kFull>(sl.raw, n, x, k0, cnt);
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const bool in = kFull || j < cnt;
      if constexpr ((kMode & 1) != 0) sl.sp[j] = in ? Sb[o + j * lanes] : 0.f;
      if constexpr ((kMode & 2) != 0)
        sl.ac[j] = in ? __ldg(ab + o + j * lanes) : 0.f;
    }
  };

  // the lowest-index minimum over the groups of one step's published
  // partials (strict <, groups in order)
  auto reduce = [&](int buf, int& arg) {
    const float4* vb4 = (const float4*)(s_best + buf + tx * Tp);
    const int4* ab4 = (const int4*)(s_arg + buf + tx * Tp);
    float best = inf;
    arg = 0;
    for (int g = 0; g < Tp / 4; ++g) {
      const float4 v = vb4[g];
      const int4 w = ab4[g];
      if (v.x < best) best = v.x, arg = w.x;
      if (v.y < best) best = v.y, arg = w.y;
      if (v.z < best) best = v.z, arg = w.z;
      if (v.w < best) best = v.w, arg = w.w;
    }
    return best;
  };
  auto minimum = [&](int buf) {
    const float4* vb4 = (const float4*)(s_best + buf + tx * Tp);
    float m = inf;
    for (int g = 0; g < Tp / 4; ++g) {
      const float4 v = vb4[g];
      m = fminf(m, fminf(fminf(v.x, v.y), fminf(v.z, v.w)));
    }
    return m;
  };
  auto vote = [&](int s, int x, int arg) {
    vb[(n0 + dn * s) * lanes + x] = arg;
  };
  const bool voter = valid && ty == 0 && a.votes != nullptr;
  int x = q, xprev = q;                      // lanes of this and the last step

  auto step = [&](const Slot<Src, kN, kMode>& sl, int s) {
    const int cur = (s & 1) * kShared, prv = cur ^ kShared;
    // step s - 1's minimum is this step's m and step s - 1's vote: one
    // reduction, before this step's barrier
    float m = 0.f;
    if (s > 0 && voter) {
      int arg;
      m = reduce(prv, arg);
      vote(s - 1, xprev, arg);
    } else if (s > 0 && valid) {
      m = minimum(prv);
    }
    if (valid) {
      bool dead = s == 0;
      if (lat != 0) {                        // x's place in its segment
        const int xl = seg_w < lanes ? x % seg_w : x;
        dead = dead || (lat > 0 ? xl < lat : xl >= seg_w + lat);
      }
      float lo = inf, hi = inf;
      if (!dead) {
        if (ty > 0) lo = s_hi[prv + me - 1];
        if (ty + 1 < T) hi = s_lo[prv + me + 1];
      }
      float* const Sp = Sb + ((n0 + dn * s) * D + k0) * lanes + x;
      const float mp2 = m + sl.p2v;
      float best = 0.f, before = lo;        // before: old Lp[k - 1]
      int arg = k0;
      // branch-free over the group: a candidate past D (j >= cnt, the
      // last group only) costs inf, so its carry stays inf, which is the
      // last real candidate's right neighbour hi = inf; it is not stored
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float c = !kFull && j >= cnt ? inf
                        : t.template cost<kN>(sl.raw, j);
        const float here = Lp[j];
        const float after = j + 1 < kN ? Lp[j + 1] : hi;
        const float u = fminf(fminf(here, fminf(before, after) + p1), mp2);
        const float L = c + (dead ? 0.f : u - m);
        before = here;
        Lp[j] = L;
        if (j == 0 || L < best) {
          best = L;
          arg = k0 + j;
        }
        float ssum = L;
        if constexpr ((kMode & 1) != 0) ssum = sl.sp[j] + L;
        if (sub_l != 0.f) ssum = ssum - sub_l * c;
        if constexpr ((kMode & 2) != 0) ssum = ssum + sl.ac[j];
        if (kFull || j < cnt) Sp[j * lanes] = ssum;
      }
      s_best[cur + me] = best;
      s_arg[cur + me] = arg;
      s_lo[cur + me] = Lp[0];
      float last_l = Lp[0];
#pragma unroll
      for (int j = 1; j < kN; ++j)
        if (kFull || j < cnt) last_l = Lp[j];
      s_hi[cur + me] = last_l;
    }
    xprev = x;
    x = next(x);
    __syncthreads();
  };

#pragma unroll
  for (int p = 0; p < kP; ++p)
    if (p < N) fetch(ring[p], p);
  for (int s0 = 0; s0 < N; s0 += R) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = s0 + r;                  // uniform over the block
      if (s < N) {
        if (s + kP < N) fetch(ring[(r + kP) % R], s + kP);
        step(ring[r], s);
      }
    }
  }
  if (voter) {                               // the last step's vote
    int arg;
    reduce(((N - 1) & 1) * kShared, arg);
    vote(N - 1, xprev, arg);
  }
}

template <class Src, int kMode, bool kFull>
__global__ void __launch_bounds__(kThreads, 1)
scan_kernel(Src src, Pass a) {
  scan_chains<Src, kK, 1, kMode, kFull>(src, a);
}

template <class Src, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
scan_wide_kernel(Src src, Pass a) {
  scan_chains<Src, kWideK, 0, kMode, false>(src, a);
}

template <class Src, bool kWide, bool kFull, int kMode>
void launch_mode(dim3 grid, dim3 block, cudaStream_t stream, const Src& src,
                 const Pass& a) {
  if constexpr (kWide)
    scan_wide_kernel<Src, kMode><<<grid, block, 0, stream>>>(src, a);
  else
    scan_kernel<Src, kMode, kFull><<<grid, block, 0, stream>>>(src, a);
}

template <class Src, bool kWide, bool kFull>
void launch(int mode, dim3 grid, dim3 block, cudaStream_t stream,
            const Src& src, const Pass& a) {
  switch (mode) {
    case 0: launch_mode<Src, kWide, kFull, 0>(grid, block, stream, src, a); break;
    case 1: launch_mode<Src, kWide, kFull, 1>(grid, block, stream, src, a); break;
    case 2: launch_mode<Src, kWide, kFull, 2>(grid, block, stream, src, a); break;
    default: launch_mode<Src, kWide, kFull, 3>(grid, block, stream, src, a); break;
  }
}

// One launch per direction, in order, on one stream.
template <class Src>
int launch_dirs(const Src& src, const float* p2, const float* accum,
                float* S, int* votes, int B, int N, int D, int lanes,
                int seg_w, int n_dirs, const int* lats, float p1, float sub,
                int reverse, cudaStream_t stream) {
  if (n_dirs < 1 || n_dirs > 3 || D > kWideMaxD || seg_w <= 0 ||
      (lanes > 0 && lanes % seg_w != 0))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || N <= 0 || D <= 0 || lanes <= 0) return (int)cudaGetLastError();
  if (!src.fits(N, D, lanes) || (long long)N * D * lanes >= kInt)
    return (int)cudaErrorInvalidValue;
  const bool wide = D > kMaxD;
  const int kn = wide ? kWideK : kK;
  const int T = (D + kn - 1) / kn;
  const int C = kThreads / T < 32 ? kThreads / T : 32;
  const dim3 grid((lanes + C - 1) / C, B);   // one chain a lane
  const dim3 block(C, T);
  for (int d = 0; d < n_dirs; ++d) {
    const int last = d == n_dirs - 1;
    const Pass a{p2, accum, S, votes, N, D, lanes, seg_w, lats[d], d,
                 n_dirs, last, p1, sub, reverse};
    const int mode = (d > 0 ? 1 : 0) | (last && accum != nullptr ? 2 : 0);
    if (wide) launch<Src, true, false>(mode, grid, block, stream, src, a);
    else if (D % kK == 0) launch<Src, false, true>(mode, grid, block, stream, src, a);
    else launch<Src, false, false>(mode, grid, block, stream, src, a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

}  // namespace

// Cost mode (K2): the uint8 pre-pass volume through its strides.
extern "C" int s2p_scan(const void* cost, long long cs_b, long long cs_n,
                        long long cs_k, long long cs_l, const void* p2,
                        const void* accum, void* S, void* votes, int B, int N,
                        int D, int lanes, int n_dirs, int lat0, int lat1,
                        int lat2, float p1, float invalid_cost, float sub,
                        int reverse, void* stream) {
  const CostU8 src{(const uint8_t*)cost, cs_b, cs_n, cs_k, cs_l,
                   invalid_cost};
  const int lats[3] = {lat0, lat1, lat2};
  return launch_dirs(src, (const float*)p2, (const float*)accum, (float*)S,
                     (int*)votes, B, N, D, lanes, lanes, n_dirs, lats, p1,
                     sub, reverse, (cudaStream_t)stream);
}

// Signature mode (K4a): the census cost built in the kernel.  ``len2`` is
// the secondary's row length (vertical, W2) or row count (horizontal, N2);
// ``seg_w`` the lane-fold mode's segment width (``lanes`` for one tile).
extern "C" int s2p_scan_sig(const void* s1, const void* s2,
                            const void* allowed, const void* p2,
                            const void* accum, void* S, void* votes, int B,
                            int N, int D, int lanes, int len2, int horizontal,
                            int disp_min, int pad, int sec_len,
                            unsigned int mask, int n_dirs, int lat0, int lat1,
                            int lat2, int seg_w, float p1, float invalid_cost,
                            float sub, int reverse, void* stream) {
  const CostSig src{(const uint32_t*)s1, (const uint32_t*)s2,
                    (const int32_t*)allowed, N, lanes, len2, D, disp_min,
                    pad, sec_len, horizontal, seg_w, mask, invalid_cost};
  const int lats[3] = {lat0, lat1, lat2};
  return launch_dirs(src, (const float*)p2, (const float*)accum, (float*)S,
                     (int*)votes, B, N, D, lanes, seg_w, n_dirs, lats, p1,
                     sub, reverse, (cudaStream_t)stream);
}

extern "C" const char* s2p_scan_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
