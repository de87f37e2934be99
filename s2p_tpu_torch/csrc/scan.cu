// One SGM scan pass with one lateral carry offset per direction.
//
// Replaces s2p_tpu/ops/sgm_pallas.py _scan_kernel (:81, wrapper
// _scan_pass_pallas :244) in two of its modes:
//
//   * cost mode (s2p_scan): the cost rows come from the uint8 pre-pass
//     volume, cv == 255 meaning invalid_cost (the mgm flow, K2);
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
//     the [0, sec_len) mask, so the kernel indexes directly and reads s2
//     only where the candidate is in range.
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
// carry restarts fresh: a fresh carry is zero and minconv(0) == 0, which is
// how the TPU kernel masks the segment edges).  The f32 operations run in exactly this order, and
// the build disables FMA contraction, so the sums round as the
// reference's do around BIG = 1e9.
//
// Design.  The TPU kernel carries L in VMEM across sequential grid steps;
// CUDA blocks run in no order.  For one direction, lane x at step s
// depends only on lane x - lat at step s - 1, so the positions
// x = c + lat * s form independent chains, and a block can own any set of
// chains for all steps.  A block owns C consecutive chains (threadIdx.x,
// so loads and stores coalesce along the lanes) and splits the D
// candidates of each chain over T = ceil(D / kK) groups of kK
// (threadIdx.y).  Each thread keeps its kK values of the chain's carry in
// registers; per step it publishes its partial minimum, argmin and edge
// values in shared memory (double-buffered: one __syncthreads per step),
// from which the next step reads m and the neighbouring candidates of
// its edges, and the vote is the lowest-index minimum over the groups
// (strict <, groups in order).  C is 32 while T <= 16 and halves as T
// doubles (C * T <= 512), so any D up to 16384 fits one block per chain
// set.  Directions run as successive launches on the stream in direction
// order: the first writes S = L_0, the next ones S = S + L_d, the last
// also subtracts sub * cost and adds accum -- the reference's order of
// f32 operations.  The uint8 cost may be any strided view.
//
// Bound: bytes (u8 cost or the signatures in, f32 S out, f32 accum in,
// once each, plus the S round trip between directions); the chains'
// sequential steps keep it above that.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;  // chains x candidate groups per block
constexpr int kMaxChains = 32;
constexpr int kValidBit = 24;
constexpr int kPadBit = 25;

// Cost sources.  row(b, n, x, k0) does the per-(step, lane) address work
// once; Row::raw(j) loads candidate k0 + j as the source stores it and
// Row::value turns that into the f32 cost (the uint8 volume keeps its
// bytes in registers until they are used, as they take fewer).

// cost mode: the uint8 pre-pass volume through its strides
struct CostU8 {
  const uint8_t* cost;
  long long sb, sn, sk, sl;
  float invalid;
  struct Row {
    using Raw = uint8_t;
    const uint8_t* p;
    long long sk;
    float invalid;
    __device__ __forceinline__ Raw raw(int j) const { return p[j * sk]; }
    __device__ __forceinline__ float value(Raw v) const {
      return v == 255 ? invalid : (float)v;
    }
  };
  __device__ __forceinline__ Row row(int b, int n, int x, int k0) const {
    return Row{cost + b * sb + n * sn + x * sl + k0 * sk, sk, invalid};
  }
};

// signature mode: the census cost built from the packed signatures
struct CostSig {
  const uint32_t* s1;       // (B, N, lanes)
  const uint32_t* s2;       // vertical (B, N, W2); horizontal (B, N2, lanes)
  const int32_t* allowed;   // (B, lanes / seg_w, D) or null
  int N, lanes, len2, D, dmin, pad, sec_len, horizontal, seg_w;
  uint32_t mask;
  float invalid;
  struct Row {
    using Raw = float;
    const uint32_t* p;      // s2 at candidate position ix = 0
    const int32_t* al;      // allowed from k0, or null
    long long step;         // s2 elements between positions ix and ix + 1
    uint32_t a, mask;
    int ix0, sec_len;       // position of candidate k0; the range
    int state;              // 0: compute, 1: reference padding, 2: invalid
    float invalid;
    __device__ __forceinline__ Raw raw(int j) const {
      if (state == 1) return 0.f;
      const int ix = ix0 + j;
      bool ok = state == 0 && ix >= 0 && ix < sec_len;
      if (ok && al != nullptr) ok = al[j] == 1;
      if (!ok) return invalid;
      const uint32_t s = p[ix * step];
      if (!((s >> kValidBit) & 1u)) return invalid;
      return (float)__popc((a ^ s) & mask);
    }
    __device__ __forceinline__ float value(Raw v) const { return v; }
  };
  __device__ __forceinline__ Row row(int b, int n, int x, int k0) const {
    const uint32_t a = s1[((long long)b * N + n) * lanes + x];
    const int state = ((a >> kPadBit) & 1u) ? 1 : (((a >> kValidBit) & 1u) ? 0 : 2);
    const uint32_t* p =
        horizontal ? s2 + ((long long)b * len2 + pad) * lanes + x
                   : s2 + ((long long)b * N + n) * len2;
    const int32_t* al =
        allowed == nullptr
            ? nullptr
            : allowed + ((long long)b * (lanes / seg_w) + x / seg_w) * D + k0;
    return Row{p, al,
               horizontal ? (long long)lanes : 1LL, a, mask,
               (horizontal ? n : x) + dmin + k0, sec_len, state, invalid};
  }
};

// kC: chains per block, compile-time where it is 32 (0: blockDim.x).
template <int kK, int kC, class Cost>
__global__ void __launch_bounds__(kMaxThreads)
scan_dir_kernel(Cost src, const float* __restrict__ p2,
                const float* __restrict__ accum, float* S,
                int* __restrict__ votes, int N, int D, int lanes,
                int seg_w, int n_chains, int lat, int dir, int n_dirs,
                int first, int last, float p1, float sub, int reverse) {
  // per buffer (2) and thread (T x C <= kMaxThreads): the partial minimum,
  // its argmin, the first and the last carry of the thread's group
  __shared__ float s_best[2 * kMaxThreads];
  __shared__ int s_arg[2 * kMaxThreads];
  __shared__ float s_lo[2 * kMaxThreads];
  __shared__ float s_hi[2 * kMaxThreads];
  const int C = kC > 0 ? kC : blockDim.x, T = blockDim.y;
  const float inf = __int_as_float(0x7f800000);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.y;
  const int q = blockIdx.x * C + tx;
  const int k0 = ty * kK;
  const int cnt = D - k0 < kK ? D - k0 : kK;          // >= 1 by launch
  const int x0 = lat > 0 ? q - lat * (N - 1) : q;     // lane at step 0
  float Lp[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j) Lp[j] = 0.f;
  bool started = false;
  for (int s = 0; s < N; ++s) {
    const int x = x0 + lat * s;
    const bool valid = q < n_chains && x >= 0 && x < lanes;
    const int cur = (s & 1) * kMaxThreads, prv = ((s & 1) ^ 1) * kMaxThreads;
    if (valid) {
      bool dead = !started;
      if (seg_w < lanes && lat != 0) {
        const int xl = x % seg_w;
        dead = dead || (lat > 0 ? xl < lat : xl >= seg_w + lat);
      }
      const int n = reverse ? N - 1 - s : s;
      float m = 0.f, lo = inf, hi = inf;
      if (!dead) {
        m = s_best[prv + tx];
        for (int g = 1; g < T; ++g) m = fminf(m, s_best[prv + g * C + tx]);
        if (ty > 0) lo = s_hi[prv + (ty - 1) * C + tx];
        if (ty + 1 < T) hi = s_lo[prv + (ty + 1) * C + tx];
      }
      const float p2v = p2[((long long)b * N + n) * lanes + x];
      const long long o = (((long long)b * N + n) * D + k0) * lanes + x;
      const typename Cost::Row row = src.row(b, n, x, k0);
      typename Cost::Row::Raw cv[kK];
      float sp[kK], ac[kK];
#pragma unroll
      for (int j = 0; j < kK; ++j) {
        cv[j] = 0;
        sp[j] = 0.f;
        ac[j] = 0.f;
        if (j < cnt) {
          cv[j] = row.raw(j);
          if (!first) sp[j] = S[o + (long long)j * lanes];
          if (last && accum != nullptr) ac[j] = accum[o + (long long)j * lanes];
        }
      }
      float best = 0.f, before = lo;          // before: old Lp[k - 1]
      int arg = k0;
#pragma unroll
      for (int j = 0; j < kK; ++j) {
        if (j < cnt) {
          const float c = row.value(cv[j]);
          const float here = Lp[j];
          float contrib = 0.f;
          if (!dead) {
            const float after = j + 1 < cnt ? Lp[j + 1] : hi;
            const float t = fminf(fminf(here, fminf(before, after) + p1),
                                  m + p2v);
            contrib = t - m;
          }
          before = here;
          const float L = c + contrib;
          Lp[j] = L;
          if (j == 0 || L < best) {
            best = L;
            arg = k0 + j;
          }
          float ssum = first ? L : sp[j] + L;
          if (last) {
            if (sub != 0.f) ssum = ssum - sub * c;
            if (accum != nullptr) ssum = ssum + ac[j];
          }
          S[o + (long long)j * lanes] = ssum;
        }
      }
      s_best[cur + ty * C + tx] = best;
      s_arg[cur + ty * C + tx] = arg;
      s_lo[cur + ty * C + tx] = Lp[0];
      float last_l = Lp[0];
#pragma unroll
      for (int j = 1; j < kK; ++j)
        if (j < cnt) last_l = Lp[j];
      s_hi[cur + ty * C + tx] = last_l;
      started = true;
    }
    __syncthreads();
    if (valid && ty == 0 && votes != nullptr) {
      float best = s_best[cur + tx];
      int arg = s_arg[cur + tx];
      for (int g = 1; g < T; ++g) {
        if (s_best[cur + g * C + tx] < best) {
          best = s_best[cur + g * C + tx];
          arg = s_arg[cur + g * C + tx];
        }
      }
      const int n = reverse ? N - 1 - s : s;
      votes[(((long long)b * n_dirs + dir) * N + n) * lanes + x] = arg;
    }
  }
}

// One launch per direction, in order, on one stream.
template <class Cost>
int launch_dirs(const Cost& src, const void* p2, const void* accum, void* S,
                void* votes, int B, int N, int D, int lanes, int seg_w,
                int n_dirs, const int* lats, float p1, float sub, int reverse,
                cudaStream_t stream) {
  if (n_dirs < 1 || n_dirs > 3) return (int)cudaErrorInvalidValue;
  if (seg_w <= 0 || (lanes > 0 && lanes % seg_w != 0))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || N <= 0 || D <= 0 || lanes <= 0) return (int)cudaGetLastError();
  const int kk = D <= 16 * 16 ? 16 : 32;
  const int T = (D + kk - 1) / kk;
  if (T > kMaxThreads) return (int)cudaErrorInvalidValue;
  int C = kMaxChains;
  while (C > 1 && C * T > kMaxThreads) C /= 2;
  for (int d = 0; d < n_dirs; ++d) {
    const int lat = lats[d];
    const int n_chains = lanes + (lat < 0 ? -lat : lat) * (N - 1);
    const dim3 grid((n_chains + C - 1) / C, B);
    const dim3 block(C, T);
#define S2P_SCAN_ARGS                                                       \
  src, (const float*)p2, (const float*)accum, (float*)S, (int*)votes, N, D, \
      lanes, seg_w, n_chains, lat, d, n_dirs, d == 0, d == n_dirs - 1, p1,  \
      sub, reverse
    if (C != kMaxChains)
      scan_dir_kernel<32, 0, Cost><<<grid, block, 0, stream>>>(S2P_SCAN_ARGS);
    else if (kk == 16)
      scan_dir_kernel<16, kMaxChains, Cost><<<grid, block, 0, stream>>>(
          S2P_SCAN_ARGS);
    else
      scan_dir_kernel<32, kMaxChains, Cost><<<grid, block, 0, stream>>>(
          S2P_SCAN_ARGS);
#undef S2P_SCAN_ARGS
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

}  // namespace

// Cost mode (K2): the uint8 pre-pass volume.
extern "C" int s2p_scan(const void* cost, long long cs_b, long long cs_n,
                        long long cs_k, long long cs_l, const void* p2,
                        const void* accum, void* S, void* votes, int B, int N,
                        int D, int lanes, int n_dirs, int lat0, int lat1,
                        int lat2, float p1, float invalid_cost, float sub,
                        int reverse, void* stream) {
  const CostU8 src{(const uint8_t*)cost, cs_b, cs_n, cs_k, cs_l,
                   invalid_cost};
  const int lats[3] = {lat0, lat1, lat2};
  return launch_dirs(src, p2, accum, S, votes, B, N, D, lanes, lanes, n_dirs,
                     lats, p1, sub, reverse, (cudaStream_t)stream);
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
  return launch_dirs(src, p2, accum, S, votes, B, N, D, lanes, seg_w, n_dirs,
                     lats, p1, sub, reverse, (cudaStream_t)stream);
}

extern "C" const char* s2p_scan_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
