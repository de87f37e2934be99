// One SGM scan pass whose directions average the penalty terms of
// several lateral predecessors (MGM), with the census cost built from
// bit-packed signatures in the kernel.
//
// Replaces s2p_tpu/ops/sgm_pallas.py _scan_kernel (:81, wrapper
// _scan_pass_pallas :244) in signature mode with len(laterals) > 1
// (:203-221), the mode sgm_pallas.aggregate runs with params.mgm.  Per
// scan step s (row n), lane x and direction d with laterals lat[d][i]:
//
//   c_i  = dead_i ? 0 : minconv(L_d of step s - 1 at lane x - lat[d][i])[k]
//   c    = (c_0 + c_1) [+ c_2]
//   L_d  = fma(c, f32(1 / n_lat), cost)       (n_lat > 1; else cost + c)
//   S    = ((L_0 + L_1) + L_2) - sub * cost + accum
//
// with minconv(Lp)[k] = min(min(Lp[k], min(Lp[k-1], Lp[k+1]) + p1),
// m + p2[n, x]) - m, m = min_k Lp, and the cost of s2p_scan_sig (scan.cu).
// "dead_i" is step 0 and every lane whose predecessor x - lat lies outside
// the image.  The f32 operations run in exactly this order, FMA
// contraction off; the one fused multiply-add is explicit: the reference
// is the JAX package's CPU run, where XLA contracts cost + c * f32(1/n).
//
// Design.  Lane x at step s depends on lanes x - 1, x and x + 1 of step
// s - 1, so the chains of scan.cu do not exist here: a step needs the
// whole previous row.  A thread block cluster of kCluster blocks owns one
// (tile, direction) and walks the steps; each block owns a slice of the
// lanes.  The carry and the per-lane minimum m live in global memory (the
// carry does not fit shared memory at real widths: D x W x 4 bytes),
// double-buffered so a step reads one buffer and writes the other.  Each
// step is (A) every thread updating a strided set of the block's (k, x)
// elements, lanes fastest, so loads and stores coalesce; a __syncthreads;
// (B) the per-lane minimum and vote (lowest k on ties) from chunks of
// candidates reduced in order; and one cluster barrier, whose
// release/acquire order makes the step's carry and minima visible to the
// neighbouring blocks that read the edge lanes at the next step.
// Directions run as successive launches, as in scan.cu.
//
// Bound: bytes, as scan.cu; but only kCluster SMs work on a (tile,
// direction), and each step streams the carry (D x W floats, read three
// times per lateral) between L2 and them, so this kernel sits far above
// it.  Keeping the carry in distributed shared memory is the next step.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kCluster = 8;      // blocks of one (tile, direction)
constexpr int kValidBit = 24;
constexpr int kPadBit = 25;

struct Sig {
  const uint32_t* s1;       // (B, N, lanes)
  const uint32_t* s2;       // vertical (B, N, W2); horizontal (B, N2, lanes)
  const int32_t* allowed;   // (B, D) or null
  int N, lanes, len2, D, dmin, pad, sec_len, horizontal;
  uint32_t mask;
  float invalid;
  __device__ __forceinline__ float at(int b, int n, int x, int k) const {
    const uint32_t a = s1[((long long)b * N + n) * lanes + x];
    if ((a >> kPadBit) & 1u) return 0.f;
    const int ix = (horizontal ? n : x) + dmin + k;
    bool ok = ((a >> kValidBit) & 1u) && ix >= 0 && ix < sec_len;
    if (ok && allowed != nullptr) ok = allowed[b * D + k] == 1;
    if (!ok) return invalid;
    const uint32_t s =
        horizontal ? s2[((long long)b * len2 + ix + pad) * lanes + x]
                   : s2[((long long)b * N + n) * len2 + ix];
    if (!((s >> kValidBit) & 1u)) return invalid;
    return (float)__popc((a ^ s) & mask);
  }
};

struct Lats {
  int n;
  int v[3];
};

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
scan_mgm_kernel(Sig src, const float* __restrict__ p2,
                const float* __restrict__ accum, float* S,
                int* __restrict__ votes, float* carry, float* mins, Lats lats,
                int N, int D, int lanes, int dir, int n_dirs, int first,
                int last, float p1, float inv_n, float sub, int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float s_v[kThreads];         // partial minima of phase (B)
  __shared__ int s_k[kThreads];
  const float inf = __int_as_float(0x7f800000);
  const int b = blockIdx.y;
  const int W = lanes;
  const int Wb = (W + kCluster - 1) / kCluster;
  const int x_lo = (int)cluster.block_rank() * Wb;
  const int w_own = W - x_lo < Wb ? (W - x_lo > 0 ? W - x_lo : 0) : Wb;
  const int plane = D * W;
  // phase (B) splits each lane's candidates into kparts contiguous chunks
  const int kparts =
      w_own > 0 && w_own <= (int)blockDim.x ? (int)blockDim.x / w_own : 1;
  const int chunk = (D + kparts - 1) / kparts;
  float* buf0 = carry + (long long)b * 2 * plane;
  float* m0 = mins + (long long)b * 2 * W;
  for (int s = 0; s < N; ++s) {
    const int n = reverse ? N - 1 - s : s;
    const float* prev = buf0 + ((s & 1) ^ 1) * plane;
    float* next = buf0 + (s & 1) * plane;
    const float* m_prev = m0 + ((s & 1) ^ 1) * W;
    float* m_next = m0 + (s & 1) * W;
    const long long row = ((long long)b * N + n) * plane;
    // (A) the new carry and S on the block's lanes
    for (int e = threadIdx.x; e < D * w_own; e += blockDim.x) {
      const int k = e / w_own;
      const int x = x_lo + (e - k * w_own);
      const float c = src.at(b, n, x, k);
      float acc = 0.f;
      if (s > 0) {
        const float p2v = p2[((long long)b * N + n) * W + x];
        for (int i = 0; i < lats.n; ++i) {
          const int xs = x - lats.v[i];
          float t = 0.f;
          if (xs >= 0 && xs < W) {
            const float m = m_prev[xs];
            const float here = prev[k * W + xs];
            const float lo = k > 0 ? prev[(k - 1) * W + xs] : inf;
            const float hi = k + 1 < D ? prev[(k + 1) * W + xs] : inf;
            t = fminf(fminf(here, fminf(lo, hi) + p1), m + p2v) - m;
          }
          acc = i == 0 ? t : acc + t;
        }
      }
      // the fused multiply-add of the reference's CPU run (XLA contracts
      // cost + c * f32(1 / n) into one rounding)
      const float L = lats.n > 1 ? __fmaf_rn(acc, inv_n, c) : c + acc;
      const int o = k * W + x;
      next[o] = L;
      float ssum = first ? L : S[row + o] + L;
      if (last) {
        if (sub != 0.f) ssum = ssum - sub * c;
        if (accum != nullptr) ssum = ssum + accum[row + o];
      }
      S[row + o] = ssum;
    }
    __syncthreads();
    // (B) per lane: m for the next step and the vote (lowest k on ties):
    // the minimum of each chunk, then of the chunks in order
    for (int t = threadIdx.x; t < kparts * w_own; t += blockDim.x) {
      const int part = t / w_own;
      const int x = x_lo + (t - part * w_own);
      const int k_lo = part * chunk;
      const int k_hi = k_lo + chunk < D ? k_lo + chunk : D;
      float best = inf;
      int arg = -1;                       // an empty chunk
      for (int k = k_lo; k < k_hi; ++k) {
        const float v = next[k * W + x];
        if (arg < 0 || v < best) {
          best = v;
          arg = k;
        }
      }
      if (kparts == 1) {
        m_next[x] = best;
        if (votes != nullptr)
          votes[(((long long)b * n_dirs + dir) * N + n) * W + x] = arg;
      } else {
        s_v[t] = best;
        s_k[t] = arg;
      }
    }
    if (kparts > 1) {
      __syncthreads();
      for (int xl = threadIdx.x; xl < w_own; xl += blockDim.x) {
        float best = s_v[xl];
        int arg = s_k[xl];
        for (int part = 1; part < kparts; ++part) {
          const int t = part * w_own + xl;
          if (s_k[t] >= 0 && s_v[t] < best) {
            best = s_v[t];
            arg = s_k[t];
          }
        }
        m_next[x_lo + xl] = best;
        if (votes != nullptr)
          votes[(((long long)b * n_dirs + dir) * N + n) * W + x_lo + xl] =
              arg;
      }
    }
    // the carry and the minima of step s, written by every block of the
    // cluster, are read by its neighbours at step s + 1
    cluster.sync();
  }
}

}  // namespace

// One launch per direction, in order, on one stream.  ``lats`` holds
// n_dirs x 3 lateral offsets, ``n_lats`` the count of each direction;
// ``carry`` is (B, 2, D, lanes) and ``mins`` (B, 2, lanes) float32 scratch.
extern "C" int s2p_scan_mgm(const void* s1, const void* s2,
                            const void* allowed, const void* p2,
                            const void* accum, void* S, void* votes,
                            void* carry, void* mins, int B, int N, int D,
                            int lanes, int len2, int horizontal, int disp_min,
                            int pad, int sec_len, unsigned int mask,
                            int n_dirs, const int* n_lats, const int* lats,
                            float p1, float invalid_cost, float sub,
                            int reverse, void* stream) {
  if (n_dirs < 1 || n_dirs > 3) return (int)cudaErrorInvalidValue;
  if (B <= 0 || N <= 0 || D <= 0 || lanes <= 0) return (int)cudaGetLastError();
  if ((long long)D * lanes > 0x7fffffffLL || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Sig src{(const uint32_t*)s1, (const uint32_t*)s2,
                (const int32_t*)allowed, N, lanes, len2, D, disp_min, pad,
                sec_len, horizontal, mask, invalid_cost};
  for (int d = 0; d < n_dirs; ++d) {
    Lats l;
    l.n = n_lats[d];
    if (l.n < 1 || l.n > 3) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < 3; ++i) l.v[i] = lats[3 * d + i];
    const float inv_n = (float)(1.0 / l.n);
    scan_mgm_kernel<<<dim3(kCluster, B), kThreads, 0, (cudaStream_t)stream>>>(
        src, (const float*)p2, (const float*)accum, (float*)S, (int*)votes,
        (float*)carry, (float*)mins, l, N, D, lanes, d, n_dirs, d == 0,
        d == n_dirs - 1, p1, inv_n, sub, reverse);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

extern "C" const char* s2p_scan_mgm_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
