// One SGM scan pass of the mgm flow over a precomputed uint8 cost volume.
//
// Replaces s2p_tpu/ops/sgm_pallas.py _scan_kernel (:81, wrapper
// _scan_pass_pallas :244) in cost mode with one lateral offset per
// direction.  Per scan step s (row n = s, or N - 1 - s in reverse), lane x
// and direction d with lateral offset lat[d]:
//
//   cost  = cv == 255 ? invalid_cost : cv
//   Lp    = L_d of step s - 1 at lane x - lat[d]
//   m     = min_k Lp
//   L_d   = cost + (dead ? 0 : min(min(Lp[k], min(Lp[k-1], Lp[k+1]) + p1),
//                                  m + p2[n, x]) - m)
//   S     = ((L_0 + L_1) + L_2) - sub * cost + accum
//   votes = lowest k of min_k L_d
//
// "dead" is step 0 and every lane whose predecessor x - lat[d] lies
// outside the image.  The f32 operations run in exactly this order, and
// the build disables FMA contraction, so the sums round as the
// reference's do around BIG = 1e9.
//
// Design.  The TPU kernel carries L in VMEM across sequential grid steps;
// CUDA blocks run in no order.  For one direction, lane x at step s
// depends only on lane x - lat at step s - 1, so the positions
// x = c + lat * s form independent chains, and a block can own any set of
// chains for all steps.  A block owns 32 consecutive chains
// (threadIdx.x, so loads and stores coalesce along the lanes) and splits
// the D candidates of each chain over blockDim.y groups of kK
// (threadIdx.y).  Each thread keeps its kK values of the chain's carry in
// registers; per step it publishes its partial minimum, argmin and edge
// values in shared memory (double-buffered: one __syncthreads per step),
// from which the next step reads m and the neighbouring candidates of
// its edges, and the vote is the lowest-index minimum over the groups.
// Directions run as successive launches on the stream in direction
// order: the first writes S = L_0, the next ones S = S + L_d, the last
// also subtracts sub * cost and adds accum -- the reference's order of
// f32 operations.  The cost may be any strided view.
//
// Bound: bytes (u8 cost in, f32 S out, f32 accum in, once each, plus the
// S round trip between directions); the chains' sequential steps keep it
// above that.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 32;      // chains per block (threadIdx.x)
constexpr int kMaxGroups = 16;   // candidate groups per chain (threadIdx.y)

template <int kK>
__global__ void __launch_bounds__(kChains * kMaxGroups)
scan_dir_kernel(const uint8_t* __restrict__ cost, long long cs_b,
                long long cs_n, long long cs_k, long long cs_l,
                const float* __restrict__ p2, const float* __restrict__ accum,
                float* S, int* __restrict__ votes, int N, int D, int lanes,
                int n_chains, int lat, int dir, int n_dirs, int first,
                int last, float p1, float invalid_cost, float sub,
                int reverse) {
  __shared__ float s_best[2][kMaxGroups][kChains];
  __shared__ int s_arg[2][kMaxGroups][kChains];
  __shared__ float s_lo[2][kMaxGroups][kChains];
  __shared__ float s_hi[2][kMaxGroups][kChains];
  const float inf = __int_as_float(0x7f800000);
  const int tx = threadIdx.x, ty = threadIdx.y, T = blockDim.y;
  const int b = blockIdx.y;
  const int q = blockIdx.x * kChains + tx;
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
    const int cur = s & 1, prv = cur ^ 1;
    if (valid) {
      const bool dead = !started;
      const int n = reverse ? N - 1 - s : s;
      float m = 0.f, lo = inf, hi = inf;
      if (!dead) {
        m = s_best[prv][0][tx];
        for (int g = 1; g < T; ++g) m = fminf(m, s_best[prv][g][tx]);
        if (ty > 0) lo = s_hi[prv][ty - 1][tx];
        if (ty + 1 < T) hi = s_lo[prv][ty + 1][tx];
      }
      const float p2v = p2[((long long)b * N + n) * lanes + x];
      const uint8_t* cst = cost + b * cs_b + n * cs_n + x * cs_l + k0 * cs_k;
      const long long o = (((long long)b * N + n) * D + k0) * lanes + x;
      uint8_t cv[kK];
      float sp[kK], ac[kK];
#pragma unroll
      for (int j = 0; j < kK; ++j) {
        cv[j] = 0;
        sp[j] = 0.f;
        ac[j] = 0.f;
        if (j < cnt) {
          cv[j] = cst[j * cs_k];
          if (!first) sp[j] = S[o + (long long)j * lanes];
          if (last && accum != nullptr) ac[j] = accum[o + (long long)j * lanes];
        }
      }
      float best = 0.f, before = lo;          // before: old Lp[k - 1]
      int arg = k0;
#pragma unroll
      for (int j = 0; j < kK; ++j) {
        if (j < cnt) {
          const float c = cv[j] == 255 ? invalid_cost : (float)cv[j];
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
      s_best[cur][ty][tx] = best;
      s_arg[cur][ty][tx] = arg;
      s_lo[cur][ty][tx] = Lp[0];
      float last_l = Lp[0];
#pragma unroll
      for (int j = 1; j < kK; ++j)
        if (j < cnt) last_l = Lp[j];
      s_hi[cur][ty][tx] = last_l;
      started = true;
    }
    __syncthreads();
    if (valid && ty == 0 && votes != nullptr) {
      float best = s_best[cur][0][tx];
      int arg = s_arg[cur][0][tx];
      for (int g = 1; g < T; ++g) {
        if (s_best[cur][g][tx] < best) {
          best = s_best[cur][g][tx];
          arg = s_arg[cur][g][tx];
        }
      }
      const int n = reverse ? N - 1 - s : s;
      votes[(((long long)b * n_dirs + dir) * N + n) * lanes + x] = arg;
    }
  }
}

}  // namespace

// One launch per direction, in order, on one stream.
extern "C" int s2p_scan(const void* cost, long long cs_b, long long cs_n,
                        long long cs_k, long long cs_l, const void* p2,
                        const void* accum, void* S, void* votes, int B, int N,
                        int D, int lanes, int n_dirs, int lat0, int lat1,
                        int lat2, float p1, float invalid_cost, float sub,
                        int reverse, void* stream) {
  if (n_dirs < 1 || n_dirs > 3) return (int)cudaErrorInvalidValue;
  if (D > 32 * kMaxGroups) return (int)cudaErrorInvalidValue;
  if (B <= 0 || N <= 0 || D <= 0 || lanes <= 0) return (int)cudaGetLastError();
  const int kk = D <= 16 * kMaxGroups ? 16 : 32;
  const int lats[3] = {lat0, lat1, lat2};
  for (int d = 0; d < n_dirs; ++d) {
    const int lat = lats[d];
    const int n_chains = lanes + (lat < 0 ? -lat : lat) * (N - 1);
    const dim3 grid((n_chains + kChains - 1) / kChains, B);
    const dim3 block(kChains, (D + kk - 1) / kk);
#define S2P_SCAN_ARGS                                                        \
  (const uint8_t*)cost, cs_b, cs_n, cs_k, cs_l, (const float*)p2,            \
      (const float*)accum, (float*)S, (int*)votes, N, D, lanes, n_chains,    \
      lat, d, n_dirs, d == 0, d == n_dirs - 1, p1, invalid_cost, sub, reverse
    if (kk == 16)
      scan_dir_kernel<16><<<grid, block, 0, (cudaStream_t)stream>>>(
          S2P_SCAN_ARGS);
    else
      scan_dir_kernel<32><<<grid, block, 0, (cudaStream_t)stream>>>(
          S2P_SCAN_ARGS);
#undef S2P_SCAN_ARGS
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

extern "C" const char* s2p_scan_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
