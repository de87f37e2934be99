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
// s - 1 (laterals are -1, 0 or +1), so a step needs the whole previous
// row but a lane only its two neighbours.  A thread block cluster of
// kCluster blocks owns one (direction, tile) and walks the steps of the
// pass; the clusters of every direction of a pass run at once in one
// launch (kCluster SMs per direction and tile).  Each block owns
// Wb = ceil(W / kCluster) lanes.  In the shared instantiation the carry
// (D x Wb floats, double-buffered) and the per-lane minima live in the
// block's own shared memory, with one halo lane on each side, so the
// carry never touches L2.  The step's signature words and P2 are copied
// into shared memory one step ahead (cp.async), off the recurrence's
// critical path; a horizontal pass keeps its secondary rows in a ring to
// which a step adds one row.  A step is (A) each warp taking a range of
// candidates of the block's lanes, a thread one lane, sliding a window of
// three candidates down its range per lateral: the new carry, the
// direction's output, and the lane's partial minimum and vote; a
// __syncthreads; (B) the per-lane minimum and vote (lowest k on ties)
// over the warps' ranges in order, while two warps store the block's edge
// lanes of the new carry into the neighbours' halos through distributed
// shared memory (the minima's edges go likewise); and one cluster
// barrier, whose release/acquire order makes the pushes visible.  The
// most laterals of a direction is a template argument, so the step's
// loops unroll without a branch: the carry has a +inf row above and below
// the candidates, and a dead lateral reads its own lane and adds +0.
//
// A pass of one direction writes S itself.  With several, direction 0
// writes L_0 into S and direction d > 0 its L_d into a scratch volume
// (with the cost where sub is set), and a second kernel sums them in the
// reference's order: S = ((L_0 + L_1) + L_2) - sub * cost + accum.
// A cluster per direction, and not a pass's directions in lockstep in
// one cluster, because a step is bound by the instruction issue of the
// SMs that run it: the SMs that three clusters give a vertical pass gain
// more than the extra launch and the scratch volumes cost (PERF.md,
// section 6).
//
// A shape whose carry does not fit shared memory (D x Wb too large) runs
// the global instantiation: the same loop with the carry and minima in a
// (B, n_dirs, 2, D + 2, W) global scratch, read from L2 across the block
// edges, and the cost read from the signatures at its step; the cluster
// barrier's release/acquire order publishes each step.
//
// Bound: bytes, as scan.cu; but only kCluster SMs work on a direction of
// a tile and a step is serial, so the floor is the step count times one
// cluster barrier (s2p_cluster_sync_loop times it).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 16;  // blocks of a (direction, tile); non-portable
constexpr int kMaxShared = 232448;
constexpr int kValidBit = 24;
constexpr int kPadBit = 25;

struct Pass {
  const uint32_t* s1;       // (B, N, W)
  const uint32_t* s2;       // vertical (B, N, len2); horizontal (B, len2, W)
  const int32_t* allowed;   // (B, D) or null
  const float* p2;          // (B, N, W)
  const float* accum;       // (B, N, D, W) or null
  float* S;                 // (B, N, D, W)
  int* votes;               // (B, n_dirs, N, W) or null
  float* carry;             // global instantiation: (B, n_dirs, 2, D + 2, W)
  float* mins;              // global instantiation: (B, n_dirs, 2, W)
  float* part;              // n_dirs > 1: L_1 [, L_2] [, cost] (B, N, D, W)
  int N, D, W, len2, dmin, pad, sec_len, horizontal, reverse;
  uint32_t mask;
  float invalid, p1, sub;
  int n_dirs;
  int n_lat[3];
  int lat[3][3];
  float inv_n[3];
  int Wb;                   // lanes of a block
};

// Shared-memory layout in 4-byte words of one block (one direction).
// The shared instantiation holds carry[2][D + 2][Wb + 2], mins[2][Wb + 2]
// (lane xl at column xl + 1, the halos at 0 and Wb + 1), raw[2][...] (a
// step's s1 words and P2, and for a vertical pass its Wb + D - 1
// secondary columns) and, for a horizontal pass, a ring of D + 1
// secondary rows of Wb words (row r in slot r mod (D + 1): a step adds
// one row); both hold the warps' partial minima and votes and `allowed`.
struct Layout {
  int carry, mins, pv, pk, raw, raw_w, ring, al, total;
};

__host__ __device__ inline Layout layout(bool shared, int D, int Wb,
                                         int horizontal) {
  Layout l;
  const int rs = Wb + 2;
  l.carry = 0;
  l.mins = l.carry + (shared ? 2 * (D + 2) * rs : 0);
  l.pv = l.mins + (shared ? 2 * rs : 0);
  l.pk = l.pv + kWarps * Wb;
  l.raw = l.pk + kWarps * Wb;
  l.raw_w = 2 * Wb + (horizontal ? 0 : Wb + D - 1);
  l.ring = l.raw + (shared ? 2 * l.raw_w : 0);
  l.al = l.ring + (shared && horizontal ? (D + 1) * Wb : 0);
  l.total = l.al + D;
  return l;
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src,
                                          bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the ring slot of secondary row r: r mod (D + 1), for any sign of r
__device__ __forceinline__ int ring_slot(int r, int D) {
  const int m = r % (D + 1);
  return m < 0 ? m + D + 1 : m;
}

// the census cost of s2p_scan_sig from the raw words
__device__ __forceinline__ float cost_of(const Pass& p, uint32_t a,
                                         uint32_t s, int ix, int al) {
  if ((a >> kPadBit) & 1u) return 0.f;
  const bool ok = ((a >> kValidBit) & 1u) && ix >= 0 && ix < p.sec_len &&
                  al == 1 && ((s >> kValidBit) & 1u);
  return ok ? (float)__popc((a ^ s) & p.mask) : p.invalid;
}

template <bool kShared, int NL>
__global__ void __launch_bounds__(kThreads, 1) scan_mgm_kernel(Pass p) {
  extern __shared__ __align__(16) uint32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const float inf = __int_as_float(0x7f800000);
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int dir = blockIdx.y, b = blockIdx.z;
  const int N = p.N, D = p.D, W = p.W, Wb = p.Wb, nd = p.n_dirs;
  const int x_lo = rank * Wb;
  const int w_own = W - x_lo < Wb ? (W - x_lo > 0 ? W - x_lo : 0) : Wb;
  const Layout lay = layout(kShared, D, Wb, p.horizontal);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // warp w takes candidates [k_lo, k_hi); nw warps have any
  const int KS = (D + kWarps - 1) / kWarps;
  const int nw = (D + KS - 1) / KS;
  const int k_lo = warp * KS < D ? warp * KS : D;
  const int k_hi = k_lo + KS < D ? k_lo + KS : D;
  float* const pv = reinterpret_cast<float*>(sm + lay.pv);
  int* const pk = reinterpret_cast<int*>(sm + lay.pk);
  int* const s_al = reinterpret_cast<int*>(sm + lay.al);
  // the direction's laterals
  int lat[NL], n_lat = p.n_lat[dir];
#pragma unroll
  for (int i = 0; i < NL; ++i) lat[i] = p.lat[dir][i];
  const float inv_n = p.inv_n[dir];
  // where L goes: S (direction 0, or the only one, which also applies sub
  // and accum) or the direction's scratch volume; the cost to scratch for
  // the sum's sub
  const long long vol = (long long)p.N * D * W * gridDim.z;
  float* const out = dir == 0 ? p.S : p.part + (dir - 1) * vol;
  float* const cost_out =
      nd > 1 && dir == 0 && p.sub != 0.f ? p.part + (nd - 1) * vol : nullptr;
  const bool finish = nd == 1;
  // carry[2][D + 2][RS] (candidate k in row k + 1, rows 0 and D + 1 +inf,
  // so a window never tests an end) and mins[2][RS]; the block's lane xl
  // sits at column col0 + xl
  float* carry;
  float* mins;
  int RS, col0;
  if (kShared) {
    carry = reinterpret_cast<float*>(sm + lay.carry);
    mins = reinterpret_cast<float*>(sm + lay.mins);
    RS = Wb + 2;
    col0 = 1;
  } else {
    carry = p.carry + ((long long)b * nd + dir) * 2 * (D + 2) * W;
    mins = p.mins + ((long long)b * nd + dir) * 2 * W;
    RS = W;
    col0 = x_lo;
  }
  const int plane = (D + 2) * RS;
  // the neighbours' carry and minima (shared instantiation): this block's
  // first lane is the left neighbour's right halo, its last lane the
  // right neighbour's left halo
  float* lc = nullptr;
  float* lm = nullptr;
  float* rc = nullptr;
  float* rm = nullptr;
  if (kShared && rank > 0) {
    lc = cluster.map_shared_rank(carry, rank - 1);
    lm = cluster.map_shared_rank(mins, rank - 1);
  }
  if (kShared && rank + 1 < C) {
    rc = cluster.map_shared_rank(carry, rank + 1);
    rm = cluster.map_shared_rank(mins, rank + 1);
  }
  for (int k = tid; k < D; k += kThreads)
    s_al[k] = p.allowed != nullptr ? p.allowed[b * D + k] : 1;
  // the +inf end rows of both buffers: every column of the block's own
  // (shared) or its lanes of the scratch (global)
  {
    const int c0 = kShared ? 0 : x_lo;
    const int cols = kShared ? RS : w_own;
    for (int e = tid; e < 2 * 2 * cols; e += kThreads) {
      const int c = e % cols, r = e / cols;   // r: parity and end
      carry[(r >> 1) * plane + (r & 1) * (D + 1) * RS + c0 + c] = inf;
    }
  }

  // copy step s's s1 words and P2 into raw[s & 1], with the secondary
  // words it needs (vertical) or the row its window gains (horizontal)
  auto stage = [&](int s) {
    const int n = p.reverse ? N - 1 - s : s;
    uint32_t* const r = sm + lay.raw + (s & 1) * lay.raw_w;
    const long long row = (long long)b * N + n;
    for (int xl = tid; xl < w_own; xl += kThreads) {
      cp_async4(r + xl, p.s1 + row * W + x_lo + xl, true);
      cp_async4(r + Wb + xl, p.p2 + row * W + x_lo + xl, true);
    }
    if (!p.horizontal) {
      uint32_t* const r2 = r + 2 * Wb;
      // columns x_lo + dmin + j of row n, j in [0, w_own + D - 1)
      const uint32_t* const s2r = p.s2 + row * p.len2;
      for (int j = tid; j < w_own + D - 1; j += kThreads) {
        const int col = x_lo + p.dmin + j;
        const bool in = col >= 0 && col < p.len2;
        cp_async4(r2 + j, s2r + (in ? col : 0), in);
      }
    } else {
      // rows n + dmin + pad + k (k in [0, D)) of the block's lanes into
      // the ring: all of them for the first step, then the one row that
      // the window gains (forward its last, reverse its first)
      const int first = s == 0 ? 0 : p.reverse ? 0 : D - 1;
      const int last = s == 0 ? D : first + 1;
      for (int k = first + warp; k < last; k += kWarps) {
        const int rr = n + p.dmin + p.pad + k;
        const bool in = rr >= 0 && rr < p.len2;
        const uint32_t* const s2r =
            p.s2 + ((long long)b * p.len2 + (in ? rr : 0)) * W + x_lo;
        uint32_t* const slot = sm + lay.ring + ring_slot(rr, D) * Wb;
        for (int xl = lane; xl < w_own; xl += 32)
          cp_async4(slot + xl, s2r + xl, in);
      }
    }
  };

  if (kShared) {
    stage(0);
    cp_async_wait_all();
  }
  // every block of the cluster runs (its shared memory may be written),
  // and s_al, the end rows and raw[0] are in place
  cluster.sync();

  for (int s = 0; s < N; ++s) {
    const int n = p.reverse ? N - 1 - s : s;
    const int cur = s & 1, prv = cur ^ 1;
    if (kShared && s + 1 < N) stage(s + 1);
    const long long row = (long long)b * N + n;
    const uint32_t* const r = sm + lay.raw + cur * lay.raw_w;
    const float* const prevc = carry + prv * plane;
    const float* const prevm = mins + prv * RS;

    // (A) the new carry, the output, and each warp's partial minima
    for (int xl = lane; xl < w_own && k_lo < k_hi; xl += 32) {
      const int x = x_lo + xl;
      const int col = col0 + xl;
      uint32_t a;
      float p2v;
      if (kShared) {
        a = r[xl];
        p2v = __uint_as_float(r[Wb + xl]);
      } else {
        a = p.s1[row * W + x];
        p2v = p.p2[row * W + x];
      }
      // per lateral: alive (a lateral past the direction's count or a
      // source lane outside the image is not, and adds +0), the source
      // lane's minimum, and a window of candidates k - 1, k with a
      // pointer to k + 1 at the source lane (a dead lateral reads its own
      // lane, in bounds, and discards it)
      bool live[NL];
      float m[NL], mq[NL], lo[NL], here[NL];
      const float* q[NL];
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const int xs = x - lat[i];
        live[i] = i < n_lat && s > 0 && xs >= 0 && xs < W;
        const int cs = live[i] ? col - lat[i] : col;
        const float* const src = prevc + cs;
        m[i] = live[i] ? prevm[cs] : 0.f;
        mq[i] = m[i] + p2v;
        lo[i] = src[k_lo * RS];
        here[i] = src[(k_lo + 1) * RS];
        q[i] = src + (k_lo + 2) * RS;
      }
      float bmin = 0.f;
      int barg = 0;
      const uint32_t* const r2 = r + 2 * Wb + xl;
      // the ring slot of candidate k_lo's secondary row (horizontal)
      const uint32_t* const ring = sm + lay.ring + xl;
      int slot = ring_slot(n + p.dmin + p.pad + k_lo, D);
      float* nc = carry + cur * plane + (k_lo + 1) * RS;
      long long so = (row * D + k_lo) * W + x;
      for (int k = k_lo; k < k_hi; ++k) {
        const int ix = (p.horizontal ? n : x) + p.dmin + k;
        uint32_t sw;
        if (kShared) {
          if (p.horizontal) {
            sw = ring[slot * Wb];
            slot = slot == D ? 0 : slot + 1;
          } else {
            sw = r2[k];
          }
        } else {
          const bool in = ix >= 0 && ix < p.sec_len;
          sw = !in ? 0u
               : p.horizontal
                   ? p.s2[((long long)b * p.len2 + ix + p.pad) * W + x]
                   : p.s2[row * p.len2 + ix];
        }
        const float c = cost_of(p, a, sw, ix, s_al[k]);
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          const float hi = *q[i];
          q[i] += RS;
          float t = fminf(fminf(here[i], fminf(lo[i], hi) + p.p1), mq[i]) -
                    m[i];
          t = live[i] ? t : 0.f;
          lo[i] = here[i];
          here[i] = hi;
          acc = i == 0 ? t : acc + t;
        }
        // the fused multiply-add of the reference's CPU run (XLA
        // contracts cost + c * f32(1 / n) into one rounding)
        const float L = n_lat > 1 ? __fmaf_rn(acc, inv_n, c) : c + acc;
        nc[col] = L;
        nc += RS;
        if (k == k_lo || L < bmin) {
          bmin = L;
          barg = k;
        }
        float v = L;
        if (finish) {
          if (p.sub != 0.f) v = v - p.sub * c;
          if (p.accum != nullptr) v = v + p.accum[so];
        } else if (cost_out != nullptr) {
          cost_out[so] = c;
        }
        out[so] = v;
        so += W;
      }
      pv[warp * Wb + xl] = bmin;
      pk[warp * Wb + xl] = barg;
    }
    __syncthreads();
    // (B) per lane: m for the next step and the vote, the warps' ranges
    // in order (lowest k on ties); the edge lanes' m into the neighbours'
    // halos
    for (int xl = tid; xl < w_own; xl += kThreads) {
      float best = pv[xl];
      int arg = pk[xl];
      for (int w = 1; w < nw; ++w) {
        const float v = pv[w * Wb + xl];
        if (v < best) {
          best = v;
          arg = pk[w * Wb + xl];
        }
      }
      const int o = cur * RS;
      mins[o + col0 + xl] = best;
      if (kShared && xl == 0 && lm != nullptr) lm[o + Wb + 1] = best;
      if (kShared && xl == w_own - 1 && rm != nullptr) rm[o] = best;
      if (p.votes != nullptr)
        p.votes[(((long long)b * nd + dir) * N + n) * W + x_lo + xl] = arg;
    }
    // the edge lanes' new carry into the neighbours' halos, a warp each
    if (kShared && w_own > 0 && warp >= kWarps - 2) {
      const bool right = warp == kWarps - 1;
      float* const dst = right ? rc : lc;
      const int from = right ? col0 + w_own - 1 : col0;
      const int to = right ? 0 : Wb + 1;
      if (dst != nullptr)
        for (int k = lane; k < D; k += 32) {
          const int o = cur * plane + (k + 1) * RS;
          dst[o + to] = carry[o + from];
        }
    }
    // the next step's staged words have landed; the step's carry and
    // minima, written here and pushed into the neighbours' halos (or to
    // global memory), are visible to the whole cluster after the barrier
    if (kShared) cp_async_wait_all();
    cluster.sync();
  }
}

// The sum of a pass's directions in the reference's order:
// S = ((S + L_1) [+ L_2]) [- sub * cost] [+ accum], S holding L_0.
__global__ void mgm_sum_kernel(float* __restrict__ S,
                               const float* __restrict__ part,
                               const float* __restrict__ accum, int n_extra,
                               float sub, long long vol) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < vol; i += (long long)gridDim.x * blockDim.x) {
    float v = S[i] + part[i];
    if (n_extra == 2) v = v + part[vol + i];
    if (sub != 0.f) v = v - sub * part[n_extra * vol + i];
    if (accum != nullptr) v = v + accum[i];
    S[i] = v;
  }
}

// The step floor: one cluster barrier per step and no work.
__global__ void __launch_bounds__(kThreads, 1) cluster_sync_kernel(int steps) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int s = 0; s < steps; ++s) cluster.sync();
}

cudaError_t launch_clusters(const void* fn, void** args, dim3 grid,
                            size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelExC(&cfg, fn, args);
}

}  // namespace

// The scratch volumes (B, N, D, lanes) float32 that a pass needs in
// ``part``: L_1 [and L_2] of a pass with several directions, and their
// cost where sub is set.
extern "C" int s2p_scan_mgm_part_volumes(int n_dirs, float sub) {
  return n_dirs > 1 ? n_dirs - 1 + (sub != 0.f ? 1 : 0) : 0;
}

// One pass: one launch of a cluster per (direction, tile), and for
// several directions one launch of their sum.  ``lats`` holds n_dirs x 3
// lateral offsets (each -1, 0 or +1), ``n_lats`` the count of each
// direction; ``part`` holds s2p_scan_mgm_part_volumes volumes.
// ``carry`` null runs the shared instantiation (the error
// cudaErrorInvalidValue if its layout does not fit shared memory);
// otherwise ``carry`` is (B, n_dirs, 2, D + 2, lanes) and ``mins``
// (B, n_dirs, 2, lanes) float32 scratch for the global instantiation.
extern "C" int s2p_scan_mgm(const void* s1, const void* s2,
                            const void* allowed, const void* p2,
                            const void* accum, void* S, void* votes,
                            void* carry, void* mins, void* part, int B, int N,
                            int D, int lanes, int len2, int horizontal,
                            int disp_min, int pad, int sec_len,
                            unsigned int mask, int n_dirs, const int* n_lats,
                            const int* lats, float p1, float invalid_cost,
                            float sub, int reverse, void* stream) {
  if (n_dirs < 1 || n_dirs > 3) return (int)cudaErrorInvalidValue;
  if (B <= 0 || N <= 0 || D <= 0 || lanes <= 0) return (int)cudaGetLastError();
  if ((long long)2 * (D + 2) * lanes > 0x7fffffffLL || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (s2p_scan_mgm_part_volumes(n_dirs, sub) > 0 && part == nullptr)
    return (int)cudaErrorInvalidValue;
  Pass p{(const uint32_t*)s1, (const uint32_t*)s2, (const int32_t*)allowed,
         (const float*)p2, (const float*)accum, (float*)S, (int*)votes,
         (float*)carry, (float*)mins, (float*)part, N, D, lanes, len2,
         disp_min, pad, sec_len, horizontal, reverse, mask, invalid_cost, p1,
         sub, n_dirs};
  for (int d = 0; d < 3; ++d) {
    p.n_lat[d] = d < n_dirs ? n_lats[d] : 0;
    if (d < n_dirs && (p.n_lat[d] < 1 || p.n_lat[d] > 3))
      return (int)cudaErrorInvalidValue;
    for (int i = 0; i < 3; ++i) {
      p.lat[d][i] = d < n_dirs ? lats[3 * d + i] : 0;
      if (i < p.n_lat[d] && (p.lat[d][i] < -1 || p.lat[d][i] > 1))
        return (int)cudaErrorInvalidValue;
    }
    p.inv_n[d] = p.n_lat[d] > 0 ? (float)(1.0 / p.n_lat[d]) : 0.f;
  }
  p.Wb = (lanes + kCluster - 1) / kCluster;
  const bool shared = carry == nullptr;
  if (!shared && mins == nullptr) return (int)cudaErrorInvalidValue;
  const Layout lay = layout(shared, D, p.Wb, horizontal);
  const size_t smem = (size_t)lay.total * 4;
  if (smem > (size_t)kMaxShared) return (int)cudaErrorInvalidValue;
  // the most laterals of a direction (at least 2: a missing lateral is
  // dead and adds +0) is a template argument
  int nl = 2;
  for (int d = 0; d < n_dirs; ++d) nl = p.n_lat[d] > nl ? p.n_lat[d] : nl;
  static const void* const kernels[2][2] = {
      {(const void*)scan_mgm_kernel<false, 2>,
       (const void*)scan_mgm_kernel<false, 3>},
      {(const void*)scan_mgm_kernel<true, 2>,
       (const void*)scan_mgm_kernel<true, 3>}};
  void* args[] = {&p};
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = launch_clusters(kernels[shared][nl - 2], args,
                                  dim3(kCluster, n_dirs, B), smem, st);
  if (e != cudaSuccess || n_dirs == 1) return (int)e;
  const long long vol = (long long)B * N * D * lanes;
  long long blocks = (vol + 255) / 256;
  if (blocks > 8192) blocks = 8192;
  mgm_sum_kernel<<<(unsigned)blocks, 256, 0, st>>>(
      (float*)S, (const float*)part, (const float*)accum, n_dirs - 1, sub,
      vol);
  return (int)cudaGetLastError();
}

// The bytes of shared memory the shared instantiation needs for a pass,
// which the wrapper uses to choose the instantiation.
extern "C" long long s2p_scan_mgm_shared_bytes(int D, int lanes,
                                               int horizontal) {
  return 4LL * layout(true, D, (lanes + kCluster - 1) / kCluster,
                      horizontal).total;
}

// ``steps`` cluster barriers in B clusters of K4b's shape, nothing else.
extern "C" int s2p_cluster_sync_loop(int B, int steps, void* stream) {
  void* args[] = {&steps};
  return (int)launch_clusters((const void*)cluster_sync_kernel, args,
                              dim3(kCluster, B, 1), 0, (cudaStream_t)stream);
}

extern "C" const char* s2p_scan_mgm_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
