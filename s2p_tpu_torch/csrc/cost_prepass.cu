// Census cost pre-pass of the mgm flow: the uint8 cost volume that feeds
// all four SGM scans of one side.
//
// Replaces s2p_tpu/ops/sgm_pallas.py _cost_prepass_kernel (:474, wrapper
// _cost_prepass :510).  For scan position n, candidate k and lane l:
//
//   cost[b, n, k, l] = popcount((s1t[n, l] ^ s2tp[n + dmin + pad + k, l]) & mask)
//
// and 255 where the candidate position n + dmin + k lies outside
// [0, sec_len), where its row n + dmin + pad + k lies outside [0, N2),
// where either signature's valid bit is clear, or where allowed[b, k] != 1;
// it is 0 wherever s1t carries the padding bit (the reference side's
// padding keeps the scan carry in its fresh-border state).
//
// Bound: bytes.  The output (B N D L bytes) is written once and dwarfs the
// signatures; each s2tp row serves D outputs per lane.  A block owns one
// tile b, kG consecutive scan positions, a strip of 32 V lanes and a
// chunk of kKC candidates (the chunks on the grid, so that even one tile
// gives every SM several blocks): a warp is one position, each thread V
// consecutive lanes (V = 4 where the lane count allows a 4-byte store,
// else 1).  A thread keeps its s1t words and their valid and pad bits in
// registers across the chunk's candidates and writes one V-byte word per
// candidate, so a warp stores 32 V contiguous bytes.  The secondary rows
// that the block's kG positions reach for its chunk, [n0 + dmin + pad +
// k0, ... + kG + kKC - 1), are staged in shared memory (rows outside
// [0, N2) are never read), so s2tp is read from L2 (kG + kKC - 1) / kKC
// times and not D times.  The lanes' four bytes are formed at once: the
// Hamming distances, the secondary's valid bits gathered into the bytes
// (__byte_perm) and the reference's per-lane pass and fail bytes, so a
// candidate's word takes one select by mask.  The candidate's range and
// `allowed` tests are per (n, k), one comparison each.  Offsets inside a
// tile are 32-bit, only a block divides (its tile and chunk), and the
// output row advances by a pointer step per candidate.  The TPU kernel's
// sublane windows have no counterpart to carry over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kValidBit = 24;
constexpr int kPadBit = 25;
constexpr int kG = 16;       // scan positions per block (one per warp)
constexpr int kKC = 32;      // candidates per staged chunk
constexpr int kRows = kG + kKC - 1;

template <int V> struct Vec;
template <> struct Vec<4> {
  using In = uint4;          // four signature words
  using Out = uint32_t;      // four cost bytes
};
template <> struct Vec<1> {
  using In = uint32_t;
  using Out = uint8_t;
};

__device__ __forceinline__ void words(const uint4& v, uint32_t (&w)[4]) {
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void words(const uint32_t& v, uint32_t (&w)[1]) {
  w[0] = v;
}

template <int V>
__global__ void __launch_bounds__(32 * kG)
cost_prepass_kernel(const uint32_t* __restrict__ s1t,
                    const uint32_t* __restrict__ s2tp,
                    const int32_t* __restrict__ allowed,
                    uint8_t* __restrict__ out, int B, int N, int N2, int L,
                    int D, int disp_min, int pad, int sec_len,
                    uint32_t mask) {
  using In = typename Vec<V>::In;
  using Out = typename Vec<V>::Out;
  constexpr int kLanes = 32 * V;                 // lanes of a strip
  __shared__ In win[kRows][32];                  // staged s2tp rows
  __shared__ int s_al[kKC];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 32 + tx;
  const int l0 = blockIdx.x * kLanes;            // the strip's first lane
  const int n0 = blockIdx.y * kG;
  const int n = n0 + ty;
  const int l = l0 + tx * V;
  const bool active = n < N && l < L;
  // the lanes of this strip (the last strip may be partial; L % V == 0)
  const int strip = L - l0 < kLanes ? L - l0 : kLanes;
  const int vecs = strip / V;
  // candidate k of position n is in range for k in [k_in0, k_in1): its
  // position n + dmin + k in [0, sec_len) and its row in [0, N2)
  const int lo = pad < 0 ? -pad : 0;
  const int hi = sec_len < N2 - pad ? sec_len : N2 - pad;
  const int k_in0 = lo - n - disp_min;
  const int k_in1 = hi - n - disp_min;
  const int row0 = n0 + disp_min + pad;          // the block's first row
  const int nch = (D + kKC - 1) / kKC;
  // blockIdx.z walks (tile, chunk) pairs, the grid's z capped at 65535
  for (int bc = blockIdx.z; bc < B * nch; bc += gridDim.z) {
    const int b = bc / nch;
    const int k0 = (bc - b * nch) * kKC;
    const int kc = D - k0 < kKC ? D - k0 : kKC;
    const uint32_t* const s2b = s2tp + (long long)b * N2 * L + l0;
    if (bc != (int)blockIdx.z) __syncthreads();  // the last chunk is read
    for (int e = tid; e < (kG + kc - 1) * 32; e += 32 * kG) {
      const int r = e >> 5, v = e & 31;
      const int row = row0 + k0 + r;
      if (v < vecs && row >= 0 && row < N2)
        win[r][v] = *reinterpret_cast<const In*>(s2b + (long long)row * L +
                                                 v * V);
    }
    if (tid < kc)
      s_al[tid] = allowed == nullptr ? 1 : allowed[b * D + k0 + tid];
    // this thread's reference words: the Hamming operand, and per lane
    // the value where a candidate is rejected (0 over padding, else 255)
    // and whether the lane can take a cost at all (valid, not padding)
    // (one byte per lane: 255 or 0, and 1 or 0)
    uint32_t a[V];
    uint32_t fail = 0, live = 0;
    if (active) {
      words(*reinterpret_cast<const In*>(s1t + ((long long)b * N + n) * L +
                                         l), a);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const bool p = (a[j] >> kPadBit) & 1u;
        const bool v = (a[j] >> kValidBit) & 1u;
        fail |= (p ? 0u : 255u) << (8 * j);
        live |= (!p && v ? 1u : 0u) << (8 * j);
        a[j] &= mask;
      }
    }
    __syncthreads();
    if (!active) continue;
    Out* o = reinterpret_cast<Out*>(out + (((long long)b * N + n) * D + k0) *
                                              L + l);
    for (int kk = 0; kk < kc; ++kk) {
      const int k = k0 + kk;
      const bool ok = k >= k_in0 && k < k_in1 && s_al[kk] == 1;
      Out c = (Out)fail;
      if (ok) {
        uint32_t s[V];
        words(win[ty + kk][tx], s);
        // the lanes' Hamming distances, one byte each
        uint32_t h = 0;
#pragma unroll
        for (int j = 0; j < V; ++j)
          h |= (uint32_t)__popc((a[j] ^ s[j]) & mask) << (8 * j);
        // the secondary's valid bits in the lanes' bytes: byte 3 of each
        // word gathered (bit 24 is the low bit of byte 3)
        uint32_t v;
        if constexpr (V == 4) {
          v = __byte_perm(__byte_perm(s[0], s[1], 0x0073),
                          __byte_perm(s[2], s[3], 0x7300), 0x7610);
        } else {
          v = s[0] >> kValidBit;
        }
        // 0xff in the bytes of the lanes that take a cost
        const uint32_t take = (v & live) * 0xffu;
        c = (Out)((h & take) | (fail & ~take));
      }
      *o = c;
      o += L / V;
    }
  }
}

}  // namespace

extern "C" int s2p_cost_prepass(const void* s1t, const void* s2tp,
                                const void* allowed, void* out, int B, int N,
                                int N2, int L, int D, int disp_min, int pad,
                                int sec_len, unsigned int mask,
                                void* stream) {
  if ((N + kG - 1) / kG > 65535) return (int)cudaErrorInvalidValue;
  if (B > 0 && N > 0 && L > 0 && D > 0) {
    const dim3 block(32, kG);
    const long long bc = (long long)B * ((D + kKC - 1) / kKC);
    const unsigned z = bc < 65535 ? (unsigned)bc : 65535u;
    const cudaStream_t st = (cudaStream_t)stream;
    // 4-byte words need every row of out and s1t 4-byte aligned: L % 4
    // (torch's allocations themselves are 256-byte aligned)
    if (L % 4 == 0 &&
        ((uintptr_t)s1t | (uintptr_t)s2tp | (uintptr_t)out) % 16 == 0) {
      const dim3 grid((L + 127) / 128, (N + kG - 1) / kG, z);
      cost_prepass_kernel<4><<<grid, block, 0, st>>>(
          (const uint32_t*)s1t, (const uint32_t*)s2tp,
          (const int32_t*)allowed, (uint8_t*)out, B, N, N2, L, D, disp_min,
          pad, sec_len, mask);
    } else {
      const dim3 grid((L + 31) / 32, (N + kG - 1) / kG, z);
      cost_prepass_kernel<1><<<grid, block, 0, st>>>(
          (const uint32_t*)s1t, (const uint32_t*)s2tp,
          (const int32_t*)allowed, (uint8_t*)out, B, N, N2, L, D, disp_min,
          pad, sec_len, mask);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* s2p_cost_prepass_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
