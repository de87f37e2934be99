// Census cost pre-pass of the mgm flow: the uint8 cost volume that feeds
// all four SGM scans of one side.
//
// Replaces s2p_tpu/ops/sgm_pallas.py _cost_prepass_kernel (:474, wrapper
// _cost_prepass :510).  For scan position n, candidate k and lane l:
//
//   cost[b, n, k, l] = popcount((s1t[n, l] ^ s2tp[n + dmin + pad + k, l]) & mask)
//
// and 255 where the candidate position n + dmin + k lies outside
// [0, sec_len), where either signature's valid bit is clear, or where
// allowed[b, k] != 1; it is 0 wherever s1t carries the padding bit (the
// reference side's padding keeps the scan carry in its fresh-border state).
//
// Bound: bytes.  Every output byte is written once and the signatures are
// read from L2 (each s2tp row serves D outputs).  One thread per output
// element: lanes on threadIdx (loads and byte stores coalesce), the
// candidate on blockIdx.y, the (tile, scan position) pair on blockIdx.z,
// so no thread divides a 64-bit index.  The TPU kernel's sublane windows
// have no counterpart to carry over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kValidBit = 24;
constexpr int kPadBit = 25;

__global__ void cost_prepass_kernel(const uint32_t* __restrict__ s1t,
                                    const uint32_t* __restrict__ s2tp,
                                    const int32_t* __restrict__ allowed,
                                    uint8_t* __restrict__ out,
                                    int B, int N, int N2, int L, int D,
                                    int disp_min, int pad, int sec_len,
                                    uint32_t mask) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (l >= L) return;
  for (int bn = blockIdx.z; bn < B * N; bn += gridDim.z) {
    const int b = bn / N;
    const int n = bn - b * N;
    const uint32_t a = s1t[(long long)bn * L + l];
    uint8_t c;
    if ((a >> kPadBit) & 1u) {
      c = 0;
    } else {
      const int ix = n + disp_min + k;
      const int row = ix + pad;
      bool ok = ix >= 0 && ix < sec_len && row >= 0 && row < N2 &&
                ((a >> kValidBit) & 1u);
      if (ok && allowed != nullptr) ok = allowed[b * D + k] == 1;
      if (ok) {
        const uint32_t s = s2tp[((long long)b * N2 + row) * L + l];
        ok = (s >> kValidBit) & 1u;
        c = ok ? (uint8_t)__popc((a ^ s) & mask) : (uint8_t)255;
      } else {
        c = 255;
      }
    }
    out[((long long)bn * D + k) * L + l] = c;
  }
}

}  // namespace

extern "C" int s2p_cost_prepass(const void* s1t, const void* s2tp,
                                const void* allowed, void* out, int B, int N,
                                int N2, int L, int D, int disp_min, int pad,
                                int sec_len, unsigned int mask,
                                void* stream) {
  if (D > 65535) return (int)cudaErrorInvalidValue;
  if (B > 0 && N > 0 && L > 0 && D > 0) {
    const int threads = 128;
    const int bn = B * N;
    dim3 grid((L + threads - 1) / threads, D, bn < 65535 ? bn : 65535);
    cost_prepass_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)s1t, (const uint32_t*)s2tp, (const int32_t*)allowed,
        (uint8_t*)out, B, N, N2, L, D, disp_min, pad, sec_len, mask);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* s2p_cost_prepass_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
