// Edge softmax over CSR-by-destination, fp32, for sm_90a.
//
//   m_vh       = max(-1e30, max_{k in row v} x[eid[k], h])
//   s_vh       = sum_{k in row v} exp(x[eid[k], h] - m_vh)
//   out[eid[k], h] = exp(x[eid[k], h] - m_vh) / max(s_vh, 1e-38)
//
// x and out are (n_edges, H) in the caller's edge order; a row with no
// edge owns no output element and writes nothing.
//
// Replaces the TPU kernel src/repro/kernels/edge_softmax/kernel.py::
// _softmax_kernel, which needs every destination row packed whole into a
// padded ELL stripe (gathered from caller order, pad slots masked with
// -1e30, scattered back by XLA). The -1e30 floor on the max and the
// 1e-38 floor on the sum are that kernel's, so both give the same
// numbers. Here one warp owns one destination row and walks its CSR edges
// directly: no stripe, no padding, no mask.
//
// Bound on the H100: bytes. A few flops per element against 8 bytes (x
// read once, out written once) plus the CSR. The design:
//   * lanes are (edge slot, head) pairs: a group of Hl lanes (the power of
//     two >= H, at most 32) covers the heads of one edge and the warp's
//     32 / Hl groups take different edges, so at H = 4 and 1 a warp works
//     on 8 or 32 edges at once;
//   * three passes over the row (max, sum, write), each combined across
//     groups by a shuffle tree and unrolled 4 deep so a lane keeps several
//     gathers in flight; the second and third reads of x hit L1/L2;
//   * reads and writes go through eid: a gather and a scatter, coalesced
//     only where caller order follows canonical order. Timed as it is.
// A hub row (in-degree 4,275 on reddit-like) is one warp's serial loop.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
edge_softmax_csr_kernel(const int* __restrict__ indptr,
                        const int* __restrict__ eid,
                        const float* __restrict__ x, float* __restrict__ out,
                        int n_dst, int H, int hl) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_dst) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int ngrp = 32 / hl;
  const int grp = lane / hl;
  const int sub = lane - grp * hl;
  const int beg = __ldg(indptr + row);
  const int end = __ldg(indptr + row + 1);
  if (beg == end) return;  // warp-uniform: nothing to write

  for (int h0 = 0; h0 < H; h0 += hl) {
    const int h = h0 + sub;
    const bool h_ok = h < H;
    float m = -1e30f;
#pragma unroll 4
    for (int k = beg + grp; k < end; k += ngrp)
      if (h_ok) m = fmaxf(m, __ldg(x + (int64_t)__ldg(eid + k) * H + h));
    for (int off = hl; off < 32; off <<= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));

    float s = 0.0f;
#pragma unroll 4
    for (int k = beg + grp; k < end; k += ngrp)
      if (h_ok) s += expf(__ldg(x + (int64_t)__ldg(eid + k) * H + h) - m);
    for (int off = hl; off < 32; off <<= 1)
      s += __shfl_xor_sync(kFull, s, off);
    const float z = fmaxf(s, 1e-38f);

#pragma unroll 4
    for (int k = beg + grp; k < end; k += ngrp) {
      if (h_ok) {
        const int64_t at = (int64_t)__ldg(eid + k) * H + h;
        out[at] = expf(__ldg(x + at) - m) / z;
      }
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int edge_softmax_csr_f32(const void* indptr, const void* eid,
                                    const void* logits, void* out, int n_dst,
                                    int H, void* stream) {
  if (n_dst > 0 && H > 0) {
    int hl = 1;
    while (hl < H && hl < 32) hl <<= 1;
    const dim3 grid((unsigned)((n_dst + kWarpsPerBlock - 1) / kWarpsPerBlock));
    edge_softmax_csr_kernel<<<grid, kWarpsPerBlock * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(eid),
        static_cast<const float*>(logits), static_cast<float*>(out), n_dst, H,
        hl);
  }
  return static_cast<int>(cudaGetLastError());
}
