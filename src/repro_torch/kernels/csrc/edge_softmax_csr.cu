// Edge softmax over the row-segment work list, fp32, for sm_90a.
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
// numbers. Here no stripe is packed: the kernel walks the CSR by
// destination over the row-segment work list (kernels/rowsplit.py), at
// K = 128 edges per segment (B1 and B2 take K = 256).
//
// Bound on the H100: bytes. A few flops per element against 8 bytes (x
// read once, out written once) plus the CSR. What the time goes to is
// each segment's chain of dependent steps (the segment, eid, x, the
// merge, the write); before the work list it was the hub row (in-degree
// 4,275 on reddit-like), one warp's serial loop of three passes. The
// design:
//   * launch 1: a segment gets LANES = max(Hl, 16) lanes, so at H <= 16 a
//     warp takes two consecutive segments of the longest-first list. Most
//     rows are short (mean in-degree 9.6), and half as many warps finish
//     sooner; with 16 lanes K = 128 keeps a full segment's chain as short
//     as 32 lanes at K = 256 (chip_smoke.py's sweep rows time both).
//     Lanes are (edge slot, head) pairs: a group of Hl lanes (the power of
//     two >= H, at most 32) covers the heads of one edge and the
//     segment's LANES / Hl groups take different edges. Each lane folds
//     its edges into an online (max, sum), the sum rescaled when the max
//     grows, UNR loads in flight ahead of the fold; the groups then
//     merge: a max butterfly, one rescale of each lane's sum, a sum
//     butterfly. So the logits are read once before the write, not twice.
//       - A whole-row segment (slot -1, nearly every row) then writes
//         alpha over its edges: from registers when the segment fits in
//         one batch of UNR edges per group (H = 4: 16 edges, H = 1: 64),
//         else by reading x again (L1 / L2 hits).
//       - A segment of a split row writes its (m, s) per head to its
//         partial slot.
//   * launch 2, one block per split row: the block folds the row's slots
//     in slot (= edge) order, m = max m_i, s = sum s_i e^(m_i - m), then
//     its threads write alpha over the row's edges, so a hub's write pass
//     is spread across the block's 32 warps.
// Every sum has a fixed order and there are no atomics: alpha is
// bit-identical from call to call.
// History: the first version gave each destination row one warp and made
// three serial passes over it (max, sum, write).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kCombineThreads = 1024;
constexpr int UNR = 4;
constexpr int kMaxHeads = 4096;  // launch 2 keeps (m, z) per head in smem
constexpr float kNeg = -1e30f;   // the TPU kernel's mask value and floor
constexpr float kTiny = 1e-38f;  // its floor on the sum

// fold logit v into the running (max m, sum s of exp(x - m))
__device__ __forceinline__ void fold(float& m, float& s, float v) {
  if (v > m) {
    s = s * expf(m - v) + 1.0f;
    m = v;
  } else {
    s += expf(v - m);
  }
}

// One group of LANES lanes per segment, 32 / LANES segments per warp.
template <int LANES>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
softmax_segment_kernel(const int4* __restrict__ seg, int n_seg,
                       const int* __restrict__ eid,
                       const float* __restrict__ x, float* __restrict__ out,
                       float* __restrict__ pml, int H, int hl) {
  constexpr int kSpw = 32 / LANES;  // segments per warp
  const int64_t s0 =
      ((int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * kSpw;
  if (s0 >= n_seg) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int64_t si = s0 + lane / LANES;
  // past the list's end: an empty whole-row segment, which writes nothing
  // but keeps its lanes in the warp's shuffles
  const int4 sg = si < n_seg ? __ldg(seg + si) : make_int4(0, 0, 0, -1);
  const int beg = sg.y;
  const int end = sg.z;
  const int ngrp = LANES / hl;
  const int grp = (lane % LANES) / hl;
  const int sub = lane % hl;

  // a segment of at most UNR edges per group is read once: its logits and
  // edge ids stay in registers for the write
  const bool one_batch = end - beg <= UNR * ngrp;
  for (int h0 = 0; h0 < H; h0 += hl) {
    const int h = h0 + sub;
    const bool h_ok = h < H;
    float m = kNeg;
    float s = 0.0f;
    float v[UNR];
    int ek[UNR];  // each batch edge's caller id, -1 for none
#pragma unroll
    for (int u = 0; u < UNR; ++u) ek[u] = -1;
    for (int k0 = beg + grp; k0 < end; k0 += UNR * ngrp) {
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int k = k0 + u * ngrp;
        ek[u] = h_ok && k < end ? __ldg(eid + k) : -1;
        v[u] = ek[u] >= 0 ? __ldg(x + (int64_t)ek[u] * H + h) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < UNR; ++u)
        if (ek[u] >= 0) fold(m, s, v[u]);
    }
    // merge the groups' pairs: the max, one rescale, then the sum. Each
    // butterfly gives every lane of a head the same bits (a + b == b + a)
    float mx = m;
#pragma unroll
    for (int off = LANES / 2; off >= 1; off >>= 1)
      if (off >= hl) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    s *= expf(m - mx);
#pragma unroll
    for (int off = LANES / 2; off >= 1; off >>= 1)
      if (off >= hl) s += __shfl_xor_sync(kFull, s, off);
    if (sg.w < 0) {
      const float z = fmaxf(s, kTiny);
      if (one_batch) {
#pragma unroll
        for (int u = 0; u < UNR; ++u)
          if (ek[u] >= 0) {
            out[(int64_t)ek[u] * H + h] = expf(v[u] - mx) / z;
          }
      } else {
#pragma unroll 4
        for (int k = beg + grp; k < end; k += ngrp) {
          if (h_ok) {
            const int64_t a = (int64_t)__ldg(eid + k) * H + h;
            out[a] = expf(__ldg(x + a) - mx) / z;
          }
        }
      }
    } else if (grp == 0 && h_ok) {
      float* ml = pml + 2 * ((int64_t)sg.w * H + h);
      ml[0] = mx;
      ml[1] = s;
    }
  }
}

// One block per split row: fold its slots in slot order, then write.
// Every segment of a split row has edges.
__global__ void __launch_bounds__(kCombineThreads)
softmax_combine_kernel(const int* __restrict__ split,
                       const int* __restrict__ indptr,
                       const int* __restrict__ eid,
                       const float* __restrict__ x,
                       const float* __restrict__ pml, float* __restrict__ out,
                       int H) {
  extern __shared__ float mz[];  // (m, z) per head
  const int row = __ldg(split + 3 * blockIdx.x);
  const int first = __ldg(split + 3 * blockIdx.x + 1);
  const int count = __ldg(split + 3 * blockIdx.x + 2);
  for (int h = threadIdx.x; h < H; h += kCombineThreads) {
    float m = kNeg;
    for (int i = 0; i < count; ++i)
      m = fmaxf(m, __ldg(pml + 2 * ((int64_t)(first + i) * H + h)));
    float s = 0.0f;
    for (int i = 0; i < count; ++i) {
      const float* p = pml + 2 * ((int64_t)(first + i) * H + h);
      s = fmaf(__ldg(p + 1), expf(__ldg(p) - m), s);
    }
    mz[2 * h] = m;
    mz[2 * h + 1] = fmaxf(s, kTiny);
  }
  __syncthreads();
  const int beg = __ldg(indptr + row);
  const int64_t n = (int64_t)(__ldg(indptr + row + 1) - beg) * H;
#pragma unroll 4
  for (int64_t t = threadIdx.x; t < n; t += kCombineThreads) {
    const int i = (int)(t / H);
    const int h = (int)(t - (int64_t)i * H);
    const int64_t at = (int64_t)__ldg(eid + beg + i) * H + h;
    out[at] = expf(__ldg(x + at) - mz[2 * h]) / mz[2 * h + 1];
  }
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue when H is not in 1 .. 4096 or ``lanes`` (lanes
// per segment: 16 or 32, at least Hl; 0 for the default, max(Hl, 16)) is
// not one of those. ``seg`` (n_seg x 4)
// and ``split`` (n_split x 3) are the work list of kernels/rowsplit.py;
// ``pml`` (n_partials x H x 2) is the workspace of the split rows'
// segments (null when n_split == 0).
extern "C" int edge_softmax_csr_f32(const void* seg, int n_seg,
                                    const void* split, int n_split,
                                    const void* indptr, const void* eid,
                                    const void* logits, void* out, void* pml,
                                    int H, int lanes, void* stream) {
  if (H < 1 || H > kMaxHeads) return static_cast<int>(cudaErrorInvalidValue);
  int hl = 1;
  while (hl < H && hl < 32) hl <<= 1;
  if (lanes == 0) lanes = hl > 16 ? hl : 16;
  if ((lanes != 16 && lanes != 32) || lanes < hl)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ei = static_cast<const int*>(eid);
  const float* xp = static_cast<const float*>(logits);
  float* op = static_cast<float*>(out);
  float* mp = static_cast<float*>(pml);
  if (n_seg > 0) {
    const int spw = 32 / lanes;
    const int64_t warps = (n_seg + spw - 1) / spw;
    const dim3 grid((unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
    const int4* sg = static_cast<const int4*>(seg);
    if (lanes == 16) {
      softmax_segment_kernel<16><<<grid, kWarpsPerBlock * 32, 0, st>>>(
          sg, n_seg, ei, xp, op, mp, H, hl);
    } else {
      softmax_segment_kernel<32><<<grid, kWarpsPerBlock * 32, 0, st>>>(
          sg, n_seg, ei, xp, op, mp, H, hl);
    }
  }
  if (n_split > 0) {
    softmax_combine_kernel<<<(unsigned)n_split, kCombineThreads,
                             2 * H * sizeof(float), st>>>(
        static_cast<const int*>(split), static_cast<const int*>(indptr), ei,
        xp, mp, op, H);
  }
  return static_cast<int>(cudaGetLastError());
}
