// Fused Binary-Reduce over CSR-by-destination, fp32, for sm_90a.
//
//   C[v, j] = sum_{k in row v} B[src[k], j] (op) E[eid[k], j]
//   op in {add, sub, mul, div, copy_lhs, copy_rhs}
//   mean:  C[v, :] /= max(deg_v, 1);   rows with no edge write 0.
//
// E is in the caller's edge order and is read through eid; an E of width
// 1 broadcasts over the d features. For copy_rhs (e_copy_*_v) B may be
// null: the node operand is never read.
//
// Replaces the TPU kernel src/repro/kernels/binary_reduce/kernel.py::
// _br_kernel, which walks TilePack buckets, gathers B with a one-hot
// matmul, reads E pre-permuted into tile order, zeroes the pad slots and
// scatters with a second one-hot matmul. Hopper needs none of that: one
// warp owns one destination row of the CSR, reads E through eid, and
// there are no pad slots. No atomics, so a sum is the same on every run.
//
// Bound on the H100: bytes. One op and one add per element against 4 to
// 8 bytes read per element. The least traffic is the CSR, B and E read
// once and C written once. The design:
//   * a row of width d is covered by a group of lpe lanes (the power of
//     two >= d, at most 32); the warp's 32 / lpe groups take different
//     edges of the row, so at d = 4 and 1 (GAT's softmax sums) a warp
//     works on 8 or 32 edges at once instead of idling 28 or 31 lanes;
//   * the warp loads 32 edges' (src, eid) with one coalesced read and
//     broadcasts them by shuffle; each lane keeps UNR edges' loads in
//     flight before it accumulates;
//   * the groups' partial sums are combined by a fixed shuffle tree.
// A hub row (in-degree 4,275 on reddit-like) is one warp's serial loop,
// as in spmm_csr.cu; splitting it is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum BinOp { kAdd = 0, kSub = 1, kMul = 2, kDiv = 3, kCopyLhs = 4,
             kCopyRhs = 5 };

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int UNR = 4;

template <int OP>
__device__ __forceinline__ float apply(float a, float b) {
  if constexpr (OP == kAdd) return a + b;
  if constexpr (OP == kSub) return a - b;
  if constexpr (OP == kMul) return a * b;
  if constexpr (OP == kDiv) return a / b;
  if constexpr (OP == kCopyLhs) return a;
  return b;  // kCopyRhs
}

template <int OP>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
binary_reduce_csr_kernel(const int* __restrict__ indptr,
                         const int* __restrict__ src,
                         const int* __restrict__ eid,
                         const float* __restrict__ B,
                         const float* __restrict__ E, float* __restrict__ C,
                         int n_dst, int d, int de, int lpe, int mean) {
  constexpr bool kReadB = OP != kCopyRhs;
  constexpr bool kReadE = OP != kCopyLhs;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_dst) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int ngrp = 32 / lpe;
  const int grp = lane / lpe;
  const int sub = lane - grp * lpe;
  const int beg = __ldg(indptr + row);
  const int end = __ldg(indptr + row + 1);
  const float deg = (float)max(end - beg, 1);
  float* crow = C + (int64_t)row * d;

  for (int c0 = 0; c0 < d; c0 += lpe) {
    const int c = c0 + sub;
    const bool col_ok = c < d;
    const int ce = de == 1 ? 0 : c;
    float acc = 0.0f;
    for (int e0 = beg; e0 < end; e0 += 32) {
      const int e = e0 + lane;
      int s = 0, id = 0;
      if (e < end) {
        if (kReadB) s = __ldg(src + e);
        if (kReadE) id = __ldg(eid + e);
      }
      const int cnt = min(32, end - e0);
      for (int jj = 0; jj < cnt; jj += ngrp * UNR) {
        float a[UNR], b[UNR];
        bool ok[UNR];
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          const int j = jj + u * ngrp + grp;
          const int sj = __shfl_sync(kFull, s, j & 31);
          const int ij = __shfl_sync(kFull, id, j & 31);
          ok[u] = j < cnt && col_ok;
          a[u] = (kReadB && ok[u]) ? __ldg(B + (int64_t)sj * d + c) : 0.0f;
          b[u] = (kReadE && ok[u]) ? __ldg(E + (int64_t)ij * de + ce) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < UNR; ++u)
          if (ok[u]) acc += apply<OP>(a[u], b[u]);
      }
    }
    // combine the edge groups of a narrow row (a fixed order)
    for (int off = lpe; off < 32; off <<= 1)
      acc += __shfl_xor_sync(kFull, acc, off);
    if (grp == 0 && col_ok) crow[c] = mean ? acc / deg : acc;
  }
}

template <int OP>
void launch(const int* indptr, const int* src, const int* eid, const float* B,
            const float* E, float* C, int n_dst, int d, int de, int mean,
            cudaStream_t stream) {
  int lpe = 1;
  while (lpe < d && lpe < 32) lpe <<= 1;
  const dim3 grid((unsigned)((n_dst + kWarpsPerBlock - 1) / kWarpsPerBlock));
  binary_reduce_csr_kernel<OP><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      indptr, src, eid, B, E, C, n_dst, d, de, lpe, mean);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unknown op, an E width other than d or 1,
// or a null B for an op that reads it. ``mean`` != 0 divides by
// max(deg, 1).
extern "C" int binary_reduce_csr_f32(const void* indptr, const void* src,
                                     const void* eid, const void* B,
                                     const void* E, void* C, int n_dst, int d,
                                     int de, int binop, int mean,
                                     void* stream) {
  if (binop < kAdd || binop > kCopyRhs || (de != d && de != 1) ||
      (B == nullptr && binop != kCopyRhs))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_dst > 0 && d > 0) {
    const int* ip = static_cast<const int*>(indptr);
    const int* sp = static_cast<const int*>(src);
    const int* ep = static_cast<const int*>(eid);
    const float* bp = static_cast<const float*>(B);
    const float* xp = static_cast<const float*>(E);
    float* cp = static_cast<float*>(C);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (binop) {
      case kAdd:
        launch<kAdd>(ip, sp, ep, bp, xp, cp, n_dst, d, de, mean, st);
        break;
      case kSub:
        launch<kSub>(ip, sp, ep, bp, xp, cp, n_dst, d, de, mean, st);
        break;
      case kMul:
        launch<kMul>(ip, sp, ep, bp, xp, cp, n_dst, d, de, mean, st);
        break;
      case kDiv:
        launch<kDiv>(ip, sp, ep, bp, xp, cp, n_dst, d, de, mean, st);
        break;
      case kCopyLhs:
        launch<kCopyLhs>(ip, sp, ep, bp, xp, cp, n_dst, d, de, mean, st);
        break;
      default:
        launch<kCopyRhs>(ip, sp, ep, bp, xp, cp, n_dst, d, de, mean, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
