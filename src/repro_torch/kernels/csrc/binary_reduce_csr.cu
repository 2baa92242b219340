// Fused Binary-Reduce over the row-segment work list, fp32 or bf16, for
// sm_90a.
//
//   C[v, j] = sum_{k in row v} B[src[k], j] (op) E[eid[k], j]
//   op in {add, sub, mul, div, copy_lhs, copy_rhs}
//   mean:  C[v, :] /= max(deg_v, 1);   rows with no edge write 0.
//
// E is in the caller's edge order and is read through eid. Its width de
// divides d: feature j reads E[eid[k], j / (d / de)], so an E of width d
// is read element for element, one of width 1 broadcasts over the d
// features, and one of width H holds a value per head, spread over that
// head's d / H consecutive features (GAT's per-head alpha times its
// (n, H, F) features, flattened to d = H * F). For copy_rhs (e_copy_*_v) B
// may be null: the node operand is never read.
//
// Replaces the TPU kernel src/repro/kernels/binary_reduce/kernel.py::
// _br_kernel, which walks TilePack buckets, gathers B with a one-hot
// matmul, reads E pre-permuted into tile order, zeroes the pad slots and
// scatters with a second one-hot matmul. Hopper needs none of that: the
// kernel walks the CSR by destination over the row-segment work list
// (kernels/rowsplit.py) at K = 128 edges per segment, B5's list, reads E
// through eid, and there are no pad slots.
//
// Bound on the H100: bytes. One op and one add per element against 4 to
// 8 bytes read per element; E in caller order costs one 32-byte sector
// per edge even at d = 1, since a row's edges are scattered in it. What
// the time goes to is each segment's chain of dependent loads (the
// segment, its (src, eid), E[eid]) over ~67k segments, most of them
// short (mean in-degree 9.6). Before the work list it was the hub row
// (in-degree 4,275 on reddit-like), one warp's serial loop of 134 chunks.
// The design:
//   * launch 1: a segment gets `lanes` lanes, 16 or 32 (max(lpe, 16) by
//     default), so at d <= 16 a warp takes two consecutive segments of the
//     longest-first list. A row of width d is covered by a group of LPE
//     lanes (a template: the power of two >= d, at most 32; a column loop
//     covers d > 32), and the segment's lanes / LPE groups take its edges
//     in a fixed stride: group g those at positions = g mod (lanes / LPE),
//     in ascending order.
//   * the segment's lanes load a tile of R x lanes edges' (src, eid) with
//     R coalesced reads and broadcast them by shuffle. R is picked so that
//     a group holds max(LPE, UNR) edges of the tile, UNR = 4 loads of B
//     and E in flight before it accumulates: at d = 1 and 4 a short
//     segment (most of them) is one tile. UNR = 8 took 10-22% longer (more
//     registers and guarded code for edges short segments lack), and a cap
//     of 32 registers spilled (PERF.md §6). The warp's two segments
//     walk the longer one's trip count, so every shuffle has the whole
//     warp.
//   * the groups' sums are combined by a fixed __shfl_xor tree. A segment
//     that is the whole row (slot < 0; on reddit-like at K = 128 all but
//     697 rows) writes C, divided by its degree for mean; a split row's
//     segment writes its raw sum to partial slot `slot`.
//   * a split row is folded in the same launch, by whichever of its
//     segments finishes last: each writes its slot, fences, and adds one
//     to the row's counter (atomicAdd); the one that sees count - 1 sums
//     the row's slots in slot (= edge) order, divides by the row's full
//     degree for mean, writes C and resets the counter to 0. A second
//     launch for the fold cost ~0.002 ms more (PERF.md §6).
// No value is summed by an atomic and every sum has a fixed order: C is
// bit-identical from call to call.
// A per-head E: a lane's column c, and so its edge column c / (d / de), is
// fixed for a pass of the column loop, so the edge column is found once a
// pass, outside the edge loop, and widths d and 1 keep their loop as it
// was. At d = 64, H = 8 (F = 8) a warp's 32 lanes cover four heads in a
// pass: its E loads for one edge are four floats of one 32-byte sector,
// the two passes read the same sector, and one E value serves F lanes.
// Element types: B, E and C are all fp32 (binary_reduce_csr_f32) or all
// bf16 (binary_reduce_csr_bf16; for copy_rhs E and C). A bf16 value is
// widened exactly, the op and the sum run in fp32 (the split rows'
// partials too), and C is rounded to bf16 once, at the store
// (__float2bfloat16_rn): the Pallas kernel loads its operands' dtype,
// accumulates in fp32 (repro/kernels/binary_reduce/kernel.py:44) and
// writes B's dtype (:54). A bf16 training step hands B4 bf16 edge values
// (GAT's copy_rhs sums over G and its transpose); a sampled R-GCN block's
// messages carry its fp32 mean weights, so they reach copy_rhs in fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// loads widen to fp32 exactly; a bf16 store rounds to nearest even, once
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const bf16* p) {
  return __uint_as_float(
      (unsigned int)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *reinterpret_cast<unsigned short*>(p) =
      __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

enum BinOp { kAdd = 0, kSub = 1, kMul = 2, kDiv = 3, kCopyLhs = 4,
             kCopyRhs = 5 };

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int UNR = 4;  // loads of B and E a lane keeps in flight

template <int OP>
__device__ __forceinline__ float apply(float a, float b) {
  if constexpr (OP == kAdd) return a + b;
  if constexpr (OP == kSub) return a - b;
  if constexpr (OP == kMul) return a * b;
  if constexpr (OP == kDiv) return a / b;
  if constexpr (OP == kCopyLhs) return a;
  return b;  // kCopyRhs
}

// One group of `lanes` lanes (16 or 32) per segment, 32 / lanes segments
// per warp; a row is covered by groups of LPE lanes.
template <typename T, int OP, int LPE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
br_segment_kernel(const int4* __restrict__ seg, int n_seg,
                  const int* __restrict__ src, const int* __restrict__ eid,
                  const T* __restrict__ B, const T* __restrict__ E,
                  T* __restrict__ C, float* __restrict__ partial,
                  const int* __restrict__ indptr, int* __restrict__ cnt,
                  int K, int d, int de, int lanes, int mean) {
  constexpr bool kReadB = OP != kCopyRhs;
  constexpr bool kReadE = OP != kCopyLhs;
  // a tile is R x lanes edges, R (src, eid) registers a lane; a group takes
  // R x LPE = max(LPE, UNR) of them
  constexpr int R = UNR > LPE ? UNR / LPE : 1;
  constexpr int kPer = R * LPE;  // a group's edges in a tile
  // lanes is 16 or 32: shifts and masks, not integer divisions
  const int lsh = lanes == 16 ? 4 : 5;
  const int64_t s0 = ((int64_t)blockIdx.x * kWarpsPerBlock +
                      (threadIdx.x >> 5)) << (5 - lsh);
  if (s0 >= n_seg) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int ln = lane & (lanes - 1);
  const int64_t si = s0 + (lane >> lsh);
  // past the list's end: an empty segment that writes nothing but keeps
  // its lanes in the warp's shuffles
  const bool valid = si < n_seg;
  const int4 sg = valid ? __ldg(seg + si) : make_int4(0, 0, 0, -1);
  const int beg = sg.y;
  const int len = sg.z - sg.y;
  int wlen = len;  // the warp's longest segment sets its trip counts
  for (int off = lanes; off < 32; off <<= 1)
    wlen = max(wlen, __shfl_xor_sync(kFull, wlen, off));
  const int ngrp = lanes / LPE;  // LPE is a power of two: a shift
  const int grp = ln / LPE;
  const int sub = ln - grp * LPE;
  const int tile = R * lanes;
  // a whole row writes C, divided by its degree for mean; a segment of a
  // split row writes its raw fp32 sum
  const bool whole = sg.w < 0;
  T* crow = C + (int64_t)sg.x * d;
  float* prow = partial + (int64_t)(whole ? 0 : sg.w) * d;
  float deg = 1.0f;
  if (whole && mean) deg = (float)max(len, 1);

  for (int c0 = 0; c0 < d; c0 += LPE) {
    const int c = c0 + sub;
    const bool col_ok = c < d;
    const int ce = de == 1 ? 0 : de == d ? c : c / (d / de);
    float acc = 0.0f;
    for (int t0 = 0; t0 < wlen; t0 += tile) {
      int s[R], id[R];
#pragma unroll
      for (int t = 0; t < R; ++t) {
        const int k = t0 + t * lanes + ln;
        s[t] = 0;
        id[t] = 0;
        if (t * lanes < wlen - t0 && k < len) {  // the first, warp-uniform
          if (kReadB) s[t] = __ldg(src + beg + k);
          if (kReadE) id[t] = __ldg(eid + beg + k);
        }
      }
      // the group's i-th edge of the tile sits at position grp + ngrp * i,
      // in register i / LPE of lane grp + ngrp * (i % LPE): the group
      // takes the positions = grp mod ngrp, in ascending order
#pragma unroll
      for (int i0 = 0; i0 < kPer; i0 += UNR) {
        float a[UNR], b[UNR];
        bool ok[UNR];
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          const int i = i0 + u;
          ok[u] = false;
          a[u] = 0.0f;
          b[u] = 0.0f;
          if (ngrp * i < wlen - t0) {  // warp-uniform
            const int q = grp + ngrp * (i % LPE);
            const int sj = kReadB ? __shfl_sync(kFull, s[i / LPE], q, lanes)
                                  : 0;
            const int ij = kReadE ? __shfl_sync(kFull, id[i / LPE], q, lanes)
                                  : 0;
            ok[u] = t0 + grp + ngrp * i < len && col_ok;
            if (kReadB && ok[u]) a[u] = ld(B + (int64_t)sj * d + c);
            if (kReadE && ok[u]) b[u] = ld(E + (int64_t)ij * de + ce);
          }
        }
#pragma unroll
        for (int u = 0; u < UNR; ++u)
          if (ok[u]) acc += apply<OP>(a[u], b[u]);
      }
    }
    // combine the segment's edge groups (a fixed order)
    for (int off = LPE; off < lanes; off <<= 1)
      acc += __shfl_xor_sync(kFull, acc, off);
    if (valid && grp == 0 && col_ok) {
      if (whole) {
        st(crow + c, mean ? acc / deg : acc);
      } else {
        prow[c] = acc;
      }
    }
  }
  // the segment of a split row that finishes last folds the row's slots
  // in slot order; cnt[row] counts the row's finished segments
  const bool split_seg = valid && sg.w >= 0;
  int last = 0;
  if (split_seg) __threadfence();
  __syncwarp();
  if (split_seg && ln == 0) {
    const int rb = __ldg(indptr + sg.x);
    const int count = (__ldg(indptr + sg.x + 1) - rb + K - 1) / K;
    last = atomicAdd(cnt + sg.x, 1) == count - 1;
  }
  last = __shfl_sync(kFull, last, 0, lanes);
  if (!last) return;
  __threadfence();
  const int rb = __ldg(indptr + sg.x);
  const int rdeg = __ldg(indptr + sg.x + 1) - rb;
  const int count = (rdeg + K - 1) / K;
  const int first = sg.w - (beg - rb) / K;
  for (int c = ln; c < d; c += lanes) {
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < count; ++k)
      acc += __ldcg(partial + (int64_t)(first + k) * d + c);
    st(crow + c, mean ? acc / (float)max(rdeg, 1) : acc);
  }
  if (ln == 0) cnt[sg.x] = 0;  // ready for the next call
}

template <typename T, int OP>
void launch_segments(int lpe, int lanes, const int4* seg, int n_seg,
                     const int* src, const int* eid, const T* B, const T* E,
                     T* C, float* partial, const int* indptr, int* cnt,
                     int K, int d, int de, int mean, cudaStream_t stream) {
  const int64_t warps = (n_seg + 32 / lanes - 1) / (32 / lanes);
  const dim3 grid((unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
#define BR_LPE(LPE)                                                       \
  br_segment_kernel<T, OP, LPE><<<grid, kWarpsPerBlock * 32, 0, stream>>>( \
      seg, n_seg, src, eid, B, E, C, partial, indptr, cnt, K, d, de, lanes, \
      mean)
  switch (lpe) {
    case 1: BR_LPE(1); break;
    case 2: BR_LPE(2); break;
    case 4: BR_LPE(4); break;
    case 8: BR_LPE(8); break;
    case 16: BR_LPE(16); break;
    default: BR_LPE(32);
  }
#undef BR_LPE
}

template <typename T>
int run(const void* seg, int n_seg, int n_split, const void* indptr,
        const void* src, const void* eid, const void* B, const void* E,
        void* C, void* partial, void* counters, int K, int d, int de,
        int binop, int mean, int lanes, void* stream) {
  int lpe = 1;
  while (lpe < d && lpe < 32) lpe <<= 1;
  if (lanes == 0) lanes = lpe > 16 ? lpe : 16;
  if (binop < kAdd || binop > kCopyRhs || de < 1 || d % de != 0 ||
      (B == nullptr && binop != kCopyRhs) ||
      (lanes != 16 && lanes != 32) || lanes < lpe ||
      (n_split > 0 && (partial == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_seg > 0 && d > 0) {
    const int4* sg = static_cast<const int4*>(seg);
    const int* sp = static_cast<const int*>(src);
    const int* ep = static_cast<const int*>(eid);
    const T* bp = static_cast<const T*>(B);
    const T* xp = static_cast<const T*>(E);
    T* cp = static_cast<T*>(C);
    float* pp = static_cast<float*>(partial);
    const int* ip = static_cast<const int*>(indptr);
    int* cn = static_cast<int*>(counters);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BR_SEGMENTS(OP)                                                   \
  launch_segments<T, OP>(lpe, lanes, sg, n_seg, sp, ep, bp, xp, cp, pp, ip, \
                         cn, K, d, de, mean, st)
    switch (binop) {
      case kAdd: BR_SEGMENTS(kAdd); break;
      case kSub: BR_SEGMENTS(kSub); break;
      case kMul: BR_SEGMENTS(kMul); break;
      case kDiv: BR_SEGMENTS(kDiv); break;
      case kCopyLhs: BR_SEGMENTS(kCopyLhs); break;
      default: BR_SEGMENTS(kCopyRhs);
    }
#undef BR_SEGMENTS
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unknown op, an E width that does not divide
// d, a null B for an op that reads it, ``lanes`` (lanes per segment: 16 or
// 32, at least lpe; 0 for the default, max(lpe, 16)) not one of those, or
// split rows without a workspace. ``seg`` (n_seg x 4) is the work list of
// kernels/rowsplit.py at cap K, with n_split split rows; ``partial``
// (n_partials x d, fp32) holds their segments' sums and ``counters`` (n_dst
// ints, all 0) their finished segments, which the fold resets to 0.
// ``mean`` != 0 divides by max(deg, 1). B, E and C are fp32.
extern "C" int binary_reduce_csr_f32(const void* seg, int n_seg, int n_split,
                                     const void* indptr, const void* src,
                                     const void* eid, const void* B,
                                     const void* E, void* C, void* partial,
                                     void* counters, int K, int d, int de,
                                     int binop, int mean, int lanes,
                                     void* stream) {
  return run<float>(seg, n_seg, n_split, indptr, src, eid, B, E, C, partial,
                    counters, K, d, de, binop, mean, lanes, stream);
}

// The same with B, E and C in bf16; the workspace and the sums stay fp32.
extern "C" int binary_reduce_csr_bf16(const void* seg, int n_seg,
                                      int n_split, const void* indptr,
                                      const void* src, const void* eid,
                                      const void* B, const void* E, void* C,
                                      void* partial, void* counters, int K,
                                      int d, int de, int binop, int mean,
                                      int lanes, void* stream) {
  return run<bf16>(seg, n_seg, n_split, indptr, src, eid, B, E, C, partial,
                   counters, K, d, de, binop, mean, lanes, stream);
}
