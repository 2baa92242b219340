// Copy-Reduce SpMM over CSR-by-destination, fp32, for sm_90a.
//
//   C[v, :] = sum_{e in row v} w_e * B[src_e, :]        (w_e = 1 unweighted)
//   mean:  C[v, :] /= max(deg_v, 1);   rows with no edge write 0.
//
// Replaces the TPU kernel src/repro/kernels/spmm/kernel.py::_spmm_kernel,
// which walks TilePack buckets and turns each bucket's gather and scatter
// into one-hot matmuls on the MXU. Hopper has no reason to densify: this
// kernel walks the graph's CSR (indptr_dst, canonical src) directly.
//
// Bound on the H100: bytes. Each edge moves d * 4 bytes of B for 2 * d
// flops (0.5 flop/byte), far below the card's ~20 flop/byte fp32 ridge,
// so tensor cores and TMA tiles do not apply. What the card needs is many
// independent gathers in flight on all 132 SMs, with no warp left to run
// a heavy row alone. The design:
//   * a work list (kernels/rowsplit.py) cuts every row into segments of at
//     most K edges, listed longest first; one warp owns one segment. A row
//     of in-degree <= K is one segment and writes C directly (no atomics).
//     A heavier row's segments write fp32 partial rows to a workspace the
//     wrapper allocates, and a second launch sums each such row's partials
//     in segment (= edge) order and scales a mean by the row's FULL degree.
//     Every sum has a fixed order, so results are bit-identical from call
//     to call.
//   * K = 256 (SEGMENT_EDGES, kernels/rowsplit.py): the in-degree-4,275
//     hub of reddit-like becomes 17 segments, the longest warp walks 256
//     edges instead of 4,275, and only 140 rows (496 partial slots, 1.2 MB
//     at d = 602) need the combine; rows up to 256 edges, 99.8% of them,
//     stay on the one-launch path. Measured on the H100 over K = 64 …
//     1024 (benchmarks/torch_rowsplit_sweep.py, PERF.md): 256 is the
//     fastest or within noise of it at every main-path shape of B1 and
//     B2; smaller K adds segments, larger K brings the hub's tail back.
//   * the warp loads 32 edges' (src, weight) with one coalesced read and
//     broadcasts them by shuffle;
//   * lanes split the feature axis in VEC-wide vectors (float4/float2 when
//     d and the base pointers allow, else scalar); a narrow row (d / VEC <
//     32) is covered by a group of LPE lanes and the warp's 32 / LPE groups
//     take different edges, combined by a fixed shuffle tree at the end;
//   * each lane holds NCH column chunks, picked from d so that one pass
//     over the segment's edges covers the whole row up to d = 16 * 32 *
//     VEC (d = 602 walks its edges once, with 10 of 12 chunk slots live),
//     and keeps UNR edges of loads in flight before it accumulates: few
//     on a narrow row, whose warps are latency-bound and gain more from
//     the occupancy that fewer registers allow.
// History: until the work list, one warp owned one whole row, and the hub
// row's serial loop (2 x 4,275 / 2 steps at d = 602) set the kernel's time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kCombineThreads = 256;

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// One warp per segment (row, [beg, end), slot) of the work list.
template <int VEC, int NCH>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_segment_kernel(const int4* __restrict__ seg, int n_seg,
                    const int* __restrict__ src,
                    const float* __restrict__ weight,
                    const float* __restrict__ B, float* __restrict__ C,
                    float* __restrict__ partial, int d, int lpe, int mean) {
  // edges of loads in flight per lane: 16 floats' worth on a narrow row
  // (few registers, so more warps per SM hide the short rows' latency),
  // two edges up to 64 floats, one beyond
  constexpr int W = NCH * VEC;
  constexpr int UNR = W > 32 ? 1 : (W >= 8 ? 2 : 16 / W);
  const int w = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n_seg) return;  // warp-uniform
  const int4 sg = __ldg(seg + w);
  const int beg = sg.y;
  const int end = sg.z;
  const int lane = threadIdx.x & 31;
  const int ngrp = 32 / lpe;
  const int grp = lane / lpe;
  const int sub = lane - grp * lpe;
  const int dv = d / VEC;
  // a whole row (slot < 0) writes C, scaled by its degree end - beg; a
  // segment of a split row writes its raw partial sum
  float scale = 1.0f;
  float* orow;
  if (sg.w < 0) {
    orow = C + (int64_t)sg.x * d;
    if (mean) scale = 1.0f / (float)max(end - beg, 1);
  } else {
    orow = partial + (int64_t)sg.w * d;
  }

  for (int c0 = 0; c0 < dv; c0 += NCH * lpe) {
    float acc[NCH][VEC];
#pragma unroll
    for (int k = 0; k < NCH; ++k)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[k][i] = 0.0f;

    for (int e0 = beg; e0 < end; e0 += 32) {
      const int e = e0 + lane;
      int s = 0;
      float wt = 0.0f;
      if (e < end) {
        s = __ldg(src + e);
        wt = weight != nullptr ? __ldg(weight + e) : 1.0f;
      }
      const int cnt = min(32, end - e0);
      for (int jj = 0; jj < cnt; jj += ngrp * UNR) {
        int sj[UNR];
        float wj[UNR];
        bool okj[UNR];
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          const int j = jj + u * ngrp + grp;
          sj[u] = __shfl_sync(kFull, s, j & 31);
          wj[u] = __shfl_sync(kFull, wt, j & 31);
          okj[u] = j < cnt;
        }
        float vals[UNR][NCH][VEC];
#pragma unroll
        for (int u = 0; u < UNR; ++u)
#pragma unroll
          for (int k = 0; k < NCH; ++k) {
            const int cv = c0 + k * lpe + sub;
            if (okj[u] && cv < dv) {
              load_vec<VEC>(B + (int64_t)sj[u] * d + (int64_t)cv * VEC,
                            vals[u][k]);
            } else {
#pragma unroll
              for (int i = 0; i < VEC; ++i) vals[u][k][i] = 0.0f;
            }
          }
#pragma unroll
        for (int u = 0; u < UNR; ++u)
#pragma unroll
          for (int k = 0; k < NCH; ++k)
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              acc[k][i] = fmaf(wj[u], vals[u][k][i], acc[k][i]);
      }
    }

    // combine the edge groups of a narrow row
    for (int off = lpe; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < NCH; ++k)
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[k][i] += __shfl_xor_sync(kFull, acc[k][i], off);
    }
    if (grp == 0) {
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        const int cv = c0 + k * lpe + sub;
        if (cv < dv) {
          float out[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) out[i] = acc[k][i] * scale;
          store_vec<VEC>(orow + (int64_t)cv * VEC, out);
        }
      }
    }
  }
}

// One thread per (split row, VEC-wide column): the row's partial sums in
// slot order, times the mean scale of the row's full degree.
template <int VEC>
__global__ void __launch_bounds__(kCombineThreads)
spmm_combine_kernel(const int* __restrict__ split, int n_split,
                    const int* __restrict__ indptr,
                    const float* __restrict__ partial, float* __restrict__ C,
                    int d, int mean) {
  const int dv = d / VEC;
  const int64_t t = (int64_t)blockIdx.x * kCombineThreads + threadIdx.x;
  if (t >= (int64_t)n_split * dv) return;
  const int r = (int)(t / dv);
  const int cv = (int)(t - (int64_t)r * dv);
  const int row = __ldg(split + 3 * r);
  const int first = __ldg(split + 3 * r + 1);
  const int count = __ldg(split + 3 * r + 2);
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  for (int k = 0; k < count; ++k) {
    float v[VEC];
    load_vec<VEC>(partial + (int64_t)(first + k) * d + (int64_t)cv * VEC, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] += v[i];
  }
  float scale = 1.0f;
  if (mean) {
    const int deg = __ldg(indptr + row + 1) - __ldg(indptr + row);
    scale = 1.0f / (float)max(deg, 1);
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] *= scale;
  store_vec<VEC>(C + (int64_t)row * d + (int64_t)cv * VEC, acc);
}

template <int VEC>
void launch_vec(const int4* seg, int n_seg, const int* split, int n_split,
                const int* indptr, const int* src, const float* weight,
                const float* B, float* C, float* partial, int d, int mean,
                cudaStream_t stream) {
  const int dv = d / VEC;
  int lpe = 1;
  while (lpe < dv && lpe < 32) lpe <<= 1;
  const int chunks = (dv + lpe - 1) / lpe;
  const dim3 grid((unsigned)((n_seg + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(kWarpsPerBlock * 32);
#define SPMM_SEGMENTS(NCH)                                                  \
  spmm_segment_kernel<VEC, NCH><<<grid, block, 0, stream>>>(                \
      seg, n_seg, src, weight, B, C, partial, d, lpe, mean)
  if (chunks > 12) {
    SPMM_SEGMENTS(16);
  } else if (chunks > 8) {
    SPMM_SEGMENTS(12);
  } else if (chunks > 4) {
    SPMM_SEGMENTS(8);
  } else if (chunks > 2) {
    SPMM_SEGMENTS(4);
  } else if (chunks == 2) {
    SPMM_SEGMENTS(2);
  } else {
    SPMM_SEGMENTS(1);
  }
#undef SPMM_SEGMENTS
  if (n_split > 0) {
    const int64_t threads = (int64_t)n_split * dv;
    spmm_combine_kernel<VEC>
        <<<(unsigned)((threads + kCombineThreads - 1) / kCombineThreads),
           kCombineThreads, 0, stream>>>(split, n_split, indptr, partial, C,
                                         d, mean);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 on success). ``seg``
// (n_seg x 4) and ``split`` (n_split x 3) are the work list of
// kernels/rowsplit.py; ``partial`` holds one d-wide fp32 row per partial
// slot (null when n_split == 0). ``weight`` may be null (unweighted);
// ``mean`` != 0 divides by max(deg, 1).
extern "C" int spmm_csr_f32(const void* seg, int n_seg, const void* split,
                            int n_split, const void* indptr, const void* src,
                            const void* weight, const void* B, void* C,
                            void* partial, int d, int mean, void* stream) {
  if (n_seg > 0 && d > 0) {
    const int4* sg = static_cast<const int4*>(seg);
    const int* sp = static_cast<const int*>(split);
    const int* ip = static_cast<const int*>(indptr);
    const int* srcp = static_cast<const int*>(src);
    const float* wp = static_cast<const float*>(weight);
    const float* bp = static_cast<const float*>(B);
    float* cp = static_cast<float*>(C);
    float* pp = static_cast<float*>(partial);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (d % 4 == 0 && aligned(bp, 16) && aligned(cp, 16) &&
        aligned(pp, 16)) {
      launch_vec<4>(sg, n_seg, sp, n_split, ip, srcp, wp, bp, cp, pp, d, mean,
                    st);
    } else if (d % 2 == 0 && aligned(bp, 8) && aligned(cp, 8) &&
               aligned(pp, 8)) {
      launch_vec<2>(sg, n_seg, sp, n_split, ip, srcp, wp, bp, cp, pp, d, mean,
                    st);
    } else {
      launch_vec<1>(sg, n_seg, sp, n_split, ip, srcp, wp, bp, cp, pp, d, mean,
                    st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
