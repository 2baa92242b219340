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
// flops (0.5 flop/byte), far below the card's ~20 flop/byte fp32 ridge.
// The least traffic is B read once plus C written once; the rows of B a
// destination gathers are scattered, so the design aims at keeping many
// independent gathers in flight:
//   * one warp owns one output row (no atomics, deterministic sums);
//   * the warp loads 32 edges' (src, weight) with one coalesced read and
//     broadcasts them by shuffle;
//   * lanes split the feature axis in VEC-wide vectors (float4/float2 when
//     d and the base pointers allow, else scalar); a narrow row (d / VEC <
//     32) is covered by a group of LPE lanes and the warp's 32 / LPE groups
//     take different edges, combined by a shuffle reduction at the end;
//   * each lane keeps NCH column chunks and UNR edges of loads in flight
//     (NCH * UNR = 16 vector loads) before it accumulates.
// A hub row (in-degree 4,275 on reddit-like) is one warp's serial loop and
// bounds the tail; splitting hub rows across warps is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

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

template <int VEC, int NCH>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_csr_kernel(const int* __restrict__ indptr, const int* __restrict__ src,
                const float* __restrict__ weight,
                const float* __restrict__ B, float* __restrict__ C,
                int n_dst, int d, int lpe, int mean) {
  constexpr int UNR = (16 / NCH) > 1 ? (16 / NCH) : 1;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_dst) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int ngrp = 32 / lpe;
  const int grp = lane / lpe;
  const int sub = lane - grp * lpe;
  const int beg = __ldg(indptr + row);
  const int end = __ldg(indptr + row + 1);
  const int dv = d / VEC;
  const float scale = mean ? 1.0f / (float)max(end - beg, 1) : 1.0f;
  float* crow = C + (int64_t)row * d;

  for (int c0 = 0; c0 < dv; c0 += NCH * lpe) {
    float acc[NCH][VEC];
#pragma unroll
    for (int k = 0; k < NCH; ++k)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[k][i] = 0.0f;

    for (int e0 = beg; e0 < end; e0 += 32) {
      const int e = e0 + lane;
      int s = 0;
      float w = 0.0f;
      if (e < end) {
        s = __ldg(src + e);
        w = weight != nullptr ? __ldg(weight + e) : 1.0f;
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
          wj[u] = __shfl_sync(kFull, w, j & 31);
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
          store_vec<VEC>(crow + (int64_t)cv * VEC, out);
        }
      }
    }
  }
}

template <int VEC>
void launch_vec(const int* indptr, const int* src, const float* weight,
                const float* B, float* C, int n_dst, int d, int mean,
                cudaStream_t stream) {
  const int dv = d / VEC;
  int lpe = 1;
  while (lpe < dv && lpe < 32) lpe <<= 1;
  const int chunks = (dv + lpe - 1) / lpe;
  const dim3 grid((unsigned)((n_dst + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(kWarpsPerBlock * 32);
  if (chunks >= 8) {
    spmm_csr_kernel<VEC, 8><<<grid, block, 0, stream>>>(
        indptr, src, weight, B, C, n_dst, d, lpe, mean);
  } else if (chunks >= 3) {
    spmm_csr_kernel<VEC, 4><<<grid, block, 0, stream>>>(
        indptr, src, weight, B, C, n_dst, d, lpe, mean);
  } else if (chunks == 2) {
    spmm_csr_kernel<VEC, 2><<<grid, block, 0, stream>>>(
        indptr, src, weight, B, C, n_dst, d, lpe, mean);
  } else {
    spmm_csr_kernel<VEC, 1><<<grid, block, 0, stream>>>(
        indptr, src, weight, B, C, n_dst, d, lpe, mean);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). ``weight``
// may be null (unweighted); ``mean`` != 0 divides by max(deg, 1).
extern "C" int spmm_csr_f32(const void* indptr, const void* src,
                            const void* weight, const void* B, void* C,
                            int n_dst, int d, int mean, void* stream) {
  if (n_dst > 0 && d > 0) {
    const int* ip = static_cast<const int*>(indptr);
    const int* sp = static_cast<const int*>(src);
    const float* wp = static_cast<const float*>(weight);
    const float* bp = static_cast<const float*>(B);
    float* cp = static_cast<float*>(C);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (d % 4 == 0 && aligned(bp, 16) && aligned(cp, 16)) {
      launch_vec<4>(ip, sp, wp, bp, cp, n_dst, d, mean, st);
    } else if (d % 2 == 0 && aligned(bp, 8) && aligned(cp, 8)) {
      launch_vec<2>(ip, sp, wp, bp, cp, n_dst, d, mean, st);
    } else {
      launch_vec<1>(ip, sp, wp, bp, cp, n_dst, d, mean, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
