// Fused GAT attention over CSR-by-destination, fp32, for sm_90a.
//
//   s_e      = leaky_relu(el[src_e, h] + er[v, h])            (leaky first)
//   alpha_e  = softmax of s over the edges of row v (per head h)
//   out[v,h] = sum_e alpha_e * z[src_e, h, :]       rows with no edge are 0
//
// Replaces the TPU kernel
// src/repro/kernels/edge_softmax/kernel.py::_attention_kernel, which
// needs every destination row packed whole into a padded ELL stripe
// (one pallas_call per pow2 degree class) so the masked softmax can run
// over the stripe in VMEM. Here one warp owns one (row, head) pair and
// runs a single-pass online softmax over the row's CSR edges — running
// max and running sum, the accumulator rescaled when the max grows — so
// a hub row (in-degree 4,275 on reddit-like) needs no padded stripe and
// alpha never leaves registers.
//
// Bound on the H100: bytes. Per edge and head the kernel reads F floats
// of z for ~2F + 8 flops; the least traffic is z, el, er and the CSR read
// once plus out written once. Each 32-edge batch is one coalesced load of
// src and el, one warp max and one warp sum; then the lanes, striding the
// F features, keep UNR edges' z loads in flight before accumulating.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int UNR = 8;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int FPL>  // features per lane: F <= 32 * FPL
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
attention_csr_kernel(const int* __restrict__ indptr,
                     const int* __restrict__ src,
                     const float* __restrict__ el,
                     const float* __restrict__ er,
                     const float* __restrict__ z, float* __restrict__ out,
                     int n_dst, int H, int F, float slope) {
  const int64_t warp =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= (int64_t)n_dst * H) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int row = (int)(warp / H);
  const int h = (int)(warp - (int64_t)row * H);
  const int beg = __ldg(indptr + row);
  const int end = __ldg(indptr + row + 1);
  const float erv = __ldg(er + warp);  // er is (n_dst, H): flat index = warp

  float m = -INFINITY;  // running max of the row's logits
  float l = 0.0f;       // running sum of exp(s - m)
  float acc[FPL];
#pragma unroll
  for (int k = 0; k < FPL; ++k) acc[k] = 0.0f;

  for (int e0 = beg; e0 < end; e0 += 32) {
    const int e = e0 + lane;
    int s = 0;
    float x = -INFINITY;
    if (e < end) {
      s = __ldg(src + e);
      const float t = __ldg(el + (int64_t)s * H + h) + erv;
      x = t >= 0.0f ? t : slope * t;
    }
    const float m_new = fmaxf(m, warp_max(x));  // finite: batch has an edge
    const float corr = expf(m - m_new);         // 0 on the first batch
    const float p = e < end ? expf(x - m_new) : 0.0f;
    l = l * corr + warp_sum(p);
#pragma unroll
    for (int k = 0; k < FPL; ++k) acc[k] *= corr;
    m = m_new;

    const int cnt = min(32, end - e0);
    for (int jj = 0; jj < cnt; jj += UNR) {
      int sj[UNR];
      float pj[UNR];
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        sj[u] = __shfl_sync(kFull, s, (jj + u) & 31);
        pj[u] = __shfl_sync(kFull, p, (jj + u) & 31);
      }
      float zv[UNR][FPL];
#pragma unroll
      for (int u = 0; u < UNR; ++u)
#pragma unroll
        for (int k = 0; k < FPL; ++k) {
          const int f = lane + 32 * k;
          zv[u][k] = (jj + u < cnt && f < F)
                         ? __ldg(z + ((int64_t)sj[u] * H + h) * F + f)
                         : 0.0f;
        }
#pragma unroll
      for (int u = 0; u < UNR; ++u)
#pragma unroll
        for (int k = 0; k < FPL; ++k) acc[k] = fmaf(pj[u], zv[u][k], acc[k]);
    }
  }

  // l >= 1 on any row with an edge; an empty row writes 0 (no division,
  // so a flush-to-zero build cannot turn 0 / tiny into NaN)
  const float inv = l > 0.0f ? 1.0f / l : 0.0f;
  float* orow = out + warp * F;
#pragma unroll
  for (int k = 0; k < FPL; ++k) {
    const int f = lane + 32 * k;
    if (f < F) orow[f] = acc[k] * inv;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue when F > 128.
extern "C" int fused_attention_csr_f32(const void* indptr, const void* src,
                                       const void* el, const void* er,
                                       const void* z, void* out, int n_dst,
                                       int H, int F, float slope,
                                       void* stream) {
  if (F > 128) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t warps = (int64_t)n_dst * H;
  if (warps > 0 && F > 0) {
    const dim3 grid((unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
    const dim3 block(kWarpsPerBlock * 32);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* ip = static_cast<const int*>(indptr);
    const int* sp = static_cast<const int*>(src);
    const float* lp = static_cast<const float*>(el);
    const float* rp = static_cast<const float*>(er);
    const float* zp = static_cast<const float*>(z);
    float* op = static_cast<float*>(out);
    if (F <= 32) {
      attention_csr_kernel<1><<<grid, block, 0, st>>>(ip, sp, lp, rp, zp, op,
                                                      n_dst, H, F, slope);
    } else if (F <= 64) {
      attention_csr_kernel<2><<<grid, block, 0, st>>>(ip, sp, lp, rp, zp, op,
                                                      n_dst, H, F, slope);
    } else {
      attention_csr_kernel<4><<<grid, block, 0, st>>>(ip, sp, lp, rp, zp, op,
                                                      n_dst, H, F, slope);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
