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
// over the stripe in VMEM. Here no stripe is packed: the kernel walks the
// CSR by destination with a single-pass online softmax (running max m,
// running sum l, the accumulator rescaled when the max grows), so alpha
// never leaves registers.
//
// Bound on the H100: bytes. Per edge and head the kernel reads F floats
// of z for ~2F + 8 flops; the least traffic is z, el, er and the CSR read
// once plus out written once. Like B1 it is gather-bound, and the design
// is flash-decoding over the row-segment work list (kernels/rowsplit.py,
// K = 256 edges; spmm_csr.cu says why):
//   * one warp owns one segment and a group of heads. A row of in-degree
//     <= K is one segment and writes out = acc / l directly (an empty row
//     writes 0, with no division). A heavier row's segments each write
//     their (m_i, l_i, acc_i) to a workspace the wrapper allocates, and a
//     second launch merges them in segment (= edge) order:
//       m = max m_i,  l = sum l_i e^(m_i - m),  acc = sum acc_i e^(m_i - m),
//       out = acc / l.
//     Every sum has a fixed order: results are bit-identical per call.
//   * a warp covers hg = min(H, 128 / F, 8) heads at once, so src and
//     el[src, heads] are read once per edge instead of once per head; the
//     lanes hold the group's hg * F contiguous floats of z[src] as float4
//     (float2 / scalar when F or the pointers do not allow), at H = 4,
//     F = 32 all 32 lanes with one float4 each.
//   * each 32-edge batch is one coalesced load of src and el, one warp max
//     and one warp sum per head (the heads' butterflies interleaved, so
//     their shuffle chains overlap); the weights p go through shared memory
//     (a lane reads its own head's), and the lanes keep UNR = 4 edges' z
//     loads in flight before accumulating. A lane holds only as many
//     vectors (NV) as the group's floats need. Most rows are short (mean
//     in-degree 9.6 on reddit-like), so a warp's time is a chain of
//     dependent loads: fewer registers, hence more warps per SM, beat a
//     deeper unroll (measured: PERF.md, §6).
// History: until the work list, one warp owned one (row, head) pair, each
// of a row's H warps re-read its src and el, and the in-degree-4,275 hub
// of reddit-like was one warp's serial loop.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kCombineThreads = 256;
constexpr int UNR = 4;     // divides 32: a batch's edge index stays < 32
constexpr int kLaneFloats = 4;  // a warp's head group covers <= 128 floats

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

// a[i] for a warp-divergent i, without indexing a register array
template <int N>
__device__ __forceinline__ float pick(const float (&a)[N], int i) {
  float r = a[0];
#pragma unroll
  for (int k = 1; k < N; ++k) r = i == k ? a[k] : r;
  return r;
}

// One warp per (segment, head group) of the work list; each lane holds NV
// vectors of VEC floats of the group's hg * F, and HMAX >= hg heads' state.
template <int VEC, int HMAX, int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
attention_segment_kernel(const int4* __restrict__ seg, int n_seg, int n_grp,
                         const int* __restrict__ src,
                         const float* __restrict__ el,
                         const float* __restrict__ er,
                         const float* __restrict__ z, float* __restrict__ out,
                         float* __restrict__ pacc, float* __restrict__ pml,
                         int H, int F, int hg, float slope) {
  static_assert(NV * VEC <= kLaneFloats, "a group covers <= 128 floats");
  __shared__ float ps[kWarpsPerBlock][32 * HMAX];
  const int wi = threadIdx.x >> 5;
  const int64_t w = (int64_t)blockIdx.x * kWarpsPerBlock + wi;
  if (w >= (int64_t)n_seg * n_grp) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int si = (int)(w / n_grp);
  const int h0 = (int)(w - (int64_t)si * n_grp) * hg;
  const int nh = min(hg, H - h0);
  const int4 sg = __ldg(seg + si);
  const int row = sg.x;
  const int beg = sg.y;
  const int end = sg.z;
  const int64_t hf = (int64_t)H * F;
  const int64_t goff = (int64_t)h0 * F;  // the group's floats in a z row

  // this lane's vectors: floats o_k .. o_k + VEC - 1 of the group, head hk
  int vo[NV];  // offset of the vector in the group, or -1
  int hk[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int o = (k * 32 + lane) * VEC;
    vo[k] = o < nh * F ? o : -1;
    hk[k] = vo[k] >= 0 ? o / F : 0;
  }
  float erv[HMAX], m[HMAX], l[HMAX];
#pragma unroll
  for (int hh = 0; hh < HMAX; ++hh) {
    erv[hh] = hh < nh ? __ldg(er + (int64_t)row * H + h0 + hh) : 0.0f;
    m[hh] = -INFINITY;
    l[hh] = 0.0f;
  }
  float acc[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[k][i] = 0.0f;

  for (int e0 = beg; e0 < end; e0 += 32) {
    const int e = e0 + lane;
    int s = 0;
    float x[HMAX];
#pragma unroll
    for (int hh = 0; hh < HMAX; ++hh) x[hh] = hh < nh ? -INFINITY : 0.0f;
    if (e < end) {
      s = __ldg(src + e);
#pragma unroll
      for (int hh = 0; hh < HMAX; ++hh) {
        if (hh < nh) {
          const float t = __ldg(el + (int64_t)s * H + h0 + hh) + erv[hh];
          x[hh] = t >= 0.0f ? t : slope * t;
        }
      }
    }
    // the heads' warp max and warp sum as HMAX interleaved butterflies
    // (independent shuffle chains overlap); a head slot past nh reduces
    // zeros, and its state is never read
    float corr[HMAX], red[HMAX];
#pragma unroll
    for (int hh = 0; hh < HMAX; ++hh) red[hh] = x[hh];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int hh = 0; hh < HMAX; ++hh)
        red[hh] = fmaxf(red[hh], __shfl_xor_sync(kFull, red[hh], off));
#pragma unroll
    for (int hh = 0; hh < HMAX; ++hh) {
      const float m_new = fmaxf(m[hh], red[hh]);  // batch has an edge
      corr[hh] = expf(m[hh] - m_new);             // 0 on the first
      const float p = e < end ? expf(x[hh] - m_new) : 0.0f;
      m[hh] = m_new;
      red[hh] = p;
      ps[wi][lane * HMAX + hh] = p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int hh = 0; hh < HMAX; ++hh)
        red[hh] += __shfl_xor_sync(kFull, red[hh], off);
#pragma unroll
    for (int hh = 0; hh < HMAX; ++hh) l[hh] = l[hh] * corr[hh] + red[hh];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const float c = pick<HMAX>(corr, hk[k]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[k][i] *= c;
    }
    __syncwarp();

    const int cnt = min(32, end - e0);
    for (int jj = 0; jj < cnt; jj += UNR) {
      int sj[UNR];
#pragma unroll
      for (int u = 0; u < UNR; ++u) sj[u] = __shfl_sync(kFull, s, jj + u);
      float zv[UNR][NV][VEC];
#pragma unroll
      for (int u = 0; u < UNR; ++u)
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          if (jj + u < cnt && vo[k] >= 0) {
            load_vec<VEC>(z + (int64_t)sj[u] * hf + goff + vo[k], zv[u][k]);
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) zv[u][k][i] = 0.0f;
          }
        }
#pragma unroll
      for (int u = 0; u < UNR; ++u)
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          const float p = ps[wi][(jj + u) * HMAX + hk[k]];
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            acc[k][i] = fmaf(p, zv[u][k][i], acc[k][i]);
        }
    }
    __syncwarp();  // the next batch rewrites ps
  }

  if (sg.w < 0) {
    // l >= 1 on any row with an edge; an empty row writes 0 (no division,
    // so a flush-to-zero build cannot turn 0 / tiny into NaN)
    float inv[HMAX];
#pragma unroll
    for (int hh = 0; hh < HMAX; ++hh) inv[hh] = l[hh] > 0.0f ? 1.0f / l[hh]
                                                             : 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (vo[k] >= 0) {
        const float c = pick<HMAX>(inv, hk[k]);
        float v[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[i] = acc[k][i] * c;
        store_vec<VEC>(out + (int64_t)row * hf + goff + vo[k], v);
      }
    }
  } else {
    const int64_t slot = sg.w;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (vo[k] >= 0) store_vec<VEC>(pacc + slot * hf + goff + vo[k], acc[k]);
    if (lane == 0) {
#pragma unroll
      for (int hh = 0; hh < HMAX; ++hh) {
        if (hh < nh) {
          float* ml = pml + 2 * (slot * H + h0 + hh);
          ml[0] = m[hh];
          ml[1] = l[hh];
        }
      }
    }
  }
}

// One thread per (split row, head, feature): merge the row's segments in
// slot order. Every segment of a split row has edges, so each m_i is
// finite and l >= 1.
__global__ void __launch_bounds__(kCombineThreads)
attention_combine_kernel(const int* __restrict__ split, int n_split,
                         const float* __restrict__ pacc,
                         const float* __restrict__ pml,
                         float* __restrict__ out, int H, int F) {
  const int64_t hf = (int64_t)H * F;
  const int64_t t = (int64_t)blockIdx.x * kCombineThreads + threadIdx.x;
  if (t >= (int64_t)n_split * hf) return;
  const int r = (int)(t / hf);
  const int64_t c = t - (int64_t)r * hf;  // h * F + f
  const int h = (int)(c / F);
  const int row = __ldg(split + 3 * r);
  const int first = __ldg(split + 3 * r + 1);
  const int count = __ldg(split + 3 * r + 2);
  float mx = -INFINITY;
  for (int k = 0; k < count; ++k)
    mx = fmaxf(mx, __ldg(pml + 2 * ((int64_t)(first + k) * H + h)));
  float l = 0.0f;
  float a = 0.0f;
  for (int k = 0; k < count; ++k) {
    const int64_t ms = 2 * ((int64_t)(first + k) * H + h);
    const float wk = expf(__ldg(pml + ms) - mx);
    l = fmaf(__ldg(pml + ms + 1), wk, l);
    a = fmaf(__ldg(pacc + (int64_t)(first + k) * hf + c), wk, a);
  }
  out[(int64_t)row * hf + c] = a * (l > 0.0f ? 1.0f / l : 0.0f);
}

#define SEGMENT_ARGS                                                        \
  seg, n_seg, n_grp, src, el, er, z, out, pacc, pml, H, F, hg, slope
#define SEGMENT_PARAMS                                                      \
  const int4 *seg, int n_seg, int n_grp, const int *src, const float *el,   \
      const float *er, const float *z, float *out, float *pacc, float *pml, \
      int H, int F, int hg, float slope

template <int VEC, int HMAX, int NV>
void launch_segments(SEGMENT_PARAMS, cudaStream_t st) {
  const int64_t warps = (int64_t)n_seg * n_grp;
  const dim3 grid((unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  attention_segment_kernel<VEC, HMAX, NV>
      <<<grid, kWarpsPerBlock * 32, 0, st>>>(SEGMENT_ARGS);
}

// NV: as few vectors per lane as the group's hg * F floats need (fewer
// registers, more warps per SM for the latency-bound short rows)
template <int VEC, int HMAX>
void launch_nv(SEGMENT_PARAMS, cudaStream_t st) {
  const int nv = (hg * F + 32 * VEC - 1) / (32 * VEC);
  if constexpr (VEC == 4) {
    launch_segments<4, HMAX, 1>(SEGMENT_ARGS, st);
  } else if constexpr (VEC == 2) {
    if (nv <= 1) launch_segments<2, HMAX, 1>(SEGMENT_ARGS, st);
    else launch_segments<2, HMAX, 2>(SEGMENT_ARGS, st);
  } else {
    if (nv <= 1) launch_segments<1, HMAX, 1>(SEGMENT_ARGS, st);
    else if (nv <= 2) launch_segments<1, HMAX, 2>(SEGMENT_ARGS, st);
    else launch_segments<1, HMAX, 4>(SEGMENT_ARGS, st);
  }
}

template <int VEC>
void launch_vec(const int4* seg, int n_seg, const int* src, const float* el,
                const float* er, const float* z, float* out, float* pacc,
                float* pml, int H, int F, int hg, float slope,
                cudaStream_t st) {
  const int n_grp = (H + hg - 1) / hg;
  if (hg <= 1) {
    launch_nv<VEC, 1>(SEGMENT_ARGS, st);
  } else if (hg <= 2) {
    launch_nv<VEC, 2>(SEGMENT_ARGS, st);
  } else if (hg <= 4) {
    launch_nv<VEC, 4>(SEGMENT_ARGS, st);
  } else {
    launch_nv<VEC, 8>(SEGMENT_ARGS, st);
  }
}
#undef SEGMENT_ARGS
#undef SEGMENT_PARAMS

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue when a head group would exceed 128 floats
// (hg < 1, hg > 8 or hg * F > 128). ``seg`` (n_seg x 4) and ``split``
// (n_split x 3) are the work list of kernels/rowsplit.py; ``pacc``
// (n_partials x H x F) and ``pml`` (n_partials x H x 2) are the
// workspace of the split rows' segments (null when n_split == 0).
extern "C" int fused_attention_csr_f32(const void* seg, int n_seg,
                                       const void* split, int n_split,
                                       const void* src, const void* el,
                                       const void* er, const void* z,
                                       void* out, void* pacc, void* pml,
                                       int H, int F, int hg, float slope,
                                       void* stream) {
  if (hg < 1 || hg > 8 || hg * F > 32 * kLaneFloats)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_seg > 0 && H > 0 && F > 0) {
    const int4* sg = static_cast<const int4*>(seg);
    const int* sp = static_cast<const int*>(src);
    const float* lp = static_cast<const float*>(el);
    const float* rp = static_cast<const float*>(er);
    const float* zp = static_cast<const float*>(z);
    float* op = static_cast<float*>(out);
    float* ap = static_cast<float*>(pacc);
    float* mp = static_cast<float*>(pml);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (F % 4 == 0 && aligned(zp, 16) && aligned(op, 16) && aligned(ap, 16)) {
      launch_vec<4>(sg, n_seg, sp, lp, rp, zp, op, ap, mp, H, F, hg, slope,
                    st);
    } else if (F % 2 == 0 && aligned(zp, 8) && aligned(op, 8) &&
               aligned(ap, 8)) {
      launch_vec<2>(sg, n_seg, sp, lp, rp, zp, op, ap, mp, H, F, hg, slope,
                    st);
    } else {
      launch_vec<1>(sg, n_seg, sp, lp, rp, zp, op, ap, mp, H, F, hg, slope,
                    st);
    }
    if (n_split > 0) {
      const int64_t threads = (int64_t)n_split * H * F;
      attention_combine_kernel<<<
          (unsigned)((threads + kCombineThreads - 1) / kCombineThreads),
          kCombineThreads, 0, st>>>(static_cast<const int*>(split), n_split,
                                    ap, mp, op, H, F);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
