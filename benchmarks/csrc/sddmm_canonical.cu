// B3 (gSDDMM) walking canonical edge order: a benchmark variant only.
//
//   out[eid[k], j] = lhs[idx_l[k], j] (op) rhs[idx_r[k], j]     k < n_edges
//   op in {add, sub, mul, div, copy};  dot: out[eid[k], 0] = sum_j of mul
//
// idx_l / idx_r are the canonical (dst-sorted) index arrays of the
// operands' targets: src for 'u', dst for 'v', eid for 'e'. This was the
// port's first B3 kernel: one thread per output element, the write through
// eid a scatter of d-float rows. The port's kernel,
// src/repro_torch/kernels/csrc/sddmm_csr.cu, walks caller order instead;
// benchmarks/torch_sddmm_walks.py times the two against each other.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { kAdd = 0, kSub = 1, kMul = 2, kDiv = 3, kDot = 4, kCopy = 5 };

constexpr int kThreads = 256;

template <int OP>
__device__ __forceinline__ float apply(float a, float b) {
  if constexpr (OP == kAdd) return a + b;
  if constexpr (OP == kSub) return a - b;
  if constexpr (OP == kMul) return a * b;
  if constexpr (OP == kDiv) return a / b;
  return a;  // kCopy
}

// Elementwise ops: thread t computes element (k, j) = (t / d, t % d).
template <int OP>
__global__ void __launch_bounds__(kThreads)
sddmm_elem_kernel(const int* __restrict__ idx_l, const int* __restrict__ idx_r,
                  const int* __restrict__ eid, const float* __restrict__ lhs,
                  const float* __restrict__ rhs, float* __restrict__ out,
                  int64_t n_elems, int d, int dl, int dr) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < n_elems; t += stride) {
    const int64_t k = t / d;
    const int j = (int)(t - k * d);
    const float a = __ldg(lhs + (int64_t)__ldg(idx_l + k) * dl +
                          (dl == 1 ? 0 : j));
    float b = 0.0f;
    if constexpr (OP != kCopy)
      b = __ldg(rhs + (int64_t)__ldg(idx_r + k) * dr + (dr == 1 ? 0 : j));
    out[(int64_t)__ldg(eid + k) * d + j] = apply<OP>(a, b);
  }
}

// dot: one thread per edge sums over the feature axis, writes width 1.
__global__ void __launch_bounds__(kThreads)
sddmm_dot_kernel(const int* __restrict__ idx_l, const int* __restrict__ idx_r,
                 const int* __restrict__ eid, const float* __restrict__ lhs,
                 const float* __restrict__ rhs, float* __restrict__ out,
                 int n_edges, int d, int dl, int dr) {
  const int stride = gridDim.x * blockDim.x;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n_edges;
       k += stride) {
    const float* a = lhs + (int64_t)__ldg(idx_l + k) * dl;
    const float* b = rhs + (int64_t)__ldg(idx_r + k) * dr;
    float acc = 0.0f;
    for (int j = 0; j < d; ++j)
      acc = fmaf(__ldg(a + (dl == 1 ? 0 : j)), __ldg(b + (dr == 1 ? 0 : j)),
                 acc);
    out[__ldg(eid + k)] = acc;
  }
}

unsigned grid_for(int64_t work) {
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  return (unsigned)(blocks < (1 << 20) ? blocks : (1 << 20));
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unknown op or widths that neither match
// nor broadcast from 1. ``rhs`` / ``idx_r`` are ignored (may be null) for
// copy, whose width is dl.
extern "C" int sddmm_canonical_f32(const void* idx_l, const void* idx_r,
                             const void* eid, const void* lhs,
                             const void* rhs, void* out, int n_edges, int dl,
                             int dr, int op, void* stream) {
  if (op < kAdd || op > kCopy || dl < 1 || (op != kCopy && dr < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int d = op == kCopy ? dl : (dl > dr ? dl : dr);
  if (op != kCopy && ((dl != d && dl != 1) || (dr != d && dr != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_edges > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* il = static_cast<const int*>(idx_l);
    const int* ir = static_cast<const int*>(idx_r);
    const int* ei = static_cast<const int*>(eid);
    const float* lp = static_cast<const float*>(lhs);
    const float* rp = static_cast<const float*>(rhs);
    float* o = static_cast<float*>(out);
    if (op == kDot) {
      sddmm_dot_kernel<<<grid_for(n_edges), kThreads, 0, st>>>(
          il, ir, ei, lp, rp, o, n_edges, d, dl, dr);
    } else {
      const int64_t n = (int64_t)n_edges * d;
      const unsigned grid = grid_for(n);
      switch (op) {
        case kAdd:
          sddmm_elem_kernel<kAdd><<<grid, kThreads, 0, st>>>(
              il, ir, ei, lp, rp, o, n, d, dl, dr);
          break;
        case kSub:
          sddmm_elem_kernel<kSub><<<grid, kThreads, 0, st>>>(
              il, ir, ei, lp, rp, o, n, d, dl, dr);
          break;
        case kMul:
          sddmm_elem_kernel<kMul><<<grid, kThreads, 0, st>>>(
              il, ir, ei, lp, rp, o, n, d, dl, dr);
          break;
        case kDiv:
          sddmm_elem_kernel<kDiv><<<grid, kThreads, 0, st>>>(
              il, ir, ei, lp, rp, o, n, d, dl, dr);
          break;
        default:
          sddmm_elem_kernel<kCopy><<<grid, kThreads, 0, st>>>(
              il, ir, ei, lp, rp, o, n, d, dl, dr);
      }
    }
  }
  return static_cast<int>(cudaGetLastError());
}
