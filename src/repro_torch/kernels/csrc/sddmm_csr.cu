// gSDDMM in caller edge order, fp32 or bf16, for sm_90a.
//
//   out[e, j] = lhs[ia[e], j] (op) rhs[ib[e], j]      e < n_edges, caller id
//   op in {add, sub, mul, div, copy};
//   dot: out[e, 0] = one fma chain over j ascending of lhs * rhs
//
// ia / ib give each operand's row: src_caller (src[eid_inv]) for a 'u'
// operand, dst_caller for 'v', and null for 'e', whose row is e itself (no
// index array is read). An operand of width 1 broadcasts to the other's
// width. Every thread owns whole output rows, so no two threads write one.
//
// Replaces the TPU kernels src/repro/kernels/sddmm/kernel.py::_binary_kernel
// and ::_copy_kernel. Those take operand streams that XLA has already
// gathered into canonical (dst-sorted) order, padded to a multiple of the
// edge block, and leave the un-permute by eid_inv to XLA: three passes
// over (E, d) streams in HBM. Here the kernel walks the caller's order, as
// the JAX package's own `gather` plan does (repro/core/binary_reduce.py),
// so there is neither a gather into canonical order nor an un-permute.
//
// Bound on the H100: bytes. One op per element (d flops per edge for dot)
// against 8 or more bytes per element. The least traffic is one index
// array per node operand, each operand and the output once. The design:
//   * the output and an 'e' operand are read and written contiguously;
//     caller order is usually sorted by source (an edge list from
//     np.unique(src * n + dst)), so a 'u' operand is read in
//     non-decreasing row order, and only a 'v' operand is a gather
//     (at most 65,536 x 4 fp32 on reddit-like, which sits in L2);
//   * width 4 (GAT's H = 4): one edge per thread, one float4 load per
//     operand of width 4 and one float4 store (two edges per thread, all
//     loads in flight first, measured no faster);
//   * width 1: four edges per thread, one int4 load per index array, one
//     float4 load of an 'e' operand and one float4 store;
//   * other widths, or pointers not 16-byte aligned: one thread per output
//     element (dot: per edge), in caller order all the same.
// Per element the arithmetic is the plain version's (one IEEE op; division
// is IEEE, nvcc's default -prec-div=true), so every op but dot gives the
// plain version's bits. There are no pad rows.
// Element types: lhs, rhs and out are all fp32 (sddmm_csr_f32) or all bf16
// (sddmm_csr_bf16). A bf16 operand is widened exactly to fp32, the op (a
// dot's whole chain) runs in fp32, and the result is rounded to bf16 once,
// at the store (__float2bfloat16_rn), as the Pallas kernel computes in fp32
// (repro/kernels/sddmm/kernel.py:19-20) and writes lhs's dtype (:33). The
// vector paths read 4 elements (16 bytes fp32, 8 bytes bf16) and need each
// pointer aligned to 4 elements; else the element path runs.
// History: the first version walked canonical order and wrote out[eid[k]],
// a scatter of 4- or 16-byte rows, with an 'e' operand gathered through
// eid (benchmarks/csrc/sddmm_canonical.cu keeps it, to time the two walks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { kAdd = 0, kSub = 1, kMul = 2, kDiv = 3, kDot = 4, kCopy = 5 };

constexpr int kThreads = 256;

typedef __nv_bfloat16 bf16;

template <int OP>
__device__ __forceinline__ float apply(float a, float b) {
  if constexpr (OP == kAdd) return a + b;
  if constexpr (OP == kSub) return a - b;
  if constexpr (OP == kMul) return a * b;
  if constexpr (OP == kDiv) return a / b;
  if constexpr (OP == kDot) return fmaf(a, b, 0.0f);  // a chain of one
  return a;  // kCopy
}

// loads widen to fp32 exactly; a bf16 store rounds to nearest even, once
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const bf16* p) {
  return __uint_as_float(
      (unsigned int)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ unsigned int bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}
__device__ __forceinline__ void st(bf16* p, float v) {
  *reinterpret_cast<unsigned short*>(p) = (unsigned short)bf16_bits(v);
}

// four consecutive elements at p (aligned to four elements) as a float4
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(t.x << 16),
                     __uint_as_float(t.x & 0xffff0000u),
                     __uint_as_float(t.y << 16),
                     __uint_as_float(t.y & 0xffff0000u));
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bf16_bits(v.x) | (bf16_bits(v.y) << 16),
                 bf16_bits(v.z) | (bf16_bits(v.w) << 16));
}

// the operand row of caller edge e: idx[e], or e itself for an 'e' operand
__device__ __forceinline__ int64_t row_of(const int* __restrict__ idx,
                                          int64_t e) {
  return idx != nullptr ? (int64_t)__ldg(idx + e) : e;
}

// row r of an operand of width w (4, or 1 broadcast) as one float4
template <typename T>
__device__ __forceinline__ float4 load_row4(const T* __restrict__ p,
                                            int64_t r, int w) {
  if (w == 4) return ld4(p + 4 * r);
  const float v = ld(p + r);
  return make_float4(v, v, v, v);
}

// a width-1 operand at caller edges e0 .. e0 + 3
template <typename T>
__device__ __forceinline__ float4 load_quad(const T* __restrict__ p,
                                            const int* __restrict__ idx,
                                            int64_t e0) {
  if (idx == nullptr) return ld4(p + e0);
  const int4 r = __ldg(reinterpret_cast<const int4*>(idx + e0));
  return make_float4(ld(p + r.x), ld(p + r.y), ld(p + r.z), ld(p + r.w));
}

// Width 4: thread per edge.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
sddmm_w4_kernel(const int* __restrict__ ia, const int* __restrict__ ib,
                const T* __restrict__ lhs, const T* __restrict__ rhs,
                T* __restrict__ out, int n_edges, int dl, int dr) {
  const int stride = gridDim.x * blockDim.x;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n_edges;
       e += stride) {
    const float4 a = load_row4(lhs, row_of(ia, e), dl);
    float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if constexpr (OP != kCopy) b = load_row4(rhs, row_of(ib, e), dr);
    if constexpr (OP == kDot) {
      st(out + e, fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y,
                                                      fmaf(a.x, b.x, 0.0f)))));
    } else {
      st4(out + 4 * (int64_t)e,
          make_float4(apply<OP>(a.x, b.x), apply<OP>(a.y, b.y),
                      apply<OP>(a.z, b.z), apply<OP>(a.w, b.w)));
    }
  }
}

// Width 1: thread per four consecutive edges; the first n_edges % 4
// threads also take one edge of the tail.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
sddmm_w1_kernel(const int* __restrict__ ia, const int* __restrict__ ib,
                const T* __restrict__ lhs, const T* __restrict__ rhs,
                T* __restrict__ out, int n_edges) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int n4 = n_edges >> 2;
  for (int q = tid; q < n4; q += stride) {
    const int64_t e0 = (int64_t)q * 4;
    const float4 a = load_quad(lhs, ia, e0);
    float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if constexpr (OP != kCopy) b = load_quad(rhs, ib, e0);
    st4(out + e0, make_float4(apply<OP>(a.x, b.x), apply<OP>(a.y, b.y),
                              apply<OP>(a.z, b.z), apply<OP>(a.w, b.w)));
  }
  if (tid < (n_edges & 3)) {
    const int64_t e = (int64_t)n4 * 4 + tid;
    const float a = ld(lhs + row_of(ia, e));
    float b = 0.0f;
    if constexpr (OP != kCopy) b = ld(rhs + row_of(ib, e));
    st(out + e, apply<OP>(a, b));
  }
}

// Any width, elementwise ops: thread t computes element (e, j) =
// (t / d, t % d).
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
sddmm_elem_kernel(const int* __restrict__ ia, const int* __restrict__ ib,
                  const T* __restrict__ lhs, const T* __restrict__ rhs,
                  T* __restrict__ out, int64_t n_elems, int d, int dl,
                  int dr) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < n_elems; t += stride) {
    const int64_t e = t / d;
    const int j = (int)(t - e * d);
    const float a = ld(lhs + row_of(ia, e) * dl + (dl == 1 ? 0 : j));
    float b = 0.0f;
    if constexpr (OP != kCopy)
      b = ld(rhs + row_of(ib, e) * dr + (dr == 1 ? 0 : j));
    st(out + t, apply<OP>(a, b));
  }
}

// Any width, dot: thread per edge, one fp32 fma chain over j ascending.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sddmm_dot_kernel(const int* __restrict__ ia, const int* __restrict__ ib,
                 const T* __restrict__ lhs, const T* __restrict__ rhs,
                 T* __restrict__ out, int n_edges, int d, int dl, int dr) {
  const int stride = gridDim.x * blockDim.x;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n_edges;
       e += stride) {
    const T* a = lhs + row_of(ia, e) * dl;
    const T* b = rhs + row_of(ib, e) * dr;
    float acc = 0.0f;
    for (int j = 0; j < d; ++j)
      acc = fmaf(ld(a + (dl == 1 ? 0 : j)), ld(b + (dr == 1 ? 0 : j)), acc);
    st(out + e, acc);
  }
}

unsigned grid_for(int64_t work) {
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  return (unsigned)(blocks < (1 << 20) ? blocks : (1 << 20));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// aligned to four elements of T: one vector load or store
template <typename T>
bool aligned4(const T* p) {
  return (reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T))) == 0;
}

template <typename T, int OP>
void launch(const int* ia, const int* ib, const T* lp, const T* rp, T* o,
            int n_edges, int dl, int dr, cudaStream_t st) {
  const int w = OP == kCopy ? dl : (dl > dr ? dl : dr);  // operand width
  // width 1 reads an index array as int4s, an 'e' operand as 4-vectors
  const bool quads_ok = (ia == nullptr ? aligned4(lp) : aligned16(ia)) &&
                        (OP == kCopy ||
                         (ib == nullptr ? aligned4(rp) : aligned16(ib)));
  if (w == 4 && (dl == 1 || aligned4(lp)) &&
      (OP == kCopy || dr == 1 || aligned4(rp)) &&
      (OP == kDot || aligned4(o))) {
    sddmm_w4_kernel<T, OP><<<grid_for(n_edges), kThreads, 0, st>>>(
        ia, ib, lp, rp, o, n_edges, dl, dr);
  } else if (w == 1 && quads_ok && aligned4(o)) {
    sddmm_w1_kernel<T, OP><<<grid_for((n_edges + 3) / 4), kThreads, 0, st>>>(
        ia, ib, lp, rp, o, n_edges);
  } else if constexpr (OP == kDot) {
    sddmm_dot_kernel<T><<<grid_for(n_edges), kThreads, 0, st>>>(
        ia, ib, lp, rp, o, n_edges, w, dl, dr);
  } else {
    const int64_t n = (int64_t)n_edges * w;
    sddmm_elem_kernel<T, OP><<<grid_for(n), kThreads, 0, st>>>(
        ia, ib, lp, rp, o, n, w, dl, dr);
  }
}

template <typename T>
int run(const void* idx_l, const void* idx_r, const void* lhs,
        const void* rhs, void* out, int n_edges, int dl, int dr, int op,
        void* stream) {
  if (op < kAdd || op > kCopy || dl < 1 || (op != kCopy && dr < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int d = op == kCopy ? dl : (dl > dr ? dl : dr);
  if (op != kCopy && ((dl != d && dl != 1) || (dr != d && dr != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_edges > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* ia = static_cast<const int*>(idx_l);
    const int* ib = static_cast<const int*>(idx_r);
    const T* lp = static_cast<const T*>(lhs);
    const T* rp = static_cast<const T*>(rhs);
    T* o = static_cast<T*>(out);
    switch (op) {
      case kAdd: launch<T, kAdd>(ia, ib, lp, rp, o, n_edges, dl, dr, st); break;
      case kSub: launch<T, kSub>(ia, ib, lp, rp, o, n_edges, dl, dr, st); break;
      case kMul: launch<T, kMul>(ia, ib, lp, rp, o, n_edges, dl, dr, st); break;
      case kDiv: launch<T, kDiv>(ia, ib, lp, rp, o, n_edges, dl, dr, st); break;
      case kDot: launch<T, kDot>(ia, ib, lp, rp, o, n_edges, dl, dr, st); break;
      default: launch<T, kCopy>(ia, ib, lp, rp, o, n_edges, dl, dr, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unknown op or widths that neither match
// nor broadcast from 1. ``idx_l`` / ``idx_r`` are the operands' caller-order
// index arrays, null for an 'e' operand; ``rhs`` / ``idx_r`` are ignored
// (may be null) for copy, whose width is dl. Operands and output fp32.
extern "C" int sddmm_csr_f32(const void* idx_l, const void* idx_r,
                             const void* lhs, const void* rhs, void* out,
                             int n_edges, int dl, int dr, int op,
                             void* stream) {
  return run<float>(idx_l, idx_r, lhs, rhs, out, n_edges, dl, dr, op,
                    stream);
}

// The same with operands and output in bf16 (arithmetic in fp32).
extern "C" int sddmm_csr_bf16(const void* idx_l, const void* idx_r,
                              const void* lhs, const void* rhs, void* out,
                              int n_edges, int dl, int dr, int op,
                              void* stream) {
  return run<bf16>(idx_l, idx_r, lhs, rhs, out, n_edges, dl, dr, op,
                   stream);
}
