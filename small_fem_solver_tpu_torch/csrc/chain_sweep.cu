// Chain-sweep kernel for Hopper (sm_90a): forward RHS sweep and backward
// substitution of the block-tridiagonal chain solve in one launch.
//
// Replaces the two Pallas TPU kernels of benchmarks/ab_pallas_sweep.py
// (pallas_sweep): the forward sweep _fwd_kernel (pl.pallas_call at :106)
//
//   y_l = Dinv_l g_l - DinvL_l y_{l-1},          l = 0 .. n_int-1, y_{-1} = 0
//
// and the backward substitution _bwd_kernel (pl.pallas_call at :114)
//
//   v_l = y_l - C'_l v_{l+1},                    l = n_int-1 .. 0, v_{n_int} = 0
//
// and adds the interface extras fI = -B0 v_0, fJ = -Cn v_{n_int-1}.  It
// computes what ops/condense.py::chain_sweep_plain computes (the counterpart
// of the JAX lax.scan pair in small_fem_solver_tpu/ops/condense.py).
//
// Layout.  One thread owns one (right-hand side b, chain c) 6-vector; c is
// the fastest index, so a warp's threads read neighbouring chains' factors
// and neighbouring 6-vectors of g.  The forward carry y stays in registers;
// y_l is written into v and read back by the same thread in the backward
// pass, which overwrites it with v_l.  Factors (shared by every b) are read
// through the read-only cache (__ldg).
//
// Bounds.  Per (b, c) and level the thread does three 6x6 mat-vecs
// (108 FMAs) against 24 values of g / v moved through device memory (read
// g, write y, read y, write v: ~50 MB at the flagship level-1 shape).  The
// factors are small (n_int * C * 3 * 36 values, <1 MB) and stay in L1/L2,
// but a warp's threads read them 144 bytes apart, so every factor load
// touches 32 sectors: the kernel is bound by that L1 traffic, not by
// device memory (95 us at B = 360, n_int = 7, C = 204 on an H100 80GB HBM3
// at 700 W).  The point of this first design is that one launch replaces
// the ~4 n_int launches of the plain level loop; coalesced factor tiles
// are the next step.
//
// Numerics.  Plain FMAs in a fixed order in the input type (float or
// double), no atomics and no tensor cores: a launch is bit-repeatable and
// there is no TF32.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

// out = A x for a row-major 6x6 block A (read-only cache), fixed order
template <typename T>
__device__ __forceinline__ void matvec6(const T* __restrict__ A,
                                        const T (&x)[6], T (&out)[6]) {
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < 6; ++k) acc = fma(__ldg(A + r * 6 + k), x[k], acc);
    out[r] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
chain_sweep_kernel(const T* __restrict__ Dinv,     // [n_int, C, 6, 6]
                   const T* __restrict__ DinvL,    // [n_int, C, 6, 6]
                   const T* __restrict__ Cprime,   // [n_int, C, 6, 6]
                   const T* __restrict__ g,        // [B, n_int, C, 6]
                   const T* __restrict__ B0,       // [C, 6, 6]
                   const T* __restrict__ Cn,       // [C, 6, 6]
                   int B, int n_int, int C,
                   T* __restrict__ v,              // [B, n_int, C, 6]
                   T* __restrict__ fI,             // [B, C, 6]
                   T* __restrict__ fJ) {           // [B, C, 6]
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)B * C) return;
  const int b = (int)(i / C);
  const int c = (int)(i % C);
  const size_t level = (size_t)C * 6;              // g / v stride of a level
  const T* gb = g + (size_t)b * n_int * level + (size_t)c * 6;
  T* vb = v + (size_t)b * n_int * level + (size_t)c * 6;

  // forward sweep: y_l = Dinv_l g_l - DinvL_l y_{l-1}
  T y[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  for (int l = 0; l < n_int; ++l) {
    const size_t f = ((size_t)l * C + c) * 36;
    T gl[6], a[6], s[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) gl[k] = __ldg(gb + l * level + k);
    matvec6(Dinv + f, gl, a);
    matvec6(DinvL + f, y, s);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      y[k] = a[k] - s[k];
      vb[l * level + k] = y[k];
    }
  }

  // backward substitution: v_l = y_l - C'_l v_{l+1}
  T vn[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  T v_last[6];
  for (int l = n_int - 1; l >= 0; --l) {
    const size_t f = ((size_t)l * C + c) * 36;
    T s[6];
    matvec6(Cprime + f, vn, s);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      vn[k] = vb[l * level + k] - s[k];
      vb[l * level + k] = vn[k];
    }
    if (l == n_int - 1) {
#pragma unroll
      for (int k = 0; k < 6; ++k) v_last[k] = vn[k];
    }
  }

  // interface extras: fI = -B0 v_0, fJ = -Cn v_{n_int-1}
  T a[6], s[6];
  matvec6(B0 + (size_t)c * 36, vn, a);
  matvec6(Cn + (size_t)c * 36, v_last, s);
  const size_t o = ((size_t)b * C + c) * 6;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    fI[o + k] = -a[k];
    fJ[o + k] = -s[k];
  }
}

template <typename T>
int launch(const T* Dinv, const T* DinvL, const T* Cprime, const T* g,
           const T* B0, const T* Cn, int B, int n_int, int C, T* v, T* fI,
           T* fJ, void* stream) {
  if (B <= 0 || n_int <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * C;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  chain_sweep_kernel<T><<<blocks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      Dinv, DinvL, Cprime, g, B0, Cn, B, n_int, C, v, fI, fJ);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the sweep on ``stream``.  All pointers are device memory of one
// type, contiguous in the shapes noted at the kernel; returns the CUDA
// error code (0 on success).
int chain_sweep_launch_f32(const float* Dinv, const float* DinvL,
                           const float* Cprime, const float* g,
                           const float* B0, const float* Cn, int B,
                           int n_int, int C, float* v, float* fI, float* fJ,
                           void* stream) {
  return launch<float>(Dinv, DinvL, Cprime, g, B0, Cn, B, n_int, C, v, fI,
                       fJ, stream);
}

int chain_sweep_launch_f64(const double* Dinv, const double* DinvL,
                           const double* Cprime, const double* g,
                           const double* B0, const double* Cn, int B,
                           int n_int, int C, double* v, double* fI,
                           double* fJ, void* stream) {
  return launch<double>(Dinv, DinvL, Cprime, g, B0, Cn, B, n_int, C, v, fI,
                        fJ, stream);
}

const char* chain_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
