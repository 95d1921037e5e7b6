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
// Layout.  A block owns a tile of LANES = 32 right-hand sides b (one per
// lane) x Ct chains c (one per warp).  All lanes of a warp sweep the same
// chain, so every factor read is a shared-memory broadcast.  The block
// stages its chains' factors of every level (each level's Ct x 36 values of
// Dinv, DinvL and C' are contiguous in [n_int, C, 6, 6]) and its whole g
// tile [32, n_int, Ct, 6] into shared memory with cp.async, sweeps with the
// carry in registers and y_l held in the g slot it replaces, overwrites it
// with v_l, then writes the v tile and the fI / fJ tiles back in runs of
// Ct x 6 values per (b, l).  v is written once and g is read once.
//
// g is read through element strides (b, l, m, q) with the chain index split
// as c = m Q + q, so a strided caller layout (the nested level-1 view of the
// chain-position loads, or the transposed chain layout of the scan) needs no
// copy; the tile loads walk the levels innermost when they are the
// contiguous axis.  Ct is the largest of 8, 4, 2, 1 whose tile fits in
// 80 KB of shared memory (two or more blocks per SM); when even one chain
// does not fit (n_int beyond ~190 in f32, ~95 in f64) the same kernel runs
// without the tile: each thread keeps y_l in v in device memory and reads
// its factors through the cache.
//
// Bounds.  Per (b, c) and level the thread does three 6x6 mat-vecs
// (108 FMAs) against 12 values of g and v moved through device memory once:
// at the flagship nested level 1 (B 360, n_int 7, C 204, f32) 12.3 MB of g
// in, 12.3 MB of v and 3.5 MB of fI / fJ out, ~29 MB, ~8.6 us at 3.35 TB/s;
// the arithmetic (1.2e8 FLOP) is ~2 us.  The kernel is bound by bytes.
//
// Numerics.  Plain FMAs in a fixed order in the input type (float or
// double), no atomics and no tensor cores: a launch is bit-repeatable and
// there is no TF32.  The tiled and untiled forms do the same arithmetic.
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;          // right-hand sides per block
constexpr int PAD = LANES + 1;     // shared tile row: conflict-free both ways
constexpr int MAX_CHAINS = 8;      // chains per block (warps)
constexpr size_t TILE_BUDGET = 80 * 1024;

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

template <typename T>
struct SweepArgs {
  const T* Dinv;      // [n_int, C, 6, 6]
  const T* DinvL;     // [n_int, C, 6, 6]
  const T* Cprime;    // [n_int, C, 6, 6]
  const T* B0;        // [C, 6, 6]
  const T* Cn;        // [C, 6, 6]
  const T* g;         // element (b, l, c = m Q + q, k) at
                      // b sb + l sl + m sm + q sq + k
  long long sb, sl, sm, sq;
  int Q, B, n_int, C, levels_inner;
  T* v;               // [B, n_int, C, 6]
  T* fI;              // [B, C, 6]
  T* fJ;              // [B, C, 6]
};

// out = A x for a row-major 6x6 block A (8- or 16-byte aligned), fixed order
template <typename T>
__device__ __forceinline__ void matvec6(const T* A, const T (&x)[6],
                                        T (&out)[6]) {
  using P = typename Pair<T>::type;
  const P* Ap = reinterpret_cast<const P*>(A);
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    T acc = T(0);
#pragma unroll
    for (int h = 0; h < 3; ++h) {
      const P a = Ap[r * 3 + h];
      acc = fma(a.x, x[2 * h], acc);
      acc = fma(a.y, x[2 * h + 1], acc);
    }
    out[r] = acc;
  }
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T>
size_t tile_bytes(int Ct, int n_int) {
  const int levels = n_int > 2 ? n_int : 2;   // fI / fJ reuse slots 0, 1
  return sizeof(T) * ((size_t)n_int * Ct * 108 + (size_t)Ct * 72
                      + (size_t)levels * Ct * 6 * PAD);
}

template <typename T, bool TILED>
__global__ void __launch_bounds__(LANES * MAX_CHAINS)
chain_sweep_kernel(const SweepArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Ct = blockDim.y, n_int = a.n_int, C = a.C;
  T* fac = reinterpret_cast<T*>(smem_raw);            // [n_int][Ct][3][36]
  T* ends = fac + (size_t)n_int * Ct * 108;            // [Ct][2][36]
  T* buf = ends + (size_t)Ct * 72;                     // [lv][Ct][6][PAD]
  const int lane = threadIdx.x, cw = threadIdx.y;
  const int tid = cw * LANES + lane, nthreads = Ct * LANES;
  const int b0 = blockIdx.x * LANES, c0 = blockIdx.y * Ct;
  const int nb = min(LANES, a.B - b0), nc = min(Ct, C - c0);
  auto slot = [&](int l, int k) -> T& {
    return buf[((size_t)(l * Ct + cw) * 6 + k) * PAD + lane];
  };

  // this lane's (at most two) positions e in a row of the tile's nc
  // chains x 6 values: source offset of g (chain c = m Q + q) and slot
  const int row = nc * 6;
  long long g_off[2];
  int s_off[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int e = lane + p * LANES, cc = e / 6, k = e % 6, c = c0 + cc;
    g_off[p] = (c / a.Q) * a.sm + (c % a.Q) * a.sq + k;
    s_off[p] = (cc * 6 + k) * PAD;
  }

  if constexpr (TILED) {
    // factors: per (level, matrix) the tile's nc x 36 values are contiguous
    for (int l = 0; l < n_int; ++l) {
#pragma unroll
      for (int mat = 0; mat < 3; ++mat) {
        const T* src = (mat == 0 ? a.Dinv : (mat == 1 ? a.DinvL : a.Cprime))
                       + ((size_t)l * C + c0) * 36;
        T* dst = fac + (size_t)l * Ct * 108 + mat * 36;
        for (int e = tid; e < nc * 36; e += nthreads)
          cp_async(dst + (e / 36) * 108 + e % 36, src + e);
      }
    }
#pragma unroll
    for (int mat = 0; mat < 2; ++mat) {
      const T* src = (mat == 0 ? a.B0 : a.Cn) + (size_t)c0 * 36;
      for (int e = tid; e < nc * 36; e += nthreads)
        cp_async(ends + (e / 36) * 72 + mat * 36 + e % 36, src + e);
    }
    // g tile: one warp per right-hand side at a time
    if (a.levels_inner) {
      // the scan's chain layout (and its nested level-1 view): a chain's
      // n_int x 6 values are contiguous
      for (int bb = cw; bb < nb; bb += Ct)
        for (int cc = 0; cc < nc; ++cc) {
          const int c = c0 + cc;
          const T* src = a.g + (b0 + bb) * a.sb + (c / a.Q) * a.sm
                         + (c % a.Q) * a.sq;
          for (int e = lane; e < n_int * 6; e += LANES) {
            const int l = e / 6, k = e % 6;
            cp_async(buf + ((size_t)(l * Ct + cc) * 6 + k) * PAD + bb,
                     src + l * a.sl + k);
          }
        }
    } else {
      // per (b, l) a row of nc chains x 6 values
      for (int bb = cw; bb < nb; bb += Ct)
        for (int l = 0; l < n_int; ++l) {
          const T* src = a.g + (b0 + bb) * a.sb + l * a.sl;
          T* dst = buf + (size_t)l * Ct * 6 * PAD + bb;
#pragma unroll
          for (int p = 0; p < 2; ++p)
            if (lane + p * LANES < row)
              cp_async(dst + s_off[p], src + g_off[p]);
        }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  T fi[6], fj[6];
  if (lane < nb && cw < nc) {
    const int b = b0 + lane, c = c0 + cw;
    const T* gb = a.g + b * a.sb + (c / a.Q) * a.sm + (c % a.Q) * a.sq;
    T* vb = a.v + ((size_t)b * n_int * C + c) * 6;
    const size_t level = (size_t)C * 6;

    // forward sweep: y_l = Dinv_l g_l - DinvL_l y_{l-1}
    T y[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
    for (int l = 0; l < n_int; ++l) {
      const T *Fd, *Fl;
      T gl[6], av[6], sv[6];
      if constexpr (TILED) {
        Fd = fac + (size_t)(l * Ct + cw) * 108;
        Fl = Fd + 36;
#pragma unroll
        for (int k = 0; k < 6; ++k) gl[k] = slot(l, k);
      } else {
        Fd = a.Dinv + ((size_t)l * C + c) * 36;
        Fl = a.DinvL + ((size_t)l * C + c) * 36;
#pragma unroll
        for (int k = 0; k < 6; ++k) gl[k] = gb[l * a.sl + k];
      }
      matvec6(Fd, gl, av);
      matvec6(Fl, y, sv);
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        y[k] = av[k] - sv[k];
        if constexpr (TILED) slot(l, k) = y[k];
        else vb[l * level + k] = y[k];
      }
    }

    // backward substitution: v_l = y_l - C'_l v_{l+1}
    T vn[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
    T v_last[6];
    for (int l = n_int - 1; l >= 0; --l) {
      const T* Fc = TILED ? fac + (size_t)(l * Ct + cw) * 108 + 72
                          : a.Cprime + ((size_t)l * C + c) * 36;
      T sv[6];
      matvec6(Fc, vn, sv);
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        if constexpr (TILED) {
          vn[k] = slot(l, k) - sv[k];
          slot(l, k) = vn[k];
        } else {
          vn[k] = vb[l * level + k] - sv[k];
          vb[l * level + k] = vn[k];
        }
      }
      if (l == n_int - 1) {
#pragma unroll
        for (int k = 0; k < 6; ++k) v_last[k] = vn[k];
      }
    }

    // interface extras: fI = -B0 v_0, fJ = -Cn v_{n_int-1}
    const T* E0 = TILED ? ends + (size_t)cw * 72 : a.B0 + (size_t)c * 36;
    const T* E1 = TILED ? E0 + 36 : a.Cn + (size_t)c * 36;
    matvec6(E0, vn, fi);
    matvec6(E1, v_last, fj);
    if constexpr (!TILED) {
      const size_t o = ((size_t)b * C + c) * 6;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        a.fI[o + k] = -fi[k];
        a.fJ[o + k] = -fj[k];
      }
    }
  }

  if constexpr (TILED) {
    // v tile to device memory: runs of nc x 6 values per (b, l)
    __syncthreads();
    for (int bb = cw; bb < nb; bb += Ct)
      for (int l = 0; l < n_int; ++l) {
        T* dst = a.v + (((size_t)(b0 + bb) * n_int + l) * C + c0) * 6;
        const T* src = buf + (size_t)l * Ct * 6 * PAD + bb;
#pragma unroll
        for (int p = 0; p < 2; ++p)
          if (lane + p * LANES < row) dst[lane + p * LANES] = src[s_off[p]];
      }
    __syncthreads();
    if (lane < nb && cw < nc) {
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        slot(0, k) = -fi[k];
        slot(1, k) = -fj[k];
      }
    }
    __syncthreads();
    for (int bb = cw; bb < nb; bb += Ct) {
      const size_t o = ((size_t)(b0 + bb) * C + c0) * 6;
#pragma unroll
      for (int p = 0; p < 2; ++p)
        if (lane + p * LANES < row) {
          a.fI[o + lane + p * LANES] = buf[s_off[p] + bb];
          a.fJ[o + lane + p * LANES] =
              buf[(size_t)Ct * 6 * PAD + s_off[p] + bb];
        }
    }
  }
}

template <typename T>
int launch(const SweepArgs<T>& a, void* stream) {
  if (a.B <= 0 || a.n_int <= 0 || a.C <= 0 || a.Q <= 0 || a.C % a.Q != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  int Ct = MAX_CHAINS;
  while (Ct > 1 && tile_bytes<T>(Ct, a.n_int) > TILE_BUDGET) Ct /= 2;
  const size_t smem = tile_bytes<T>(Ct, a.n_int);
  const unsigned rhs_tiles = (unsigned)((a.B + LANES - 1) / LANES);
  if (smem <= (size_t)optin) {
    err = cudaFuncSetAttribute(chain_sweep_kernel<T, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(rhs_tiles, (unsigned)((a.C + Ct - 1) / Ct));
    chain_sweep_kernel<T, true><<<grid, dim3(LANES, Ct), smem, st>>>(a);
  } else {
    const dim3 grid(rhs_tiles,
                    (unsigned)((a.C + MAX_CHAINS - 1) / MAX_CHAINS));
    chain_sweep_kernel<T, false><<<grid, dim3(LANES, MAX_CHAINS), 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the sweep on ``stream``.  Factors and outputs are contiguous device
// memory of one type in the shapes noted at SweepArgs; g is read at element
// (b, l, c = m Q + q, k) -> g + b sb + l sl + m sm + q sq + k (levels_inner:
// the tile loads walk l before c).  Returns the CUDA error code (0 on
// success).
int chain_sweep_launch_f32(const float* Dinv, const float* DinvL,
                           const float* Cprime, const float* B0,
                           const float* Cn, const float* g, long long sb,
                           long long sl, long long sm, long long sq, int Q,
                           int B, int n_int, int C, int levels_inner,
                           float* v, float* fI, float* fJ, void* stream) {
  const SweepArgs<float> a{Dinv, DinvL, Cprime, B0, Cn, g, sb, sl, sm, sq,
                           Q, B, n_int, C, levels_inner, v, fI, fJ};
  return launch(a, stream);
}

int chain_sweep_launch_f64(const double* Dinv, const double* DinvL,
                           const double* Cprime, const double* B0,
                           const double* Cn, const double* g, long long sb,
                           long long sl, long long sm, long long sq, int Q,
                           int B, int n_int, int C, int levels_inner,
                           double* v, double* fI, double* fJ, void* stream) {
  const SweepArgs<double> a{Dinv, DinvL, Cprime, B0, Cn, g, sb, sl, sm, sq,
                            Q, B, n_int, C, levels_inner, v, fI, fJ};
  return launch(a, stream);
}

// Chains per block the launch picks for (n_int, element size): the wrapper
// and the tests read the tiling from here.  0: the untiled form.
int chain_sweep_chains_per_block(int n_int, int elem_bytes) {
  int Ct = MAX_CHAINS;
  const auto bytes = [&](int ct) {
    return elem_bytes == 4 ? tile_bytes<float>(ct, n_int)
                           : tile_bytes<double>(ct, n_int);
  };
  while (Ct > 1 && bytes(Ct) > TILE_BUDGET) Ct /= 2;
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return bytes(Ct) <= (size_t)optin ? Ct : 0;
}

const char* chain_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
