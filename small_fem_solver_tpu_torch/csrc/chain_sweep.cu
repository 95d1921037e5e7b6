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
// of the JAX lax.scan pair in small_fem_solver_tpu/ops/condense.py).  Two
// forms, picked by the launch from the shapes alone (chain_sweep_narrow_rhs):
// the wide form for B >= NARROW_B right-hand sides, the narrow form below.
//
// Wide form.  A block owns a tile of LANES = 32 right-hand sides b (one per
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
// Narrow form (chain_sweep_narrow_kernel).  With few right-hand sides the
// wide form leaves most lanes idle, and on deep chains its untiled variant
// puts a device-memory round trip on every dependent step (~1.9 us a
// level at depth 326 in f64 on an H100).  Here a block is one chain, a
// group of rg <= 5 right-hand sides and three warps.  In the consumer warp
// lane (r, bb) = 6 bb + r computes row r of the 6x6 products for
// right-hand side bb; the carry (y_{l-1}, v_{l+1}) is exchanged through a
// double-buffered row in shared memory (one warp barrier a level), so only
// the carry's dependent chain (the exchange, six FMAs and a subtraction)
// is on the critical path, and each level's operands are read two levels
// ahead in a loop unrolled four times.  What does not depend on the carry
// arrives through a RING-deep ring of stages in shared memory (per forward
// level Dinv_l, DinvL_l and g_l, per backward level C'_l, one sequence, so
// the backward pass's first factors arrive while the forward pass ends),
// filled with cp.async by NARROW_PRODUCERS producer warps in groups of
// NARROW_UNROLL levels: a group's full mbarrier completes when its copies
// land (cp.async.mbarrier.arrive), its empty one when the consumer has
// read it.  (Issuing the copies from the consumer warp cost about 0.1 us a
// level on an H100, and __shfl_sync in a loop not unrolled about 0.05 us
// more.)  y_l stays in shared memory for the backward pass: rg
// shrinks until the ring and y fit NARROW_BUDGET, two blocks an SM; past
// ~1,800 levels in f64 the wide form runs.  Grid (C, ceil(B / rg)): 153
// blocks at the 99,882-DOF nested level 1 (B 1), 204 for its chain-mode
// iteration (B 18, 51 chains).
//
// Bounds.  Per (b, c) and level three 6x6 mat-vecs (108 FMAs) against 12
// values of g and v moved through device memory once: at the flagship
// nested level 1 (B 360, n_int 7, C 204, f32) 12.3 MB of g in, 12.3 MB of
// v and 3.5 MB of fI / fJ out, ~29 MB, ~8.6 us at 3.35 TB/s; the arithmetic
// (1.2e8 FLOP) is ~2 us.  The wide form is bound by bytes.  The narrow form
// at B 1 moves mostly factors (16 MB at the 99,882-DOF level 1, 4.8 us)
// but is held by its 2 n_int dependent steps: its floor is 2 n_int times
// the latency of one step, ~0.11 us in f64 on an H100 at 700 W, so ~25 us
// at that level 1 and ~72 us for the chain-mode iteration's 326 levels
// (chip_smoke.py's narrow sweep phase measures both bounds).
//
// Numerics.  Plain FMAs in a fixed order in the input type (float or
// double), no atomics and no tensor cores: a launch is bit-repeatable and
// there is no TF32.  The tiled and untiled forms do the same arithmetic,
// and each lane of the narrow form computes its row in matvec6's order, so
// column b of a narrow launch is bit-equal to column b of a wide launch on
// the same factors.
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;          // right-hand sides per block
constexpr int PAD = LANES + 1;     // shared tile row: conflict-free both ways
constexpr int MAX_CHAINS = 8;      // chains per block (warps)
constexpr size_t TILE_BUDGET = 80 * 1024;
constexpr int NARROW_B = 32;       // narrower batches take the narrow form
constexpr int NARROW_RHS = 5;      // right-hand sides a narrow warp (6 lanes)
constexpr int RING = 32;           // levels in flight in the narrow ring
constexpr int NARROW_UNROLL = 8;   // levels a ring group
constexpr int NARROW_GROUPS = RING / NARROW_UNROLL;   // groups in the ring
constexpr int NARROW_PRODUCERS = 2;   // warps that fill the ring
constexpr size_t NARROW_BUDGET = 111 * 1024;   // two narrow blocks an SM

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

// Shared-memory mbarriers (the narrow form's ring): init with an arrival
// count; arrive when this thread's earlier cp.async copies have landed
// (noinc: counted in the init count); arrive; wait for the phase of the
// given parity to complete.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  unsigned long long state;
  asm volatile("mbarrier.arrive.shared.b64 %0, [%1];\n"
               : "=l"(state) : "r"(smem_addr(bar)) : "memory");
  (void)state;
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
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

// Narrow form: a ring stage holds one forward level's Dinv, DinvL (36 values
// each) and the group's g_l (6 rg), or one backward level's C' (36, in
// DinvL's place), padded to 16 bytes; y_l of the group's right-hand sides
// follows the ring.
template <typename T>
__host__ __device__ constexpr int stage_elems(int rg) {
  return (72 + 6 * rg + 16 / (int)sizeof(T) - 1) / (16 / (int)sizeof(T))
         * (16 / (int)sizeof(T));
}

template <typename T>
size_t narrow_bytes(int rg, int n_int) {
  return sizeof(T) * ((size_t)RING * stage_elems<T>(rg)
                      + (size_t)n_int * 6 * rg)
         + 2 * sizeof(unsigned long long) * NARROW_GROUPS;
}

// Right-hand sides a narrow warp takes for (B, n_int): 0 for the wide form
// (B >= NARROW_B, or no group's y fits NARROW_BUDGET).
template <typename T>
int narrow_rhs(int B, int n_int) {
  if (B >= NARROW_B) return 0;
  int rg = B < NARROW_RHS ? B : NARROW_RHS;
  while (rg > 0 && narrow_bytes<T>(rg, n_int) > NARROW_BUDGET) --rg;
  return rg;
}

template <typename T>
__global__ void __launch_bounds__(32 * (1 + NARROW_PRODUCERS))
chain_sweep_narrow_kernel(const SweepArgs<T> a, int rg) {
  using P2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = 16 / sizeof(T), NP = 36 / P;   // 16-byte pieces a block
  constexpr int U = NARROW_UNROLL, NG = NARROW_GROUPS;
  const int SW = stage_elems<T>(rg), YW = 6 * rg;
  T* ring = reinterpret_cast<T*>(smem_raw);        // [RING][SW]
  T* ys = ring + (size_t)RING * SW;                // [n_int][6 rg]
  // per ring group: full (its copies landed), empty (the consumer read it)
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(ys + (size_t)a.n_int * YW);
  unsigned long long* empty = full + NG;
  const int n_int = a.n_int, C = a.C, c = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = lane % 6, bb = lane / 6;
  const int b0 = blockIdx.y * rg, nb = min(rg, a.B - b0);
  const bool live = bb < nb;
  // dead lanes (bb >= nb, lanes >= 6 rg) read inside the group's slots
  const int bc = min(bb, rg - 1), yl = min(lane, YW - 1);
  const int stages = 2 * n_int, groups = (stages + U - 1) / U;
  auto slot = [&](int t) { return ring + (size_t)(t & (RING - 1)) * SW; };
  if (threadIdx.x < NG) {
    mbar_init(full + threadIdx.x, 32);
    mbar_init(empty + threadIdx.x, 32);
  }
  __syncthreads();

  if (warp > 0) {
    // ---- producer warps: group k goes to warp 1 + k % NARROW_PRODUCERS.
    // Stage t = forward level t (t < n_int): Dinv_t at 0, DinvL_t at 36,
    // g_t at 72; backward level 2 n_int - 1 - t: C' at 36.  A level's 2 NP
    // 16-byte pieces of Dinv | DinvL go to lanes e and e + 32 (f64: lanes
    // 0-3 take two), C''s NP pieces to lanes e < NP, g's element of
    // (right-hand side bb, row r) to lane 6 bb + r.  A group's full
    // barrier completes when the copies of its 32 lanes have landed.
    const size_t lvl = (size_t)C * 36;
    const T* f0 = (lane < NP ? a.Dinv + lane * P : a.DinvL + (lane - NP) * P)
                  + (size_t)c * 36;
    const T* f1 = a.DinvL + (lane + 32 - NP) * P + (size_t)c * 36;
    const T* fc = a.Cprime + lane * P + (size_t)c * 36;
    const bool has0 = lane < 2 * NP, has1 = lane + 32 < 2 * NP,
               hasc = lane < NP;
    const T* gl = a.g + (long long)(b0 + bc) * a.sb + (c / a.Q) * a.sm
                  + (c % a.Q) * a.sq + r;
    for (int k = warp - 1; k < groups; k += NARROW_PRODUCERS) {
      // group k reuses the slots of group k - NG once they are read
      if (k >= NG) mbar_wait(empty + k % NG, (k / NG - 1) & 1);
      for (int t = k * U; t < k * U + U && t < stages; ++t) {
        T* st = slot(t);
        if (t < n_int) {
          if (has0) cp_async16(st + lane * P, f0 + t * lvl);
          if (has1) cp_async16(st + (lane + 32) * P, f1 + t * lvl);
          if (live) cp_async(st + 72 + lane, gl + t * a.sl);
        } else if (hasc) {
          cp_async16(st + 36 + lane * P, fc + (stages - 1 - t) * lvl);
        }
      }
      mbar_arrive_copies(full + k % NG);
    }
    cp_async_wait_all();
    return;
  }

  // ---- consumer warp ----
  // a stage's operands of this lane, loaded two levels ahead of their use:
  // its carry row (DinvL_l or C'_l) and, for a forward level, its row of
  // Dinv_l and its right-hand side's g_l, in pairs
  struct Raw {
    P2 row[3], d[3], g[3];
  };
  auto load_row = [&](int t, Raw& w) {
    const P2* rp = reinterpret_cast<const P2*>(slot(t) + 36 + 6 * r);
#pragma unroll
    for (int h = 0; h < 3; ++h) w.row[h] = rp[h];
  };
  auto load = [&](int t, Raw& w) {
    load_row(t, w);
    const T* st = slot(t);
    const P2* dp = reinterpret_cast<const P2*>(st + 6 * r);
    const P2* gp = reinterpret_cast<const P2*>(st + 72 + 6 * bc);
#pragma unroll
    for (int h = 0; h < 3; ++h) {
      w.d[h] = dp[h];
      w.g[h] = gp[h];
    }
  };
  // the carry row and (Dinv_l g_l)_r in matvec6's order
  auto finish = [&](const Raw& w, T& av, T (&row)[6]) {
    T acc = T(0);
#pragma unroll
    for (int h = 0; h < 3; ++h) {
      row[2 * h] = w.row[h].x;
      row[2 * h + 1] = w.row[h].y;
      acc = fma(w.d[h].x, w.g[h].x, acc);
      acc = fma(w.d[h].y, w.g[h].y, acc);
    }
    av = acc;
  };
  // row r of A x, x gathered from the 6 lanes of this right-hand side
  // through a double-buffered exchange row in shared memory (one warp
  // barrier a level; the buffer written next was read before the last
  // barrier).  On an H100 this was faster than six __shfl_sync.
  __shared__ __align__(16) T xch[2][32];
  int xp = 0;
  auto carry_row = [&](const T (&A)[6], T x) {
    xch[xp][lane] = x;
    __syncwarp();
    const P2* q = reinterpret_cast<const P2*>(&xch[xp][6 * bc]);
    const P2 q0 = q[0], q1 = q[1], q2 = q[2];
    const T xs[6] = {q0.x, q0.y, q1.x, q1.y, q2.x, q2.y};
    xp ^= 1;
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < 6; ++k) acc = fma(A[k], xs[k], acc);
    return acc;
  };
  // at the first stage of group k: group k - 1 is read (release its
  // slots), and group k + 1 must have landed (stages are read two ahead)
  auto group = [&](int t) {
    const int k = t / U;
    if (k >= 1) mbar_arrive(empty + (k - 1) % NG);
    if (k + 1 < groups) mbar_wait(full + (k + 1) % NG, ((k + 1) / NG) & 1);
  };

  // B0 and Cn of the chain, used at the end (in shared memory, so that
  // no register holds them through the levels)
  __shared__ __align__(16) T ends[72];
  for (int e = lane; e < 72; e += 32)
    ends[e] = __ldg((e < 36 ? a.B0 + e : a.Cn + e - 36) + (size_t)c * 36);
  mbar_wait(full, 0);
  T av, row[6];
  Raw w1;
  load(0, w1);
  finish(w1, av, row);
  load(1, w1);

  // forward sweep: y_l = Dinv_l g_l - DinvL_l y_{l-1} (stage t = l); x is
  // this lane's row of the carry
  T x = T(0);
  T* const y_out = ys + lane;
  const T* const y_in = ys + yl;
#pragma unroll 4
  for (int l = 0; l < n_int; ++l) {
    if ((l & (U - 1)) == 0) group(l);
    Raw w2;
    load(l + 2, w2);
    T av1, row1[6];
    finish(w1, av1, row1);
    x = av - carry_row(row, x);
    if (lane < YW) y_out[(size_t)l * YW] = x;
    av = av1;
#pragma unroll
    for (int k = 0; k < 6; ++k) row[k] = row1[k];
    w1 = w2;
  }

  // backward substitution: v_l = y_l - C'_l v_{l+1} (stage t = 2 n_int -
  // 1 - l); y_l read a level ahead too
  const size_t C6 = (size_t)C * 6;
  T* const vp = a.v + ((size_t)(b0 + bc) * n_int * C + c) * 6 + r;
  T v_last = T(0), y_l = y_in[(size_t)(n_int - 1) * YW];
  x = T(0);
#pragma unroll 4
  for (int l = n_int - 1; l >= 0; --l) {
    const int t = stages - 1 - l;
    if ((t & (U - 1)) == 0) group(t);
    Raw w2;
    load_row(t + 2, w2);
    const T y_next = y_in[(size_t)max(l - 1, 0) * YW];
    x = y_l - carry_row(row, x);
    if (live) vp[l * C6] = x;
    if (l == n_int - 1) v_last = x;
#pragma unroll
    for (int h = 0; h < 3; ++h) {
      row[2 * h] = w1.row[h].x;
      row[2 * h + 1] = w1.row[h].y;
    }
    w1 = w2;
    y_l = y_next;
  }

  // interface extras: fI = -B0 v_0, fJ = -Cn v_{n_int-1}
  T e0[6], e1[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    e0[k] = ends[r * 6 + k];
    e1[k] = ends[36 + r * 6 + k];
  }
  const T fi = carry_row(e0, x), fj = carry_row(e1, v_last);
  if (live) {
    const size_t o = ((size_t)(b0 + bb) * C + c) * 6 + r;
    a.fI[o] = -fi;
    a.fJ[o] = -fj;
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
  const int rg = narrow_rhs<T>(a.B, a.n_int);
  if (rg > 0) {
    const size_t smem = narrow_bytes<T>(rg, a.n_int);
    err = cudaFuncSetAttribute(chain_sweep_narrow_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)a.C, (unsigned)((a.B + rg - 1) / rg));
    chain_sweep_narrow_kernel<T>
        <<<grid, 32 * (1 + NARROW_PRODUCERS), smem, st>>>(a, rg);
    return (int)cudaGetLastError();
  }
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

// Chains per block the wide form takes for (n_int, element size): the
// wrapper and the tests read the tiling from here.  0: the untiled form.
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

// Right-hand sides a warp of the narrow form takes for (B, n_int, element
// size), the launch's form rule: 0 means the wide form.
int chain_sweep_narrow_rhs(int B, int n_int, int elem_bytes) {
  return elem_bytes == 4 ? narrow_rhs<float>(B, n_int)
                         : narrow_rhs<double>(B, n_int);
}

const char* chain_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
