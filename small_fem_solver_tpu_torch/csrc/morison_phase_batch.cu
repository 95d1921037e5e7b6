// Fused phase-batch Morison loads for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel small_fem_solver_tpu/ops/pallas_kernels.py
// (morison_phase_batch_pallas, body _make_kernel._kernel).  Computes what
// ops/morison.py::morison_phase_batch computes, for every wave phase s and
// quadrature point q of every member m:
//
//   1. the five kinematic fields (eta, u along the wave heading, w, du/dt,
//      dw/dt) as sums over the N Fourier modes of spatial factors
//      cos/sin(j k x), U_j C_j(z), U_j S_j(z) times phase factors
//      cos/sin(j omega t_s);
//   2. optionally the frozen-stretch Wheeler correction (second-order Taylor
//      of each field about z with dz = -(z + d) eta / (d + eta), clipped to
//      +-d) from the d/dz and d^2/dz^2 fields of the same mode sums;
//   3. the submergence mask z <= eta, the projection normal to the member
//      axis, drag cd |u_n| u_n (gated at |u_n| > 1e-10) and inertia ci a_n;
//   4. the lever-rule sums over each member's points into the node-1 /
//      node-2 end forces F1 = sum (1 - s_q) f, F2 = sum s_q f, plus
//      per-phase drag and inertia totals.
//
// Operands.  The kernel takes the member arrays as the model holds them
// (coords, conn, D), Cd / Cm and the scalars (headings, rho, power-law
// exponent) each as a device pointer or a value, the wave's E, U, k, omega,
// d, U_c as device pointers, the phase times and the Gauss rule (by value).
// Its prologue builds each member's axis and per-point elevation, wave-frame
// x, current and drag / inertia coefficients, then the spatial factors of
// every (point, mode) into shared memory, so the wrapper issues no device
// work besides the output allocations.
//
// Layout.  Phases run on the lanes: a thread owns two phases (s and
// s + 192 of a 384-phase tile, which holds the flagship's 360).  Persistent
// blocks (two per SM) walk the members one at a time.  For every (point,
// mode) all lanes of the block read the same record cos(jkx), sin(jkx),
// U_j C_j, U_j S_j (one LDS.128) and (E_j, j omega) (one LDS.64):
// broadcasts, 24 bytes a lane, feeding ~28 FP32 instructions over the two
// phases.  Each phase's cos/sin(j omega t) come from cos/sin(omega t)
// (sincosf once per block) by angle addition along the mode loop (4 FP32
// instructions a mode; its rounding grows with j, ~1e-6 relative at 32
// modes), which keeps a thread within 168 registers: tables of
// cos/sin(j omega t) in registers (4 NMAX of them) spill there.  The modes
// are zero-padded to a multiple of 4 (NMAX), so the unrolled mode loop has
// no branch and its loads issue ahead of the arithmetic (a branch per mode
// ends a basic block and each mode then waits for its own loads).  Shared
// memory delivers 128 bytes of lane data a clock, whatever the broadcast,
// so one phase a thread with 32-byte records would be bound by it above
// the FP32 time; two phases a thread halve the bytes per FMA.  The lever-rule
// sums, the drag and inertia sums and the per-phase totals are register
// accumulators (F1 = sum f - F2): no shuffles, no float atomics and no
// barrier inside a member.  Each thread writes its phases' F1 / F2 rows
// (3 values a phase and member) itself: a staged tile would not lengthen
// the runs along m, which one member per work item fixes at 3.
//
// Bounds.  The function is 2 x 2N x 5 FLOP per (phase, point) for the mode
// sums plus ~60 for the epilogue: 3.7 GFLOP at the flagship shapes (S 360,
// M 1632, Q 15, N 18), 55 us at the H100's 67 TFLOP/s of FP32; device
// memory sees the 14 MB of F1 / F2 (~4 us).  The kernel issues ~14 FP32
// instructions per (phase, point, mode) with the padding and the angle
// addition, so its own floor is ~95 us; it measured ~150 us (H100 80GB
// HBM3, 700 W), 12 warps an SM hiding the shared-load latency.
// Every sum is plain f32 in registers (no tensor cores, no TF32).
//
// Totals.  Each block accumulates per-phase drag / inertia sums over the
// members it walks, in order, and writes them once [G, S, 6]; a second
// kernel adds the blocks in a fixed order.  The grid depends only on the
// card and the shapes: results are bit-repeatable.
//
// Float64.  morison_phase_batch_f64_kernel computes the same function in
// double precision for float64 models (the dense design envelope and the
// dynamics loads, which the JAX package evaluates in the model's dtype).
// It is the simple form: one phase a thread, 64 phases a block, each block
// walking a fixed stride of members, its records built per member in
// shared memory as above and cos / sin (j omega t) by angle addition
// (rounding ~j eps in float64).  Bound at the flagship shapes: 3.7 GFLOP
// over the H100's 34 TFLOP/s of FP64, ~109 us.  The float32 kernel above
// is not touched by it.
//
// Random seas.  morison_sea_kernel (float32 and float64, at the end of the
// file) computes the function for a general mode set (independent k_i,
// omega_i, phi_i, optional per-mode headings, any N), reading the phase
// factors from a table the wrapper builds; the harmonic kernels above are
// not touched by it.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_GAUSS = 16;
constexpr int THREADS = 192;                 // two phases per thread
constexpr int PHASE_TILE = 2 * THREADS;      // 384 phases per work item
constexpr float kPi = 3.14159265358979323846f;
constexpr double kPi64 = 3.14159265358979323846;

}  // namespace

// A coefficient given either as device memory (ptr, element m at
// ptr[stride * m]; stride 0 for a 0-d tensor) or, when ptr is null, by value.
template <typename T>
struct OperandT {
  const T* ptr;
  long long stride;
  T value;
};

// Everything one launch reads and writes; passed to the kernel by value.
template <typename T>
struct ParamsT {
  const T* coords;         // [n_nodes, 3]
  const long long* conn;   // [M, 2]
  const T* D;              // [M] hydrodynamic diameter [m]
  OperandT<T> Cd, Cm;      // per member or scalar
  OperandT<T> wave_dir, current_dir, rho, alpha;   // scalars
  const T* E;              // [N]
  const T* U;              // [N]
  const T* k;              // wave scalars (device, 0-d)
  const T* omega;
  const T* d;
  const T* Uc;
  const T* ts;             // [S]
  T s[MAX_GAUSS];          // Gauss abscissae on [0, 1]
  T w[MAX_GAUSS];          // Gauss weights (sum 1)
  int M, S, N, n_gauss, power_law;
  T* F1;                   // [S, M, 3]
  T* F2;                   // [S, M, 3]
  T* partials;             // [G, S, 6]
  T* totals;               // [S, 6] drag xyz | inertia xyz
};

// The general-mode (random sea) instance's operands: per-mode arrays
// instead of one wave's harmonics, and the phase table.
template <typename T>
struct SeaParamsT {
  const T* coords;         // [n_nodes, 3]
  const long long* conn;   // [M, 2]
  const T* D;              // [M] hydrodynamic diameter [m]
  OperandT<T> Cd, Cm;      // per member or scalar
  OperandT<T> wave_dir, current_dir, rho, alpha;   // scalars
  const T* E;              // [N] surface amplitudes
  const T* U;              // [N] velocity coefficients
  const T* k;              // [N] wavenumbers
  const T* omega;          // [N] angular frequencies
  const T* phi;            // [N] phases
  const T* dir;            // [N] headings relative to wave_dir, or null
  const T* d;              // depth (device, 0-d)
  const T* Uc;             // current (device, 0-d)
  const T* phase;          // [S, 2N]: cos (omega_i t_s) | sin (omega_i t_s)
  T s[MAX_GAUSS];          // Gauss abscissae on [0, 1]
  T w[MAX_GAUSS];          // Gauss weights (sum 1)
  int M, S, N, n_gauss, power_law;
  T* F1;                   // [S, M, 3]
  T* F2;                   // [S, M, 3]
  T* partials;             // [G, S, 6]
  T* totals;               // [S, 6] drag xyz | inertia xyz
};

using Operand = OperandT<float>;
using MorisonParams = ParamsT<float>;
using MorisonParams64 = ParamsT<double>;

namespace {

template <typename T>
__device__ __forceinline__ T operand(const OperandT<T>& o, int m) {
  return o.ptr ? __ldg(o.ptr + o.stride * m) : o.value;
}

// The kinematic mode sums of one (phase, point).
template <bool WHEELER>
struct Fields {
  float eta = 0.f, u = 0.f, w = 0.f, du = 0.f, dw = 0.f;
  float u_z = 0.f, w_z = 0.f, du_z = 0.f, dw_z = 0.f;
  float u_zz = 0.f, w_zz = 0.f, du_zz = 0.f, dw_zz = 0.f;
};

// One member's sums at one phase: drag, inertia, and the node-2 share.
struct MemberSums {
  float fdx = 0.f, fdy = 0.f, fdz = 0.f, fix = 0.f, fiy = 0.f, fiz = 0.f;
  float f2x = 0.f, f2y = 0.f, f2z = 0.f;
};

// Adds mode j of one point at one phase.  r: cos(jkx), sin(jkx),
// U_j C_j(z), U_j S_j(z); ucw = j omega U_j C_j, nusw = -j omega U_j S_j.
template <bool WHEELER>
__device__ __forceinline__ void add_mode(Fields<WHEELER>& f, const float4 r,
                                         float E, float ucw, float nusw,
                                         float jk, float ct, float st) {
  // cos / sin of (j k x - j omega t)
  const float cp = fmaf(r.x, ct, r.y * st);
  const float sp = fmaf(r.y, ct, -r.x * st);
  f.eta = fmaf(E, cp, f.eta);
  f.u = fmaf(r.z, cp, f.u);
  f.w = fmaf(r.w, sp, f.w);
  f.du = fmaf(ucw, sp, f.du);
  f.dw = fmaf(nusw, cp, f.dw);
  if (WHEELER) {
    // d/dz: C' = jk S, S' = jk C; d^2/dz^2: C'' = jk^2 C, S'' = jk^2 S
    const float t1 = jk * cp, t2 = jk * sp;
    f.u_z = fmaf(r.w, t1, f.u_z);
    f.w_z = fmaf(r.z, t2, f.w_z);
    f.du_z = fmaf(-nusw, t2, f.du_z);
    f.dw_z = fmaf(-ucw, t1, f.dw_z);
    const float t3 = jk * t1, t4 = jk * t2;
    f.u_zz = fmaf(r.z, t3, f.u_zz);
    f.w_zz = fmaf(r.w, t4, f.w_zz);
    f.du_zz = fmaf(ucw, t4, f.du_zz);
    f.dw_zz = fmaf(nusw, t3, f.dw_zz);
  }
}

// Wheeler, submergence, normal projection, drag and inertia of one point
// at one phase, added to the member's sums.  pa: z, wave-frame x, current
// x / y; pb: cd, ci, s_q; e: member axis.
template <bool WHEELER>
__device__ __forceinline__ void add_point(MemberSums& a, Fields<WHEELER> f,
                                          const float4 pa, const float4 pb,
                                          const float4 e, float cos_w,
                                          float sin_w, float d) {
  const float z = pa.x;
  if (WHEELER) {
    float dz = -(z + d) * f.eta / (d + f.eta);
    dz = fminf(fmaxf(dz, -d), d);
    const float h2 = 0.5f * dz * dz;
    f.u = f.u + dz * f.u_z + h2 * f.u_zz;
    f.w = f.w + dz * f.w_z + h2 * f.w_zz;
    f.du = f.du + dz * f.du_z + h2 * f.du_zz;
    f.dw = f.dw + dz * f.dw_z + h2 * f.dw_zz;
  }
  if (z <= f.eta) {
    const float Ux = f.u * cos_w + pa.z, Uy = f.u * sin_w + pa.w, Uz = f.w;
    const float Ax = f.du * cos_w, Ay = f.du * sin_w, Az = f.dw;
    const float Ue = Ux * e.x + Uy * e.y + Uz * e.z;
    const float Ae = Ax * e.x + Ay * e.y + Az * e.z;
    const float Upx = Ux - Ue * e.x, Upy = Uy - Ue * e.y, Upz = Uz - Ue * e.z;
    const float Umag = sqrtf(Upx * Upx + Upy * Upy + Upz * Upz);
    const float cdf = (Umag > 1e-10f) ? pb.x * Umag : 0.f;
    const float gx = cdf * Upx, gy = cdf * Upy, gz = cdf * Upz;
    const float ix = pb.y * (Ax - Ae * e.x), iy = pb.y * (Ay - Ae * e.y),
                iz = pb.y * (Az - Ae * e.z);
    a.fdx += gx; a.fdy += gy; a.fdz += gz;
    a.fix += ix; a.fiy += iy; a.fiz += iz;
    a.f2x = fmaf(pb.z, gx + ix, a.f2x);
    a.f2y = fmaf(pb.z, gy + iy, a.f2y);
    a.f2z = fmaf(pb.z, gz + iz, a.f2z);
  }
}

// Two blocks of THREADS per SM: 168 registers a thread, which the flagship
// instance (NMAX 20) uses without spilling; three blocks (113) would spill.
template <int NMAX, bool WHEELER>
__global__ void __launch_bounds__(THREADS, 2)
morison_phase_batch_kernel(const MorisonParams p) {
  extern __shared__ float4 smem4[];
  const int N = p.N, Q = p.n_gauss, M = p.M, S = p.S;
  // modes j >= N are zero-padded to NMAX, so the mode loop has no branch
  // and the compiler can issue its shared loads ahead of the arithmetic
  float4* rec = smem4;                          // [Q * NMAX] point x mode
  float4* pt = rec + Q * NMAX;                  // [Q][2] point data
  float2* modes = reinterpret_cast<float2*>(pt + 2 * Q);   // [NMAX] E, jw
  float* jks = reinterpret_cast<float*>(modes + NMAX);     // [NMAX] j k
  const int tid = threadIdx.x;

  const float d = __ldg(p.d), kk = __ldg(p.k), omega = __ldg(p.omega);
  // compass to math heading: theta = (90 - dir) degrees
  float sin_w, cos_w, sin_c, cos_c;
  sincospif((90.f - operand(p.wave_dir, 0)) / 180.f, &sin_w, &cos_w);
  sincospif((90.f - operand(p.current_dir, 0)) / 180.f, &sin_c, &cos_c);
  for (int j = tid; j < NMAX; j += THREADS) {
    modes[j] = j < N ? make_float2(__ldg(p.E + j), (j + 1) * omega)
                     : make_float2(0.f, 0.f);
    jks[j] = j < N ? (j + 1) * kk : 0.f;
  }
  // with several phase tiles a block may skip one: its rows start at zero
  const int n_ptiles = (S + PHASE_TILE - 1) / PHASE_TILE;
  if (n_ptiles > 1)
    for (int i = tid; i < S * 6; i += THREADS)
      p.partials[(size_t)blockIdx.x * S * 6 + i] = 0.f;

  float c1[2], s1[2];
  float tot[2][6];
  int cur_tile = -1, s_ph[2] = {0, 0};

  // persistent blocks walk the (phase tile, member) items, phase-tile major
  for (int item = blockIdx.x; item < n_ptiles * M; item += gridDim.x) {
    const int tile = item / M, m = item - tile * M;
    if (tile != cur_tile) {
      if (cur_tile >= 0) {   // flush the previous tile's totals
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (s_ph[h] < S) {
            float* o = p.partials + ((size_t)blockIdx.x * S + s_ph[h]) * 6;
#pragma unroll
            for (int c = 0; c < 6; ++c) o[c] = tot[h][c];
          }
      }
      cur_tile = tile;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s_ph[h] = tile * PHASE_TILE + h * THREADS + tid;
        const float t = (s_ph[h] < S) ? __ldg(p.ts + s_ph[h]) : 0.f;
        sincosf(omega * t, &s1[h], &c1[h]);
#pragma unroll
        for (int c = 0; c < 6; ++c) tot[h][c] = 0.f;
      }
    }
    __syncthreads();   // the previous item's records are read

    // ---- prologue 1: the member's geometry, points, current, cd / ci ----
    const long long n1 = p.conn[2 * m], n2 = p.conn[2 * m + 1];
    const float x1 = p.coords[3 * n1], y1 = p.coords[3 * n1 + 1],
                z1 = p.coords[3 * n1 + 2];
    const float dx = p.coords[3 * n2] - x1, dy = p.coords[3 * n2 + 1] - y1,
                dz = p.coords[3 * n2 + 2] - z1;
    const float L = sqrtf(dx * dx + dy * dy + dz * dz);
    const float4 e = make_float4(dx / L, dy / L, dz / L, 0.f);
    for (int q = tid; q < Q; q += THREADS) {
      const float s = p.s[q];
      const float x = x1 + s * dx, y = y1 + s * dy, z = z1 + s * dz;
      float uc = __ldg(p.Uc);
      if (p.power_law) {
        const float frac = fminf(fmaxf((z + d) / d, 0.f), 1.f);
        uc *= powf(frac, operand(p.alpha, 0));
      }
      const float D = p.D[m], rho = operand(p.rho, 0), Lw = L * p.w[q];
      const float cd = 0.5f * rho * operand(p.Cd, m) * D * Lw;
      const float ci = rho * operand(p.Cm, m) * (kPi * D * D / 4.f) * Lw;
      pt[2 * q] = make_float4(z, x * cos_w + y * sin_w, uc * cos_c,
                              uc * sin_c);
      pt[2 * q + 1] = make_float4(cd, ci, s, 0.f);
    }
    __syncthreads();

    // ---- prologue 2: spatial factors of every (point, mode) ----
    for (int i = tid; i < Q * NMAX; i += THREADS) {
      const int q = i / NMAX, j = i % NMAX;
      if (j >= N) {   // padding: adds exact zeros
        rec[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        continue;
      }
      const float4 a = pt[2 * q];
      const float z = a.x, xw = a.y, jk = jks[j];
      const float U = __ldg(p.U + j);
      float sjx, cjx;
      sincosf(jk * xw, &sjx, &cjx);
      // overflow-safe cosh(A)/cosh(B), sinh(A)/cosh(B), A = jk (z + d)
      const float A = jk * (z + d), B = jk * d, Aa = fabsf(A);
      const float scale = expf(Aa - B) / (1.f + expf(-2.f * B));
      const float e2 = expf(-2.f * Aa);
      const float sgn = (A > 0.f) ? 1.f : ((A < 0.f) ? -1.f : 0.f);
      rec[i] = make_float4(cjx, sjx, U * scale * (1.f + e2),
                           U * sgn * scale * (1.f - e2));
    }
    __syncthreads();

    // ---- main loop: both phases of this thread over points and modes ----
    MemberSums acc[2];
    for (int q = 0; q < Q; ++q) {
      const float4* r = rec + q * NMAX;
      Fields<WHEELER> f[2];
      float cj[2] = {c1[0], c1[1]}, sj[2] = {s1[0], s1[1]};
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        const float4 a = r[j];
        const float2 mj = modes[j];
        const float jk = WHEELER ? jks[j] : 0.f;
        const float ucw = mj.y * a.z, nusw = -mj.y * a.w;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          add_mode(f[h], a, mj.x, ucw, nusw, jk, cj[h], sj[h]);
          // cos / sin ((j + 2) omega t) by angle addition
          const float cn = fmaf(cj[h], c1[h], -sj[h] * s1[h]);
          sj[h] = fmaf(sj[h], c1[h], cj[h] * s1[h]);
          cj[h] = cn;
        }
      }
      const float4 pa = pt[2 * q], pb = pt[2 * q + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        add_point(acc[h], f[h], pa, pb, e, cos_w, sin_w, d);
    }
    // F1 = sum f - F2; each phase's 3 + 3 values go straight out
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const MemberSums& a = acc[h];
      if (s_ph[h] < S) {
        const size_t o = ((size_t)s_ph[h] * M + m) * 3;
        p.F1[o] = (a.fdx + a.fix) - a.f2x;
        p.F1[o + 1] = (a.fdy + a.fiy) - a.f2y;
        p.F1[o + 2] = (a.fdz + a.fiz) - a.f2z;
        p.F2[o] = a.f2x; p.F2[o + 1] = a.f2y; p.F2[o + 2] = a.f2z;
      }
      tot[h][0] += a.fdx; tot[h][1] += a.fdy; tot[h][2] += a.fdz;
      tot[h][3] += a.fix; tot[h][4] += a.fiy; tot[h][5] += a.fiz;
    }
  }
  if (cur_tile >= 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (s_ph[h] < S) {
        float* o = p.partials + ((size_t)blockIdx.x * S + s_ph[h]) * 6;
#pragma unroll
        for (int c = 0; c < 6; ++c) o[c] = tot[h][c];
      }
  }
}

// totals[s, c] = sum over blocks g (in order) of partials[g, s, c]
template <typename T>
__global__ void morison_totals_kernel(const T* __restrict__ partials,
                                      int G, int S, T* __restrict__ totals) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * 6) return;
  T acc = 0;
  for (int g = 0; g < G; ++g) acc += partials[(size_t)g * S * 6 + i];
  totals[i] = acc;
}

template <int NMAX>
size_t smem_bytes(const MorisonParams& p) {
  return sizeof(float4) * (size_t)p.n_gauss * (NMAX + 2)
         + (sizeof(float2) + sizeof(float)) * NMAX;
}

// Blocks of the persistent grid: as many as fit the card at once, at most
// one per work item.  The grid depends only on the card and the shapes, so
// the fixed-order totals are bit-repeatable.
template <int NMAX, bool WHEELER>
int grid_blocks(const MorisonParams& p) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, morison_phase_batch_kernel<NMAX, WHEELER>, THREADS,
        smem_bytes<NMAX>(p));
  if (err != cudaSuccess) return -(int)err;
  const long long items =
      (long long)((p.S + PHASE_TILE - 1) / PHASE_TILE) * p.M;
  return (int)(items < (long long)sms * per_sm ? items
                                               : (long long)sms * per_sm);
}

template <int NMAX, bool WHEELER>
cudaError_t launch(const MorisonParams& p, int G, cudaStream_t stream) {
  morison_phase_batch_kernel<NMAX, WHEELER>
      <<<G, THREADS, smem_bytes<NMAX>(p), stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  morison_totals_kernel<float><<<(p.S * 6 + 255) / 256, 256, 0, stream>>>(
      p.partials, G, p.S, p.totals);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Float64 instance
// ---------------------------------------------------------------------------

constexpr int THREADS64 = 64;         // one phase a thread
constexpr int MEMBER_BLOCKS64 = 512;  // blocks along the members (grid.y)

// The float64 mode sums of one (phase, point); Wheeler adds the d/dz and
// d^2/dz^2 sums.  r: cos(jkx), sin(jkx), U_j C_j(z), U_j S_j(z).
template <bool WHEELER>
struct Fields64 {
  double eta = 0, u = 0, w = 0, du = 0, dw = 0;
  double u_z = 0, w_z = 0, du_z = 0, dw_z = 0;
  double u_zz = 0, w_zz = 0, du_zz = 0, dw_zz = 0;
};

// Grid: x over 64-phase tiles, y over MEMBER_BLOCKS64 member strides; block
// (x, y) walks members y, y + gridDim.y, ... in order and writes its
// per-phase drag / inertia sums to partials[y, s, :].  Shared memory: the
// member's records [Q * N][4], point data [Q][8] and per-mode E, j k, j w.
template <bool WHEELER>
__global__ void __launch_bounds__(THREADS64)
morison_phase_batch_f64_kernel(const MorisonParams64 p) {
  extern __shared__ double smem64[];
  const int N = p.N, Q = p.n_gauss, M = p.M, S = p.S;
  double* rec = smem64;                 // [Q * N][4]
  double* pt = rec + 4 * Q * N;         // [Q][8]
  double* mE = pt + 8 * Q;              // [N]
  double* mjk = mE + N;                 // [N]
  double* mjw = mjk + N;                // [N]
  const int tid = threadIdx.x;
  const int s_ph = blockIdx.x * THREADS64 + tid;
  const bool live_ph = s_ph < S;

  const double d = p.d[0], kk = p.k[0], omega = p.omega[0];
  double sin_w, cos_w, sin_c, cos_c;
  sincospi((90.0 - operand(p.wave_dir, 0)) / 180.0, &sin_w, &cos_w);
  sincospi((90.0 - operand(p.current_dir, 0)) / 180.0, &sin_c, &cos_c);
  for (int j = tid; j < N; j += THREADS64) {
    mE[j] = p.E[j];
    mjk[j] = (j + 1) * kk;
    mjw[j] = (j + 1) * omega;
  }
  double s1, c1;
  sincos(omega * (live_ph ? p.ts[s_ph] : 0.0), &s1, &c1);
  double tot[6] = {0, 0, 0, 0, 0, 0};

  for (int m = blockIdx.y; m < M; m += gridDim.y) {
    __syncthreads();   // the previous member's records are read
    const long long n1 = p.conn[2 * m], n2 = p.conn[2 * m + 1];
    const double x1 = p.coords[3 * n1], y1 = p.coords[3 * n1 + 1],
                 z1 = p.coords[3 * n1 + 2];
    const double dx = p.coords[3 * n2] - x1, dy = p.coords[3 * n2 + 1] - y1,
                 dz = p.coords[3 * n2 + 2] - z1;
    const double L = sqrt(dx * dx + dy * dy + dz * dz);
    const double ex = dx / L, ey = dy / L, ez = dz / L;
    for (int q = tid; q < Q; q += THREADS64) {
      const double s = p.s[q];
      const double x = x1 + s * dx, y = y1 + s * dy, z = z1 + s * dz;
      double uc = p.Uc[0];
      if (p.power_law) {
        const double frac = fmin(fmax((z + d) / d, 0.0), 1.0);
        uc *= pow(frac, operand(p.alpha, 0));
      }
      const double D = p.D[m], rho = operand(p.rho, 0), Lw = L * p.w[q];
      double* o = pt + 8 * q;
      o[0] = z;
      o[1] = x * cos_w + y * sin_w;
      o[2] = uc * cos_c;
      o[3] = uc * sin_c;
      o[4] = 0.5 * rho * operand(p.Cd, m) * D * Lw;
      o[5] = rho * operand(p.Cm, m) * (kPi64 * D * D / 4.0) * Lw;
      o[6] = s;
    }
    __syncthreads();
    for (int i = tid; i < Q * N; i += THREADS64) {
      const int q = i / N, j = i % N;
      const double z = pt[8 * q], xw = pt[8 * q + 1], jk = mjk[j];
      const double U = p.U[j];
      double sjx, cjx;
      sincos(jk * xw, &sjx, &cjx);
      // overflow-safe cosh(A)/cosh(B), sinh(A)/cosh(B), A = jk (z + d)
      const double A = jk * (z + d), B = jk * d, Aa = fabs(A);
      const double scale = exp(Aa - B) / (1.0 + exp(-2.0 * B));
      const double e2 = exp(-2.0 * Aa);
      const double sgn = (A > 0.0) ? 1.0 : ((A < 0.0) ? -1.0 : 0.0);
      double* r = rec + 4 * i;
      r[0] = cjx;
      r[1] = sjx;
      r[2] = U * scale * (1.0 + e2);
      r[3] = U * sgn * scale * (1.0 - e2);
    }
    __syncthreads();
    if (!live_ph) continue;

    double fdx = 0, fdy = 0, fdz = 0, fix = 0, fiy = 0, fiz = 0;
    double f2x = 0, f2y = 0, f2z = 0;
    for (int q = 0; q < Q; ++q) {
      const double* r = rec + 4 * q * N;
      Fields64<WHEELER> f;
      double cj = c1, sj = s1;   // cos / sin (j omega t), j = 1
      for (int j = 0; j < N; ++j) {
        const double cx = r[4 * j], sx = r[4 * j + 1];
        const double UC = r[4 * j + 2], US = r[4 * j + 3];
        const double jw = mjw[j];
        // cos / sin of (j k x - j omega t)
        const double cp = cx * cj + sx * sj, sp = sx * cj - cx * sj;
        const double ucw = jw * UC, nusw = -jw * US;
        f.eta += mE[j] * cp;
        f.u += UC * cp;
        f.w += US * sp;
        f.du += ucw * sp;
        f.dw += nusw * cp;
        if (WHEELER) {
          const double jk = mjk[j];
          const double t1 = jk * cp, t2 = jk * sp;
          f.u_z += US * t1;
          f.w_z += UC * t2;
          f.du_z += -nusw * t2;
          f.dw_z += -ucw * t1;
          const double t3 = jk * t1, t4 = jk * t2;
          f.u_zz += UC * t3;
          f.w_zz += US * t4;
          f.du_zz += ucw * t4;
          f.dw_zz += nusw * t3;
        }
        const double cn = cj * c1 - sj * s1;
        sj = sj * c1 + cj * s1;
        cj = cn;
      }
      const double* a = pt + 8 * q;
      const double z = a[0];
      if (WHEELER) {
        double dzw = -(z + d) * f.eta / (d + f.eta);
        dzw = fmin(fmax(dzw, -d), d);
        const double h2 = 0.5 * dzw * dzw;
        f.u = f.u + dzw * f.u_z + h2 * f.u_zz;
        f.w = f.w + dzw * f.w_z + h2 * f.w_zz;
        f.du = f.du + dzw * f.du_z + h2 * f.du_zz;
        f.dw = f.dw + dzw * f.dw_z + h2 * f.dw_zz;
      }
      if (z <= f.eta) {
        const double Ux = f.u * cos_w + a[2], Uy = f.u * sin_w + a[3],
                     Uz = f.w;
        const double Ax = f.du * cos_w, Ay = f.du * sin_w, Az = f.dw;
        const double Ue = Ux * ex + Uy * ey + Uz * ez;
        const double Ae = Ax * ex + Ay * ey + Az * ez;
        const double Upx = Ux - Ue * ex, Upy = Uy - Ue * ey,
                     Upz = Uz - Ue * ez;
        const double Umag = sqrt(Upx * Upx + Upy * Upy + Upz * Upz);
        const double cdf = (Umag > 1e-10) ? a[4] * Umag : 0.0;
        const double gx = cdf * Upx, gy = cdf * Upy, gz = cdf * Upz;
        const double ix = a[5] * (Ax - Ae * ex), iy = a[5] * (Ay - Ae * ey),
                     iz = a[5] * (Az - Ae * ez);
        fdx += gx; fdy += gy; fdz += gz;
        fix += ix; fiy += iy; fiz += iz;
        f2x += a[6] * (gx + ix);
        f2y += a[6] * (gy + iy);
        f2z += a[6] * (gz + iz);
      }
    }
    const size_t o = ((size_t)s_ph * M + m) * 3;
    p.F1[o] = (fdx + fix) - f2x;
    p.F1[o + 1] = (fdy + fiy) - f2y;
    p.F1[o + 2] = (fdz + fiz) - f2z;
    p.F2[o] = f2x; p.F2[o + 1] = f2y; p.F2[o + 2] = f2z;
    tot[0] += fdx; tot[1] += fdy; tot[2] += fdz;
    tot[3] += fix; tot[4] += fiy; tot[5] += fiz;
  }
  if (live_ph)
    for (int c = 0; c < 6; ++c)
      p.partials[((size_t)blockIdx.y * S + s_ph) * 6 + c] = tot[c];
}

size_t smem_bytes64(const MorisonParams64& p) {
  return sizeof(double) * ((size_t)4 * p.n_gauss * p.N + 8 * p.n_gauss
                           + 3 * p.N);
}

// The member blocks of the f64 grid (the rows of its partial sums): depends
// only on the shapes, so the fixed-order totals are bit-repeatable.
int grid_members64(const MorisonParams64& p) {
  return p.M < MEMBER_BLOCKS64 ? p.M : MEMBER_BLOCKS64;
}

template <bool WHEELER>
cudaError_t launch64(const MorisonParams64& p, int G, cudaStream_t stream) {
  const dim3 grid((p.S + THREADS64 - 1) / THREADS64, G);
  morison_phase_batch_f64_kernel<WHEELER>
      <<<grid, THREADS64, smem_bytes64(p), stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  morison_totals_kernel<double><<<(p.S * 6 + 255) / 256, 256, 0, stream>>>(
      p.partials, G, p.S, p.totals);
  return cudaGetLastError();
}

// The kernel instance for N modes (NMAX = 4, 8, ..., 32) and stretching.
struct Instance {
  int (*grid)(const MorisonParams&);
  cudaError_t (*launch)(const MorisonParams&, int, cudaStream_t);
};

template <int NMAX, bool WHEELER>
constexpr Instance instance() {
  return {grid_blocks<NMAX, WHEELER>, launch<NMAX, WHEELER>};
}

Instance pick(int N, bool wheeler) {
  static const Instance table[2][8] = {
      {instance<4, false>(), instance<8, false>(), instance<12, false>(),
       instance<16, false>(), instance<20, false>(), instance<24, false>(),
       instance<28, false>(), instance<32, false>()},
      {instance<4, true>(), instance<8, true>(), instance<12, true>(),
       instance<16, true>(), instance<20, true>(), instance<24, true>(),
       instance<28, true>(), instance<32, true>()}};
  return table[wheeler ? 1 : 0][(N + 3) / 4 - 1];
}

template <typename T>
bool valid(const ParamsT<T>* p) {
  return p->M > 0 && p->S > 0 && p->N > 0 && p->N <= 32 && p->n_gauss > 0 &&
         p->n_gauss <= MAX_GAUSS;
}

// ---------------------------------------------------------------------------
// General-mode instance (random seas), float32 and float64
// ---------------------------------------------------------------------------
//
// The same function over an arbitrary mode set: mode i has its own k_i,
// omega_i, E_i, U_i, spatial phase phi_i and, for a short-crested sea, its
// own heading (wave_dir + dir_i), as ops/spectrum.py::morison_sea_batch
// computes it (the JAX package's _morison_batch_core with rel_dir_deg).
// The frequencies are not harmonics, so angle addition does not apply: as
// in the TPU kernel, the wrapper builds the phase table cos / sin(omega_i
// t_s) [S, 2N] (in float64, then cast) and the kernel reads it.
//
// Layout.  A block is 32 phases x 16 point lanes (512 threads): thread
// (phase s, point q) owns the mode sums of one quadrature point at one
// phase, in registers.  Blocks walk a fixed stride of members
// (grid.y); for each member the modes stream through shared memory in
// tiles of 32: the tile's records cos / sin(k_i x_q + phi_i), U_i C_i(z_q),
// U_i S_i(z_q) [32 modes][16 points] are built by the block, and its phase
// factors [32 phases][32 modes] copied from the table, so N has no limit.
// After the last tile each thread forms its point's drag and inertia;
// the 16 lanes of a phase add their member's sums by a fixed shuffle tree,
// and lane 0 writes F1 / F2 and keeps the phase's running totals.  Totals
// go through the same fixed-order second pass as above: bit-repeatable.
//
// Bounds.  2 x 2N x F FLOP per (phase, point) for the mode sums (F = 5
// fields, 7 for a spread sea; 13 / 19 with Wheeler) plus the epilogue.
// The records are rebuilt per 32-phase block (a sincos and two exp per
// point and mode, a few per cent of the mode sums).  Each (phase, point,
// mode) reads its record and phase factors from shared memory (24 bytes
// in f32, 48 in f64), which likely bounds this simple form: on an H100 it
// measured ~39% of its FP32 bound and ~20% of its FP64 one, and the f64
// time per phase does not fall without Wheeler's rows.

constexpr int SEA_PHASES = 32;        // phases a block
constexpr int SEA_LANES = 16;         // point lanes a phase (MAX_GAUSS)
constexpr int SEA_THREADS = SEA_PHASES * SEA_LANES;
constexpr int SEA_TILE = 32;          // modes a shared-memory tile
constexpr int SEA_MEMBER_BLOCKS = 512;

template <typename T>
__device__ __forceinline__ void sincos_t(T x, T* s, T* c);
template <>
__device__ __forceinline__ void sincos_t<float>(float x, float* s, float* c) {
  sincosf(x, s, c);
}
template <>
__device__ __forceinline__ void sincos_t<double>(double x, double* s,
                                                 double* c) {
  sincos(x, s, c);
}
template <typename T>
__device__ __forceinline__ void sincospi_t(T x, T* s, T* c);
template <>
__device__ __forceinline__ void sincospi_t<float>(float x, float* s,
                                                  float* c) {
  sincospif(x, s, c);
}
template <>
__device__ __forceinline__ void sincospi_t<double>(double x, double* s,
                                                   double* c) {
  sincospi(x, s, c);
}

// The mode sums of one (phase, point).  Long-crested seas keep the
// horizontal fields along the heading (ux, dux); spread seas resolve them
// into x (ux, dux) and y (uy, duy) with per-mode direction weights.
template <typename T>
struct SeaFields {
  T eta = 0, ux = 0, uy = 0, w = 0, dux = 0, duy = 0, dw = 0;
  T ux_z = 0, uy_z = 0, w_z = 0, dux_z = 0, duy_z = 0, dw_z = 0;
  T ux_zz = 0, uy_zz = 0, w_zz = 0, dux_zz = 0, duy_zz = 0, dw_zz = 0;
};

template <typename T, bool WHEELER, bool SPREAD>
__global__ void __launch_bounds__(SEA_THREADS)
morison_sea_kernel(const SeaParamsT<T> p) {
  // records [mode][point][4]: cos, sin (k x + phi), U C(z), U S(z)
  __shared__ T rec[SEA_TILE][SEA_LANES][4];
  __shared__ T pc[SEA_PHASES][SEA_TILE], ps[SEA_PHASES][SEA_TILE];
  // per mode: E, k, omega, heading cos / sin (spread seas)
  __shared__ T mE[SEA_TILE], mk[SEA_TILE], mw[SEA_TILE], mcw[SEA_TILE],
      msw[SEA_TILE];
  __shared__ T pts[SEA_LANES][4];   // x, y (or wave-frame x), z per point
  const int N = p.N, Q = p.n_gauss, M = p.M, S = p.S;
  const int tid = threadIdx.x;
  const int q = tid % SEA_LANES, ph = tid / SEA_LANES;
  const int s_ph = blockIdx.x * SEA_PHASES + ph;
  const bool live = s_ph < S && q < Q;

  const T d = p.d[0];
  T sin_w, cos_w, sin_c, cos_c;
  sincospi_t<T>((T(90) - operand(p.wave_dir, 0)) / T(180), &sin_w, &cos_w);
  sincospi_t<T>((T(90) - operand(p.current_dir, 0)) / T(180), &sin_c,
                &cos_c);
  const T wave_dir = operand(p.wave_dir, 0);
  T tot[6] = {0, 0, 0, 0, 0, 0};

  for (int m = blockIdx.y; m < M; m += gridDim.y) {
    const long long n1 = p.conn[2 * m], n2 = p.conn[2 * m + 1];
    const T x1 = p.coords[3 * n1], y1 = p.coords[3 * n1 + 1],
            z1 = p.coords[3 * n1 + 2];
    const T dx = p.coords[3 * n2] - x1, dy = p.coords[3 * n2 + 1] - y1,
            dzm = p.coords[3 * n2 + 2] - z1;
    const T L = sqrt(dx * dx + dy * dy + dzm * dzm);
    const T ex = dx / L, ey = dy / L, ez = dzm / L;
    // this thread's point
    const int qq = q < Q ? q : 0;
    const T sq = p.s[qq];
    const T x = x1 + sq * dx, y = y1 + sq * dy, z = z1 + sq * dzm;
    if (ph == 0 && q < Q) {
      pts[q][0] = SPREAD ? x : x * cos_w + y * sin_w;
      pts[q][1] = y;
      pts[q][2] = z;
    }
    SeaFields<T> f;
    for (int t0 = 0; t0 < N; t0 += SEA_TILE) {
      const int nt = min(SEA_TILE, N - t0);
      __syncthreads();   // the previous tile is read; pts are written
      if (tid < nt) {
        const int j = t0 + tid;
        mE[tid] = p.E[j];
        mk[tid] = p.k[j];
        mw[tid] = p.omega[j];
        if (SPREAD) {
          T sd, cd;
          sincospi_t<T>((T(90) - (wave_dir + p.dir[j])) / T(180), &sd, &cd);
          mcw[tid] = cd;
          msw[tid] = sd;
        }
      }
      for (int i = tid; i < SEA_PHASES * nt; i += SEA_THREADS) {
        const int r = i / nt, j = i % nt;
        const int s = blockIdx.x * SEA_PHASES + r;
        const size_t o = (size_t)(s < S ? s : 0) * 2 * N + t0 + j;
        pc[r][j] = p.phase[o];
        ps[r][j] = p.phase[o + N];
      }
      __syncthreads();   // mode data and headings
      for (int i = tid; i < nt * SEA_LANES; i += SEA_THREADS) {
        const int j = i / SEA_LANES, qr = i % SEA_LANES;
        if (qr >= Q) continue;
        const T kj = mk[j], U = p.U[t0 + j];
        const T xr = pts[qr][0], zr = pts[qr][2];
        const T proj = SPREAD ? xr * mcw[j] + pts[qr][1] * msw[j] : xr;
        T sx, cx;
        sincos_t<T>(kj * proj + p.phi[t0 + j], &sx, &cx);
        // overflow-safe cosh(A)/cosh(B), sinh(A)/cosh(B), A = k (z + d)
        const T A = kj * (zr + d), B = kj * d, Aa = fabs(A);
        const T scale = exp(Aa - B) / (T(1) + exp(T(-2) * B));
        const T e2 = exp(T(-2) * Aa);
        const T sgn = (A > T(0)) ? T(1) : ((A < T(0)) ? T(-1) : T(0));
        rec[j][qr][0] = cx;
        rec[j][qr][1] = sx;
        rec[j][qr][2] = U * scale * (T(1) + e2);
        rec[j][qr][3] = U * sgn * scale * (T(1) - e2);
      }
      __syncthreads();
      if (!live) continue;
      for (int j = 0; j < nt; ++j) {
        const T cx = rec[j][q][0], sx = rec[j][q][1];
        const T UC = rec[j][q][2], US = rec[j][q][3];
        const T ct = pc[ph][j], st = ps[ph][j];
        // cos / sin of (k x + phi - omega t)
        const T cp = cx * ct + sx * st, sp = sx * ct - cx * st;
        const T jw = mw[j];
        const T ucw = jw * UC, nusw = -jw * US;
        const T hx = SPREAD ? mcw[j] : T(1), hy = SPREAD ? msw[j] : T(0);
        f.eta += mE[j] * cp;
        f.ux += hx * UC * cp;
        f.w += US * sp;
        f.dux += hx * ucw * sp;
        f.dw += nusw * cp;
        if (SPREAD) {
          f.uy += hy * UC * cp;
          f.duy += hy * ucw * sp;
        }
        if (WHEELER) {
          // d/dz: C' = k S, S' = k C; d^2/dz^2: C'' = k^2 C, S'' = k^2 S
          const T kj = mk[j];
          const T t1 = kj * cp, t2 = kj * sp;
          f.ux_z += hx * US * t1;
          f.w_z += UC * t2;
          f.dux_z += hx * -nusw * t2;
          f.dw_z += -ucw * t1;
          const T t3 = kj * t1, t4 = kj * t2;
          f.ux_zz += hx * UC * t3;
          f.w_zz += US * t4;
          f.dux_zz += hx * ucw * t4;
          f.dw_zz += nusw * t3;
          if (SPREAD) {
            f.uy_z += hy * US * t1;
            f.duy_z += hy * -nusw * t2;
            f.uy_zz += hy * UC * t3;
            f.duy_zz += hy * ucw * t4;
          }
        }
      }
    }

    // this point's drag and inertia (zero for idle lanes and dry points)
    T gx = 0, gy = 0, gz = 0, ix = 0, iy = 0, iz = 0;
    if (live) {
      if (WHEELER) {
        T dzw = -(z + d) * f.eta / (d + f.eta);
        dzw = fmin(fmax(dzw, -d), d);
        const T h2 = T(0.5) * dzw * dzw;
        f.ux = f.ux + dzw * f.ux_z + h2 * f.ux_zz;
        f.w = f.w + dzw * f.w_z + h2 * f.w_zz;
        f.dux = f.dux + dzw * f.dux_z + h2 * f.dux_zz;
        f.dw = f.dw + dzw * f.dw_z + h2 * f.dw_zz;
        if (SPREAD) {
          f.uy = f.uy + dzw * f.uy_z + h2 * f.uy_zz;
          f.duy = f.duy + dzw * f.duy_z + h2 * f.duy_zz;
        }
      }
      if (z <= f.eta) {
        T uc = p.Uc[0];
        if (p.power_law) {
          const T frac = fmin(fmax((z + d) / d, T(0)), T(1));
          uc *= pow(frac, operand(p.alpha, 0));
        }
        const T wx = SPREAD ? f.ux : f.ux * cos_w;
        const T wy = SPREAD ? f.uy : f.ux * sin_w;
        const T ax = SPREAD ? f.dux : f.dux * cos_w;
        const T ay = SPREAD ? f.duy : f.dux * sin_w;
        const T Ux = wx + uc * cos_c, Uy = wy + uc * sin_c, Uz = f.w;
        const T Az = f.dw;
        const T Ue = Ux * ex + Uy * ey + Uz * ez;
        const T Ae = ax * ex + ay * ey + Az * ez;
        const T Upx = Ux - Ue * ex, Upy = Uy - Ue * ey, Upz = Uz - Ue * ez;
        const T Umag = sqrt(Upx * Upx + Upy * Upy + Upz * Upz);
        const T D = p.D[m], rho = operand(p.rho, 0), Lw = L * p.w[q];
        const T cd = T(0.5) * rho * operand(p.Cd, m) * D * Lw;
        const T ci = rho * operand(p.Cm, m) * (T(kPi64) * D * D / T(4)) * Lw;
        const T cdf = (Umag > T(1e-10)) ? cd * Umag : T(0);
        gx = cdf * Upx; gy = cdf * Upy; gz = cdf * Upz;
        ix = ci * (ax - Ae * ex); iy = ci * (ay - Ae * ey);
        iz = ci * (Az - Ae * ez);
      }
    }
    // the member's sums over its points: a fixed shuffle tree over the
    // phase's 16 lanes
    T v[9] = {gx, gy, gz, ix, iy, iz, sq * (gx + ix), sq * (gy + iy),
              sq * (gz + iz)};
#pragma unroll
    for (int c = 0; c < 9; ++c)
      for (int off = SEA_LANES / 2; off > 0; off >>= 1)
        v[c] += __shfl_xor_sync(0xffffffffu, v[c], off, SEA_LANES);
    if (q == 0 && s_ph < S) {
      const size_t o = ((size_t)s_ph * M + m) * 3;
      p.F1[o] = (v[0] + v[3]) - v[6];
      p.F1[o + 1] = (v[1] + v[4]) - v[7];
      p.F1[o + 2] = (v[2] + v[5]) - v[8];
      p.F2[o] = v[6]; p.F2[o + 1] = v[7]; p.F2[o + 2] = v[8];
      for (int c = 0; c < 6; ++c) tot[c] += v[c];
    }
  }
  if (q == 0 && s_ph < S)
    for (int c = 0; c < 6; ++c)
      p.partials[((size_t)blockIdx.y * S + s_ph) * 6 + c] = tot[c];
}

// The member blocks of the sea grid (the rows of its partial sums): a
// function of the shapes only.
template <typename T>
int grid_members_sea(const SeaParamsT<T>& p) {
  return p.M < SEA_MEMBER_BLOCKS ? p.M : SEA_MEMBER_BLOCKS;
}

template <typename T, bool WHEELER, bool SPREAD>
cudaError_t launch_sea(const SeaParamsT<T>& p, int G, cudaStream_t stream) {
  const dim3 grid((p.S + SEA_PHASES - 1) / SEA_PHASES, G);
  morison_sea_kernel<T, WHEELER, SPREAD><<<grid, SEA_THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  morison_totals_kernel<T><<<(p.S * 6 + 255) / 256, 256, 0, stream>>>(
      p.partials, G, p.S, p.totals);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sea_any(const SeaParamsT<T>& p, int wheeler, int G,
                           cudaStream_t st) {
  const bool spread = p.dir != nullptr;
  if (wheeler)
    return spread ? launch_sea<T, true, true>(p, G, st)
                  : launch_sea<T, true, false>(p, G, st);
  return spread ? launch_sea<T, false, true>(p, G, st)
                : launch_sea<T, false, false>(p, G, st);
}

template <typename T>
bool valid_sea(const SeaParamsT<T>* p) {
  return p->M > 0 && p->S > 0 && p->N > 0 && p->n_gauss > 0 &&
         p->n_gauss <= MAX_GAUSS;
}

}  // namespace

extern "C" {

// Blocks the launch uses for these shapes (the rows of the partial-sum
// buffer the wrapper allocates); negative on a CUDA error.
int morison_grid_blocks(const MorisonParams* p, int wheeler) {
  if (!valid(p)) return -(int)cudaErrorInvalidValue;
  return pick(p->N, wheeler != 0).grid(*p);
}

// sizeof(MorisonParams): the wrapper checks its ctypes mirror against it.
int morison_params_size() { return (int)sizeof(MorisonParams); }

// Launches the fused kernel on G blocks (morison_grid_blocks) and the
// fixed-order totals reduction on ``stream``.  ``p`` is host memory
// (copied into the kernel's parameters); every pointer in it is device
// memory, partials [G, S, 6].  Returns the CUDA error code (0 on success).
int morison_phase_batch_launch(const MorisonParams* p, int wheeler, int G,
                               void* stream) {
  if (!valid(p) || G <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)pick(p->N, wheeler != 0).launch(*p, G, st);
}

// The float64 instance: the same contract on a MorisonParams64 (every
// pointer to float64 device memory; partials [G, S, 6] with G from
// morison_grid_blocks_f64, which stretching does not change).
int morison_grid_blocks_f64(const MorisonParams64* p, int /*wheeler*/) {
  if (!valid(p)) return -(int)cudaErrorInvalidValue;
  return grid_members64(*p);
}

int morison_params_size_f64() { return (int)sizeof(MorisonParams64); }

int morison_phase_batch_launch_f64(const MorisonParams64* p, int wheeler,
                                   int G, void* stream) {
  if (!valid(p) || G != grid_members64(*p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(wheeler ? launch64<true>(*p, G, st)
                       : launch64<false>(*p, G, st));
}

// The general-mode instance (float32 / float64): grid rows of the partial
// sums, sizeof(SeaParamsT) for the ctypes mirror, and the launch (fused
// pass + fixed-order totals; ``dir`` null for a long-crested sea).
int morison_sea_grid_blocks_f32(const SeaParamsT<float>* p) {
  if (!valid_sea(p)) return -(int)cudaErrorInvalidValue;
  return grid_members_sea(*p);
}
int morison_sea_grid_blocks_f64(const SeaParamsT<double>* p) {
  if (!valid_sea(p)) return -(int)cudaErrorInvalidValue;
  return grid_members_sea(*p);
}
int morison_sea_params_size_f32() { return (int)sizeof(SeaParamsT<float>); }
int morison_sea_params_size_f64() { return (int)sizeof(SeaParamsT<double>); }

int morison_sea_launch_f32(const SeaParamsT<float>* p, int wheeler, int G,
                           void* stream) {
  if (!valid_sea(p) || G != grid_members_sea(*p))
    return (int)cudaErrorInvalidValue;
  return (int)launch_sea_any(*p, wheeler, G,
                             static_cast<cudaStream_t>(stream));
}
int morison_sea_launch_f64(const SeaParamsT<double>* p, int wheeler, int G,
                           void* stream) {
  if (!valid_sea(p) || G != grid_members_sea(*p))
    return (int)cudaErrorInvalidValue;
  return (int)launch_sea_any(*p, wheeler, G,
                             static_cast<cudaStream_t>(stream));
}

const char* morison_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
