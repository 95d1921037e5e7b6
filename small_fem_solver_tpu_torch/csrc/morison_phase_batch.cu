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
// Float64.  morison_harm64_kernel (after the random-sea instance, whose
// fragment, fold and epilogue helpers it shares) computes the same
// function in double precision for float64 models (the dense design
// envelope and the dynamics loads, which the JAX package evaluates in the
// model's dtype), for a batch of C cases in one launch: a records pass,
// then the mode sums on the FP64 tensor cores.  The float32 kernel above
// is not touched by it.
//
// Float32 case batches.  morison_f32_batch_kernel (after the float64
// instance) runs the float32 kernel's arithmetic for C cases in one launch,
// a tile of 384 (case, phase) slots filled from several cases (the dense
// envelope of an f32 model: 1,000 cases x 36 phases); the one-case float32
// kernel above serves the scans and is not touched by it.
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

// A coefficient of a case-batched instance: element (case c, member m) at
// ptr[sc * c + sm * m] (stride 0 along an axis it does not have), or, when
// ptr is null, by value.
template <typename T>
struct HOperandT {
  const T* ptr;
  long long sc, sm;
  T value;
};
using HOperand = HOperandT<double>;

// The case-batched harmonic instances' operands (float64, float32): C cases
// (waves, phase times, headings, current, coefficients) on one model's
// members.
template <typename T>
struct BatchParamsT {
  const T* coords;         // [n_nodes, 3]
  const long long* conn;   // [M, 2]
  HOperandT<T> D, Cd, Cm;  // [C, M], [C, 1], [M] or scalar
  HOperandT<T> wave_dir, current_dir, rho, alpha;   // [C] or scalar
  const T* E;              // [C, N]
  const T* U;              // [C, N]
  const T* k;              // [C]
  const T* omega;          // [C]
  const T* d;              // [C]
  const T* Uc;             // [C]
  const T* ts;             // [C, S]
  T s[MAX_GAUSS];          // Gauss abscissae on [0, 1]
  T w[MAX_GAUSS];          // Gauss weights (sum 1)
  int C, M, S, N, n_gauss, power_law;
  T* F1;                   // [C, S, M, 3]
  T* F2;                   // [C, S, M, 3]
  T* partials;             // [C, G, S, 6]
  T* totals;               // [C, S, 6] drag xyz | inertia xyz
};
using Harm64Params = BatchParamsT<double>;
using Batch32Params = BatchParamsT<float>;

using Operand = OperandT<float>;
using MorisonParams = ParamsT<float>;

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
// Replaces, for a general mode set, the same Pallas TPU kernel as above
// (small_fem_solver_tpu/ops/pallas_kernels.py:229, morison_phase_batch_pallas):
// the function of ops/spectrum.py::morison_sea_end_forces (the JAX
// package's _morison_batch_core with rel_dir_deg).  Mode i has its own k_i,
// omega_i, E_i, U_i, spatial phase phi_i and, for a short-crested sea, its
// own heading (wave_dir + dir_i).  The frequencies are not harmonics, so
// angle addition does not apply: the wrapper builds the phase table
// cos / sin(omega_i t_s) [S, 2N] (in float64, then cast) and the kernel
// reads it.
//
// The mode sums.  With theta_i = k_i x + phi_i - omega_i t every field of a
// (phase s, point p) is sum_i c_fi cos(theta_i) (eta, u, dw/dt and their
// z-derivatives) or sum_i c_fi sin(theta_i) (w, du/dt, ...), where the
// record c_fi folds every per-(point, mode) factor the field needs (E_i,
// U_i C_i(z), omega_i U_i S_i(z), k_i and k_i^2 for Wheeler's rows, the
// heading weights of a spread sea): F fields, 5 (7 spread), 13 (19) with
// Wheeler.  Two forms compute them:
//   angle difference: cp = cos(k x + phi) ct + sin(k x + phi) st, sp = ...
//     per (s, p, i) from the table's ct, st, then one FMA per field:
//     6 + 2F FLOP per item;
//   matrix product: D[s, (p, f)] = sum_k A[s, k] B[k, (p, f)] with A the
//     table [S, 2N] and B[(i, cos), (p, f)] = c cos(k x + phi) (or c sin),
//     B[(i, sin), (p, f)] = c sin(k x + phi) (or -c cos): 4F FLOP per item.
//
// Records pass.  morison_sea_records_kernel computes, once a launch, what
// depends on a point and a mode but not on the phase: for every (point,
// mode) cos / sin (k x + phi), U C(z), U S(z) (a sincos and two exp), for
// every point its position, current, member axis and drag / inertia
// factors, for every mode E, omega, k and the heading weights, into a
// scratch buffer the wrapper allocates (25 MB f32, 50 MB f64 at the sea
// scan's shapes).  The fused pass then reads only shared memory between
// its barriers: its global inputs all arrive by cp.async.
//
// Tiles and pipeline.  A block (one an SM) owns a tile of phases (64 in
// float64, 128 in float32) and walks member tiles of 16 point slots (the
// Q points of one member for Q > 8, of two for Q <= 8, padded) with a
// fixed stride over grid.y (at most SEA_ROWS rows), so the grid depends
// only on the shapes.  The modes run in chunks of SEA_CHUNK = 16 (any N,
// the last chunk zero-padded).  A step is one (member tile, chunk); the
// steps of all the block's tiles form one pipeline with one barrier a
// step: while step t is summed, the table slice of step t + 1 [phases x 2
// x 16] and the records of step t + 2 arrive by cp.async (double
// buffered; a tile's slot data with its first step, a ring of 4 tiles),
// and the records of step t + 1 are folded into its coefficient tile.
// In float64 at F <= 13 a third warpgroup (the producers) issues the
// copies and folds while two warpgroups (the summers) run the mode sums,
// epilogue and reductions: 384 threads at 168 registers, no spill.  Where
// the summers' registers do not fit beside it (float32, F = 19) the 256
// summing threads stage and fold themselves.
//
// Float64: the matrix-product form on the FP64 tensor cores.  A warp owns
// 16 phases x 8 slots x all F fields: F accumulator tiles of
// mma.sync.m16n8k4.f64 (the 16 x 8 tile of field f over the warp's phases
// and slots), each k-step two modes (cos, sin rows interleaved), A from
// the staged table, B from the coefficient tile.  Every DMMA product is a
// full f64 FMA: only the order of the sums changes.  A lane ends with all
// F fields of 2 phases x 2 slots in registers, so the epilogue needs no
// transpose.
//
// Float32: register-blocked FP32 FMAs in the angle-difference form (no
// tensor cores, no TF32).  A thread owns 8 phases x 1 slot x F fields:
// per mode it reads its 8 (ct, st) pairs (four 16-byte loads, shared by
// the 16 lanes of a phase group) and its slot's record (F + 2 values in
// 16-byte quads, slot-minor, so a quarter warp reads 128 contiguous
// bytes), forms cp, sp per phase and adds one FMA per field: 8 (4 + F)
// FMAs for 16 + F + 2 values read, 4.25 a value at F = 13.  The
// matrix-product form in the same tiles needs 2F FMAs per phase and 2F
// record values: 1.5x the FMAs and 1.75x the record bytes read for the
// same sums at F = 13.  A draft of it in these tiles ran slower than the
// angle form on an H100, so only the angle form is kept.
//
// Epilogue (both), after a tile's last step.  Per (phase, slot): Wheeler's
// Taylor stretch with its +-d clip, the wet mask, drag and inertia,
// written [phase][slot][6] into shared memory; then one thread per
// (phase, component) adds each member's points in order (F2 = sum s_q f,
// F1 = sum f - F2), writes F1 / F2 and keeps the phase's running totals of
// that component, which go through the fixed-order second pass
// (morison_totals_kernel).  No float atomics: bit-repeatable.
//
// Bounds.  At the sea scan's shapes (S 2,048, M 1,632, Q 15, N 64,
// Wheeler: F = 13) the matrix form is 166.8 GFLOP and the angle form 102.7:
// f32 1.58 ms at 67 TFLOP/s (angle form), f64 2.58 ms at the FP64 tensor
// cores' 67 (the angle form at 34 would take 3.1).  Measured on an H100
// (chip_smoke.py, PERF.md §6): f64 ~46% of its bound, its fold, copies and
// member sums overlapping the DMMA sums only in part; f32 ~39%, co-bound
// by shared-memory bandwidth (32 floats read per 136 FMAs a thread and
// mode: the SM's 128 bytes a clock match its FMA issue rate at that
// ratio).  Registers (-Xptxas -v, as chip_smoke.py's build report prints
// them; no spill anywhere, no stack in the fused passes, 32-40 bytes in
// the records passes): f64 168 at F = 5, 7, 13 (384 threads), 244 at
// F = 19; f32 120, 128, 192, 229 at F = 5, 7, 13, 19.  Dynamic shared
// memory: f64 150.5 / 166.5 / 214.5 / 214 KB, f32 109.5 / 117.5 / 125.5 /
// 141.5 KB.

constexpr int SEA_THREADS = 256;
constexpr int SEA_SLOTS = 16;                 // point slots a tile (MAX_GAUSS)
constexpr int SEA_CHUNK = 16;                 // modes a pipeline step
constexpr int SEA_ROWS = 128;                 // grid rows (member-tile walkers)
constexpr int SEA_SLOT_RING = 4;              // tiles of slot data in flight
constexpr int SEA_EPI = SEA_SLOTS * 6 + 1;    // a phase's row of point forces
constexpr int SEA_SMEM = 232448;              // shared memory a block may use
// per-slot data: wave-frame x (or plan x), y, z, current x / y, member axis,
// drag and inertia factors, Gauss abscissa, live flag
enum { SL_PX, SL_PY, SL_Z, SL_UCX, SL_UCY, SL_EX, SL_EY, SL_EZ, SL_CD, SL_CI,
       SL_SQ, SL_LIVE, SLOT_W };
// per-(point, mode) record: cos, sin (k x + phi), U C(z), U S(z)
enum { RC_CX, RC_SX, RC_UC, RC_US, REC_W };
// per-mode factors: E, omega, k, heading cos / sin (1, 0 long-crested)
enum { MD_E, MD_OM, MD_K, MD_HX, MD_HY, MODE_W = 8 };

#pragma nv_diag_suppress 177   // field indices an instance does not use
// The fields of one (phase, point): the cos-type fields first, then the
// sin-type ones.  Absent fields have index -1.
template <bool WHEELER, bool SPREAD>
struct SeaLayout {
  static constexpr int NZ = WHEELER ? (SPREAD ? 6 : 4) : 0;
  static constexpr int NCOS = (SPREAD ? 4 : 3) + NZ;
  static constexpr int NSIN = (SPREAD ? 3 : 2) + NZ;
  static constexpr int F = NCOS + NSIN;
  static constexpr int ETA = 0, UX = 1, DW = 2, UY = SPREAD ? 3 : -1;
  static constexpr int UX_Z = WHEELER ? (SPREAD ? 4 : 3) : -1;
  static constexpr int DW_Z = WHEELER ? UX_Z + 1 : -1;
  static constexpr int UX_ZZ = WHEELER ? UX_Z + 2 : -1;
  static constexpr int DW_ZZ = WHEELER ? UX_Z + 3 : -1;
  static constexpr int UY_Z = WHEELER && SPREAD ? UX_Z + 4 : -1;
  static constexpr int UY_ZZ = WHEELER && SPREAD ? UX_Z + 5 : -1;
  static constexpr int W = NCOS, DUX = NCOS + 1, DUY = SPREAD ? NCOS + 2 : -1;
  static constexpr int W_Z = WHEELER ? NCOS + (SPREAD ? 3 : 2) : -1;
  static constexpr int DUX_Z = WHEELER ? W_Z + 1 : -1;
  static constexpr int W_ZZ = WHEELER ? W_Z + 2 : -1;
  static constexpr int DUX_ZZ = WHEELER ? W_Z + 3 : -1;
  static constexpr int DUY_Z = WHEELER && SPREAD ? W_Z + 4 : -1;
  static constexpr int DUY_ZZ = WHEELER && SPREAD ? W_Z + 5 : -1;
};
#pragma nv_diag_default 177

// Shared-memory geometry of one instance (in elements of T).
template <typename T, bool WHEELER, bool SPREAD>
struct SeaGeom {
  static constexpr bool F64 = sizeof(T) == 8;
  static constexpr int F = SeaLayout<WHEELER, SPREAD>::F;
  static constexpr int TS = F64 ? 64 : 128;      // phases a block tile
  static constexpr int PH = 8;                   // f32: phases a thread
  // f64 up to F = 13: a producer warpgroup (copies, B tiles) beside the
  // two summing ones, 168 registers a thread; elsewhere the summers'
  // registers do not fit beside it, and they stage and build themselves
  static constexpr bool WS = F64 && F <= 13;
  static constexpr int THREADS = SEA_THREADS + (WS ? 128 : 0);
  static constexpr int PRODUCERS = WS ? 128 : SEA_THREADS;
  // staged table: f64 [TS][AS] with (cos, sin) of a mode side by side,
  // f32 [cos 16 | sin 16][AS] over the tile's phases; the padding keeps the
  // fragment / vector loads free of bank conflicts
  static constexpr int AS = F64 ? 2 * SEA_CHUNK + 4 : TS + 4;
  static constexpr int TAB = F64 ? TS * AS : 2 * SEA_CHUNK * AS;
  // f32 record [mode][quad][slot][4]: cos, sin (k x + phi) and F factors
  static constexpr int NQ = (F + 2 + 3) / 4;
  // f64 coefficient tile [2 x 16 rows][F][16 slots], row = 4 mod 16 doubles
  static constexpr int RS = F * SEA_SLOTS + 4;
  static constexpr int COEF = F64 ? 2 * SEA_CHUNK * RS
                                  : SEA_CHUNK * NQ * SEA_SLOTS * 4;
  static constexpr int BUF = TAB + COEF;         // a step's table and tile
  // a step's staged records [16 modes][16 slots][REC_W] and mode factors
  static constexpr int RAW = SEA_CHUNK * (SEA_SLOTS * REC_W + MODE_W);
  static constexpr int EPI = TS * SEA_EPI;
  static constexpr int SLOTS = SEA_SLOT_RING * SEA_SLOTS * SLOT_W;
  // the point forces get their own region where it fits, else they reuse
  // the buffer the tile's last step has drained
  static constexpr bool EPI_OWN =
      sizeof(T) * (2 * BUF + 2 * RAW + EPI + SLOTS) <= SEA_SMEM;
  static constexpr int RAW_AT = 2 * BUF;
  static constexpr int EPI_AT = RAW_AT + 2 * RAW;
  static constexpr int SLOTS_AT = EPI_AT + (EPI_OWN ? EPI : 0);
  static constexpr size_t BYTES = sizeof(T) * (SLOTS_AT + SLOTS);
  static_assert(EPI_OWN || BUF >= EPI, "point forces fit no buffer");
  static_assert(BYTES <= SEA_SMEM, "shared memory of a block");
};

// The records pass's output in the scratch buffer: records [rows][N]
// [REC_W], slot table [rows][SLOT_W], mode table [N][MODE_W]; rows = M Q
// (member-major).
template <typename T>
struct SeaScratch {
  T* rec;
  T* slot;
  T* mode;
  __host__ __device__ SeaScratch(const SeaParamsT<T>& p, T* base) {
    const long long rows = (long long)p.M * p.n_gauss;
    rec = base;
    slot = rec + rows * p.N * REC_W;
    mode = slot + rows * SLOT_W;
  }
  static long long elems(const SeaParamsT<T>& p) {
    const long long rows = (long long)p.M * p.n_gauss;
    return rows * p.N * REC_W + rows * SLOT_W + (long long)p.N * MODE_W;
  }
};

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

// Copies global -> shared that bypass the registers: one element, or 16
// bytes; a false ``pred`` fills the destination with zeros (src is not
// read).
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T)), "r"(pred ? (int)sizeof(T) : 0));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// c[16 x 8] += a[16 x 4] b[4 x 8] on the FP64 tensor cores (lane l holds
// a(l/4, l%4), a(l/4 + 8, l%4); b(l%4, l/4); c rows l/4 and l/4 + 8, columns
// 2 (l%4) and 2 (l%4) + 1).
__device__ __forceinline__ void dmma_16x8x4(double* c, double a0, double a1,
                                            double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// The per-(point, mode) factor c_f of every field (SeaLayout order).
template <typename T, bool WHEELER, bool SPREAD>
__device__ __forceinline__ void sea_fold(T E, T hx, T hy, T om, T k, T UC,
                                         T US, T* c) {
  using L = SeaLayout<WHEELER, SPREAD>;
  c[L::ETA] = E;
  c[L::UX] = hx * UC;
  c[L::DW] = -om * US;
  c[L::W] = US;
  c[L::DUX] = hx * (om * UC);
  if constexpr (SPREAD) {
    c[L::UY] = hy * UC;
    c[L::DUY] = hy * (om * UC);
  }
  if constexpr (WHEELER) {
    // d/dz: C' = k S, S' = k C; d^2/dz^2: C'' = k^2 C, S'' = k^2 S
    const T kUC = k * UC, kUS = k * US, k2UC = k * kUC, k2US = k * kUS;
    c[L::UX_Z] = hx * kUS;
    c[L::DW_Z] = -om * kUC;
    c[L::UX_ZZ] = hx * k2UC;
    c[L::DW_ZZ] = -om * k2US;
    c[L::W_Z] = kUC;
    c[L::DUX_Z] = hx * (om * kUS);
    c[L::W_ZZ] = k2US;
    c[L::DUX_ZZ] = hx * (om * k2UC);
    if constexpr (SPREAD) {
      c[L::UY_Z] = hy * kUS;
      c[L::UY_ZZ] = hy * k2UC;
      c[L::DUY_Z] = hy * (om * kUS);
      c[L::DUY_ZZ] = hy * (om * k2UC);
    }
  }
}

// U C(z) = U cosh(A) / cosh(B) and U S(z) = U sinh(A) / cosh(B) of a mode
// with wavenumber k at height z, A = k (z + d), B = k d, in a form that
// does not overflow for deep water or short waves
template <typename T>
__device__ __forceinline__ void depth_factors(T k, T z, T d, T U, T* uc,
                                              T* us) {
  const T A = k * (z + d), B = k * d, Aa = fabs(A);
  const T scale = exp(Aa - B) / (T(1) + exp(T(-2) * B));
  const T e2 = exp(T(-2) * Aa);
  const T sgn = (A > T(0)) ? T(1) : ((A < T(0)) ? T(-1) : T(0));
  *uc = U * scale * (T(1) + e2);
  *us = U * sgn * scale * (T(1) - e2);
}

// The records pass: for every (point row r = m Q + q, mode j) the record
// cos / sin (k x + phi), U C(z), U S(z); for j = 0 the point's slot data
// (position, current, member axis, drag and inertia factors); for r = 0
// the mode's factors.  One thread an item, grid-stride.
template <typename T, bool SPREAD>
__global__ void __launch_bounds__(256)
morison_sea_records_kernel(const SeaParamsT<T> p, T* scratch) {
  const SeaScratch<T> out(p, scratch);
  const int N = p.N, Q = p.n_gauss;
  const long long items = (long long)p.M * Q * N;
  const T d = p.d[0], wave_dir = operand(p.wave_dir, 0);
  T sin_w, cos_w, sin_c, cos_c;
  sincospi_t<T>((T(90) - wave_dir) / T(180), &sin_w, &cos_w);
  sincospi_t<T>((T(90) - operand(p.current_dir, 0)) / T(180), &sin_c,
                &cos_c);
  for (long long it = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       it < items; it += (long long)gridDim.x * blockDim.x) {
    const long long r = it / N;
    const int j = (int)(it - r * N), m = (int)(r / Q), q = (int)(r - m * Q);
    const long long n1 = p.conn[2 * m], n2 = p.conn[2 * m + 1];
    const T x1 = p.coords[3 * n1], y1 = p.coords[3 * n1 + 1],
            z1 = p.coords[3 * n1 + 2];
    const T dx = p.coords[3 * n2] - x1, dy = p.coords[3 * n2 + 1] - y1,
            dzm = p.coords[3 * n2 + 2] - z1;
    const T sq = p.s[q];
    const T x = x1 + sq * dx, y = y1 + sq * dy, z = z1 + sq * dzm;
    const T px = SPREAD ? x : x * cos_w + y * sin_w;
    if (j == 0) {
      const T L = sqrt(dx * dx + dy * dy + dzm * dzm);
      T uc = p.Uc[0];
      if (p.power_law) {
        const T frac = fmin(fmax((z + d) / d, T(0)), T(1));
        uc *= pow(frac, operand(p.alpha, 0));
      }
      const T D = p.D[m], rho = operand(p.rho, 0), Lw = L * p.w[q];
      T* sd = out.slot + r * SLOT_W;
      sd[SL_PX] = px;
      sd[SL_PY] = y;
      sd[SL_Z] = z;
      sd[SL_UCX] = uc * cos_c;
      sd[SL_UCY] = uc * sin_c;
      sd[SL_EX] = dx / L;
      sd[SL_EY] = dy / L;
      sd[SL_EZ] = dzm / L;
      sd[SL_CD] = T(0.5) * rho * operand(p.Cd, m) * D * Lw;
      sd[SL_CI] = rho * operand(p.Cm, m) * (T(kPi64) * D * D / T(4)) * Lw;
      sd[SL_SQ] = sq;
      sd[SL_LIVE] = 1;
    }
    const T kj = p.k[j];
    T hx = 1, hy = 0, proj = px;
    if constexpr (SPREAD) {
      sincospi_t<T>((T(90) - (wave_dir + p.dir[j])) / T(180), &hy, &hx);
      proj = px * hx + y * hy;
    }
    if (r == 0) {
      T* md = out.mode + (size_t)j * MODE_W;
      md[MD_E] = p.E[j];
      md[MD_OM] = p.omega[j];
      md[MD_K] = kj;
      md[MD_HX] = hx;
      md[MD_HY] = hy;
      md[5] = md[6] = md[7] = 0;
    }
    T sx, cx;
    sincos_t<T>(kj * proj + p.phi[j], &sx, &cx);
    T* rc = out.rec + it * REC_W;
    rc[RC_CX] = cx;
    rc[RC_SX] = sx;
    depth_factors<T>(kj, z, d, p.U[j], rc + RC_UC, rc + RC_US);
  }
}

// Stage the table slice of modes j0 .. j0 + 15 for the tile's phases into
// ``tab`` (zeros past S and N), thread t of NT.  A warp copies 4 phases x
// 8 modes: rows of 8 consecutive table entries from global memory.
template <typename T, int NT>
__device__ __forceinline__ void sea_stage_table(const SeaParamsT<T>& p,
                                                T* tab, int s0, int j0,
                                                int t) {
  using Geo = SeaGeom<T, false, false>;
  constexpr int TS = Geo::TS, AS = Geo::AS;
  constexpr int PER = TS * 2 * SEA_CHUNK / NT;
  const int lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int b = it * (NT / 32) + warp;
    const int r = (b >> 2) * 4 + (lane >> 3);           // phase in the tile
    const int jj = (b & 1) * 8 + (lane & 7), cs = (b >> 1) & 1;
    const int s = s0 + r, j = j0 + jj;
    const bool ok = s < p.S && j < p.N;
    const T* src = ok ? p.phase + (size_t)s * 2 * p.N + cs * p.N + j
                      : p.phase;
    T* dst = Geo::F64 ? tab + r * AS + 2 * jj + cs
                      : tab + (cs * SEA_CHUNK + jj) * AS + r;
    cp_async(dst, src, ok);
  }
}

// Stage the records [16 modes][16 slots][REC_W] and the mode factors
// [16][MODE_W] of modes j0 .. j0 + 15 and member tile ``mt`` into ``raw``
// (zeros for padding), 16 bytes a copy, thread t of NT.
template <typename T, int NT>
__device__ __forceinline__ void sea_stage_records(const SeaParamsT<T>& p,
                                                  const SeaScratch<T>& sc,
                                                  T* raw, int mt, int j0,
                                                  int Qp, int mpt, int t) {
  constexpr int V = 16 / sizeof(T);            // elements a copy
  constexpr int RC = REC_W / V, MC = MODE_W / V;   // copies a record, mode
  for (int c = t; c < SEA_CHUNK * SEA_SLOTS * RC; c += NT) {
    const int i = c % SEA_SLOTS, jj = (c / SEA_SLOTS) % SEA_CHUNK,
              h = c / (SEA_SLOTS * SEA_CHUNK);
    const int m = mt * mpt + i / Qp, q = i % Qp, j = j0 + jj;
    const bool ok = q < p.n_gauss && m < p.M && j < p.N;
    const long long r = (long long)m * p.n_gauss + q;
    cp_async16(raw + (jj * SEA_SLOTS + i) * REC_W + h * V,
               ok ? sc.rec + (r * p.N + j) * REC_W + h * V : sc.rec, ok);
  }
  T* md = raw + SEA_CHUNK * SEA_SLOTS * REC_W;
  const int c = t;
  if (c < SEA_CHUNK * MC) {
    const int jj = c / MC, h = c % MC, j = j0 + jj;
    cp_async16(md + jj * MODE_W + h * V,
               j < p.N ? sc.mode + (long long)j * MODE_W + h * V : sc.mode,
               j < p.N);
  }
}

// Stage the slot data [16][SLOT_W] of member tile ``mt`` into ``sd``.
template <typename T>
__device__ __forceinline__ void sea_stage_slots(const SeaParamsT<T>& p,
                                                const SeaScratch<T>& sc,
                                                T* sd, int mt, int Qp,
                                                int mpt, int t) {
  constexpr int V = 16 / sizeof(T), SC = SLOT_W / V;
  const int c = t;
  if (c >= SEA_SLOTS * SC) return;
  const int i = c / SC, h = c % SC;
  const int m = mt * mpt + i / Qp, q = i % Qp;
  const bool ok = q < p.n_gauss && m < p.M;
  const long long r = (long long)m * p.n_gauss + q;
  cp_async16(sd + i * SLOT_W + h * V, ok ? sc.slot + r * SLOT_W + h * V
                                         : sc.slot, ok);
}

// Fold the staged record of (slot, mode) ``item`` (slot item % 16, mode
// item / 16 of the step) into the step's B tile (f64) or f32 records
// ``coef``.
template <typename T, bool WHEELER, bool SPREAD>
__device__ __forceinline__ void sea_build(T* coef, const T* raw, int item) {
  using L = SeaLayout<WHEELER, SPREAD>;
  using Geo = SeaGeom<T, WHEELER, SPREAD>;
  constexpr int F = L::F;
  const int i = item % SEA_SLOTS, jj = item / SEA_SLOTS;
  const T* rc = raw + (jj * SEA_SLOTS + i) * REC_W;
  const T* md = raw + SEA_CHUNK * SEA_SLOTS * REC_W + jj * MODE_W;
  const T cx = rc[RC_CX], sx = rc[RC_SX];
  T c[F];
  sea_fold<T, WHEELER, SPREAD>(md[MD_E], md[MD_HX], md[MD_HY], md[MD_OM],
                               md[MD_K], rc[RC_UC], rc[RC_US], c);
  if constexpr (Geo::F64) {
    // rows 2 jj (cos omega t) and 2 jj + 1 (sin omega t) of the B tile
    T* b = coef + (2 * jj) * Geo::RS + i;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      b[f * SEA_SLOTS] = f < L::NCOS ? c[f] * cx : c[f] * sx;
      b[Geo::RS + f * SEA_SLOTS] = f < L::NCOS ? c[f] * sx : -(c[f] * cx);
    }
  } else {
    T r[4 * Geo::NQ];
    r[0] = cx;
    r[1] = sx;
#pragma unroll
    for (int f = 0; f < F; ++f) r[2 + f] = c[f];
#pragma unroll
    for (int e = F + 2; e < 4 * Geo::NQ; ++e) r[e] = 0;
#pragma unroll
    for (int v = 0; v < Geo::NQ; ++v)
      *reinterpret_cast<float4*>(coef + ((jj * Geo::NQ + v) * SEA_SLOTS + i)
                                 * 4) = make_float4(r[4 * v], r[4 * v + 1],
                                                    r[4 * v + 2],
                                                    r[4 * v + 3]);
  }
}

// The mode sums of chunk ``tab`` / ``coef`` (nt live modes) into the f64
// accumulators acc[f][4] of this warp's 16 phases x 8 slots.
template <bool WHEELER, bool SPREAD>
__device__ __forceinline__ void sea_sums_f64(const double* tab,
                                             const double* coef, int nt,
                                             double* acc) {
  using Geo = SeaGeom<double, WHEELER, SPREAD>;
  constexpr int F = Geo::F;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const double* a = tab + ((warp & 3) * 16 + g) * Geo::AS + t;
  const double* b = coef + t * Geo::RS + (warp >> 2) * 8 + g;
#pragma unroll 2
  for (int ks = 0; ks < (nt + 1) / 2; ++ks) {   // two modes a k-step
    const double a0 = a[4 * ks], a1 = a[8 * Geo::AS + 4 * ks];
    const double* bk = b + 4 * ks * Geo::RS;
#pragma unroll
    for (int f = 0; f < F; ++f)
      dmma_16x8x4(acc + 4 * f, a0, a1, bk[f * SEA_SLOTS]);
  }
}

// The same for f32: acc[8 phases][F] of this thread's slot.
template <bool WHEELER, bool SPREAD, int UNROLL>
__device__ __forceinline__ void sea_sums_f32(const float* tab,
                                             const float* coef, int nt,
                                             float* acc) {
  using L = SeaLayout<WHEELER, SPREAD>;
  using Geo = SeaGeom<float, WHEELER, SPREAD>;
  constexpr int F = L::F, PH = Geo::PH;
  const int i = threadIdx.x % SEA_SLOTS, pg = threadIdx.x / SEA_SLOTS;
  const float* ta = tab + pg * PH;
  const float* rec = coef + i * 4;
#pragma unroll UNROLL
  for (int j = 0; j < nt; ++j) {
    float ct[PH], st[PH], r[4 * Geo::NQ];
#pragma unroll
    for (int v = 0; v < PH / 4; ++v) {
      const float4 c4 = *reinterpret_cast<const float4*>(ta + j * Geo::AS
                                                         + 4 * v);
      const float4 s4 = *reinterpret_cast<const float4*>(
          ta + (SEA_CHUNK + j) * Geo::AS + 4 * v);
      ct[4 * v] = c4.x; ct[4 * v + 1] = c4.y;
      ct[4 * v + 2] = c4.z; ct[4 * v + 3] = c4.w;
      st[4 * v] = s4.x; st[4 * v + 1] = s4.y;
      st[4 * v + 2] = s4.z; st[4 * v + 3] = s4.w;
    }
#pragma unroll
    for (int v = 0; v < Geo::NQ; ++v) {
      const float4 r4 = *reinterpret_cast<const float4*>(
          rec + (j * Geo::NQ + v) * SEA_SLOTS * 4);
      r[4 * v] = r4.x; r[4 * v + 1] = r4.y;
      r[4 * v + 2] = r4.z; r[4 * v + 3] = r4.w;
    }
#pragma unroll
    for (int t = 0; t < PH; ++t) {
      float* a = acc + t * F;
      // cos / sin (k x + phi - omega t)
      const float cp = fmaf(r[0], ct[t], r[1] * st[t]);
      const float sp = fmaf(r[1], ct[t], -(r[0] * st[t]));
#pragma unroll
      for (int f = 0; f < F; ++f)
        a[f] = fmaf(r[2 + f], f < L::NCOS ? cp : sp, a[f]);
    }
  }
}

// Drag and inertia (x, y, z each) of one point at one phase from its
// fields ``fl`` (zero for padding and dry points).
template <typename T, bool WHEELER, bool SPREAD>
__device__ __forceinline__ void sea_forces(const T* fl, const T* sd, T d,
                                           T cos_w, T sin_w, T* o) {
  using L = SeaLayout<WHEELER, SPREAD>;
#pragma unroll
  for (int c = 0; c < 6; ++c) o[c] = 0;
  if (sd[SL_LIVE] == T(0)) return;
  const T z = sd[SL_Z], eta = fl[L::ETA];
  T ux = fl[L::UX], w = fl[L::W], dux = fl[L::DUX], dw = fl[L::DW];
  T uy = 0, duy = 0;
  if constexpr (SPREAD) {
    uy = fl[L::UY];
    duy = fl[L::DUY];
  }
  if constexpr (WHEELER) {
    T dzw = -(z + d) * eta / (d + eta);
    dzw = fmin(fmax(dzw, -d), d);
    const T h2 = T(0.5) * dzw * dzw;
    ux = ux + dzw * fl[L::UX_Z] + h2 * fl[L::UX_ZZ];
    w = w + dzw * fl[L::W_Z] + h2 * fl[L::W_ZZ];
    dux = dux + dzw * fl[L::DUX_Z] + h2 * fl[L::DUX_ZZ];
    dw = dw + dzw * fl[L::DW_Z] + h2 * fl[L::DW_ZZ];
    if constexpr (SPREAD) {
      uy = uy + dzw * fl[L::UY_Z] + h2 * fl[L::UY_ZZ];
      duy = duy + dzw * fl[L::DUY_Z] + h2 * fl[L::DUY_ZZ];
    }
  }
  if (!(z <= eta)) return;
  const T ex = sd[SL_EX], ey = sd[SL_EY], ez = sd[SL_EZ];
  const T wx = SPREAD ? ux : ux * cos_w;
  const T wy = SPREAD ? uy : ux * sin_w;
  const T ax = SPREAD ? dux : dux * cos_w;
  const T ay = SPREAD ? duy : dux * sin_w;
  const T Ux = wx + sd[SL_UCX], Uy = wy + sd[SL_UCY], Uz = w;
  const T Az = dw;
  const T Ue = Ux * ex + Uy * ey + Uz * ez;
  const T Ae = ax * ex + ay * ey + Az * ez;
  const T Upx = Ux - Ue * ex, Upy = Uy - Ue * ey, Upz = Uz - Ue * ez;
  const T Umag = sqrt(Upx * Upx + Upy * Upy + Upz * Upz);
  const T cdf = (Umag > T(1e-10)) ? sd[SL_CD] * Umag : T(0);
  const T ci = sd[SL_CI];
  o[0] = cdf * Upx; o[1] = cdf * Upy; o[2] = cdf * Upz;
  o[3] = ci * (ax - Ae * ex); o[4] = ci * (ay - Ae * ey);
  o[5] = ci * (Az - Ae * ez);
}

// The roles of a block's threads: stage and build the steps, sum them and
// reduce the tiles, or both.
enum SeaRole { SEA_PRODUCER = 1, SEA_SUMMER = 2, SEA_BOTH = 3 };

// The block's pipeline in one role (thread t of the role's threads).  The
// roles run the same steps and meet at the same barriers.
template <typename T, bool WHEELER, bool SPREAD, int ROLE>
__device__ __forceinline__ void sea_run(const SeaParamsT<T>& p, T* scratch,
                                        T* smem, int t) {
  using L = SeaLayout<WHEELER, SPREAD>;
  using Geo = SeaGeom<T, WHEELER, SPREAD>;
  constexpr int F = L::F, TS = Geo::TS;
  constexpr int NP = Geo::PRODUCERS;
  constexpr bool PROD = ROLE & SEA_PRODUCER, SUM = ROLE & SEA_SUMMER;
  constexpr int NACC = Geo::F64 ? 4 * F : Geo::PH * F;
  constexpr int NIT = (TS * 3 + SEA_THREADS - 1) / SEA_THREADS;
  const SeaScratch<T> sc(p, scratch);
  const int N = p.N, S = p.S, M = p.M, Q = p.n_gauss;
  const int Qp = Q <= 8 ? 8 : 16, mpt = SEA_SLOTS / Qp;
  const int n_tiles = (M + mpt - 1) / mpt;
  const int rows = gridDim.y, row = blockIdx.y;
  const int my_tiles = row < n_tiles ? (n_tiles - 1 - row) / rows + 1 : 0;
  const int n_chunks = (N + SEA_CHUNK - 1) / SEA_CHUNK;
  const int n_steps = my_tiles * n_chunks;
  const int s0 = blockIdx.x * TS;
  // step x: member tile x / n_chunks of this block, mode chunk x % n_chunks
  auto tile = [&](int x) { return row + (x / n_chunks) * rows; };
  auto chunk0 = [&](int x) { return (x % n_chunks) * SEA_CHUNK; };
  auto buf = [&](int x) { return smem + (x & 1) * Geo::BUF; };
  auto raw = [&](int x) { return smem + Geo::RAW_AT + (x & 1) * Geo::RAW; };
  auto slots = [&](int k) {   // the slot data of the block's tile k
    return smem + Geo::SLOTS_AT + (k % SEA_SLOT_RING) * SEA_SLOTS * SLOT_W;
  };
  // the copies step x needs two steps ahead: its records and mode factors,
  // and its tile's slot data at the tile's first step
  auto stage_ahead = [&](int x) {
    sea_stage_records<T, NP>(p, sc, raw(x), tile(x), chunk0(x), Qp, mpt, t);
    if (x % n_chunks == 0)
      sea_stage_slots<T>(p, sc, slots(x / n_chunks), tile(x), Qp, mpt, t);
  };
  // the B tile or f32 records of step x
  auto build = [&](int x) {
#pragma unroll
    for (int n = 0; n < SEA_THREADS / NP; ++n)
      sea_build<T, WHEELER, SPREAD>(buf(x) + Geo::TAB, raw(x), t + n * NP);
  };

  if (n_steps > 0) {   // prologue: steps 0 and 1 staged, step 0 built
    if constexpr (PROD) {
      sea_stage_table<T, NP>(p, buf(0), s0, 0, t);
      stage_ahead(0);
      if (n_steps > 1) stage_ahead(1);
      cp_async_commit();
      cp_async_wait_all();
    }
    __syncthreads();
    if constexpr (PROD) build(0);
    __syncthreads();
  }
  T acc[SUM ? NACC : 1];
  T tot[NIT][2];                  // running totals of items (phase, x)
  const T d = p.d[0];
  T sin_w = 0, cos_w = 0;
  if constexpr (SUM) {
#pragma unroll
    for (int a = 0; a < NACC; ++a) acc[a] = 0;
#pragma unroll
    for (int r = 0; r < NIT; ++r) tot[r][0] = tot[r][1] = 0;
    sincospi_t<T>((T(90) - operand(p.wave_dir, 0)) / T(180), &sin_w,
                  &cos_w);
  }

  for (int st = 0; st < n_steps; ++st) {
    const int k = st / n_chunks, c = st % n_chunks;
    if constexpr (PROD) {
      // copies for steps st + 1 (table) and st + 2, then the B tile or
      // f32 records of step st + 1 while step st is summed
      if (st + 1 < n_steps)
        sea_stage_table<T, NP>(p, buf(st + 1), s0, chunk0(st + 1), t);
      if (st + 2 < n_steps) stage_ahead(st + 2);
      cp_async_commit();
      if (st + 1 < n_steps) build(st + 1);
    }
    if constexpr (SUM) {
      const int nt = min(SEA_CHUNK, N - c * SEA_CHUNK);
      if constexpr (Geo::F64)
        sea_sums_f64<WHEELER, SPREAD>(buf(st), buf(st) + Geo::TAB, nt, acc);
      else
        sea_sums_f32<WHEELER, SPREAD, (F > 13 ? 1 : 2)>(
            buf(st), buf(st) + Geo::TAB, nt, acc);
    }
    if constexpr (PROD) cp_async_wait_all();
    __syncthreads();   // step st read; step st + 1 built, st + 2 staged
    if (c + 1 < n_chunks) continue;

    // tile k is summed: each (phase, slot)'s drag and inertia into epi,
    // then one thread a (phase, x) adds each member's points in order
    T* const epi = Geo::EPI_OWN ? smem + Geo::EPI_AT : buf(st);
    const T* const sl = slots(k);
    if constexpr (SUM) {
      T fl[F], o[6];
      if constexpr (Geo::F64) {
        const int lane = t & 31, warp = t >> 5;
        const int r0 = (warp & 3) * 16 + (lane >> 2);
        const int i0 = (warp >> 2) * 8 + 2 * (lane & 3);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int f = 0; f < F; ++f) fl[f] = acc[4 * f + e];
          const int r = r0 + 8 * (e >> 1), i = i0 + (e & 1);
          sea_forces<T, WHEELER, SPREAD>(fl, sl + i * SLOT_W, d, cos_w,
                                         sin_w, o);
#pragma unroll
          for (int q = 0; q < 6; ++q) epi[r * SEA_EPI + i * 6 + q] = o[q];
        }
      } else {
        const int i = t % SEA_SLOTS, r0 = (t / SEA_SLOTS) * Geo::PH;
#pragma unroll
        for (int e = 0; e < Geo::PH; ++e) {
#pragma unroll
          for (int f = 0; f < F; ++f) fl[f] = acc[e * F + f];
          sea_forces<T, WHEELER, SPREAD>(fl, sl + i * SLOT_W, d, cos_w,
                                         sin_w, o);
#pragma unroll
          for (int q = 0; q < 6; ++q)
            epi[(r0 + e) * SEA_EPI + i * 6 + q] = o[q];
        }
      }
#pragma unroll
      for (int a = 0; a < NACC; ++a) acc[a] = 0;
    }
    __syncthreads();
    if constexpr (SUM) {
#pragma unroll
      for (int r = 0; r < NIT; ++r) {
        const int it = t + r * SEA_THREADS, ph = it / 3, x = it % 3;
        const int s = s0 + ph;
        if (it >= TS * 3 || s >= S) continue;
        for (int mm = 0; mm < mpt; ++mm) {
          const int m = tile(st) * mpt + mm;
          if (m >= M) break;
          T vd = 0, vi = 0, v2 = 0;
          for (int q = 0; q < Q; ++q) {
            const int i = mm * Qp + q;
            const T g = epi[ph * SEA_EPI + i * 6 + x];
            const T f = epi[ph * SEA_EPI + i * 6 + 3 + x];
            vd += g;
            vi += f;
            v2 += sl[i * SLOT_W + SL_SQ] * (g + f);
          }
          const size_t o3 = ((size_t)s * M + m) * 3 + x;
          p.F1[o3] = (vd + vi) - v2;
          p.F2[o3] = v2;
          tot[r][0] += vd;
          tot[r][1] += vi;
        }
      }
    }
    if constexpr (!Geo::EPI_OWN) __syncthreads();   // epi is buf(st) again
  }
  if constexpr (SUM) {
#pragma unroll
    for (int r = 0; r < NIT; ++r) {
      const int it = t + r * SEA_THREADS, ph = it / 3, x = it % 3;
      const int s = s0 + ph;
      if (it < TS * 3 && s < S) {
        p.partials[((size_t)row * S + s) * 6 + x] = tot[r][0];
        p.partials[((size_t)row * S + s) * 6 + 3 + x] = tot[r][1];
      }
    }
  }
}

template <typename T, bool WHEELER, bool SPREAD>
__global__ void __launch_bounds__(SeaGeom<T, WHEELER, SPREAD>::THREADS, 1)
morison_sea_kernel(const SeaParamsT<T> p, T* scratch) {
  extern __shared__ __align__(16) unsigned char sea_smem[];
  T* const smem = reinterpret_cast<T*>(sea_smem);
  const int tid = threadIdx.x;
  if constexpr (SeaGeom<T, WHEELER, SPREAD>::WS) {
    // warpgroups 0-1 sum, warpgroup 2 stages and builds
    if (tid < SEA_THREADS)
      sea_run<T, WHEELER, SPREAD, SEA_SUMMER>(p, scratch, smem, tid);
    else
      sea_run<T, WHEELER, SPREAD, SEA_PRODUCER>(p, scratch, smem,
                                                tid - SEA_THREADS);
  } else {
    sea_run<T, WHEELER, SPREAD, SEA_BOTH>(p, scratch, smem, tid);
  }
}

// The grid rows of the sea kernel (the rows of its partial sums): a
// function of the shapes only.
template <typename T>
int grid_members_sea(const SeaParamsT<T>& p) {
  const int mpt = p.n_gauss <= 8 ? 2 : 1;
  const int tiles = (p.M + mpt - 1) / mpt;
  return tiles < SEA_ROWS ? tiles : SEA_ROWS;
}

template <typename T, bool WHEELER, bool SPREAD>
cudaError_t launch_sea(const SeaParamsT<T>& p, int G, T* scratch,
                       cudaStream_t stream) {
  using Geo = SeaGeom<T, WHEELER, SPREAD>;
  const long long items = (long long)p.M * p.n_gauss * p.N;
  const long long rb = (items + 255) / 256;
  morison_sea_records_kernel<T, SPREAD>
      <<<(unsigned)(rb < 4096 ? rb : 4096), 256, 0, stream>>>(p, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = morison_sea_kernel<T, WHEELER, SPREAD>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Geo::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + Geo::TS - 1) / Geo::TS, G);
  kernel<<<grid, Geo::THREADS, Geo::BYTES, stream>>>(p, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  morison_totals_kernel<T><<<(p.S * 6 + 255) / 256, 256, 0, stream>>>(
      p.partials, G, p.S, p.totals);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sea_any(const SeaParamsT<T>& p, int wheeler, int G,
                           T* scratch, cudaStream_t st) {
  const bool spread = p.dir != nullptr;
  if (wheeler)
    return spread ? launch_sea<T, true, true>(p, G, scratch, st)
                  : launch_sea<T, true, false>(p, G, scratch, st);
  return spread ? launch_sea<T, false, true>(p, G, scratch, st)
                : launch_sea<T, false, false>(p, G, scratch, st);
}

template <typename T>
bool valid_sea(const SeaParamsT<T>* p) {
  return p->M > 0 && p->S > 0 && p->N > 0 && p->n_gauss > 0 &&
         p->n_gauss <= MAX_GAUSS;
}

// ---------------------------------------------------------------------------
// Float64 harmonic instance, case-batched
// ---------------------------------------------------------------------------
//
// Replaces, for float64 models, the same Pallas TPU kernel
// (small_fem_solver_tpu/ops/pallas_kernels.py:229, morison_phase_batch_pallas)
// together with the JAX package's jax.vmap of the loads over a batch of
// cases (small_fem_solver_tpu/api.py:3083-3102): the function of
// ops/morison.py::morison_end_forces_batch for C cases (waves, phase times,
// headings, current, coefficients, each per case or shared) on one model's
// members, in one launch.
//
// The mode sums.  With theta_j = j (k x - omega t) every field of a (phase
// s, point p) is sum_j c_fj cos(theta_j) (eta, u, dw/dt and their
// z-derivatives) or sum_j c_fj sin(theta_j) (w, du/dt, ...), c_fj the
// per-(point, mode) factor of field f (sea_fold with mode j's E_j, j omega,
// j k): F = 5 fields, 13 with Wheeler stretching.  As a matrix product
// fields[s, (p, f)] = sum_k A[s, k] B[k, (p, f)], A the phase table [S, 2 N]
// (cos, sin (j omega t_s) side by side) and B[(j, cos), (p, f)] =
// c cos(j k x) (cos-type f) or c sin(j k x), B[(j, sin), (p, f)] = c sin(j k x)
// or -c cos(j k x): 4F FLOP per (phase, point, mode) on
// mma.sync.m16n8k4.f64 (dmma_16x8x4), two modes a k-step.  Harmonic waves
// have N <= 32, so one k-loop covers every mode, padded to an even count N2
// (no 16-mode chunks), and a block keeps its A tile for its whole life.
//
// Records pass.  morison_harm64_records_kernel computes once a launch what
// does not depend on the phase: per (case, point, mode) cos / sin (j k x),
// U_j C_j(z), U_j S_j(z) (a sincos, three exp); per (case, point) the
// random-sea instance's slot data (position, current, member axis, drag
// and inertia factors, Gauss abscissa); per (case, phase, mode) cos / sin
// (j omega t_s) by sincos, exact to rounding at every j (no angle
// addition).  The wrapper allocates the scratch, C (M Q (4 N + 12) +
// 2 S N2) doubles: 16.5 MB at the flagship shapes, 274 MB for the dense
// envelope's 1,000 cases; a batch that would need more than its cap
// (512 MiB) is launched in chunks of cases.
//
// Tiles.  A block owns one case and a tile of 16 MT phases (MT <= 4
// m-tiles: ceil(S / 16) m-tiles over the fewest tiles of at most 4) and
// walks member tiles of 16 point slots (one member for Q > 8, two for
// Q <= 8) with a fixed stride over grid.y.  It runs 2 MT warps: warp w the
// m-tile w % MT and the slot half w / MT, 16 phases x 8 slots x F fields of
// accumulators.  The grid rows (member-tile walkers) depend on S, M and Q
// alone: at least HARM_MIN_TILES tiles a row, at most HARM_BLOCKS blocks
// for one case.  A batch adds its cases along grid.x, so every case is
// tiled and summed as in a launch of its own: case i is bit-equal to a
// one-case launch of case i, and chunking a batch changes no bit.
//
// A member tile k, one barrier a tile where two B tiles fit: its records
// and slot data arrive by cp.async two tiles ahead; after the barrier all
// threads fold tile k + 1's records with the mode factors into the other
// B tile [2 N2][F x 16 slots] while each warp runs tile k's N2 / 2 k-steps
// x F DMMA and the epilogue (sea_forces: Wheeler's Taylor stretch, the wet
// mask, drag and inertia) on its lane's 2 phases x 2 slots, then the
// lever-rule member sums over the 8 slots of its half: a reduce-scatter
// over each quad's 4 lanes (9 shuffles a row, lane x < 3 keeping
// component x).  The second half's sums go through shared memory to the
// first half's warps, which write F1 / F2 after the next barrier and keep
// each phase's running totals.  No float atomics: the totals go through
// a fixed-order second pass (morison_harm64_totals_kernel), bit-repeatable.
//
// Bounds (counted by chip_smoke.py from a run's shapes, PERF.md).  At the
// flagship shapes (S 360, M 1,632, Q 15, N 18) the sums are 3.17 GFLOP,
// 47 us at the FP64 tensor cores' 67 TFLOP/s, and the epilogue ~0.53
// GFLOP at the 34 TFLOP/s of FP64 outside them: 63 us.  The dense
// envelope's 1,000 cases (S 36, M 51, N 8): 4.41 + 1.65 GFLOP, 114 us.
// On an H100 the fused pass takes about three times the bound at F = 5
// (chip_smoke.py's times; PERF.md).  Its build (chip_smoke.py's report):
// 128 registers a thread at F = 5, so an SM holds two blocks, 16 warps,
// to hide the epilogue's dependent FP64 chains (sqrt, shuffles), the
// DMMA chains and the barrier of each tile (one block where a block of 4
// m-tiles needs more than half the shared memory: N >= 27); 234 at
// F = 13, one block.
// At the dense envelope's shapes 25% of the phases are padding (36 of
// 48) and the records pass, a round trip of its output through device
// memory, takes about a third of the launch.

constexpr int HARM_SLOTS = SEA_SLOTS;        // point slots a member tile
constexpr int HARM_MAX_MT = 4;               // 16-phase m-tiles a block
constexpr int HARM_THREADS = 64 * HARM_MAX_MT;
constexpr int HARM_MIN_TILES = 12;           // member tiles a grid row walks
constexpr int HARM_BLOCKS = 264;             // blocks of one case (2 an SM)
constexpr int HARM_XCH = 9;                  // a phase's member sums:
                                             // drag, inertia, F2 (xyz each)
constexpr int HARM_SLOT_RING = 3;            // member tiles of slot data

template <typename T>
__device__ __forceinline__ T hop(const HOperandT<T>& o, int c, int m) {
  return o.ptr ? __ldg(o.ptr + o.sc * c + o.sm * m) : o.value;
}

// The tiling of one case: S phases, M members, Q points, N modes, F
// fields (the same for every case of a batch).  Shared memory, in
// doubles: the phase table A [16 MT][AS], NB B tiles [2 N2][RS] (two when
// they fit: the next member tile is folded while this one is summed),
// staged records [2][(cos, sin (j k x)) | (U C, U S)][N2][16 slots][2] (a
// fold reads 16 bytes a lane, no bank twice), slot data [3][16][SLOT_W], the
// second half's member sums [2][16 MT][HARM_XCH], mode factors [N2][4].
struct HarmTiles {
  int N2, AS, RS, MT, n_pt, Qp, mpt, n_tiles, rows, NB;
  int A_at, B_at, RAW_at, SLOT_at, XCH_at, MD_at, total;
  __host__ __device__ HarmTiles(int S, int M, int Q, int N, int F) {
    N2 = N + (N & 1);
    // row strides = 4 mod 16 doubles: the fragment loads hit no bank twice
    AS = 2 * N2 + (20 - (2 * N2) % 16) % 16;
    RS = F * HARM_SLOTS + 4;
    const int nm = (S + 15) / 16;
    n_pt = (nm + HARM_MAX_MT - 1) / HARM_MAX_MT;
    MT = (nm + n_pt - 1) / n_pt;
    Qp = Q <= 8 ? 8 : 16;
    mpt = HARM_SLOTS / Qp;
    n_tiles = (M + mpt - 1) / mpt;
    const int by_tiles = (n_tiles + HARM_MIN_TILES - 1) / HARM_MIN_TILES;
    const int by_blocks = (HARM_BLOCKS + n_pt - 1) / n_pt;
    rows = by_tiles < by_blocks ? by_tiles : by_blocks;
    // two B tiles where they fit the blocks an SM runs (two at F = 5),
    // else one; where not even one fits two blocks (F = 5, N >= 27, 4
    // m-tiles), the whole of an SM's shared memory for one block.  NB = 0:
    // no layout fits, and the host refuses the launch.
    const bool pair = F <= 5;
    for (int b = pair ? 0 : 1; b < 2; ++b) {
      const size_t budget = b ? SEA_SMEM : SEA_SMEM / 2 - 1024;
      for (NB = 2; NB >= 1; --NB)
        if (sizeof(double) * layout(NB) <= budget) return;
    }
  }
  // the offsets with NB B tiles; returns the doubles of shared memory
  __host__ __device__ int layout(int nb) {
    const int TS = 16 * MT;
    A_at = 0;
    B_at = A_at + TS * AS;
    RAW_at = B_at + nb * 2 * N2 * RS;
    SLOT_at = RAW_at + 2 * N2 * HARM_SLOTS * REC_W;
    XCH_at = SLOT_at + HARM_SLOT_RING * HARM_SLOTS * SLOT_W;
    MD_at = XCH_at + 2 * TS * HARM_XCH;
    total = MD_at + 4 * N2;
    return total;
  }
};

// The records pass's output: records [C][M Q][N][REC_W], slot data
// [C][M Q][SLOT_W], phase table [C][S][N2][2] (cos, sin; zeros past N).
struct HarmScratch {
  double* rec;
  double* slot;
  double* phase;
  __host__ __device__ HarmScratch(const Harm64Params& p, double* base) {
    const long long P = (long long)p.M * p.n_gauss;
    rec = base;
    slot = rec + p.C * P * p.N * REC_W;
    phase = slot + p.C * P * SLOT_W;
  }
  static long long elems(const Harm64Params& p) {
    const long long P = (long long)p.M * p.n_gauss;
    return p.C * (P * (p.N * REC_W + SLOT_W)
                  + 2LL * p.S * (p.N + (p.N & 1)));
  }
};

// The records pass: for every (case c, point row r = m Q + q, mode j) the
// record cos / sin (j k x), U_j C_j(z), U_j S_j(z) and, for j = 0, the
// point's slot data; then for every (case, phase, mode) cos / sin
// (j omega t_s).  One thread an item, grid-stride.
__global__ void __launch_bounds__(256)
morison_harm64_records_kernel(const Harm64Params p, double* scratch) {
  const HarmScratch out(p, scratch);
  const int N = p.N, Q = p.n_gauss, S = p.S, N2 = N + (N & 1);
  const long long P = (long long)p.M * Q;
  const long long n_rec = p.C * P * N, n_ph = (long long)p.C * S * N2;
  for (long long it = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       it < n_rec + n_ph; it += (long long)gridDim.x * blockDim.x) {
    if (it >= n_rec) {
      const long long u = it - n_rec, cs = u / N2;   // cs = c S + s
      const int j = (int)(u - cs * N2), c = (int)(cs / S);
      double sn = 0.0, cn = 0.0;
      if (j < N) sincos((j + 1) * __ldg(p.omega + c) * __ldg(p.ts + cs), &sn,
                        &cn);
      out.phase[2 * u] = cn;
      out.phase[2 * u + 1] = sn;
      continue;
    }
    const long long cr = it / N, r = cr % P;        // cr = c P + r
    const int j = (int)(it - cr * N), c = (int)(cr / P);
    const int m = (int)(r / Q), q = (int)(r - (long long)m * Q);
    const long long n1 = p.conn[2 * m], n2 = p.conn[2 * m + 1];
    const double x1 = p.coords[3 * n1], y1 = p.coords[3 * n1 + 1],
                 z1 = p.coords[3 * n1 + 2];
    const double dx = p.coords[3 * n2] - x1, dy = p.coords[3 * n2 + 1] - y1,
                 dzm = p.coords[3 * n2 + 2] - z1;
    const double sq = p.s[q];
    const double x = x1 + sq * dx, y = y1 + sq * dy, z = z1 + sq * dzm;
    const double d = __ldg(p.d + c);
    double sin_w, cos_w;
    sincospi((90.0 - hop(p.wave_dir, c, 0)) / 180.0, &sin_w, &cos_w);
    const double px = x * cos_w + y * sin_w;
    if (j == 0) {
      const double L = sqrt(dx * dx + dy * dy + dzm * dzm);
      double sin_c, cos_c;
      sincospi((90.0 - hop(p.current_dir, c, 0)) / 180.0, &sin_c, &cos_c);
      double uc = __ldg(p.Uc + c);
      if (p.power_law) {
        const double frac = fmin(fmax((z + d) / d, 0.0), 1.0);
        uc *= pow(frac, hop(p.alpha, c, 0));
      }
      const double D = hop(p.D, c, m), rho = hop(p.rho, c, 0),
                   Lw = L * p.w[q];
      double* sd = out.slot + cr * SLOT_W;
      sd[SL_PX] = px;
      sd[SL_PY] = y;
      sd[SL_Z] = z;
      sd[SL_UCX] = uc * cos_c;
      sd[SL_UCY] = uc * sin_c;
      sd[SL_EX] = dx / L;
      sd[SL_EY] = dy / L;
      sd[SL_EZ] = dzm / L;
      sd[SL_CD] = 0.5 * rho * hop(p.Cd, c, m) * D * Lw;
      sd[SL_CI] = rho * hop(p.Cm, c, m) * (kPi64 * D * D / 4.0) * Lw;
      sd[SL_SQ] = sq;
      sd[SL_LIVE] = 1.0;
    }
    const double jk = (j + 1) * __ldg(p.k + c);
    double* rc = out.rec + it * REC_W;
    sincos(jk * px, rc + RC_SX, rc + RC_CX);
    depth_factors<double>(jk, z, d, __ldg(p.U + (long long)c * N + j),
                          rc + RC_UC, rc + RC_US);
  }
}

// The fused pass: grid (C x phase tiles, rows), 64 MT threads a block.
template <bool WHEELER>
__global__ void __launch_bounds__(HARM_THREADS, WHEELER ? 1 : 2)
morison_harm64_kernel(const Harm64Params p, double* scratch) {
  using L = SeaLayout<WHEELER, false>;
  constexpr int F = L::F, RS = F * HARM_SLOTS + 4;
  extern __shared__ __align__(16) unsigned char harm_smem[];
  double* const smem = reinterpret_cast<double*>(harm_smem);
  const HarmTiles tl(p.S, p.M, p.n_gauss, p.N, F);
  const HarmScratch sc(p, scratch);
  const int N = p.N, S = p.S, M = p.M, Q = p.n_gauss, N2 = tl.N2;
  const long long P = (long long)M * Q;
  const int NT = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, tq = lane & 3;
  const int mt = warp % tl.MT, half = warp / tl.MT;
  const int c = blockIdx.x / tl.n_pt, TS = 16 * tl.MT;
  const int s0 = (blockIdx.x - c * tl.n_pt) * TS;
  const int row = blockIdx.y, rows = gridDim.y;
  const int my_tiles =
      row < tl.n_tiles ? (tl.n_tiles - 1 - row) / rows + 1 : 0;
  // DB = 1: tile k + 1 is staged two tiles ahead and folded while tile k
  // is summed, one barrier a tile; DB = 0 (one B tile): fold, barrier, sum
  const int DB = tl.NB - 1;
  double* const A = smem + tl.A_at;
  double* const md = smem + tl.MD_at;
  auto Bt = [&](int k) { return smem + tl.B_at + (k & DB) * 2 * N2 * RS; };
  auto raw = [&](int k) {
    return smem + tl.RAW_at + (k & 1) * N2 * HARM_SLOTS * REC_W;
  };
  auto slots = [&](int k) {
    return smem + tl.SLOT_at + (k % HARM_SLOT_RING) * HARM_SLOTS * SLOT_W;
  };
  auto xch = [&](int k) { return smem + tl.XCH_at + (k & 1) * TS * HARM_XCH; };
  auto first_member = [&](int k) { return (row + k * rows) * tl.mpt; };

  // member tile k's records and slot data by cp.async (zeros for
  // padding)
  auto stage = [&](int k) {
    double* const rw = raw(k);
    double* const sd = slots(k);
    const int m0 = first_member(k), per = 2 * N2;   // copies a slot's records
    for (int x = tid; x < HARM_SLOTS * per; x += NT) {
      const int i = x / per, j = (x - i * per) >> 1, h = x & 1;
      const int m = m0 + i / tl.Qp, q = i % tl.Qp;
      const bool ok = q < Q && m < M && j < N;
      const long long r = c * P + (long long)m * Q + q;
      cp_async16(rw + ((h * N2 + j) * HARM_SLOTS + i) * 2,
                 ok ? sc.rec + (r * N + j) * REC_W + 2 * h : sc.rec, ok);
    }
    for (int x = tid; x < HARM_SLOTS * SLOT_W / 2; x += NT) {
      const int i = x / (SLOT_W / 2), h = x - i * (SLOT_W / 2);
      const int m = m0 + i / tl.Qp, q = i % tl.Qp;
      const bool ok = q < Q && m < M;
      const long long r = c * P + (long long)m * Q + q;
      cp_async16(sd + i * SLOT_W + 2 * h,
                 ok ? sc.slot + r * SLOT_W + 2 * h : sc.slot, ok);
    }
  };
  // member tile k's B tile: rows 2 j (cos j omega t) and 2 j + 1 (sin j
  // omega t), column f * 16 + slot
  auto fold = [&](int k) {
    const double* const rw = raw(k);
    double* const B = Bt(k);
    for (int x = tid; x < HARM_SLOTS * N2; x += NT) {
      const int i = x % HARM_SLOTS, j = x / HARM_SLOTS;
      // (cos, sin (j k x)) and (U C, U S) of slot i, mode j
      const double* r0 = rw + 2 * x;
      const double* r1 = r0 + 2 * N2 * HARM_SLOTS;
      const double* mj = md + 4 * j;
      double cf[F];
      sea_fold<double, WHEELER, false>(mj[0], 1.0, 0.0, mj[1], mj[2], r1[0],
                                       r1[1], cf);
      const double cx = r0[0], sx = r0[1];
      double* b = B + 2 * j * RS + i;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        b[f * HARM_SLOTS] = f < L::NCOS ? cf[f] * cx : cf[f] * sx;
        b[RS + f * HARM_SLOTS] = f < L::NCOS ? cf[f] * sx : -(cf[f] * cx);
      }
    }
  };

  // the block's phase table (its case, its phases; zeros past S) and the
  // mode factors E_j, j omega, j k, then the first tiles
  for (int x = tid; x < TS * N2; x += NT) {
    const int r = x / N2, j = x - r * N2, s = s0 + r;
    const bool ok = s < S;
    cp_async16(A + r * tl.AS + 2 * j,
               ok ? sc.phase + ((long long)c * S + s) * 2 * N2 + 2 * j
                  : sc.phase, ok);
  }
  const double d = __ldg(p.d + c), kk = __ldg(p.k + c),
               om = __ldg(p.omega + c);
  for (int j = tid; j < N2; j += NT) {
    const bool live = j < N;
    md[4 * j] = live ? __ldg(p.E + (long long)c * N + j) : 0.0;
    md[4 * j + 1] = live ? (j + 1) * om : 0.0;
    md[4 * j + 2] = live ? (j + 1) * kk : 0.0;
    md[4 * j + 3] = 0.0;
  }
  for (int k = 0; k <= DB && k < my_tiles; ++k) stage(k);
  cp_async_commit();
  if (DB && my_tiles > 0) {
    cp_async_wait_all();
    __syncthreads();
    fold(0);
  }
  double sin_w, cos_w;
  sincospi((90.0 - hop(p.wave_dir, c, 0)) / 180.0, &sin_w, &cos_w);

  double acc[4 * F];
  double pend[2][3];                    // this lane's own member sums
  double tot[2][2] = {{0.0, 0.0}, {0.0, 0.0}};   // running drag, inertia

  // the first half's lanes tq < 3 (component x = tq): tile k's F1 / F2 at
  // the lane's two phase rows, from its own sums and the second half's,
  // and the running totals, members in order
  auto finalize = [&](int k) {
    const double* const xo = xch(k);
    const int m0 = first_member(k);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = mt * 16 + g + 8 * rr, s = s0 + r;
      if (s >= S) continue;
      const double* o = xo + r * HARM_XCH + 3 * tq;
      double v[2][3];
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        // one member a tile: both halves' points; two: one member a half
        v[0][u] = tl.mpt == 1 ? pend[rr][u] + o[u] : pend[rr][u];
        v[1][u] = o[u];
      }
#pragma unroll
      for (int mm = 0; mm < 2; ++mm) {
        const int m = m0 + mm;
        if (mm >= tl.mpt || m >= M) break;
        const long long o3 = (((long long)c * S + s) * M + m) * 3 + tq;
        p.F1[o3] = (v[mm][0] + v[mm][1]) - v[mm][2];
        p.F2[o3] = v[mm][2];
        tot[rr][0] += v[mm][0];
        tot[rr][1] += v[mm][1];
      }
    }
  };

  for (int k = 0; k < my_tiles; ++k) {
    cp_async_wait_all();
    __syncthreads();   // tile k + DB staged; tile k - 1 summed, exchanged
    if (k > 0 && half == 0 && tq < 3) finalize(k - 1);
    if (k + 1 + DB < my_tiles) stage(k + 1 + DB);
    cp_async_commit();
    if (DB) {
      if (k + 1 < my_tiles) fold(k + 1);
    } else {
      fold(k);
      __syncthreads();   // B tile built
    }
#pragma unroll
    for (int a = 0; a < 4 * F; ++a) acc[a] = 0.0;
    {
      const double* a = A + (mt * 16 + g) * tl.AS + tq;
      const double* b = Bt(k) + tq * RS + half * 8 + g;
#pragma unroll 2
      for (int ks = 0; ks < N2 / 2; ++ks) {   // two modes a k-step
        const double a0 = a[4 * ks], a1 = a[8 * tl.AS + 4 * ks];
        const double* bk = b + 4 * ks * RS;
#pragma unroll
        for (int f = 0; f < F; ++f)
          dmma_16x8x4(acc + 4 * f, a0, a1, bk[f * HARM_SLOTS]);
      }
    }
    // the epilogue of each of the lane's rows (phases g, g + 8 of its
    // m-tile) at its 2 slots, then the member sums over its half's 8
    // slots: a reduce-scatter over the quad's 4 lanes leaves lane x < 3
    // the sums (v0 + v2) + (v1 + v3) of component x (lane 3: of z too)
    const double* const sd = slots(k);
    double* const xo = xch(k);
    const bool lo = tq < 2;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      double v[HARM_XCH];               // drag xyz, inertia xyz, F2 xyz
#pragma unroll
      for (int u = 0; u < HARM_XCH; ++u) v[u] = 0.0;
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int e = 2 * rr + e2;
        const double* si = sd + (half * 8 + 2 * tq + e2) * SLOT_W;
        double fl[F], o[6];
#pragma unroll
        for (int f = 0; f < F; ++f) fl[f] = acc[4 * f + e];
        sea_forces<double, WHEELER, false>(fl, si, d, cos_w, sin_w, o);
        const double sq = si[SL_SQ];
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          v[x] += o[x];
          v[3 + x] += o[3 + x];
          v[6 + x] += sq * (o[x] + o[3 + x]);
        }
      }
      // lanes {t, t ^ 2}: t < 2 keeps x, y, t >= 2 keeps z
      double own[3];
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const double* q = v + 3 * u;    // quantity u's x, y, z
        const double rx = __shfl_xor_sync(0xffffffffu, lo ? q[2] : q[0], 2);
        const double ry = __shfl_xor_sync(0xffffffffu, q[1], 2);
        const double cx = q[0] + rx, cy = q[1] + ry, cz = q[2] + rx;
        // lanes {t, t ^ 1}: lane 0 keeps x, lane 1 y, lanes 2, 3 z
        const double mine = tq == 0 ? cx : (tq == 1 ? cy : cz);
        const double r2 = __shfl_xor_sync(0xffffffffu,
                                          tq == 0 ? cy : (tq == 1 ? cx : cz),
                                          1);
        own[u] = mine + r2;
      }
      if (half == 0) {
#pragma unroll
        for (int u = 0; u < 3; ++u) pend[rr][u] = own[u];
      } else if (tq < 3) {
        double* o = xo + (mt * 16 + g + 8 * rr) * HARM_XCH + 3 * tq;
#pragma unroll
        for (int u = 0; u < 3; ++u) o[u] = own[u];
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (half == 0 && tq < 3) {
    if (my_tiles > 0) finalize(my_tiles - 1);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int s = s0 + mt * 16 + g + 8 * rr;
      if (s >= S) continue;
      double* o = p.partials + (((long long)c * rows + row) * S + s) * 6;
      o[tq] = tot[rr][0];
      o[3 + tq] = tot[rr][1];
    }
  }
}

// The totals of case c0 + blockIdx.y: its partials [G, S, 6] summed over
// g in order (morison_totals_kernel's sum, a case a grid row).
__global__ void morison_harm64_totals_kernel(const double* __restrict__ part,
                                             int G, int S, int c0,
                                             double* __restrict__ totals) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * 6) return;
  const size_t c = (size_t)c0 + blockIdx.y;
  double acc = 0;
  for (int g = 0; g < G; ++g) acc += __ldg(part + (c * G + g) * S * 6 + i);
  totals[c * S * 6 + i] = acc;
}

template <bool WHEELER>
cudaError_t launch_harm64(const Harm64Params& p, int G, double* scratch,
                          cudaStream_t stream) {
  const HarmTiles tl(p.S, p.M, p.n_gauss, p.N,
                     SeaLayout<WHEELER, false>::F);
  const long long items = (long long)p.C * p.M * p.n_gauss * p.N
                          + (long long)p.C * p.S * tl.N2;
  const long long rb = (items + 255) / 256;
  morison_harm64_records_kernel
      <<<(unsigned)(rb < 8192 ? rb : 8192), 256, 0, stream>>>(p, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = morison_harm64_kernel<WHEELER>;
  const int bytes = (int)(sizeof(double) * tl.total);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)p.C * tl.n_pt, G), 64 * tl.MT, bytes, stream>>>(
      p, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the cases on grid.y, at most 65,535 a launch
  for (int c0 = 0; c0 < p.C; c0 += 65535) {
    const int nc = p.C - c0 < 65535 ? p.C - c0 : 65535;
    morison_harm64_totals_kernel
        <<<dim3((p.S * 6 + 255) / 256, nc), 256, 0, stream>>>(
            p.partials, G, p.S, c0, p.totals);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
bool valid_batch(const BatchParamsT<T>* p) {
  return p->C > 0 && p->M > 0 && p->S > 0 && p->N > 0 && p->N <= 32 &&
         p->n_gauss > 0 && p->n_gauss <= MAX_GAUSS;
}

HarmTiles harm_tiles(const Harm64Params& p, int wheeler) {
  return HarmTiles(p.S, p.M, p.n_gauss, p.N,
                   wheeler ? SeaLayout<true, false>::F
                           : SeaLayout<false, false>::F);
}

// ---------------------------------------------------------------------------
// Case-batched float32 instance
// ---------------------------------------------------------------------------
//
// morison_f32_batch_kernel computes the float32 kernel's function for C
// cases in one launch (the dense design envelope of an f32 model: 1,000
// cases x 36 phases on the 51-member jacket), where the instance above
// takes one case a launch and fills 36 of its 384 phase slots.  It keeps
// that instance's phases-on-lanes arithmetic (add_mode, add_point, the
// angle addition, the register lever sums; FP32 FMAs only, no tensor cores,
// no TF32) and fills a tile of 2 THREADS = 384 (case, phase) slots from
// several cases: a case group of K = min(384 / S2, what shared memory
// holds) cases, S2 = S rounded up to even, each case's phases on S2
// consecutive slots.  Thread t owns the slot pair (2 t, 2 t + 1), two
// phases of one case, so one record read feeds both as before.  A case
// longer than 384 slots takes K = 1 and ceil(S2 / 384) phase tiles.
//
// A work item is (case group or phase tile, member).  The block builds,
// per case of its group, the mode factors (once), and per member the
// point data and the spatial records cos / sin (j k x), U_j C_j, U_j S_j
// in shared memory, as the one-case prologue does; a case's records start
// one float4 past the previous case's (Q NMAX + 1 apart), so a quarter
// warp that straddles two cases reads two addresses on different banks.
// At S 36 a warp's 64 slots touch at most three cases.
//
// Totals and bit-equality.  Grid (groups x phase tiles, rows): row g walks
// the members g, g + rows, ... with rows = min(ceil(M / 4), 264), fixed by
// M alone.  A thread keeps its two slots' drag / inertia totals over its
// members in order and writes them once to partials [C, rows, S, 6]; the
// second kernel adds the rows in order.  Nothing a case computes depends
// on the other cases of the launch, on K or on chunking: case i of a
// batch is bit-equal to case i launched alone.
//
// Bounds.  The same FLOP as the one-case instance, per case: at the dense
// envelope's shapes (C 1,000, S 36, M 51, Q 15, N 8) 6.06 GFLOP, 90.4 us
// at 67 TFLOP/s of FP32; 44 MB of F1 / F2 written (13 us).  Per member and
// group the prologue adds K Q NMAX records (a sincos, three exp each).  On
// an H100 (700 W) that launch takes ~385 us (~23% of its bound, issue
// bound at 12 warps an SM; chip_smoke.py), against 1,000 one-case launches
// of 13-14 us each; three or four blocks an SM spill and run slower.

constexpr int F32B_SLOTS = 2 * THREADS;        // (case, phase) slots a tile
constexpr int F32B_MIN_MEMBERS = 4;            // members a grid row walks
constexpr int F32B_ROWS = 264;                 // most grid rows (2 an SM)
constexpr int F32B_SMEM = 110 * 1024;          // shared memory of a block

// The case-packed tiling for S phases, M members, Q points and NMAX modes
// (padded): slots a case S2, cases a group K, phase tiles a case n_pt,
// grid rows, a case's record stride RST (float4), and the offsets of the
// shared memory regions (bytes): records [K][RST] float4, point data
// [K][Q][2] float4, mode factors [K][NMAX] float2, j k [K][NMAX] float.
struct F32BatchTiles {
  int S2, K, n_pt, rows, RST, pt_at, md_at, jk_at, bytes;
  __host__ __device__ F32BatchTiles(int S, int M, int Q, int nmax) {
    S2 = S + (S & 1);
    RST = Q * nmax + 1;
    const int per_case = 16 * RST + 32 * Q + 12 * nmax;
    const int fit = F32B_SMEM / per_case;
    if (S2 <= F32B_SLOTS) {
      K = F32B_SLOTS / S2 < fit ? F32B_SLOTS / S2 : fit;
      n_pt = 1;
    } else {
      K = 1;
      n_pt = (S2 + F32B_SLOTS - 1) / F32B_SLOTS;
    }
    const int by_members = (M + F32B_MIN_MEMBERS - 1) / F32B_MIN_MEMBERS;
    rows = by_members < F32B_ROWS ? by_members : F32B_ROWS;
    pt_at = 16 * K * RST;
    md_at = pt_at + 32 * K * Q;
    jk_at = md_at + 8 * K * nmax;
    bytes = jk_at + 4 * K * nmax;
  }
};

template <int NMAX, bool WHEELER>
__global__ void __launch_bounds__(THREADS, 2)
morison_f32_batch_kernel(const Batch32Params p) {
  // the mode loop unrolled whole where its records' registers fit beside
  // the per-case state (168 a thread, two blocks an SM), else 4 modes a
  // step, which keeps every instance free of spills
  constexpr int F32B_UNROLL = NMAX <= (WHEELER ? 12 : 20) ? NMAX : 4;
  extern __shared__ float4 smem4[];
  const int N = p.N, Q = p.n_gauss, M = p.M, S = p.S, C = p.C;
  const F32BatchTiles tl(S, M, Q, NMAX);
  unsigned char* const base = reinterpret_cast<unsigned char*>(smem4);
  float4* const rec = smem4;                                  // [K][RST]
  float4* const pt = reinterpret_cast<float4*>(base + tl.pt_at);
  float2* const modes = reinterpret_cast<float2*>(base + tl.md_at);
  float* const jks = reinterpret_cast<float*>(base + tl.jk_at);
  const int tid = threadIdx.x, K = tl.K;
  const int grp = blockIdx.x / tl.n_pt, tile = blockIdx.x - grp * tl.n_pt;
  const int row = blockIdx.y, rows = gridDim.y;
  const int c_first = grp * K;

  // this thread's slot pair: case kk of the group, phases s0, s0 + 1
  const int slot = 2 * tid;
  const int kk = tl.n_pt == 1 ? slot / tl.S2 : 0;
  const int s0 = tl.n_pt == 1 ? slot - kk * tl.S2 : tile * F32B_SLOTS + slot;
  const int kc = kk < K ? kk : K - 1;          // dead slots read case K - 1
  const int c_me = c_first + kc < C ? c_first + kc : C - 1;
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    live[h] = kk < K && c_first + kk < C && s0 + h < S;

  // per case of the group: E_j, j omega and j k (zeros past N)
  for (int i = tid; i < K * NMAX; i += THREADS) {
    const int k = i / NMAX, j = i - k * NMAX, c = c_first + k;
    const bool ok = c < C && j < N;
    modes[i] = ok ? make_float2(__ldg(p.E + (size_t)c * N + j),
                                (j + 1) * __ldg(p.omega + c))
                  : make_float2(0.f, 0.f);
    jks[i] = ok ? (j + 1) * __ldg(p.k + c) : 0.f;
  }
  // this thread's case: depth, heading and the phase factors of its pair
  const float d = __ldg(p.d + c_me), omega = __ldg(p.omega + c_me);
  float sin_w, cos_w;
  sincospif((90.f - hop(p.wave_dir, c_me, 0)) / 180.f, &sin_w, &cos_w);
  float c1[2], s1[2], tot[2][6];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float t = live[h] ? __ldg(p.ts + (size_t)c_me * S + s0 + h) : 0.f;
    sincosf(omega * t, &s1[h], &c1[h]);
#pragma unroll
    for (int c = 0; c < 6; ++c) tot[h][c] = 0.f;
  }
  const float4* const my_rec = rec + kc * tl.RST;
  const float4* const my_pt = pt + kc * Q * 2;
  const float2* const my_modes = modes + kc * NMAX;
  const float* const my_jks = jks + kc * NMAX;

  for (int m = row; m < M; m += rows) {
    __syncthreads();   // the previous member's records are read
    // ---- prologue 1: per case, the member's points, current, cd / ci ----
    const long long n1 = p.conn[2 * m], n2 = p.conn[2 * m + 1];
    const float x1 = p.coords[3 * n1], y1 = p.coords[3 * n1 + 1],
                z1 = p.coords[3 * n1 + 2];
    const float dx = p.coords[3 * n2] - x1, dy = p.coords[3 * n2 + 1] - y1,
                dz = p.coords[3 * n2 + 2] - z1;
    const float L = sqrtf(dx * dx + dy * dy + dz * dz);
    const float4 e = make_float4(dx / L, dy / L, dz / L, 0.f);
    for (int i = tid; i < K * Q; i += THREADS) {
      const int k = i / Q, q = i - k * Q, c = c_first + k;
      if (c >= C) continue;
      float sw, cw, sc, cc;
      sincospif((90.f - hop(p.wave_dir, c, 0)) / 180.f, &sw, &cw);
      sincospif((90.f - hop(p.current_dir, c, 0)) / 180.f, &sc, &cc);
      const float dc = __ldg(p.d + c);
      const float s = p.s[q];
      const float x = x1 + s * dx, y = y1 + s * dy, z = z1 + s * dz;
      float uc = __ldg(p.Uc + c);
      if (p.power_law) {
        const float frac = fminf(fmaxf((z + dc) / dc, 0.f), 1.f);
        uc *= powf(frac, hop(p.alpha, c, 0));
      }
      const float D = hop(p.D, c, m), rho = hop(p.rho, c, 0),
                  Lw = L * p.w[q];
      const float cd = 0.5f * rho * hop(p.Cd, c, m) * D * Lw;
      const float ci = rho * hop(p.Cm, c, m) * (kPi * D * D / 4.f) * Lw;
      pt[(k * Q + q) * 2] = make_float4(z, x * cw + y * sw, uc * cc,
                                        uc * sc);
      pt[(k * Q + q) * 2 + 1] = make_float4(cd, ci, s, 0.f);
    }
    __syncthreads();

    // ---- prologue 2: per case, the spatial factors of every (point, mode)
    for (int i = tid; i < K * Q * NMAX; i += THREADS) {
      const int k = i / (Q * NMAX), qj = i - k * Q * NMAX;
      const int q = qj / NMAX, j = qj - q * NMAX, c = c_first + k;
      if (c >= C) continue;
      float4* const o = rec + k * tl.RST + qj;
      if (j >= N) {   // padding: adds exact zeros
        *o = make_float4(0.f, 0.f, 0.f, 0.f);
        continue;
      }
      const float4 a = pt[(k * Q + q) * 2];
      const float z = a.x, xw = a.y, jk = jks[k * NMAX + j];
      const float dc = __ldg(p.d + c);
      const float U = __ldg(p.U + (size_t)c * N + j);
      float sjx, cjx;
      sincosf(jk * xw, &sjx, &cjx);
      // overflow-safe cosh(A)/cosh(B), sinh(A)/cosh(B), A = jk (z + d)
      const float A = jk * (z + dc), B = jk * dc, Aa = fabsf(A);
      const float scale = expf(Aa - B) / (1.f + expf(-2.f * B));
      const float e2 = expf(-2.f * Aa);
      const float sgn = (A > 0.f) ? 1.f : ((A < 0.f) ? -1.f : 0.f);
      *o = make_float4(cjx, sjx, U * scale * (1.f + e2),
                       U * sgn * scale * (1.f - e2));
    }
    __syncthreads();

    // ---- main loop: both phases of this thread over points and modes ----
    MemberSums acc[2];
    for (int q = 0; q < Q; ++q) {
      const float4* r = my_rec + q * NMAX;
      Fields<WHEELER> f[2];
      float cj[2] = {c1[0], c1[1]}, sj[2] = {s1[0], s1[1]};
#pragma unroll F32B_UNROLL
      for (int j = 0; j < NMAX; ++j) {
        const float4 a = r[j];
        const float2 mj = my_modes[j];
        const float jk = WHEELER ? my_jks[j] : 0.f;
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
      const float4 pa = my_pt[2 * q], pb = my_pt[2 * q + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        add_point(acc[h], f[h], pa, pb, e, cos_w, sin_w, d);
    }
    // F1 = sum f - F2; each phase's 3 + 3 values go straight out
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const MemberSums& a = acc[h];
      if (live[h]) {
        const size_t o = (((size_t)c_me * S + s0 + h) * M + m) * 3;
        p.F1[o] = (a.fdx + a.fix) - a.f2x;
        p.F1[o + 1] = (a.fdy + a.fiy) - a.f2y;
        p.F1[o + 2] = (a.fdz + a.fiz) - a.f2z;
        p.F2[o] = a.f2x; p.F2[o + 1] = a.f2y; p.F2[o + 2] = a.f2z;
      }
      tot[h][0] += a.fdx; tot[h][1] += a.fdy; tot[h][2] += a.fdz;
      tot[h][3] += a.fix; tot[h][4] += a.fiy; tot[h][5] += a.fiz;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (live[h]) {
      float* o = p.partials + (((size_t)c_me * rows + row) * S + s0 + h) * 6;
#pragma unroll
      for (int c = 0; c < 6; ++c) o[c] = tot[h][c];
    }
}

// The totals of case c0 + blockIdx.y: its partials [G, S, 6] summed over
// the rows g in order.
__global__ void morison_f32_batch_totals_kernel(
    const float* __restrict__ part, int G, int S, int c0,
    float* __restrict__ totals) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * 6) return;
  const size_t c = (size_t)c0 + blockIdx.y;
  float acc = 0.f;
  for (int g = 0; g < G; ++g) acc += __ldg(part + (c * G + g) * S * 6 + i);
  totals[c * S * 6 + i] = acc;
}

template <int NMAX, bool WHEELER>
cudaError_t launch_f32_batch(const Batch32Params& p, int G,
                             cudaStream_t stream) {
  const F32BatchTiles tl(p.S, p.M, p.n_gauss, NMAX);
  if (G != tl.rows) return cudaErrorInvalidValue;
  auto kernel = morison_f32_batch_kernel<NMAX, WHEELER>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tl.bytes);
  if (err != cudaSuccess) return err;
  const long long groups = ((long long)p.C + tl.K - 1) / tl.K;
  kernel<<<dim3((unsigned)(groups * tl.n_pt), G), THREADS, tl.bytes,
           stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the cases on grid.y, at most 65,535 a launch
  for (int c0 = 0; c0 < p.C; c0 += 65535) {
    const int nc = p.C - c0 < 65535 ? p.C - c0 : 65535;
    morison_f32_batch_totals_kernel
        <<<dim3((p.S * 6 + 255) / 256, nc), 256, 0, stream>>>(
            p.partials, G, p.S, c0, p.totals);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The case-batched float32 instance for N modes (NMAX = 4, 8, ..., 32) and
// stretching.
using F32BatchLaunch = cudaError_t (*)(const Batch32Params&, int,
                                       cudaStream_t);

F32BatchLaunch pick_f32_batch(int N, bool wheeler) {
  static const F32BatchLaunch table[2][8] = {
      {launch_f32_batch<4, false>, launch_f32_batch<8, false>,
       launch_f32_batch<12, false>, launch_f32_batch<16, false>,
       launch_f32_batch<20, false>, launch_f32_batch<24, false>,
       launch_f32_batch<28, false>, launch_f32_batch<32, false>},
      {launch_f32_batch<4, true>, launch_f32_batch<8, true>,
       launch_f32_batch<12, true>, launch_f32_batch<16, true>,
       launch_f32_batch<20, true>, launch_f32_batch<24, true>,
       launch_f32_batch<28, true>, launch_f32_batch<32, true>}};
  return table[wheeler ? 1 : 0][(N + 3) / 4 - 1];
}

F32BatchTiles f32_batch_tiles(const Batch32Params& p) {
  return F32BatchTiles(p.S, p.M, p.n_gauss, (p.N + 3) / 4 * 4);
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

// The general-mode instance (float32 / float64): grid rows of the partial
// sums, sizeof(SeaParamsT) for the ctypes mirror, the elements of the
// scratch buffer the records pass fills, and the launch (records pass,
// fused pass, fixed-order totals; ``dir`` null for a long-crested sea).
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
long long morison_sea_scratch_f32(const SeaParamsT<float>* p) {
  return valid_sea(p) ? SeaScratch<float>::elems(*p) : -1;
}
long long morison_sea_scratch_f64(const SeaParamsT<double>* p) {
  return valid_sea(p) ? SeaScratch<double>::elems(*p) : -1;
}

int morison_sea_launch_f32(const SeaParamsT<float>* p, int wheeler, int G,
                           void* scratch, void* stream) {
  if (!valid_sea(p) || G != grid_members_sea(*p) || !scratch)
    return (int)cudaErrorInvalidValue;
  return (int)launch_sea_any(*p, wheeler, G, static_cast<float*>(scratch),
                             static_cast<cudaStream_t>(stream));
}
int morison_sea_launch_f64(const SeaParamsT<double>* p, int wheeler, int G,
                           void* scratch, void* stream) {
  if (!valid_sea(p) || G != grid_members_sea(*p) || !scratch)
    return (int)cudaErrorInvalidValue;
  return (int)launch_sea_any(*p, wheeler, G, static_cast<double*>(scratch),
                             static_cast<cudaStream_t>(stream));
}

// The case-batched float64 harmonic instance: sizeof(Harm64Params) for
// the ctypes mirror; its tiling for these shapes (out: m-tiles a block,
// phase tiles, grid rows G (the rows of the partial sums [C, G, S, 6]),
// member tiles, the fused pass's dynamic shared memory in bytes, B tiles;
// returns a CUDA error code, also where no layout fits shared memory); the elements of the scratch buffer the records pass
// fills; and the launch (records pass, fused pass, fixed-order totals).
int morison_harm64_params_size() { return (int)sizeof(Harm64Params); }
int morison_harm64_tiles(const Harm64Params* p, int wheeler, int* out) {
  if (!valid_batch(p)) return (int)cudaErrorInvalidValue;
  const HarmTiles tl = harm_tiles(*p, wheeler);
  if (tl.NB < 1) return (int)cudaErrorInvalidValue;
  out[0] = tl.MT;
  out[1] = tl.n_pt;
  out[2] = tl.rows;
  out[3] = tl.n_tiles;
  out[4] = (int)(sizeof(double) * tl.total);
  out[5] = tl.NB;
  return 0;
}
long long morison_harm64_scratch(const Harm64Params* p) {
  return valid_batch(p) ? HarmScratch::elems(*p) : -1;
}
int morison_harm64_launch(const Harm64Params* p, int wheeler, int G,
                          void* scratch, void* stream) {
  if (!valid_batch(p) || !scratch) return (int)cudaErrorInvalidValue;
  const HarmTiles tl = harm_tiles(*p, wheeler);
  if (tl.NB < 1 || G != tl.rows) return (int)cudaErrorInvalidValue;
  double* sc = static_cast<double*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(wheeler ? launch_harm64<true>(*p, G, sc, st)
                       : launch_harm64<false>(*p, G, sc, st));
}

// The case-batched float32 instance: sizeof(Batch32Params) for the ctypes
// mirror; its tiling for these shapes (out: cases a group K, phase tiles a
// case, grid rows G (the rows of the partial sums [C, G, S, 6]), dynamic
// shared memory in bytes; returns a CUDA error code); and the launch
// (fused pass and fixed-order totals) on ``stream``.
int morison_f32_batch_params_size() { return (int)sizeof(Batch32Params); }
int morison_f32_batch_tiles(const Batch32Params* p, int* out) {
  if (!valid_batch(p)) return (int)cudaErrorInvalidValue;
  const F32BatchTiles tl = f32_batch_tiles(*p);
  out[0] = tl.K;
  out[1] = tl.n_pt;
  out[2] = tl.rows;
  out[3] = tl.bytes;
  return 0;
}
int morison_f32_batch_launch(const Batch32Params* p, int wheeler, int G,
                             void* stream) {
  if (!valid_batch(p) || G <= 0) return (int)cudaErrorInvalidValue;
  return (int)pick_f32_batch(p->N, wheeler != 0)(
      *p, G, static_cast<cudaStream_t>(stream));
}

const char* morison_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
