// Pointwise Morison loads with the slam term, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package evaluates this path
// (ops/waves.py::kinematics under ops/morison.py::morison_loads) in plain
// jnp.  It computes what ops/morison.py::morison_pointwise_end_forces
// computes, the reference's pointwise semantics for every phase time t_s
// and Gauss point q of every member m:
//
//   1. the wave's Fourier sums at the point: surface elevation eta, its rise
//      d(eta)/dt, u and w at the evaluation height (Wheeler stretching, then
//      the 1 cm clamp z + d in [0.01, d + eta - 0.01] of a Stokes or Fenton
//      wave), and du/dt, dw/dt: the exact series, or the reference's forward
//      difference (v(t + dt) - v(t)) / dt of the dry-masked velocity through
//      the moving stretch;
//   2. the dry mask z > eta, the uniform or power-law current, the
//      projection normal to the member axis, drag 0.5 rho Cd D |u_n| u_n
//      L w (gated at |u_n| > 1e-10) and inertia rho Cm pi D^2 / 4 a_n L w;
//   3. with slam_cs > 0 the slamming load 0.5 rho Cs D eta_dot^2 |z_perp|
//      z_perp L w where |z - eta| <= D / 2 and the surface rises, folded
//      into the drag;
//   4. the lever-rule end forces F1 = sum (1 - s_q) f, F2 = sum s_q f
//      [S, M, 3] and the per-phase drag and inertia totals [S, 3].
//
// Layout.  A block of 256 threads is 16 groups of 16 lanes and owns one
// member; a group owns one phase at a time and walks the phases s = g,
// g + 16, ...; a lane owns one Gauss point of a pass of 16 (Q <= 16: one
// pass, lanes past Q add zeros; Q > 16: further passes over the phases, each
// adding its sums to the rows the same thread wrote in the pass before).
// So a lane keeps its point's phase-independent data in registers for a
// whole pass (position, x along the heading, the member axis, |z_perp|,
// L w and the drag, inertia and slam factors).  The per-mode coefficients
// sit in dynamic shared memory sized by N (6 N words), so N is bounded only
// by a block's shared memory; the Gauss rule is a device tensor [2, Q].
//
// Mode loops.  One sincos a (phase, point); cos / sin (j theta) by angle
// addition along the modes (theta = k x - omega t).  The first loop sums
// the surface, its rise and, for the difference, its step to t + dt; the
// second, at wet points, evaluates the depth profiles at the evaluation
// height (formed in float64) and sums u, w, du, dw.  The forward difference
// never subtracts two velocities: with delta = theta(t + dt) - theta(t)
// (formed in float64 from the float64 times, as the reference forms it),
// cos (j theta + j delta) - cos (j theta) = alpha_j c_j - beta_j s_j with
// alpha_j = cos (j delta) - 1, beta_j = sin (j delta) by the same
// recursion, and a height moved by dz changes C_j, S_j by P_j expm1(j k dz)
// +- M_j expm1(-j k dz) (P_j, M_j: the two exponential halves of the
// profile).  In float32 a subtracted pair of velocities divided by dt =
// 1e-3 keeps ~1e-4 of the acceleration; this form keeps float32's ~1e-7.
//
// Sums.  The 12 sums over a member's points (F1, F2, drag, inertia) are
// xor-shuffle trees over the group's 16 lanes, in a fixed order; each
// group writes its phase's F1 / F2 rows and its member's drag / inertia
// row [M, S, 6] of partial totals, and a second kernel adds the members in
// a fixed order (8 strided runs, then a tree).  No atomics: a launch is
// bit-repeatable.
//
// Bound.  Per (phase, point): one sincos, ~18 FLOP a mode for the
// harmonics, the surface, its rise, u, w, du, dw, and ~100 FLOP of
// epilogue: ~4 GFLOP at the slam scan's shapes (S 360, M 1632, Q 15, N 18),
// ~60 us at the H100's 67 TFLOP/s of FP32; device memory sees the 14 MB of
// F1 / F2.  The bound counts the depth profiles once a point, as where the
// height does not move with the phase they could be; this kernel evaluates
// them per (phase, point, mode) (2 exp, and 2 expm1 for the difference),
// which keeps one code path for every height: the scans are host-bound.
// Plain FP32 (FP64) arithmetic, no tensor cores, no fast-math intrinsics.
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 16;                  // a group: one (phase, member)
constexpr int GROUPS = 16;                 // phases in flight a block
constexpr int THREADS = LANES * GROUPS;    // 256
constexpr int SUMS = 12;                   // F1, F2, drag, inertia (xyz)
constexpr int MODE_WORDS = 6;              // shared words a mode
constexpr int STATIC_SMEM = 48 * 1024;     // dynamic shared memory without
                                           // an opt-in
constexpr double kPi = 3.14159265358979323846;

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
struct PointwiseParamsT {
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
  const T* gauss;          // [2, n_gauss]: abscissae on [0, 1], weights
  double dt_fd;            // forward-difference step [s]
  T slam_cs;               // slamming coefficient (0: none)
  int M, S, N, n_gauss, power_law, clamp_z;
  T* F1;                   // [S, M, 3]
  T* F2;                   // [S, M, 3]
  T* partials;             // [M, S, 6] drag xyz | inertia xyz a member
  T* totals;               // [S, 6] drag xyz | inertia xyz
};

namespace {

template <typename T>
__device__ __forceinline__ T operand(const OperandT<T>& o, int m) {
  return o.ptr ? o.ptr[o.stride * m] : o.value;
}

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

// The depth profile of mode j at height z (the reference's overflow-safe
// cosh(A)/cosh(B), sinh(A)/cosh(B), A = j k (z + d), B = j k d): C, S and
// the two halves P = e^(A-B) / den, Mn = e^(-A-B) / den (C = P + Mn, S = P
// - Mn); den = 1 + e^(-2B).
template <typename T>
struct Profile {
  T C, S, P, Mn;
  __device__ __forceinline__ Profile(T jk, T z, T d, T den) {
    const T A = jk * (z + d), B = jk * d, Aa = fabs(A);
    const T scale = exp(Aa - B) / den;
    const T e2 = exp(T(-2) * Aa);
    const T small = scale * e2;
    C = scale * (T(1) + e2);
    S = (A > T(0) ? T(1) : (A < T(0) ? T(-1) : T(0))) * scale * (T(1) - e2);
    P = A >= T(0) ? scale : small;
    Mn = A >= T(0) ? small : scale;
  }
};

// The evaluation height at surface elevation et (float64): Wheeler's
// stretch, then the clamp z + d in [0.01, d + et - 0.01].
template <bool WHEELER>
__device__ __forceinline__ double eval_height(double z, double d, double et,
                                              bool clamp) {
  const double zs = WHEELER ? __dadd_rn(__ddiv_rn(__dmul_rn(__dadd_rn(z, d),
                                                            d),
                                                  __dadd_rn(d, et)), -d)
                            : z;
  if (!clamp) return zs;
  const double lo = fmax(__dadd_rn(zs, d), 0.01);
  const double hi = __dadd_rn(__dadd_rn(d, et), -0.01);
  return __dadd_rn(fmin(lo, hi), -d);
}

template <typename T, bool FD, bool WHEELER>
__global__ void __launch_bounds__(THREADS, 2)
pointwise_loads_kernel(const PointwiseParamsT<T> p) {
  // per mode j: E, E j omega, U, j k, j omega, 1 + e^(-2 j k d)
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = p.N, Q = p.n_gauss, S = p.S, M = p.M;
  T* const sE = reinterpret_cast<T*>(smem);
  T* const sEjw = sE + N;
  T* const sU = sE + 2 * N;
  T* const sjk = sE + 3 * N;
  T* const sjw = sE + 4 * N;
  T* const sden = sE + 5 * N;
  const int m = blockIdx.x;
  const int lane = threadIdx.x % LANES, grp = threadIdx.x / LANES;
  const T d = *p.d, kk = *p.k, om = *p.omega, Uc = *p.Uc;

  // ---- the member (registers, the whole scan) and the modes ----
  const long long n1 = p.conn[2 * m], n2 = p.conn[2 * m + 1];
  const T x1 = p.coords[3 * n1], y1 = p.coords[3 * n1 + 1],
          z1 = p.coords[3 * n1 + 2];
  const T dx = p.coords[3 * n2] - x1, dy = p.coords[3 * n2 + 1] - y1,
          dz = p.coords[3 * n2 + 2] - z1;
  const T L = sqrt(dx * dx + dy * dy + dz * dz);
  const T ex = dx / L, ey = dy / L, ez = dz / L;
  // compass to math heading: theta = (90 - dir) degrees
  T sin_w, cos_w, sin_c, cos_c;
  sincos_t<T>((T(90) - operand(p.wave_dir, 0)) * T(kPi / 180.0), &sin_w,
              &cos_w);
  sincos_t<T>((T(90) - operand(p.current_dir, 0)) * T(kPi / 180.0), &sin_c,
              &cos_c);
  const T D = p.D[m], rho = operand(p.rho, 0);
  const T cd_m = T(0.5) * rho * operand(p.Cd, m) * D;
  const T ci_m = rho * operand(p.Cm, m) * (T(kPi) * D * D / T(4));
  // the normal part of the vertical: z_perp = zhat - e_z e
  const T zp_sq = fmax(T(1) - ez * ez, T(0));
  const T zpx = -ez * ex, zpy = -ez * ey, zp = sqrt(zp_sq);
  const T slam_m = T(0.5) * rho * p.slam_cs * D;
  for (int j = threadIdx.x; j < N; j += THREADS) {
    const T jj = T(j + 1);
    sE[j] = p.E[j];
    sEjw[j] = p.E[j] * jj * om;
    sU[j] = p.U[j];
    sjk[j] = jj * kk;
    sjw[j] = jj * om;
    sden[j] = T(1) + exp(T(-2) * (jj * kk * d));
  }
  __syncthreads();

  const T dt = T(p.dt_fd);
  const double dd = double(d);
  for (int q0 = 0; q0 < Q; q0 += LANES) {
    // ---- the lane's point (registers, the whole pass) ----
    const int q = q0 + lane;
    const bool live = q < Q;
    const T sq = live ? p.gauss[q] : T(0), wq = live ? p.gauss[Q + q] : T(0);
    const T x = x1 + sq * dx, y = y1 + sq * dy, z = z1 + sq * dz;
    const T xw = x * cos_w + y * sin_w;
    const T Lw = L * wq;
    const T cd = cd_m * Lw, ci = ci_m * Lw, slam_c = slam_m * Lw * zp;
    T ucp = Uc;
    if (p.power_law) {
      const T frac = fmin(fmax((z + d) / d, T(0)), T(1));
      ucp = Uc * pow(frac, operand(p.alpha, 0));
    }
    const T ucx = ucp * cos_c, ucy = ucp * sin_c;
    const double zd = double(z);

    // every group runs every round (the last round's idle groups on a copy
    // of the last phase, writing nothing), so the shuffles see whole warps
    for (int s0 = 0; s0 < S; s0 += GROUPS) {
      const int sp = s0 + grp;
      const T t = p.ts[sp < S ? sp : S - 1];
      T s1, c1;
      sincos_t<T>(kk * xw - om * t, &s1, &c1);
      T a1 = T(0), b1 = T(0);
      if (FD) {
        // theta(t + dt) - theta(t), as the reference's float64 forms it
        const double kx = __dmul_rn(double(kk), double(xw)), td = double(t);
        const double th0 = __dadd_rn(kx, -__dmul_rn(double(om), td));
        const double th1 = __dadd_rn(
            kx, -__dmul_rn(double(om), __dadd_rn(td, p.dt_fd)));
        const T dl = T(__dadd_rn(th1, -th0));
        T sh, ch;
        sincos_t<T>(T(0.5) * dl, &sh, &ch);
        a1 = T(-2) * sh * sh;
        b1 = T(2) * sh * ch;
      }

      // the surface, its rise and (fd) its step to t + dt
      T c = c1, sn = s1, a = a1, b = b1;
      T eta = T(0), etad = T(0), deta = T(0);
#pragma unroll 2
      for (int j = 0; j < N; ++j) {
        const T E = sE[j];
        eta = fma(E, c, eta);
        etad = fma(sEjw[j], sn, etad);
        if (FD) deta = fma(E, a * c - b * sn, deta);
        const T cn = c * c1 - sn * s1;
        sn = sn * c1 + c * s1;
        c = cn;
        if (FD) {
          const T an = a + a1 + a * a1 - b * b1;
          b = b + b1 + b * a1 + a * b1;
          a = an;
        }
      }
      const bool wet0 = z <= eta;
      const bool wet1 = !FD || z <= eta + deta;

      // the evaluation heights (float64) and, at a wet point, the profiles
      // there: the velocities and accelerations
      const double ze0 = eval_height<WHEELER>(zd, dd, double(eta),
                                              p.clamp_z);
      T hdz = T(0);
      if (FD)
        hdz = T(__dadd_rn(eval_height<WHEELER>(
                              zd, dd, __dadd_rn(double(eta), double(deta)),
                              p.clamp_z),
                          -ze0));
      T u = T(0), wv = T(0), du = T(0), dw = T(0);
      if (live && wet0) {
        const T zm = T(ze0);
        c = c1; sn = s1; a = a1; b = b1;
        for (int j = 0; j < N; ++j) {
          const T Uj = sU[j];
          const Profile<T> pr(sjk[j], zm, d, sden[j]);
          const T uc = Uj * pr.C, us = Uj * pr.S;
          u = fma(uc, c, u);
          wv = fma(us, sn, wv);
          if (FD) {
            const T dA = sjk[j] * hdz;
            const T e1 = expm1(dA), em = expm1(-dA);
            const T dC = pr.P * e1 + pr.Mn * em, dS = pr.P * e1 - pr.Mn * em;
            const T dc = a * c - b * sn, ds = a * sn + b * c;
            du = fma(Uj, pr.C * dc + dC * (c + dc), du);
            dw = fma(Uj, pr.S * ds + dS * (sn + ds), dw);
          } else {
            du = fma(uc * sjw[j], sn, du);
            dw = fma(-(us * sjw[j]), c, dw);
          }
          const T cn = c * c1 - sn * s1;
          sn = sn * c1 + c * s1;
          c = cn;
          if (FD) {
            const T an = a + a1 + a * a1 - b * b1;
            b = b + b1 + b * a1 + a * b1;
            a = an;
          }
        }
      }
      if (FD) {
        // dry at t + dt: the reference's difference to a zero velocity
        du = wet1 ? du / dt : -(u + Uc) / dt;
        dw = wet1 ? dw / dt : -wv / dt;
      }

      // ---- the point's forces, then the member's sums ----
      T r[SUMS];
#pragma unroll
      for (int i = 0; i < SUMS; ++i) r[i] = T(0);
      if (live && wet0) {
        const T Ux = u * cos_w + ucx, Uy = u * sin_w + ucy, Uz = wv;
        const T Ax = du * cos_w, Ay = du * sin_w, Az = dw;
        const T Ue = Ux * ex + Uy * ey + Uz * ez;
        const T Ae = Ax * ex + Ay * ey + Az * ez;
        const T Upx = Ux - Ue * ex, Upy = Uy - Ue * ey, Upz = Uz - Ue * ez;
        const T Um = sqrt(Upx * Upx + Upy * Upy + Upz * Upz);
        if (Um > T(1e-10)) {
          const T cdf = cd * Um;
          r[6] = cdf * Upx;
          r[7] = cdf * Upy;
          r[8] = cdf * Upz;
        }
        r[9] = ci * (Ax - Ae * ex);
        r[10] = ci * (Ay - Ae * ey);
        r[11] = ci * (Az - Ae * ez);
      }
      if (live && fabs(z - eta) <= D / T(2) && etad > T(0)) {
        const T v = slam_c * etad * etad;   // 0 without slamming
        r[6] += v * zpx;
        r[7] += v * zpy;
        r[8] += v * zp_sq;
      }
#pragma unroll
      for (int c3 = 0; c3 < 3; ++c3) {
        const T f = r[6 + c3] + r[9 + c3];
        r[c3] = (T(1) - sq) * f;
        r[3 + c3] = sq * f;
      }
#pragma unroll
      for (int off = LANES / 2; off > 0; off /= 2)
#pragma unroll
        for (int i = 0; i < SUMS; ++i)
          r[i] += __shfl_xor_sync(0xffffffffu, r[i], off, LANES);
      // lane i < 12 stores sum i: F1 xyz, F2 xyz, drag xyz, inertia xyz
      T out = r[0];
#pragma unroll
      for (int i = 1; i < SUMS; ++i)
        if (lane == i) out = r[i];
      if (sp < S && lane < SUMS) {
        const size_t fo = ((size_t)sp * M + m) * 3;
        T* const dst = lane < 3   ? p.F1 + fo + lane
                       : lane < 6 ? p.F2 + fo + lane - 3
                                  : p.partials + ((size_t)m * S + sp) * 6
                                        + lane - 6;
        *dst = q0 == 0 ? out : *dst + out;
      }
    }
  }
}

// totals[s, c] = sum over members m of partials[m, s, c] in a fixed
// order: a block takes 32 consecutive (s, c) entries (one a lane, so each
// member's row is one coalesced load) and 8 warps; warp y adds the members
// m = y, y + 8, ... in turn, then the 8 warp sums meet in a fixed tree.
constexpr int TOTALS_WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(32 * TOTALS_WARPS)
pointwise_loads_totals_kernel(const T* __restrict__ part, int M, int S,
                              T* __restrict__ totals) {
  __shared__ T sum[TOTALS_WARPS][32];
  const int lane = threadIdx.x % 32, y = threadIdx.x / 32;
  const int i = blockIdx.x * 32 + lane, n = S * 6;
  T acc = T(0);
  if (i < n)
    for (int m = y; m < M; m += TOTALS_WARPS) acc += part[(size_t)m * n + i];
  sum[y][lane] = acc;
  __syncthreads();
  if (y == 0 && i < n)
    totals[i] = ((sum[0][lane] + sum[1][lane])
                 + (sum[2][lane] + sum[3][lane]))
                + ((sum[4][lane] + sum[5][lane])
                   + (sum[6][lane] + sum[7][lane]));
}

template <typename T, bool FD, bool WHEELER>
cudaError_t launch(const PointwiseParamsT<T>& p, cudaStream_t stream) {
  const size_t smem = MODE_WORDS * (size_t)p.N * sizeof(T);
  if (smem > STATIC_SMEM) {
    // past 48 KiB a block's dynamic shared memory needs the opt-in; past
    // the device's maximum this fails and the launch reports it
    const cudaError_t err = cudaFuncSetAttribute(
        pointwise_loads_kernel<T, FD, WHEELER>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  pointwise_loads_kernel<T, FD, WHEELER><<<p.M, THREADS, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pointwise_loads_totals_kernel<T>
      <<<(p.S * 6 + 31) / 32, 32 * TOTALS_WARPS, 0, stream>>>(
          p.partials, p.M, p.S, p.totals);
  return cudaGetLastError();
}

template <typename T>
bool valid(const PointwiseParamsT<T>* p) {
  return p->M > 0 && p->S > 0 && p->N > 0 && p->n_gauss > 0 && p->coords &&
         p->conn && p->D && p->ts && p->gauss && p->F1 && p->F2 &&
         p->partials && p->totals;
}

template <typename T>
int launch_any(const PointwiseParamsT<T>* p, int fd, int wheeler,
               void* stream) {
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (fd)
    err = wheeler ? launch<T, true, true>(*p, st)
                  : launch<T, true, false>(*p, st);
  else
    err = wheeler ? launch<T, false, true>(*p, st)
                  : launch<T, false, false>(*p, st);
  return (int)err;
}

}  // namespace

extern "C" {

// sizeof(PointwiseParamsT): the wrapper checks its ctypes mirrors.
int morison_pointwise_params_size_f32() {
  return (int)sizeof(PointwiseParamsT<float>);
}
int morison_pointwise_params_size_f64() {
  return (int)sizeof(PointwiseParamsT<double>);
}

// Launches the pointwise kernel (M blocks, 6 N words of dynamic shared
// memory) and the fixed-order totals on ``stream`` (``fd``:
// forward-difference acceleration, else the exact series; ``wheeler``:
// Wheeler stretching).  ``p`` is host memory (copied into the kernel's
// parameters); every pointer in it is device memory, partials [M, S, 6].
// Returns the CUDA error code (0 on success).
int morison_pointwise_launch_f32(const PointwiseParamsT<float>* p, int fd,
                                 int wheeler, void* stream) {
  return launch_any(p, fd, wheeler, stream);
}
int morison_pointwise_launch_f64(const PointwiseParamsT<double>* p, int fd,
                                 int wheeler, void* stream) {
  return launch_any(p, fd, wheeler, stream);
}

const char* morison_pointwise_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
