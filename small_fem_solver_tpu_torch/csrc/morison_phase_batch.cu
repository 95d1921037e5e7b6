// Fused phase-batch Morison loads for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel small_fem_solver_tpu/ops/pallas_kernels.py
// (morison_phase_batch_pallas, body _make_kernel._kernel).  Computes what
// ops/morison.py::morison_phase_batch computes, for every wave phase s and
// quadrature point p of every member m:
//
//   1. the five kinematic fields (eta, u along the wave heading, w, du/dt,
//      dw/dt) as sums over the N Fourier modes, with the phase factors
//      cos/sin(j omega t_s) read from a small [S, 2N] table and the spatial
//      factors cos/sin(j k x), U_j C_j(z), U_j S_j(z) built once per block;
//   2. optionally the frozen-stretch Wheeler correction (second-order Taylor
//      of each field about z with dz = -(z + d) eta / (d + eta), clipped to
//      +-d) from the d/dz and d^2/dz^2 fields of the same mode sums;
//   3. the submergence mask z <= eta, the projection normal to the member
//      axis, drag cd |u_n| u_n (gated at |u_n| > 1e-10) and inertia ci a_n;
//   4. the lever-rule reduction over each member's quadrature points into
//      the node-1 / node-2 end forces F1 = sum (1 - s_q) f, F2 = sum s_q f,
//      plus per-phase drag and inertia totals.
//
// Layout.  One thread block owns MEMBERS_PER_BLOCK members x PHASE_TILE
// phases.  A member takes QLANES = 16 lanes (lane q = quadrature point,
// q >= n_gauss idle), so a warp holds two whole members and the reduction
// over quadrature points is four xor-shuffles inside 16-lane halves.  The
// block's 256 threads are 128 point lanes x 2 phase lanes; each thread keeps
// its point and walks PHASE_TILE / 2 phases.  Idle lanes (q >= n_gauss,
// m >= M) compute nothing and contribute exact zeros, so no padding value
// can produce inf or NaN.
//
// Bounds.  Per (phase, point) the mode loop costs ~10 f32 FMAs per mode
// (18 modes at the flagship) against four shared-memory reads of the
// point's spatial factors and two broadcast reads of the phase table; the
// only device-memory traffic is the per-point rows (read once per block)
// and the [S, M, 3] end forces written once, so the kernel is bound by
// FMA issue and shared-memory bandwidth, not by HBM.  Every sum is plain
// f32 in registers (no tensor cores, no TF32).
//
// Totals.  Each block writes per-phase partial drag/inertia sums
// [n_groups, S, 6]; a second kernel adds the groups in a fixed order.  No
// float atomics anywhere, so results are bit-repeatable.
#include <cuda_runtime.h>

namespace {

constexpr int QLANES = 16;
constexpr int MEMBERS_PER_BLOCK = 8;
constexpr int POINTS = MEMBERS_PER_BLOCK * QLANES;   // 128 point lanes
constexpr int PHASE_LANES = 2;
constexpr int THREADS = POINTS * PHASE_LANES;        // 256
constexpr int PHASE_TILE = 32;
constexpr int N_COEF = 4;   // cos(jkx), sin(jkx), U_j C_j(z), U_j S_j(z)

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = QLANES / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <bool WHEELER>
__global__ void __launch_bounds__(THREADS)
morison_phase_batch_kernel(const float* __restrict__ rows,   // [9, P]
                           const float* __restrict__ modes,  // [N, 4]
                           const float* __restrict__ ctst,   // [S, 2N]
                           const float* __restrict__ sq,     // [n_gauss]
                           const float* __restrict__ scal,   // [3]
                           int M, int n_gauss, int S, int N,
                           float* __restrict__ F1,           // [S, M, 3]
                           float* __restrict__ F2,           // [S, M, 3]
                           float* __restrict__ partials) {   // [G, S, 6]
  extern __shared__ float smem[];
  float* coef = smem;                          // [N][N_COEF][POINTS]
  float* phase = smem + N * N_COEF * POINTS;   // [PHASE_TILE][2N]
  __shared__ float red[PHASE_LANES][MEMBERS_PER_BLOCK][6];

  const float cosw = scal[0], sinw = scal[1], d = scal[2];
  const int P = M * n_gauss;
  const int tid = threadIdx.x;
  const int lp = tid % POINTS;
  const int sub = tid / POINTS;
  const int lm = lp / QLANES;
  const int q = lp % QLANES;
  const int m = blockIdx.x * MEMBERS_PER_BLOCK + lm;
  const bool valid = (m < M) && (q < n_gauss);
  const int p = m * n_gauss + q;
  const int s0 = blockIdx.y * PHASE_TILE;
  const int ns = min(PHASE_TILE, S - s0);

  // ---- per-block spatial factors of every (mode, point) ----
  for (int idx = tid; idx < N * POINTS; idx += THREADS) {
    const int j = idx / POINTS, pt = idx % POINTS;
    const int mm = blockIdx.x * MEMBERS_PER_BLOCK + pt / QLANES;
    const int qq = pt % QLANES;
    float cjx = 0.f, sjx = 0.f, uc = 0.f, us = 0.f;
    if (mm < M && qq < n_gauss) {
      const int pp = mm * n_gauss + qq;
      const float z = rows[pp];
      const float xw = rows[8 * P + pp];
      const float U = modes[j * 4 + 1];
      const float jk = modes[j * 4 + 3];
      sincosf(jk * xw, &sjx, &cjx);
      // overflow-safe cosh(A)/cosh(B), sinh(A)/cosh(B), A = jk (z + d)
      const float A = jk * (z + d), B = jk * d, Aa = fabsf(A);
      const float scale = expf(Aa - B) / (1.f + expf(-2.f * B));
      const float e2 = expf(-2.f * Aa);
      const float sgn = (A > 0.f) ? 1.f : ((A < 0.f) ? -1.f : 0.f);
      uc = U * scale * (1.f + e2);
      us = U * sgn * scale * (1.f - e2);
    }
    float* c = coef + j * N_COEF * POINTS + pt;
    c[0] = cjx;
    c[POINTS] = sjx;
    c[2 * POINTS] = uc;
    c[3 * POINTS] = us;
  }
  for (int idx = tid; idx < ns * 2 * N; idx += THREADS)
    phase[idx] = ctst[s0 * 2 * N + idx];
  __syncthreads();

  float z = 0.f, ex = 0.f, ey = 0.f, ez = 0.f, cd = 0.f, ci = 0.f;
  float ucx = 0.f, ucy = 0.f, s_q = 0.f;
  if (valid) {
    z = rows[p];
    ex = rows[P + p];
    ey = rows[2 * P + p];
    ez = rows[3 * P + p];
    cd = rows[4 * P + p];
    ci = rows[5 * P + p];
    ucx = rows[6 * P + p];
    ucy = rows[7 * P + p];
    s_q = sq[q];
  }

  const int n_steps = (ns + PHASE_LANES - 1) / PHASE_LANES;  // block-uniform
  for (int k = 0; k < n_steps; ++k) {
    const int ls = k * PHASE_LANES + sub;
    float fdx = 0.f, fdy = 0.f, fdz = 0.f, fix = 0.f, fiy = 0.f, fiz = 0.f;
    if (valid && ls < ns) {
      const float* ct = phase + ls * 2 * N;
      const float* st = ct + N;
      float eta = 0.f, u = 0.f, w = 0.f, du = 0.f, dw = 0.f;
      float u_z = 0.f, w_z = 0.f, du_z = 0.f, dw_z = 0.f;
      float u_zz = 0.f, w_zz = 0.f, du_zz = 0.f, dw_zz = 0.f;
      for (int j = 0; j < N; ++j) {
        const float* c = coef + j * N_COEF * POINTS + lp;
        const float cjx = c[0], sjx = c[POINTS];
        const float uc = c[2 * POINTS], us = c[3 * POINTS];
        const float E = modes[j * 4 + 0];
        const float jw = modes[j * 4 + 2];
        // cos / sin of (j k x - j omega t)
        const float cp = fmaf(cjx, ct[j], sjx * st[j]);
        const float sp = fmaf(sjx, ct[j], -cjx * st[j]);
        eta = fmaf(E, cp, eta);
        u = fmaf(uc, cp, u);
        w = fmaf(us, sp, w);
        du = fmaf(uc * jw, sp, du);
        dw = fmaf(-us * jw, cp, dw);
        if (WHEELER) {
          // d/dz: C' = jk S, S' = jk C; d^2/dz^2: C'' = jk^2 C, S'' = jk^2 S
          const float jk = modes[j * 4 + 3];
          const float uz = jk * us, wz = jk * uc;
          const float uzz = jk * wz, wzz = jk * uz;
          u_z = fmaf(uz, cp, u_z);
          w_z = fmaf(wz, sp, w_z);
          du_z = fmaf(uz * jw, sp, du_z);
          dw_z = fmaf(-wz * jw, cp, dw_z);
          u_zz = fmaf(uzz, cp, u_zz);
          w_zz = fmaf(wzz, sp, w_zz);
          du_zz = fmaf(uzz * jw, sp, du_zz);
          dw_zz = fmaf(-wzz * jw, cp, dw_zz);
        }
      }
      if (WHEELER) {
        float dz = -(z + d) * eta / (d + eta);
        dz = fminf(fmaxf(dz, -d), d);
        const float h2 = 0.5f * dz * dz;
        u = u + dz * u_z + h2 * u_zz;
        w = w + dz * w_z + h2 * w_zz;
        du = du + dz * du_z + h2 * du_zz;
        dw = dw + dz * dw_z + h2 * dw_zz;
      }
      if (z <= eta) {
        const float Ux = u * cosw + ucx, Uy = u * sinw + ucy, Uz = w;
        const float Ax = du * cosw, Ay = du * sinw, Az = dw;
        const float Ue = Ux * ex + Uy * ey + Uz * ez;
        const float Ae = Ax * ex + Ay * ey + Az * ez;
        const float Upx = Ux - Ue * ex, Upy = Uy - Ue * ey,
                    Upz = Uz - Ue * ez;
        const float Umag = sqrtf(Upx * Upx + Upy * Upy + Upz * Upz);
        const float cdf = (Umag > 1e-10f) ? cd * Umag : 0.f;
        fdx = cdf * Upx;
        fdy = cdf * Upy;
        fdz = cdf * Upz;
        fix = ci * (Ax - Ae * ex);
        fiy = ci * (Ay - Ae * ey);
        fiz = ci * (Az - Ae * ez);
      }
    }
    const float fx = fdx + fix, fy = fdy + fiy, fz = fdz + fiz;
    const float w1 = 1.f - s_q;
    const float a0 = half_warp_sum(w1 * fx), a1 = half_warp_sum(w1 * fy),
                a2 = half_warp_sum(w1 * fz);
    const float b0 = half_warp_sum(s_q * fx), b1 = half_warp_sum(s_q * fy),
                b2 = half_warp_sum(s_q * fz);
    const float t0 = half_warp_sum(fdx), t1 = half_warp_sum(fdy),
                t2 = half_warp_sum(fdz), t3 = half_warp_sum(fix),
                t4 = half_warp_sum(fiy), t5 = half_warp_sum(fiz);
    if (q == 0) {
      if (m < M && ls < ns) {
        const size_t o = ((size_t)(s0 + ls) * M + m) * 3;
        F1[o] = a0; F1[o + 1] = a1; F1[o + 2] = a2;
        F2[o] = b0; F2[o + 1] = b1; F2[o + 2] = b2;
      }
      float* r = red[sub][lm];
      r[0] = t0; r[1] = t1; r[2] = t2; r[3] = t3; r[4] = t4; r[5] = t5;
    }
    __syncthreads();
    if (tid < PHASE_LANES * 6) {
      const int sb = tid / 6, c = tid % 6;
      const int ls2 = k * PHASE_LANES + sb;
      if (ls2 < ns) {
        float acc = 0.f;
#pragma unroll
        for (int mm = 0; mm < MEMBERS_PER_BLOCK; ++mm) acc += red[sb][mm][c];
        partials[((size_t)blockIdx.x * S + s0 + ls2) * 6 + c] = acc;
      }
    }
    __syncthreads();
  }
}

// totals[s, c] = sum over member groups g (in order) of partials[g, s, c]
__global__ void morison_totals_kernel(const float* __restrict__ partials,
                                      int G, int S,
                                      float* __restrict__ totals) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * 6) return;
  float acc = 0.f;
  for (int g = 0; g < G; ++g) acc += partials[(size_t)g * S * 6 + i];
  totals[i] = acc;
}

template <bool WHEELER>
cudaError_t launch(const float* rows, const float* modes, const float* ctst,
                   const float* sq, const float* scal, int M,
                   int n_gauss, int S, int N, float* F1, float* F2,
                   float* partials, float* totals, cudaStream_t stream) {
  const int G = (M + MEMBERS_PER_BLOCK - 1) / MEMBERS_PER_BLOCK;
  const size_t smem =
      sizeof(float) * ((size_t)N * N_COEF * POINTS + PHASE_TILE * 2 * N);
  cudaError_t err = cudaFuncSetAttribute(
      morison_phase_batch_kernel<WHEELER>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(G, (S + PHASE_TILE - 1) / PHASE_TILE);
  morison_phase_batch_kernel<WHEELER><<<grid, THREADS, smem, stream>>>(
      rows, modes, ctst, sq, scal, M, n_gauss, S, N, F1, F2,
      partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  morison_totals_kernel<<<(S * 6 + 255) / 256, 256, 0, stream>>>(
      partials, G, S, totals);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Members per block: the wrapper sizes the partial-sum buffer with it.
int morison_members_per_block() { return MEMBERS_PER_BLOCK; }

// Launches the fused kernel and the fixed-order totals reduction on
// ``stream``.  All pointers are device f32, contiguous; returns the CUDA
// error code (0 on success).
int morison_phase_batch_launch(const float* rows, const float* modes,
                               const float* ctst, const float* sq,
                               const float* scal, int M,
                               int n_gauss, int S, int N, int wheeler,
                               float* F1, float* F2, float* partials,
                               float* totals, void* stream) {
  if (M <= 0 || S <= 0 || N <= 0 || N > 32 || n_gauss <= 0 ||
      n_gauss > QLANES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      wheeler ? launch<true>(rows, modes, ctst, sq, scal, M, n_gauss, S, N,
                             F1, F2, partials, totals, st)
              : launch<false>(rows, modes, ctst, sq, scal, M, n_gauss, S, N,
                              F1, F2, partials, totals, st);
  return (int)err;
}

const char* morison_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
