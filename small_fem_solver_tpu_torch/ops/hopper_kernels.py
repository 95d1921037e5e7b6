"""Hand-written Hopper (sm_90a) kernels and their PyTorch wrappers.

``morison_phase_batch_cuda`` launches the fused phase-batch Morison kernel
in ``csrc/morison_phase_batch.cu``, the port of the Pallas TPU kernel
``small_fem_solver_tpu/ops/pallas_kernels.py::morison_phase_batch_pallas``.
Its plain PyTorch version is ``ops/morison.py::morison_phase_batch``; the
wrapper never falls back to it.

Build: at first use the source is compiled by ``nvcc`` into a shared
library with a plain C interface under ``small_fem_solver_tpu_torch/_build/``
(keyed by a hash of the source, so an edited kernel is rebuilt) and loaded
with ``ctypes``; the launch takes raw device pointers and PyTorch's current
stream.  Nothing is built or imported when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

from .morison import MorisonPhaseBatch, gauss_legendre_01, nodal_scatter
from .waves import FourierWave

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "morison_phase_batch.cu"
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xcompiler", "-fPIC", "-shared")
MAX_MODES = 32     # wave modes the kernel takes
MAX_GAUSS = 16     # quadrature points per member (one 16-lane half-warp)

_lib = None


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the Hopper kernels are built "
                           "from source at first use and need the CUDA "
                           "toolkit")
    return path


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; returns it.

    The library file is named by the source hash and written atomically,
    so concurrent first uses cannot load a half-written file.
    """
    global _lib
    if _lib is not None:
        return _lib
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"libmorison_phase_batch_{tag}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(_SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.morison_phase_batch_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
        ptr, ptr, ptr, ptr, ptr]
    lib.morison_phase_batch_launch.restype = i32
    lib.morison_members_per_block.argtypes = []
    lib.morison_members_per_block.restype = i32
    lib.morison_error_string.argtypes = [i32]
    lib.morison_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def kernel_inputs(wave: FourierWave, coords, conn, D_m, wave_dir_deg,
                  current_dir_deg, Cd, Cm, rho_water, ts, n_gauss: int,
                  current_alpha) -> dict:
    """Pack the kernel's f32 operands on ``coords``' device:

    - ``rows`` [9, P] per quadrature point (P = M n_gauss, member-major):
      z, ex, ey, ez, cd = 0.5 rho Cd D L w_q, ci = rho Cm pi D^2/4 L w_q,
      current x / y (uniform or power-law), wave-frame x;
    - ``modes`` [N, 4]: E_j, U_j, j omega, j k;
    - ``ctst`` [S, 2N]: cos(j omega t_s) | sin(j omega t_s);
    - ``sq`` [n_gauss]: Gauss abscissae s_q;
    - ``scal`` [3]: cos / sin of the wave heading and the depth d.

    All of it is float32 whatever the caller's dtype (the TPU kernel's
    contract); the results are cast back by the caller.
    """
    f32, dev = torch.float32, coords.device

    def t(v):
        return torch.as_tensor(v, dtype=f32, device=dev)

    theta_w = torch.deg2rad(t(90.0) - t(wave_dir_deg))
    theta_c = torch.deg2rad(t(90.0) - t(current_dir_deg))
    cos_w, sin_w = torch.cos(theta_w), torch.sin(theta_w)
    cos_c, sin_c = torch.cos(theta_c), torch.sin(theta_c)

    coords = coords.to(f32)
    c1 = coords[conn[:, 0]]
    dL = coords[conn[:, 1]] - c1
    L = torch.linalg.norm(dL, dim=-1)
    e = dL / L[:, None]
    M = conn.shape[0]
    s_np, w_np = gauss_legendre_01(n_gauss)
    s, wq = t(s_np), t(w_np)
    pos = c1[:, None, :] + s[None, :, None] * dL[:, None, :]   # [M, Q, 3]

    x_wave = (pos[..., 0] * cos_w + pos[..., 1] * sin_w).reshape(-1)
    z = pos[..., 2].reshape(-1)
    Lw = L[:, None] * wq[None, :]
    D = D_m.to(f32)[:, None]

    def per_member(v):
        v = t(v)
        return v[:, None] if v.ndim == 1 else v

    rho = t(rho_water)
    cd_row = 0.5 * rho * per_member(Cd) * D * Lw
    ci_row = rho * per_member(Cm) * (math.pi * D**2 / 4.0) * Lw
    wave = wave.to(f32, dev)
    if current_alpha is None:
        Uc_pt = wave.U_c.expand(z.shape)
    else:
        frac = torch.clip((z + wave.d) / wave.d, 0.0, 1.0)
        Uc_pt = wave.U_c * frac ** t(current_alpha)
    rows = torch.stack([
        z, *(e[:, c:c + 1].expand(M, n_gauss).reshape(-1) for c in range(3)),
        cd_row.expand(M, n_gauss).reshape(-1),
        ci_row.expand(M, n_gauss).reshape(-1),
        Uc_pt * cos_c, Uc_pt * sin_c, x_wave]).contiguous()

    N = wave.n_modes
    j = torch.arange(1, N + 1, dtype=f32, device=dev)
    modes = torch.stack([wave.E, wave.U, j * wave.omega, j * wave.k],
                        dim=1).contiguous()
    jt = (j * wave.omega)[None, :] * ts.to(f32)[:, None]
    ctst = torch.cat([torch.cos(jt), torch.sin(jt)], dim=1).contiguous()
    return dict(rows=rows, modes=modes, ctst=ctst, sq=s.contiguous(),
                scal=torch.stack([cos_w, sin_w, wave.d]))


def launch_packed(k: dict, M: int, n_gauss: int, wheeler: bool):
    """Launch the kernel on operands packed by :func:`kernel_inputs` (all
    on one CUDA device); returns (F1 [S, M, 3], F2 [S, M, 3], totals
    [S, 6] = drag xyz | inertia xyz), float32."""
    lib = build()
    S, N = k["ctst"].shape[0], k["modes"].shape[0]
    dev, f32 = k["rows"].device, torch.float32
    F1 = torch.empty(S, M, 3, dtype=f32, device=dev)
    F2 = torch.empty(S, M, 3, dtype=f32, device=dev)
    mpb = lib.morison_members_per_block()
    partials = torch.empty(-(-M // mpb), S, 6, dtype=f32, device=dev)
    totals = torch.empty(S, 6, dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.morison_phase_batch_launch(
            k["rows"].data_ptr(), k["modes"].data_ptr(), k["ctst"].data_ptr(),
            k["sq"].data_ptr(), k["scal"].data_ptr(), M, n_gauss, S, N,
            int(wheeler), F1.data_ptr(), F2.data_ptr(), partials.data_ptr(),
            totals.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("morison_phase_batch kernel launch failed: "
                           + lib.morison_error_string(err).decode())
    morison_phase_batch_cuda.launches += 1
    return F1, F2, totals


def morison_phase_batch_cuda(wave: FourierWave, coords: torch.Tensor,
                             conn: torch.Tensor, D_m: torch.Tensor,
                             wave_dir_deg, current_dir_deg, Cd, Cm,
                             rho_water, ts: torch.Tensor, n_gauss: int = 15,
                             current_alpha=None,
                             stretching: str = "none") -> MorisonPhaseBatch:
    """Fused-kernel :func:`..morison.morison_phase_batch` (float32 results).

    Same signature, semantics and result type; raises ``RuntimeError`` for
    tensors that are not on a CUDA device and when the build or the launch
    fails.  ``morison_phase_batch_cuda.launches`` counts kernel launches
    (:func:`launch_packed` adds one per successful launch).
    """
    if n_gauss > MAX_GAUSS:
        raise ValueError(f"n_gauss must be <= {MAX_GAUSS}")
    if wave.n_modes > MAX_MODES:
        raise ValueError(f"wave n_modes must be <= {MAX_MODES}")
    if stretching not in ("none", "wheeler"):
        raise ValueError(f"unknown stretching mode {stretching!r}")
    if coords.device.type != "cuda":
        raise RuntimeError("morison_phase_batch_cuda needs CUDA tensors "
                           f"(got {coords.device}); the plain version is "
                           "ops.morison.morison_phase_batch")
    k = kernel_inputs(wave, coords, conn, D_m, wave_dir_deg,
                      current_dir_deg, Cd, Cm, rho_water, ts, n_gauss,
                      current_alpha)
    F1, F2, totals = launch_packed(k, conn.shape[0], n_gauss,
                                   stretching == "wheeler")
    total_drag, total_inertia = totals[:, :3], totals[:, 3:]
    return MorisonPhaseBatch(
        nodal_forces=nodal_scatter(F1, F2, conn, coords.shape[0]),
        total_drag=total_drag, total_inertia=total_inertia,
        total_morison=total_drag + total_inertia, F1=F1, F2=F2)


morison_phase_batch_cuda.launches = 0
