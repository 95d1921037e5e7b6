"""Hand-written Hopper (sm_90a) kernels and their PyTorch wrappers.

- ``morison_end_forces_cuda`` (member end forces and totals, what the
  condensed paths read) and ``morison_phase_batch_cuda`` (plus the nodal
  scatter) launch the fused phase-batch Morison kernel in
  ``csrc/morison_phase_batch.cu`` (a float32 and a float64 instance,
  picked by the operands' dtype), the port of the Pallas TPU kernel
  ``small_fem_solver_tpu/ops/pallas_kernels.py::
  morison_phase_batch_pallas``.  Its plain PyTorch versions are
  ``ops/morison.py::morison_end_forces`` / ``morison_phase_batch``.
  ``morison_end_forces_batch_cuda`` takes a batch of C cases: the float64
  instance and the case-batched float32 instance have a case axis, so the
  batch is one launch (the two wrappers above launch the float64 one at
  C = 1; a float32 single case keeps the float32 instance); its plain
  version is ``ops/morison.py::morison_end_forces_batch``.
  ``morison_sea_end_forces_cuda`` / ``morison_sea_batch_cuda`` launch the
  same file's general-mode instance (float32 and float64) for the
  independent components of a random sea; its plain version is
  ``ops/spectrum.py::morison_sea_end_forces``.
- ``morison_pointwise_end_forces_cuda`` launches the pointwise Morison
  kernel in ``csrc/morison_pointwise.cu`` (float32 and float64): the
  reference's pointwise kinematics (clamp, Wheeler stretching, the
  forward-difference or exact acceleration) and the slam term for every
  phase and Gauss point of a scan, summed to the member end forces.  It
  replaces no TPU kernel (the JAX package evaluates this path in plain
  jnp); its plain version is
  ``ops/morison.py::morison_pointwise_end_forces``.
- ``chain_sweep_cuda`` launches the chain-sweep kernel in
  ``csrc/chain_sweep.cu`` (forward RHS sweep + backward substitution), the
  port of the two Pallas TPU kernels of
  ``benchmarks/ab_pallas_sweep.py::pallas_sweep``.  Its plain PyTorch
  version is ``ops/condense.py::chain_sweep_plain``.

On CUDA tensors the wrappers launch their kernel or raise (a failed
build or launch is never replaced by the plain version); tensors on the
CPU run the plain version at any size (the chain sweep's dispatch is
``ops/condense.py::condense_loads``).  The Morison kernel takes at most
``MAX_GAUSS`` quadrature points and ``MAX_MODES`` harmonic modes; the
wrappers check those limits on the CUDA route only.  A caller that
accepts larger shapes picks its route from them first
(:func:`kernel_route`): past the limits on the card it runs the plain
version in the model's dtype and counts a plain route, launching nothing.

Build: at first use each source is compiled by ``nvcc`` into a shared
library with a plain C interface under ``small_fem_solver_tpu_torch/_build/``
(keyed by a hash of the source and flags, so an edited kernel is rebuilt)
and loaded with ``ctypes``; a launch takes raw device pointers and
PyTorch's current stream.  :func:`build_all` starts one ``nvcc`` per
source, all at once, under the build directory's file lock
(``native.build_lock``), so the ranks of a process group that reach it
together compile each library once.  Nothing is built or imported when
this module is imported.  :func:`launch_counts` reads (and resets) the
launch counters.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from ..native import build_lock
from .morison import (POINTWISE_CHUNK_ELEMS, MorisonPhaseBatch,
                      _mode_spatial_coeffs, gauss_legendre_01,
                      morison_end_forces, morison_end_forces_batch,
                      morison_pointwise_end_forces, nodal_scatter)
from .spectrum import SpectralSea, morison_sea_end_forces
from .waves import FourierWave, surface_elevation

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v")
MAX_MODES = 32     # wave modes the Morison kernel takes
MAX_GAUSS = 16     # quadrature points per member (one 16-lane half-warp)

_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points of each kernel library: name -> (argtypes, restype)
_SIGNATURES = {
    "morison_phase_batch": {
        "morison_phase_batch_launch": ([_PTR, _I32, _I32, _PTR], _I32),
        "morison_grid_blocks": ([_PTR, _I32], _I32),
        "morison_params_size": ([], _I32),
        "morison_error_string": ([_I32], ctypes.c_char_p),
        "morison_harm64_launch": ([_PTR, _I32, _I32, _PTR, _PTR], _I32),
        "morison_harm64_tiles": ([_PTR, _I32, _PTR], _I32),
        "morison_harm64_scratch": ([_PTR], _I64),
        "morison_harm64_params_size": ([], _I32),
        "morison_f32_batch_params_size": ([], _I32),
        "morison_f32_batch_tiles": ([_PTR, _PTR], _I32),
        "morison_f32_batch_launch": ([_PTR, _I32, _I32, _PTR], _I32),
        "morison_sea_launch_f32": ([_PTR, _I32, _I32, _PTR, _PTR], _I32),
        "morison_sea_launch_f64": ([_PTR, _I32, _I32, _PTR, _PTR], _I32),
        "morison_sea_grid_blocks_f32": ([_PTR], _I32),
        "morison_sea_grid_blocks_f64": ([_PTR], _I32),
        "morison_sea_scratch_f32": ([_PTR], _I64),
        "morison_sea_scratch_f64": ([_PTR], _I64),
        "morison_sea_params_size_f32": ([], _I32),
        "morison_sea_params_size_f64": ([], _I32),
    },
    "morison_pointwise": {
        "morison_pointwise_launch_f32": ([_PTR, _I32, _I32, _PTR], _I32),
        "morison_pointwise_launch_f64": ([_PTR, _I32, _I32, _PTR], _I32),
        "morison_pointwise_params_size_f32": ([], _I32),
        "morison_pointwise_params_size_f64": ([], _I32),
        "morison_pointwise_error_string": ([_I32], ctypes.c_char_p),
    },
    "chain_sweep": {
        "chain_sweep_launch_f32": ([_PTR] * 6 + [_I64] * 4 + [_I32] * 5
                                   + [_PTR] * 4, _I32),
        "chain_sweep_launch_f64": ([_PTR] * 6 + [_I64] * 4 + [_I32] * 5
                                   + [_PTR] * 4, _I32),
        "chain_sweep_chains_per_block": ([_I32, _I32], _I32),
        "chain_sweep_narrow_rhs": ([_I32, _I32, _I32], _I32),
        "chain_sweep_error_string": ([_I32], ctypes.c_char_p),
    },
}
KERNELS = tuple(_SIGNATURES)

_libs: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the Hopper kernels are built "
                           "from source at first use and need the CUDA "
                           "toolkit")
    return path


def _library_path(name: str) -> pathlib.Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"lib{name}_{tag}.so"


def build_all(names=KERNELS) -> dict:
    """Compile (if needed) and load the named kernel libraries; returns
    {name: ctypes.CDLL}.

    Missing libraries are compiled concurrently, one ``nvcc`` per source,
    under the build directory's file lock (:func:`..native.build_lock`):
    processes that reach the build at once (the ranks of a group) compile
    each library once.  Each file is named by its source hash and written
    to a temporary name renamed into place, so no process loads a
    half-written file.
    """
    todo = {n: _library_path(n) for n in names if n not in _libs}
    if not all(so.exists() for so in todo.values()):
        with build_lock(_BUILD_DIR):
            _compile({n: so for n, so in todo.items() if not so.exists()})
    for name, so in todo.items():
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        if name == "morison_phase_batch" and (
                lib.morison_params_size() != ctypes.sizeof(_MorisonParams)
                or lib.morison_harm64_params_size()
                != ctypes.sizeof(_Harm64Params)
                or lib.morison_f32_batch_params_size()
                != ctypes.sizeof(_Batch32Params)
                or lib.morison_sea_params_size_f32()
                != ctypes.sizeof(_SeaParams)
                or lib.morison_sea_params_size_f64()
                != ctypes.sizeof(_SeaParams64)):
            raise RuntimeError("MorisonParams / SeaParamsT / BatchParamsT in "
                               "morison_phase_batch.cu and their ctypes "
                               "mirrors differ in size")
        if name == "morison_pointwise" and any(
                getattr(lib, f"morison_pointwise_params_size_{n}")()
                != ctypes.sizeof(params)
                for n, params, _ in _POINTWISE_INSTANCES.values()):
            raise RuntimeError("PointwiseParamsT in morison_pointwise.cu and "
                               "its ctypes mirrors differ in size")
        _libs[name] = lib
    return {n: _libs[n] for n in names}


def _compile(todo: dict) -> None:
    """nvcc each ``{name: library path}`` concurrently (the caller holds
    the build lock); raises with nvcc's output on a failure."""
    jobs = {}
    for name, so in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(_CSRC / f"{name}.cu")]
        jobs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    failed = []
    for name, (tmp, proc) in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}.cu: nvcc failed ({proc.returncode}):\n"
                          f"{out}")
        else:
            # ptxas's report (registers, stack, spills), for build_report
            todo[name].with_suffix(".log").write_text(out)
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("\n".join(failed))


def build(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load one kernel library."""
    return _libs.get(name) or build_all((name,))[name]


def build_report(name: str) -> dict:
    """What the build of one kernel library says of each kernel, keyed by
    its mangled name: from ``ptxas -v`` (kept beside the library when it
    is built) ``registers``, ``stack``, ``spill_stores`` and
    ``spill_loads`` in bytes; from ``cuobjdump -sass`` of the library the
    count of its ``DMMA`` (FP64 tensor-core) and ``HMMA`` (any other
    tensor-core type, TF32 included) instructions and the first
    ``DMMA``'s text, ``first_dmma``."""
    build(name)
    so = _library_path(name)
    out, cur = {}, {}
    for line in so.with_suffix(".log").read_text().splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m[1])
    tool = pathlib.Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    cur = {}
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            cur.update(DMMA=0, HMMA=0, first_dmma=None)
            continue
        m = re.search(r"/\*[0-9a-f]{4,6}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"((DMMA|HMMA)[^;]*?)\s*;", line)
        if m and cur:
            cur[m[2]] += 1
            if m[2] == "DMMA" and cur["first_dmma"] is None:
                cur["first_dmma"] = m[1]
    return out


def _operand_struct(scalar):
    """ctypes mirror of ``OperandT<T>`` in ``csrc/morison_phase_batch.cu``
    for ``scalar`` (c_float or c_double)."""
    class Operand(ctypes.Structure):
        _fields_ = [("ptr", ctypes.c_void_p), ("stride", ctypes.c_longlong),
                    ("value", scalar)]
    return Operand


_Operand = _operand_struct(ctypes.c_float)
_Operand64 = _operand_struct(ctypes.c_double)


class _MorisonParams(ctypes.Structure):
    """ctypes mirror of ``ParamsT<float>`` (checked against the library's
    ``sizeof`` at build)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("coords", "conn", "D")]
                + [(n, _Operand) for n in ("Cd", "Cm", "wave_dir",
                                           "current_dir", "rho", "alpha")]
                + [(n, ctypes.c_void_p) for n in ("E", "U", "k", "omega", "d",
                                                  "Uc", "ts")]
                + [("s", ctypes.c_float * MAX_GAUSS),
                   ("w", ctypes.c_float * MAX_GAUSS)]
                + [(n, ctypes.c_int) for n in ("M", "S", "N", "n_gauss",
                                               "power_law")]
                + [(n, ctypes.c_void_p) for n in ("F1", "F2", "partials",
                                                  "totals")])


def _batch_params_struct(scalar):
    """ctypes mirrors of ``HOperandT<T>`` (element (case c, member m) at
    ptr[sc c + sm m], or ``value`` when ptr is null) and ``BatchParamsT<T>``,
    a case-batched instance's operands, for ``scalar`` (c_double or c_float;
    checked against the library's ``sizeof`` at build)."""
    class HOperand(ctypes.Structure):
        _fields_ = [("ptr", ctypes.c_void_p), ("sc", ctypes.c_longlong),
                    ("sm", ctypes.c_longlong), ("value", scalar)]

    class BatchParams(ctypes.Structure):
        _fields_ = ([(n, ctypes.c_void_p) for n in ("coords", "conn")]
                    + [(n, HOperand) for n in ("D", "Cd", "Cm", "wave_dir",
                                               "current_dir", "rho", "alpha")]
                    + [(n, ctypes.c_void_p) for n in ("E", "U", "k", "omega",
                                                      "d", "Uc", "ts")]
                    + [("s", scalar * MAX_GAUSS), ("w", scalar * MAX_GAUSS)]
                    + [(n, ctypes.c_int) for n in ("C", "M", "S", "N",
                                                   "n_gauss", "power_law")]
                    + [(n, ctypes.c_void_p) for n in ("F1", "F2", "partials",
                                                      "totals")])
    return HOperand, BatchParams


_HOperand, _Harm64Params = _batch_params_struct(ctypes.c_double)
_HOperand32, _Batch32Params = _batch_params_struct(ctypes.c_float)
# the case-batched instance's ctypes types by operand dtype
_BATCH_STRUCTS = {torch.float64: (_HOperand, _Harm64Params, ctypes.c_double),
                  torch.float32: (_HOperand32, _Batch32Params,
                                  ctypes.c_float)}


def _sea_params_struct(scalar, operand):
    """ctypes mirror of ``SeaParamsT<T>`` in ``csrc/morison_phase_batch.cu``
    (checked against the library's ``sizeof`` at build)."""
    class SeaParams(ctypes.Structure):
        _fields_ = ([(n, ctypes.c_void_p) for n in ("coords", "conn", "D")]
                    + [(n, operand) for n in ("Cd", "Cm", "wave_dir",
                                              "current_dir", "rho", "alpha")]
                    + [(n, ctypes.c_void_p) for n in ("E", "U", "k", "omega",
                                                      "phi", "dir", "d", "Uc",
                                                      "phase")]
                    + [("s", scalar * MAX_GAUSS), ("w", scalar * MAX_GAUSS)]
                    + [(n, ctypes.c_int) for n in ("M", "S", "N", "n_gauss",
                                                   "power_law")]
                    + [(n, ctypes.c_void_p) for n in ("F1", "F2", "partials",
                                                      "totals")])
    return SeaParams


_SeaParams = _sea_params_struct(ctypes.c_float, _Operand)
_SeaParams64 = _sea_params_struct(ctypes.c_double, _Operand64)
# the general-mode instance by operand dtype: (name, params, operand,
# scalar)
_SEA_INSTANCES = {
    torch.float32: ("f32", _SeaParams, _Operand, ctypes.c_float),
    torch.float64: ("f64", _SeaParams64, _Operand64, ctypes.c_double),
}


def kernel_operands(wave: FourierWave, coords, conn, D_m, wave_dir_deg,
                    current_dir_deg, Cd, Cm, rho_water, ts, n_gauss: int,
                    current_alpha) -> dict:
    """The kernel's operands, as it reads them, in ``coords``' dtype
    (float32 or float64: the kernel instance) on its device:

    - ``coords`` [n_nodes, 3], ``conn`` [M, 2] (int64), ``D`` [M], ``ts``
      [S] and the wave's ``E``, ``U`` [N], ``k``, ``omega``, ``d``, ``Uc``
      (0-d): tensors;
    - ``Cd``, ``Cm`` (per member [M] or scalar), ``wave_dir``,
      ``current_dir``, ``rho`` and ``alpha`` (``None``: uniform current):
      each a tensor or a Python float (numbers and numpy arrays are taken
      in the kernel's dtype);
    - ``s``, ``w``: the n_gauss-point Gauss rule on [0, 1] (host numpy in
      the kernel's dtype, passed to the kernel by value).

    Every tensor operand must already have ``coords``' dtype and device:
    mixed dtypes raise ``TypeError`` (nothing is cast), another device
    ``ValueError``.  So this issues no device operation: no host-to-device
    copy, no synchronisation.  The kernel's prologue expands member ->
    point from these.
    """
    return _operands({n: getattr(wave, n) for n in ("E", "U", "k", "omega",
                                                    "d", "U_c")},
                     "wave", coords, conn, D_m, wave_dir_deg,
                     current_dir_deg, Cd, Cm, rho_water, ts, n_gauss,
                     current_alpha)


def _operands(mode_fields: dict, owner: str, coords, conn, D_m,
              wave_dir_deg, current_dir_deg, Cd, Cm, rho_water, ts,
              n_gauss: int, current_alpha) -> dict:
    """:func:`kernel_operands` for the wave's (or sea's) tensor fields
    ``mode_fields``: each checked, ``U_c`` under the key ``Uc``."""
    dtype, dev = coords.dtype, coords.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError("the Morison kernel takes float32 or float64 "
                        f"operands, got {dtype}")

    def tensor(v, name):
        if v.dtype != dtype:
            raise TypeError(f"Morison kernel operand {name} is {v.dtype}, "
                            f"coords {dtype}: mixed dtypes (cast them first)")
        if v.device != dev:
            raise ValueError(f"Morison kernel operand {name} is on "
                             f"{v.device}, coords on {dev}")
        return v.contiguous()

    def value(v, name):
        if isinstance(v, torch.Tensor):
            return tensor(v, name)
        if np.ndim(v) > 0:
            return torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)
        return float(v)

    s, w = gauss_legendre_01(n_gauss, np.float32 if dtype == torch.float32
                             else np.float64)
    return dict(
        coords=tensor(coords, "coords"),
        conn=conn.to(device=dev, dtype=torch.int64).contiguous(),
        D=tensor(D_m, "D_m"), ts=tensor(ts, "ts"),
        **{"Uc" if n == "U_c" else n: None if v is None
           else tensor(v, f"{owner}.{n}") for n, v in mode_fields.items()},
        Cd=value(Cd, "Cd"),
        Cm=value(Cm, "Cm"), wave_dir=value(wave_dir_deg, "wave_dir_deg"),
        current_dir=value(current_dir_deg, "current_dir_deg"),
        rho=value(rho_water, "rho_water"),
        alpha=(None if current_alpha is None
               else value(current_alpha, "current_alpha")),
        s=s, w=w)


def cast_operands(dtype, device, *xs) -> tuple:
    """``xs`` as operands of the Morison kernel's ``dtype`` instance on
    ``device``: waves and tensors cast and moved, numpy arrays made
    tensors, Python numbers and ``None`` passed as they are (the kernel
    takes a number by value).  Integer operands (``conn``) are not passed
    through here."""
    def cast(x):
        if isinstance(x, (FourierWave, SpectralSea)):
            return x.to(dtype, device)
        if isinstance(x, (torch.Tensor, np.ndarray)):
            return torch.as_tensor(x, dtype=dtype, device=device)
        return x
    return tuple(cast(x) for x in xs)


def _operand(v, M: int, name: str, cls=_Operand):
    """A value or a tensor (0-d, or [M] per member) as an Operand."""
    if not isinstance(v, torch.Tensor):
        return cls(None, 0, v)
    if v.ndim == 0:
        return cls(v.data_ptr(), 0, 0.0)
    if tuple(v.shape) != (M,):
        raise ValueError(f"{name} must be a scalar or per-member [{M}], got "
                         f"shape {tuple(v.shape)}")
    return cls(v.data_ptr(), 1, 0.0)


def launch_morison(k: dict, wheeler: bool):
    """Launch the float32 instance on float32 operands from
    :func:`kernel_operands` (all on one CUDA device); returns (F1 [S, M,
    3], F2 [S, M, 3], totals [S, 6] = drag xyz | inertia xyz).  Raises for
    CPU tensors and for float64 operands (the float64 instance is
    :func:`launch_morison_batch64`'s)."""
    dev, dtype = k["coords"].device, k["coords"].dtype
    if dev.type != "cuda":
        raise RuntimeError("the Morison kernel needs CUDA tensors (got "
                           f"{dev}); the plain version is "
                           "ops.morison.morison_phase_batch")
    if dtype != torch.float32:
        raise TypeError("launch_morison launches the float32 instance; "
                        "float64 operands go to launch_morison_batch64")
    lib = build("morison_phase_batch")
    M, S, N = k["conn"].shape[0], k["ts"].shape[0], k["E"].shape[0]
    n_gauss = len(k["s"])
    F1 = torch.empty(S, M, 3, dtype=dtype, device=dev)
    F2 = torch.empty(S, M, 3, dtype=dtype, device=dev)
    totals = torch.empty(S, 6, dtype=dtype, device=dev)
    p = _MorisonParams(
        *(k[n].data_ptr() for n in ("coords", "conn", "D")),
        *(_operand(k[n], M, n) for n in ("Cd", "Cm", "wave_dir",
                                          "current_dir", "rho")),
        _operand(0.0 if k["alpha"] is None else k["alpha"], M, "alpha"),
        *(k[n].data_ptr() for n in ("E", "U", "k", "omega", "d", "Uc",
                                    "ts")),
        (ctypes.c_float * MAX_GAUSS)(*k["s"]),
        (ctypes.c_float * MAX_GAUSS)(*k["w"]),
        M, S, N, n_gauss, int(k["alpha"] is not None),
        F1.data_ptr(), F2.data_ptr(), None, totals.data_ptr())
    with torch.cuda.device(dev):
        G = lib.morison_grid_blocks(ctypes.byref(p), int(wheeler))
        if G <= 0:
            raise RuntimeError("morison_phase_batch grid query failed: "
                               + lib.morison_error_string(-G).decode())
        # the kernel's per-block partial totals [G, S, 6]
        partials = torch.empty(G, S, 6, dtype=dtype, device=dev)
        p.partials = partials.data_ptr()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.morison_phase_batch_launch(ctypes.byref(p), int(wheeler),
                                             G, stream)
    if err != 0:
        raise RuntimeError("morison_phase_batch kernel launch failed: "
                           + lib.morison_error_string(err).decode())
    morison_phase_batch_cuda.launches += 1
    morison_phase_batch_cuda.instance_launches["f32"] += 1
    return F1, F2, totals


def _hoperand(v, C: int, M: int, name: str, per_member: bool,
              cls=_HOperand):
    """An operand of a case-batched instance as an ``HOperand`` (``cls``:
    its ctypes mirror for the instance's dtype): a number or 0-d tensor
    (shared), [C] per case (``per_member=False``), or (with
    ``per_member``) [M] per member, [C, M] per case and member, [C, 1] per
    case."""
    if not isinstance(v, torch.Tensor):
        return cls(None, 0, 0, v)
    shape = tuple(v.shape)
    strides = {(): (0, 0)}
    strides.update({(M,): (0, 1), (C, M): (M, 1), (C, 1): (1, 0)}
                   if per_member else {(C,): (1, 0)})
    if shape not in strides:
        want = "[M], [C, M] or [C, 1]" if per_member else "[C]"
        raise ValueError(f"{name} must be a scalar or {want} with C = {C}, "
                         f"M = {M}; got shape {shape}")
    return cls(v.data_ptr(), *strides[shape], 0.0)


_MEMBER_OPERANDS = ("D", "Cd", "Cm")
_CASE_OPERANDS = ("wave_dir", "current_dir", "rho", "alpha")


def batch_kernel_operands(waves: FourierWave, coords, conn, D_m,
                          wave_dir_deg, current_dir_deg, Cd, Cm, rho_water,
                          ts, n_gauss: int, current_alpha) -> dict:
    """The case-batched instances' operands for C cases (float64 or
    float32: the instance), under :func:`kernel_operands`' dtype and device
    rules (mixed dtypes raise ``TypeError``; no device operation): ``waves``
    a batch
    (``waves.stack_waves``: ``E``, ``U`` [C, N], ``k``, ``omega``, ``d``,
    ``U_c`` [C]), ``ts`` [C, S]; ``D``, ``Cd``, ``Cm`` [C, M] (per case and
    member), [C, 1] (per case), [M] (per member) or a scalar;
    ``wave_dir``, ``current_dir``, ``rho``, ``alpha`` [C] or a scalar; and
    ``C``.  Other shapes raise ``ValueError``."""
    k = kernel_operands(waves, coords, conn, D_m, wave_dir_deg,
                        current_dir_deg, Cd, Cm, rho_water, ts, n_gauss,
                        current_alpha)
    if k["E"].ndim != 2 or k["ts"].ndim != 2:
        raise ValueError("a case batch has waves with E [C, N] and ts "
                         f"[C, S]; got E {tuple(k['E'].shape)}, ts "
                         f"{tuple(k['ts'].shape)}")
    C, N = k["E"].shape
    M = k["conn"].shape[0]
    wanted = dict(U=(C, N), k=(C,), omega=(C,), d=(C,), Uc=(C,),
                  ts=(C, k["ts"].shape[1]))
    for n, shape in wanted.items():
        if tuple(k[n].shape) != shape:
            raise ValueError(f"batch operand {n} must be {list(shape)}, got "
                             f"{list(k[n].shape)}")
    for n in _MEMBER_OPERANDS + _CASE_OPERANDS:
        if k[n] is not None:
            _hoperand(k[n], C, M, n, n in _MEMBER_OPERANDS)
    k["C"] = C
    return k


def _batch_params(k: dict):
    """The ``BatchParamsT`` of operands ``k`` (outputs unset), in their
    dtype: ``Harm64Params`` or ``Batch32Params``."""
    C, M = k["C"], k["conn"].shape[0]
    hop, params, scalar = _BATCH_STRUCTS[k["coords"].dtype]
    return params(
        k["coords"].data_ptr(), k["conn"].data_ptr(),
        *(_hoperand(k[n], C, M, n, True, hop) for n in _MEMBER_OPERANDS),
        *(_hoperand(k[n], C, M, n, False, hop) for n in _CASE_OPERANDS[:3]),
        _hoperand(0.0 if k["alpha"] is None else k["alpha"], C, M, "alpha",
                  False, hop),
        *(k[n].data_ptr() for n in ("E", "U", "k", "omega", "d", "Uc",
                                    "ts")),
        (scalar * MAX_GAUSS)(*k["s"]), (scalar * MAX_GAUSS)(*k["w"]),
        C, M, k["ts"].shape[1], k["E"].shape[1], len(k["s"]),
        int(k["alpha"] is not None), None, None, None, None)


# The most bytes of records scratch one launch of the case-batched float64
# instance takes (M Q (4 N + 12) + 2 S N2 doubles a case): a larger batch
# is launched in chunks of cases.  Every case is tiled and summed as in a
# launch of its own, so chunking changes no bit.  The 1,000 cases of the
# dense envelope on the 51-member jacket (274 MB) stay one launch.
HARM64_SCRATCH_BYTES = 1 << 29


def case_slice(k: dict, c0: int, c1: int) -> dict:
    """Cases ``c0:c1`` of operands from :func:`batch_kernel_operands`, as
    views: the wave and phase times, and each per-case operand ([C] or [C,
    M] / [C, 1]); shared operands unchanged."""
    out = dict(k, C=c1 - c0)
    for n in ("E", "U", "k", "omega", "d", "Uc", "ts"):
        out[n] = k[n][c0:c1]
    for n in _MEMBER_OPERANDS + _CASE_OPERANDS:
        v = k[n]
        if isinstance(v, torch.Tensor) and v.ndim == (
                2 if n in _MEMBER_OPERANDS else 1):
            out[n] = v[c0:c1]
    return out


def harm64_tiles(k: dict, wheeler: bool) -> dict:
    """The tiling the library derives for operands ``k`` (S, M, Q and N;
    the same for every case): m-tiles a block ``MT``, phase tiles
    ``n_pt``, grid rows ``G`` (the rows of the partial sums), member tiles,
    the fused pass's shared memory in bytes, its B tiles ``NB``, and the
    scratch doubles of one case.  Raises ``ValueError`` where the library
    refuses the shapes (no layout fits shared memory)."""
    lib = build("morison_phase_batch")
    p = _batch_params(case_slice(k, 0, 1))
    tiles = (ctypes.c_int * 6)()
    err = lib.morison_harm64_tiles(ctypes.byref(p), int(wheeler), tiles)
    if err != 0:
        raise ValueError("morison_harm64 tiling refused these operands: "
                         + lib.morison_error_string(err).decode())
    return dict(zip(("MT", "n_pt", "G", "n_tiles", "smem_bytes", "NB"),
                    tiles), scratch=lib.morison_harm64_scratch(
                        ctypes.byref(p)))


def launch_morison_batch64(k: dict, wheeler: bool):
    """Launch the case-batched float64 instance on operands from
    :func:`batch_kernel_operands` (all on one CUDA device): its records
    pass (into a scratch buffer of M Q (4 N + 12) + 2 S N2 doubles a case
    allocated here, N2 = N rounded up to even), the fused pass and the
    fixed-order totals, one launch for the C cases, or one a chunk of
    cases where their scratch would pass ``HARM64_SCRATCH_BYTES``.
    Returns (F1 [C, S, M, 3], F2 [C, S, M, 3], totals [C, S, 6] = drag xyz
    | inertia xyz).  Raises for CPU tensors."""
    dev, dtype = k["coords"].device, k["coords"].dtype
    if dev.type != "cuda":
        raise RuntimeError("the Morison kernel needs CUDA tensors (got "
                           f"{dev}); the plain version is "
                           "ops.morison.morison_end_forces_batch")
    if dtype != torch.float64:
        raise TypeError("the case-batched instance takes float64 operands, "
                        f"got {dtype}")
    lib = build("morison_phase_batch")
    C, M, S = k["C"], k["conn"].shape[0], k["ts"].shape[1]
    F1 = torch.empty(C, S, M, 3, dtype=dtype, device=dev)
    F2 = torch.empty(C, S, M, 3, dtype=dtype, device=dev)
    totals = torch.empty(C, S, 6, dtype=dtype, device=dev)
    tl = harm64_tiles(k, wheeler)
    G = tl["G"]
    chunk = max(1, min(C, HARM64_SCRATCH_BYTES // (8 * tl["scratch"])))
    with torch.cuda.device(dev):
        # a chunk's partial totals [chunk, G, S, 6]; the records pass's
        # per-(case, point, mode) records, slot data and phase table
        partials = torch.empty(chunk, G, S, 6, dtype=dtype, device=dev)
        scratch = torch.empty(chunk * tl["scratch"], dtype=dtype,
                              device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for c0 in range(0, C, chunk):
            c1 = min(C, c0 + chunk)
            p = _batch_params(case_slice(k, c0, c1))
            p.F1, p.F2 = F1[c0:c1].data_ptr(), F2[c0:c1].data_ptr()
            p.totals, p.partials = totals[c0:c1].data_ptr(), \
                partials.data_ptr()
            err = lib.morison_harm64_launch(ctypes.byref(p), int(wheeler),
                                            G, scratch.data_ptr(), stream)
            if err != 0:
                raise RuntimeError("morison_harm64 kernel launch failed: "
                                   + lib.morison_error_string(err).decode())
            morison_phase_batch_cuda.launches += 1
            morison_phase_batch_cuda.instance_launches["f64"] += 1
    return F1, F2, totals


# The case-batched float32 instance's case-packed tile (its library's
# rule, csrc/morison_phase_batch.cu::F32BatchTiles): (case, phase) slots a
# tile, members a grid row walks, most grid rows, shared memory a block.
F32B_SLOTS = 384
F32B_MIN_MEMBERS = 4
F32B_ROWS = 264
F32B_SMEM = 110 * 1024
# The most bytes of partial totals ([chunk, rows, S, 6] floats) one launch
# of the case-batched float32 instance writes: a larger batch is launched
# in chunks of cases, which changes no bit.
F32_BATCH_PARTIALS_BYTES = 1 << 28


def f32_batch_tiles(S: int, M: int, Q: int, N: int) -> dict:
    """The case-packed tiling of the case-batched float32 instance for S
    phases, M members, Q points and N modes (the library's rule, which
    :func:`launch_morison_batch32` reads from the library): ``S2`` (S
    rounded up to even: the slots of a case), ``K`` cases a group,
    ``n_pt`` phase tiles a case, ``rows`` (grid rows, the rows of the
    partial totals), ``RST`` (a case's record stride in float4, Q NMAX + 1)
    and ``bytes`` of shared memory.  Thread t of a tile owns slots 2 t and
    2 t + 1: case 2 t // S2 of the group at phases 2 t % S2 and + 1 (one
    tile), or phases tile * 384 + 2 t and + 1 of the group's one case."""
    nmax = (N + 3) // 4 * 4
    S2, RST = S + (S & 1), Q * nmax + 1
    per_case = 16 * RST + 32 * Q + 12 * nmax
    fit = F32B_SMEM // per_case
    if S2 <= F32B_SLOTS:
        K, n_pt = min(F32B_SLOTS // S2, fit), 1
    else:
        K, n_pt = 1, -(-S2 // F32B_SLOTS)
    rows = min(-(-M // F32B_MIN_MEMBERS), F32B_ROWS)
    return dict(S2=S2, K=K, n_pt=n_pt, rows=rows, RST=RST,
                bytes=per_case * K)


def launch_morison_batch32(k: dict, wheeler: bool):
    """Launch the case-batched float32 instance on float32 operands from
    :func:`batch_kernel_operands` (all on one CUDA device): its fused pass
    and the fixed-order totals, one launch for the C cases, or one a chunk
    of cases where their partial totals would pass
    ``F32_BATCH_PARTIALS_BYTES``.  Returns (F1 [C, S, M, 3], F2 [C, S, M,
    3], totals [C, S, 6] = drag xyz | inertia xyz).  Raises for CPU
    tensors."""
    dev, dtype = k["coords"].device, k["coords"].dtype
    if dev.type != "cuda":
        raise RuntimeError("the Morison kernel needs CUDA tensors (got "
                           f"{dev}); the plain version is "
                           "ops.morison.morison_end_forces_batch")
    if dtype != torch.float32:
        raise TypeError("launch_morison_batch32 takes float32 operands, got "
                        f"{dtype}")
    lib = build("morison_phase_batch")
    C, M, S = k["C"], k["conn"].shape[0], k["ts"].shape[1]
    F1 = torch.empty(C, S, M, 3, dtype=dtype, device=dev)
    F2 = torch.empty(C, S, M, 3, dtype=dtype, device=dev)
    totals = torch.empty(C, S, 6, dtype=dtype, device=dev)
    tiles = (ctypes.c_int * 4)()
    err = lib.morison_f32_batch_tiles(ctypes.byref(_batch_params(
        case_slice(k, 0, 1))), tiles)
    if err != 0:
        raise ValueError("morison_f32_batch tiling refused these operands: "
                         + lib.morison_error_string(err).decode())
    G = tiles[2]
    chunk = max(1, min(C, F32_BATCH_PARTIALS_BYTES // (4 * G * S * 6)))
    with torch.cuda.device(dev):
        partials = torch.empty(chunk, G, S, 6, dtype=dtype, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for c0 in range(0, C, chunk):
            c1 = min(C, c0 + chunk)
            p = _batch_params(case_slice(k, c0, c1))
            p.F1, p.F2 = F1[c0:c1].data_ptr(), F2[c0:c1].data_ptr()
            p.totals, p.partials = totals[c0:c1].data_ptr(), \
                partials.data_ptr()
            err = lib.morison_f32_batch_launch(ctypes.byref(p), int(wheeler),
                                               G, stream)
            if err != 0:
                raise RuntimeError("morison_f32_batch kernel launch failed: "
                                   + lib.morison_error_string(err).decode())
            morison_phase_batch_cuda.launches += 1
            morison_phase_batch_cuda.instance_launches["f32_batch"] += 1
    return F1, F2, totals


def morison_end_forces_batch_cuda(waves: FourierWave, coords: torch.Tensor,
                                  conn: torch.Tensor, D_m, wave_dir_deg,
                                  current_dir_deg, Cd, Cm, rho_water,
                                  ts: torch.Tensor, n_gauss: int = 15,
                                  current_alpha=None,
                                  stretching: str = "none"):
    """Fused-kernel :func:`..morison.morison_end_forces_batch` of C cases
    (the operand shapes of :func:`batch_kernel_operands`): (F1, F2 [C, S,
    M, 3], total_drag, total_inertia [C, S, 3]).

    CUDA tensors launch the case-batched instance of their dtype once for
    the whole batch (float64: :func:`launch_morison_batch64`; float32:
    :func:`launch_morison_batch32`), or raise; CPU tensors run the plain
    version.  Launches count on ``morison_phase_batch_cuda.launches`` and
    ``.instance_launches`` ("f64", "f32_batch").  On CUDA tensors
    ``n_gauss`` > ``MAX_GAUSS`` or more than ``MAX_MODES`` modes raise
    (:func:`kernel_route` picks the plain version for such shapes
    first)."""
    if stretching not in ("none", "wheeler"):
        raise ValueError(f"unknown stretching mode {stretching!r}")
    if coords.device.type != "cuda":
        return morison_end_forces_batch(
            waves, coords, conn, D_m, wave_dir_deg, current_dir_deg, Cd, Cm,
            rho_water, ts, n_gauss, current_alpha, stretching)
    _check_limits(n_gauss, waves.n_modes)
    k = batch_kernel_operands(waves, coords, conn, D_m, wave_dir_deg,
                              current_dir_deg, Cd, Cm, rho_water, ts,
                              n_gauss, current_alpha)
    launch = (launch_morison_batch32 if coords.dtype == torch.float32
              else launch_morison_batch64)
    F1, F2, totals = launch(k, stretching == "wheeler")
    return F1, F2, totals[..., :3], totals[..., 3:]


def morison_end_forces_cuda(wave: FourierWave, coords: torch.Tensor,
                            conn: torch.Tensor, D_m: torch.Tensor,
                            wave_dir_deg, current_dir_deg, Cd, Cm, rho_water,
                            ts: torch.Tensor, n_gauss: int = 15,
                            current_alpha=None, stretching: str = "none"):
    """Fused-kernel :func:`..morison.morison_end_forces`: (F1, F2,
    total_drag, total_inertia) in the operands' dtype.

    CUDA tensors launch the kernel instance of their dtype: float32, or
    float64 (the case-batched instance at C = 1); any other dtype, or
    operands of mixed dtypes, raise ``TypeError`` (nothing is cast), and a
    failed build or launch raises.  CPU tensors run the plain version in
    their own dtype.  Kernel launches count on
    ``morison_phase_batch_cuda.launches`` (per instance on
    ``.instance_launches``).  On CUDA tensors ``n_gauss`` > ``MAX_GAUSS``
    or more than ``MAX_MODES`` modes raise; on the CPU any size runs.
    """
    if stretching not in ("none", "wheeler"):
        raise ValueError(f"unknown stretching mode {stretching!r}")
    if coords.device.type != "cuda":
        return morison_end_forces(wave, coords, conn, D_m, wave_dir_deg,
                                  current_dir_deg, Cd, Cm, rho_water, ts,
                                  n_gauss, current_alpha, stretching)
    _check_limits(n_gauss, wave.n_modes)
    if coords.dtype != torch.float32:
        # the case-batched instance on a batch of one (views, no copy)
        F1, F2, drag, inertia = morison_end_forces_batch_cuda(
            wave._map(lambda t: t[None]), coords, conn, D_m, wave_dir_deg,
            current_dir_deg, Cd, Cm, rho_water, ts[None], n_gauss,
            current_alpha, stretching)
        return F1[0], F2[0], drag[0], inertia[0]
    k = kernel_operands(wave, coords, conn, D_m, wave_dir_deg,
                        current_dir_deg, Cd, Cm, rho_water, ts, n_gauss,
                        current_alpha)
    F1, F2, totals = launch_morison(k, stretching == "wheeler")
    return F1, F2, totals[:, :3], totals[:, 3:]


def morison_phase_batch_cuda(wave: FourierWave, coords: torch.Tensor,
                             conn: torch.Tensor, D_m: torch.Tensor,
                             wave_dir_deg, current_dir_deg, Cd, Cm,
                             rho_water, ts: torch.Tensor, n_gauss: int = 15,
                             current_alpha=None,
                             stretching: str = "none") -> MorisonPhaseBatch:
    """Fused-kernel :func:`..morison.morison_phase_batch`: same signature,
    semantics and result type (in the operands' dtype, float32 or float64,
    on a CUDA device; CPU tensors run the plain version).
    ``morison_phase_batch_cuda.launches`` counts the K1 launches of the
    wrappers and ``.instance_launches`` those of each instance ("f32",
    "f32_batch" and "f64" (case-batched), "sea_f32", "sea_f64"); each
    launcher adds one per launch."""
    F1, F2, total_drag, total_inertia = morison_end_forces_cuda(
        wave, coords, conn, D_m, wave_dir_deg, current_dir_deg, Cd, Cm,
        rho_water, ts, n_gauss, current_alpha, stretching)
    return MorisonPhaseBatch(
        nodal_forces=nodal_scatter(F1, F2, conn, coords.shape[0]),
        total_drag=total_drag, total_inertia=total_inertia,
        total_morison=total_drag + total_inertia, F1=F1, F2=F2)


morison_phase_batch_cuda.launches = 0
morison_phase_batch_cuda.instance_launches = {"f32": 0, "f32_batch": 0,
                                              "f64": 0, "sea_f32": 0,
                                              "sea_f64": 0}
morison_phase_batch_cuda.plain_routes = 0


def kernel_takes(n_gauss: int, n_modes: int | None = None) -> bool:
    """Whether the Morison kernel takes ``n_gauss`` quadrature points and
    ``n_modes`` harmonic modes (None: a random sea, whose general-mode
    instance takes any number of components)."""
    return n_gauss <= MAX_GAUSS and (n_modes is None or n_modes <= MAX_MODES)


def _check_limits(n_gauss: int, n_modes: int | None = None) -> None:
    """The kernel's size limits, on the CUDA route of the wrappers."""
    if n_gauss > MAX_GAUSS:
        raise ValueError(f"n_gauss must be <= {MAX_GAUSS} on the card "
                         f"(got {n_gauss})")
    if n_modes is not None and n_modes > MAX_MODES:
        raise ValueError(f"wave n_modes must be <= {MAX_MODES} on the card "
                         f"(got {n_modes})")


def kernel_route(device: torch.device, n_gauss: int,
                 n_modes: int | None = None) -> bool:
    """The route of a phase-batch Morison call, picked by its caller from
    the shapes before anything runs: True sends it through the kernel's
    wrapper (the kernel on the card, the plain version on the CPU); False,
    on the card past :func:`kernel_takes`' limits, means the caller runs
    the plain version in the model's dtype and launches no kernel, and
    counts one ``morison_phase_batch_cuda.plain_routes``.  The JAX
    package's separable engine, which these paths follow, has no such
    limits."""
    if device.type != "cuda" or kernel_takes(n_gauss, n_modes):
        return True
    morison_phase_batch_cuda.plain_routes += 1
    return False


def sea_phase_table(sea: SpectralSea, ts: torch.Tensor) -> torch.Tensor:
    """The general-mode kernel's phase factors [S, 2N] = cos(omega_i t_s)
    | sin(omega_i t_s), formed in float64 and cast to ``ts``' dtype: a
    2,048-step realization reaches omega t ~ 4e3 rad, where a float32
    argument alone is off by ~2e-4 rad."""
    ang = ts.double()[:, None] * sea.omega.double()[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=1).to(ts.dtype)


# m: float32 against float64 K1-sea results are held off the (sample,
# member) pairs with a Gauss point this close to the f64 free surface
SURFACE_BAND = 1e-4


def surface_band(sea: SpectralSea, coords, conn, wave_dir, ts,
                 band: float = SURFACE_BAND, n_gauss: int = 15):
    """[S, M] mask of the (sample, member) pairs with a Gauss point within
    ``band`` m of the free surface of ``sea`` (f64, from its spatial eta
    rows and the f64 phase table): there the wet / dry mask z <= eta is a
    jump, so a point that float32 rounding of eta (~1e-6 m) puts on the
    other side of the surface changes the member's force by the point's
    whole share."""
    mc = _mode_spatial_coeffs(sea.k, sea.omega, sea.phi, sea.E, sea.U, sea.d,
                              coords, conn, wave_dir, 0.0, n_gauss, "none",
                              sea.dir_deg)
    ph = sea_phase_table(sea, ts)
    N = sea.n_modes
    eta = ph[:, :N] @ mc.Acat[0].T + ph[:, N:] @ mc.Bcat[0].T    # [S, P]
    near = (mc.z[None, :] - eta).abs() < band
    return near.reshape(ts.shape[0], conn.shape[0], -1).any(dim=-1)


def pointwise_band(wave: FourierWave, coords, conn, D_m, wave_dir_deg, ts,
                   n_gauss: int = 15, band: float = SURFACE_BAND,
                   slam: bool = False, fd: bool = False):
    """[S, M] mask of the (phase, member) pairs with a Gauss point within
    ``band`` m of a jump of the pointwise loads (f64, in chunks of
    phases): the free surface (the wet / dry mask), also at t + dt_fd
    with ``fd`` (the forward difference's mask), and with ``slam`` the
    slam band's edges |z - eta| = D / 2.  A float32 evaluation may put a
    point there on the other side of the jump."""
    f64 = torch.float64
    wave = wave.to(f64, coords.device)
    coords, D = coords.to(f64), D_m.to(f64)[:, None]
    th = torch.deg2rad(torch.as_tensor(90.0 - wave_dir_deg, dtype=f64,
                                       device=coords.device))
    s = torch.as_tensor(gauss_legendre_01(n_gauss)[0], device=coords.device)
    c1 = coords[conn[:, 0]]
    pos = c1[:, None, :] + s[None, :, None] * (coords[conn[:, 1]] - c1)[
        :, None, :]
    xw = pos[..., 0] * torch.cos(th) + pos[..., 1] * torch.sin(th)
    z = pos[..., 2]
    out = []
    step = max(1, POINTWISE_CHUNK_ELEMS // (conn.shape[0] * n_gauss
                                            * wave.n_modes))
    for tc in ts.to(f64).split(step):
        tb = tc[:, None, None]
        gap = (z - surface_elevation(wave, xw, tb)).abs()
        near = gap < band
        if slam:
            near |= (gap - D / 2.0).abs() < band
        if fd:
            near |= (z - surface_elevation(wave, xw, tb + wave.dt_fd)
                     ).abs() < band
        out.append(near.any(dim=-1))
    return torch.cat(out)


def sea_kernel_operands(sea: SpectralSea, coords, conn, D_m, wave_dir_deg,
                        current_dir_deg, Cd, Cm, rho_water, ts, n_gauss: int,
                        current_alpha) -> dict:
    """The general-mode instance's operands, as :func:`kernel_operands`
    gives the harmonic ones (the same dtype and device rules: mixed dtypes
    raise ``TypeError``), with the sea's per-mode ``E``, ``U``, ``k``,
    ``omega``, ``phi``, ``dir`` (``None`` for a long-crested sea), and the
    phase table ``phase`` [S, 2N] (:func:`sea_phase_table`, the one device
    operation this issues)."""
    k = _operands({n: getattr(sea, n) for n in ("E", "U", "k", "omega",
                                                "phi", "d", "U_c")}
                  | {"dir": sea.dir_deg}, "sea", coords, conn, D_m,
                  wave_dir_deg, current_dir_deg, Cd, Cm, rho_water, ts,
                  n_gauss, current_alpha)
    k["phase"] = sea_phase_table(sea, k["ts"]).contiguous()
    return k


def launch_morison_sea(k: dict, wheeler: bool):
    """Launch the general-mode instance of the operands' dtype on
    operands from :func:`sea_kernel_operands` (its records pass, fused
    pass and fixed-order totals; the records pass fills a scratch buffer
    of M Q (4 N + 12) + 8 N elements allocated here); returns (F1 [S, M,
    3], F2 [S, M, 3], totals [S, 6]).  Raises for CPU tensors."""
    dev, dtype = k["coords"].device, k["coords"].dtype
    if dev.type != "cuda":
        raise RuntimeError("the Morison kernel needs CUDA tensors (got "
                           f"{dev}); the plain version is "
                           "ops.spectrum.morison_sea_end_forces")
    name, params, operand, scalar = _SEA_INSTANCES[dtype]
    lib = build("morison_phase_batch")
    M, S, N = k["conn"].shape[0], k["ts"].shape[0], k["E"].shape[0]
    F1 = torch.empty(S, M, 3, dtype=dtype, device=dev)
    F2 = torch.empty(S, M, 3, dtype=dtype, device=dev)
    totals = torch.empty(S, 6, dtype=dtype, device=dev)
    p = params(
        *(k[n].data_ptr() for n in ("coords", "conn", "D")),
        *(_operand(k[n], M, n, operand) for n in ("Cd", "Cm", "wave_dir",
                                                   "current_dir", "rho")),
        _operand(0.0 if k["alpha"] is None else k["alpha"], M, "alpha",
                 operand),
        *(k[n].data_ptr() for n in ("E", "U", "k", "omega", "phi")),
        None if k["dir"] is None else k["dir"].data_ptr(),
        k["d"].data_ptr(), k["Uc"].data_ptr(), k["phase"].data_ptr(),
        (scalar * MAX_GAUSS)(*k["s"]), (scalar * MAX_GAUSS)(*k["w"]),
        M, S, N, len(k["s"]), int(k["alpha"] is not None),
        F1.data_ptr(), F2.data_ptr(), None, totals.data_ptr())
    with torch.cuda.device(dev):
        G = getattr(lib, f"morison_sea_grid_blocks_{name}")(ctypes.byref(p))
        if G <= 0:
            raise RuntimeError("morison_sea grid query failed: "
                               + lib.morison_error_string(-G).decode())
        partials = torch.empty(G, S, 6, dtype=dtype, device=dev)
        p.partials = partials.data_ptr()
        # the records pass's output: per (point, mode) records, per-point
        # and per-mode tables
        scratch = torch.empty(
            getattr(lib, f"morison_sea_scratch_{name}")(ctypes.byref(p)),
            dtype=dtype, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"morison_sea_launch_{name}")(
            ctypes.byref(p), int(wheeler), G, scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("morison_sea kernel launch failed: "
                           + lib.morison_error_string(err).decode())
    morison_phase_batch_cuda.launches += 1
    morison_phase_batch_cuda.instance_launches["sea_" + name] += 1
    return F1, F2, totals


def morison_sea_end_forces_cuda(sea: SpectralSea, coords: torch.Tensor,
                                conn: torch.Tensor, D_m: torch.Tensor,
                                wave_dir_deg, current_dir_deg, Cd, Cm,
                                rho_water, ts: torch.Tensor,
                                n_gauss: int = 15, current_alpha=None,
                                stretching: str = "none"):
    """Fused-kernel :func:`..spectrum.morison_sea_end_forces` (a random
    sea: any number of components, long-crested or spread): (F1, F2,
    total_drag, total_inertia) in the operands' dtype.

    The same contract as :func:`morison_end_forces_cuda`: CUDA tensors
    launch the general-mode instance of their dtype (float32 or float64;
    mixed dtypes raise ``TypeError``) or raise when the build or the
    launch fails; CPU tensors run the plain version.  Launches count on
    ``morison_phase_batch_cuda.launches`` and on
    ``.instance_launches["sea_f32"]`` / ``["sea_f64"]``.  On CUDA tensors
    ``n_gauss`` > ``MAX_GAUSS`` raises; the instance takes any number of
    components."""
    if stretching not in ("none", "wheeler"):
        raise ValueError(f"unknown stretching mode {stretching!r}")
    if coords.device.type != "cuda":
        return morison_sea_end_forces(sea, coords, conn, D_m, wave_dir_deg,
                                      current_dir_deg, Cd, Cm, rho_water, ts,
                                      n_gauss, current_alpha, stretching)
    _check_limits(n_gauss)
    k = sea_kernel_operands(sea, coords, conn, D_m, wave_dir_deg,
                            current_dir_deg, Cd, Cm, rho_water, ts, n_gauss,
                            current_alpha)
    F1, F2, totals = launch_morison_sea(k, stretching == "wheeler")
    return F1, F2, totals[:, :3], totals[:, 3:]


def morison_sea_batch_cuda(sea: SpectralSea, coords: torch.Tensor,
                           conn: torch.Tensor, D_m: torch.Tensor,
                           wave_dir_deg, current_dir_deg, Cd, Cm, rho_water,
                           ts: torch.Tensor, n_gauss: int = 15,
                           current_alpha=None,
                           stretching: str = "none") -> MorisonPhaseBatch:
    """:func:`morison_sea_end_forces_cuda` plus the nodal scatter: the
    kernel form of :func:`..spectrum.morison_sea_batch` (which calls it)."""
    F1, F2, total_drag, total_inertia = morison_sea_end_forces_cuda(
        sea, coords, conn, D_m, wave_dir_deg, current_dir_deg, Cd, Cm,
        rho_water, ts, n_gauss, current_alpha, stretching)
    return MorisonPhaseBatch(
        nodal_forces=nodal_scatter(F1, F2, conn, coords.shape[0]),
        total_drag=total_drag, total_inertia=total_inertia,
        total_morison=total_drag + total_inertia, F1=F1, F2=F2)


def _pointwise_params_struct(scalar, operand):
    """ctypes mirror of ``PointwiseParamsT<T>`` in
    ``csrc/morison_pointwise.cu`` (checked against the library's
    ``sizeof`` at build)."""
    class PointwiseParams(ctypes.Structure):
        _fields_ = ([(n, ctypes.c_void_p) for n in ("coords", "conn", "D")]
                    + [(n, operand) for n in ("Cd", "Cm", "wave_dir",
                                              "current_dir", "rho", "alpha")]
                    + [(n, ctypes.c_void_p) for n in ("E", "U", "k", "omega",
                                                      "d", "Uc", "ts",
                                                      "gauss")]
                    + [("dt_fd", ctypes.c_double), ("slam_cs", scalar)]
                    + [(n, ctypes.c_int) for n in ("M", "S", "N", "n_gauss",
                                                   "power_law", "clamp_z")]
                    + [(n, ctypes.c_void_p) for n in ("F1", "F2", "partials",
                                                      "totals")])
    return PointwiseParams


# the pointwise kernel's instances by operand dtype: (name, params,
# operand)
_POINTWISE_INSTANCES = {
    torch.float32: ("f32", _pointwise_params_struct(ctypes.c_float, _Operand),
                    _Operand),
    torch.float64: ("f64",
                    _pointwise_params_struct(ctypes.c_double, _Operand64),
                    _Operand64),
}


@functools.lru_cache(maxsize=None)
def _gauss_rule(n_gauss: int, dtype: torch.dtype, device: torch.device):
    """The n_gauss-point Gauss rule on [0, 1] as the pointwise kernel reads
    it: [2, n_gauss] (abscissae, weights) in ``dtype`` on ``device``, made
    once (one host-to-device copy) and then reused."""
    rule = gauss_legendre_01(n_gauss, np.float32 if dtype == torch.float32
                             else np.float64)
    return torch.as_tensor(np.stack(rule), device=device)


def morison_pointwise_cuda(k: dict, accel: str, stretching: str,
                           dt_fd: float, clamp_z: bool, slam_cs: float):
    """Launch the pointwise kernel's instance of the operands' dtype
    (float32 or float64) on operands from :func:`kernel_operands` (all on
    one CUDA device): the kernel over M blocks, then the fixed-order
    totals over the members' partial sums [M, S, 6] (allocated here).
    ``dt_fd``, ``clamp_z``: the wave's forward-difference step and
    evaluation-height clamp.  Any number of Gauss points and modes runs;
    a wave whose 6 N mode words overflow a block's shared memory (some
    4,800 modes in float64 on the H100) fails at the launch and raises.
    Returns (F1 [S, M, 3], F2 [S, M, 3], totals [S, 6] = drag xyz |
    inertia xyz).  Raises for CPU tensors; launches count on
    ``morison_pointwise_cuda.launches``."""
    dev, dtype = k["coords"].device, k["coords"].dtype
    if dev.type != "cuda":
        raise RuntimeError("the pointwise Morison kernel needs CUDA tensors "
                           f"(got {dev}); the plain version is "
                           "ops.morison.morison_pointwise_end_forces")
    if accel not in ("fd", "analytic"):
        raise ValueError(f"unknown accel mode {accel!r}")
    name, params, operand = _POINTWISE_INSTANCES[dtype]
    lib = build("morison_pointwise")
    M, S, N = k["conn"].shape[0], k["ts"].shape[0], k["E"].shape[0]
    gauss = _gauss_rule(len(k["s"]), dtype, dev)
    F1 = torch.empty(S, M, 3, dtype=dtype, device=dev)
    F2 = torch.empty(S, M, 3, dtype=dtype, device=dev)
    totals = torch.empty(S, 6, dtype=dtype, device=dev)
    partials = torch.empty(M, S, 6, dtype=dtype, device=dev)
    p = params(
        *(k[n].data_ptr() for n in ("coords", "conn", "D")),
        *(_operand(k[n], M, n, operand) for n in ("Cd", "Cm", "wave_dir",
                                                   "current_dir", "rho")),
        _operand(0.0 if k["alpha"] is None else k["alpha"], M, "alpha",
                 operand),
        *(k[n].data_ptr() for n in ("E", "U", "k", "omega", "d", "Uc",
                                    "ts")),
        gauss.data_ptr(), float(dt_fd), float(slam_cs),
        M, S, N, len(k["s"]), int(k["alpha"] is not None), int(clamp_z),
        F1.data_ptr(), F2.data_ptr(), partials.data_ptr(),
        totals.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"morison_pointwise_launch_{name}")(
            ctypes.byref(p), int(accel == "fd"), int(stretching == "wheeler"),
            stream)
    if err != 0:
        raise RuntimeError("morison_pointwise kernel launch failed: "
                           + lib.morison_pointwise_error_string(err).decode())
    morison_pointwise_cuda.launches += 1
    return F1, F2, totals


morison_pointwise_cuda.launches = 0


def morison_pointwise_end_forces_cuda(wave: FourierWave, coords: torch.Tensor,
                                      conn: torch.Tensor, D_m: torch.Tensor,
                                      wave_dir_deg, current_dir_deg, Cd, Cm,
                                      rho_water, ts: torch.Tensor,
                                      n_gauss: int = 15, accel: str = "fd",
                                      stretching: str = "none",
                                      current_alpha=None,
                                      slam_cs: float = 0.0):
    """Kernel :func:`..morison.morison_pointwise_end_forces` (the
    reference's pointwise kinematics with the slam term): (F1, F2,
    total_drag, total_inertia) in the operands' dtype, the same tuple as
    :func:`morison_end_forces_cuda`.

    CUDA tensors launch the pointwise kernel's instance of their dtype
    (float32 or float64; mixed dtypes raise ``TypeError``, nothing is
    cast), at any ``n_gauss`` and number of modes, or raise; CPU tensors
    run the plain version."""
    if stretching not in ("none", "wheeler"):
        raise ValueError(f"unknown stretching mode {stretching!r}")
    if coords.device.type != "cuda":
        return morison_pointwise_end_forces(
            wave, coords, conn, D_m, wave_dir_deg, current_dir_deg, Cd, Cm,
            rho_water, ts, n_gauss, accel, stretching, current_alpha,
            slam_cs)
    k = kernel_operands(wave, coords, conn, D_m, wave_dir_deg,
                        current_dir_deg, Cd, Cm, rho_water, ts, n_gauss,
                        current_alpha)
    F1, F2, totals = morison_pointwise_cuda(k, accel, stretching, wave.dt_fd,
                                            wave.clamp_z, slam_cs)
    return F1, F2, totals[:, :3], totals[:, 3:]


SWEEP_LANES = 32            # right-hand sides per sweep block (one a lane)
SWEEP_MAX_CHAINS = 8        # chains per sweep block (one a warp)
SWEEP_TILE_BUDGET = 80 * 1024
H100_SMEM_OPTIN = 232448    # shared memory a block may opt in to (sm_90)
SWEEP_NARROW_B = 32         # batches narrower than this take the narrow form
SWEEP_NARROW_RHS = 5        # right-hand sides a narrow warp (6 lanes each)
SWEEP_RING = 32             # levels in flight in the narrow form's ring
SWEEP_NARROW_UNROLL = 8     # levels a group of the narrow form's ring
SWEEP_NARROW_BUDGET = 111 * 1024   # shared memory of a narrow block


def sweep_chains_per_block(n_int: int, itemsize: int,
                           smem_optin: int = H100_SMEM_OPTIN) -> int:
    """Chains per block of the sweep kernel's tile (its launch's rule,
    ``csrc/chain_sweep.cu``): the largest of 8, 4, 2, 1 whose tile of
    factors and g / v fits ``SWEEP_TILE_BUDGET``; 0 when even one chain
    exceeds ``smem_optin`` (the untiled form)."""
    def tile_bytes(ct):
        return itemsize * (n_int * ct * 108 + ct * 72
                           + max(n_int, 2) * ct * 6 * (SWEEP_LANES + 1))
    ct = SWEEP_MAX_CHAINS
    while ct > 1 and tile_bytes(ct) > SWEEP_TILE_BUDGET:
        ct //= 2
    return ct if tile_bytes(ct) <= smem_optin else 0


def sweep_stage_elems(rg: int, itemsize: int) -> int:
    """Elements of one stage of the narrow form's ring: a forward level's
    Dinv and DinvL (36 each) and g of ``rg`` right-hand sides (6 each),
    padded to 16 bytes; a backward level's C' takes DinvL's place."""
    per = 16 // itemsize
    return -(-(72 + 6 * rg) // per) * per


def sweep_narrow_rhs(B: int, n_int: int, itemsize: int) -> int:
    """Right-hand sides a warp of the sweep kernel's narrow form takes (its
    launch's form rule, ``csrc/chain_sweep.cu``): for B < ``SWEEP_NARROW_B``
    the most of min(5, B), 4, ..., 1 whose ring, y store (n_int x 6 rg
    values) and the ring groups' two mbarriers fit
    ``SWEEP_NARROW_BUDGET``; 0 means the wide form."""
    if B >= SWEEP_NARROW_B:
        return 0
    barriers = 2 * 8 * (SWEEP_RING // SWEEP_NARROW_UNROLL)
    rg = min(SWEEP_NARROW_RHS, B)
    while rg > 0 and itemsize * (SWEEP_RING * sweep_stage_elems(rg, itemsize)
                                 + n_int * 6 * rg) + barriers \
            > SWEEP_NARROW_BUDGET:
        rg -= 1
    return rg


def sweep_operand(g: torch.Tensor, split: bool = False):
    """How the sweep kernel reads ``g``: (g3, B, (sb, sl, sm, sq), Q,
    levels_inner) with ``g3`` the tensor whose storage it reads.

    ``g`` is [..., n_int, C, 6], or with ``split`` a view [..., n_int, Mc,
    Q, 6] whose chain index is c = m Q + q; element (b, l, c, k) lies at
    ``g3.data_ptr()`` + b sb + l sl + m sm + q sq + k elements;
    ``levels_inner`` says the kernel's tile loads walk l before c.  Leading
    dims flatten to b (a copy only when they do not flatten to one stride),
    and only a ``g`` whose last axis is not contiguous is copied.
    """
    tail = 4 if split else 3
    if g.stride(-1) != 1:
        g = g.contiguous()
    g3 = g.reshape(-1, *g.shape[g.dim() - tail:])
    if split:
        _, _, _, Q, _ = g3.shape
        sb, sl, sm, sq, _ = g3.stride()
        chain_stride = min(sm, sq)
    else:
        Q, sq = 1, 0
        sb, sl, sm, _ = g3.stride()
        chain_stride = sm
    # walk the levels innermost when they are the contiguous axis and a
    # chain's levels fill three warp-wide rounds of loads (the flagship
    # thomas depth); shorter chains (the nested levels) load faster a row of
    # the tile's chains at a time, each load instruction using all 32 lanes
    levels_inner = sl < chain_stride and g3.shape[1] * 6 >= 3 * SWEEP_LANES
    return g3, g3.shape[0], (sb, sl, sm, sq), Q, int(levels_inner)


def chain_sweep_cuda(fac, g: torch.Tensor, split: bool = False):
    """Kernel :func:`..condense.chain_sweep_plain`: same contract, one
    launch for the forward sweep and the backward substitution.

    ``fac``: a ``ChainFactor`` whose ``Dinv``/``DinvL``/``Cprime``
    [n_int, C, 6, 6] and ``B0``/``Cn`` [C, 6, 6] are contiguous;
    ``g``: [..., n_int, C, 6] (or, with ``split``, a view [..., n_int, Mc,
    Q, 6] of the chains c = m Q + q) of the same dtype (float32 or float64)
    on the same CUDA device, in any strided layout (see
    :func:`sweep_operand`).  Returns (fI [..., C, 6], fJ [..., C, 6],
    v [..., n_int, C, 6]), contiguous.  Raises for CPU tensors, mismatched
    operands and any CUDA error.  The launch runs the narrow form for B <
    ``SWEEP_NARROW_B`` right-hand sides (:func:`sweep_narrow_rhs`), else the
    wide form; each column is bit-equal in either.
    ``chain_sweep_cuda.launches`` counts kernel launches and
    ``.narrow_launches`` those of the narrow form.
    """
    if not g.is_cuda:
        raise RuntimeError("chain_sweep_cuda needs CUDA tensors (got "
                           f"{g.device}); the plain version is "
                           "ops.condense.chain_sweep_plain")
    if g.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"chain_sweep_cuda takes float32 or float64, got "
                        f"{g.dtype}")
    n_int, C = fac.Cprime.shape[:2]
    tail = (tuple(g.shape[-4:-3]) + (g.shape[-3] * g.shape[-2],
                                     g.shape[-1])
            if split and g.dim() >= 4 else tuple(g.shape[-3:]))
    if tail != (n_int, C, 6):
        raise ValueError(f"g {tuple(g.shape)} (split={split}) does not end "
                         f"in the factor's (n_int, C, 6) = ({n_int}, {C}, 6)")
    shapes = dict(Dinv=(n_int, C, 6, 6), DinvL=(n_int, C, 6, 6),
                  Cprime=(n_int, C, 6, 6), B0=(C, 6, 6), Cn=(C, 6, 6))
    for name, shape in shapes.items():
        t = getattr(fac, name)
        if (t.device != g.device or t.dtype != g.dtype
                or tuple(t.shape) != shape or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(
                f"factor {name} must be a contiguous, 16-byte aligned "
                f"{shape} tensor of {g.dtype} on {g.device} (got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}, "
                f"contiguous={t.is_contiguous()})")
    batch = g.shape[:g.dim() - (4 if split else 3)]
    g3, B, (sb, sl, sm, sq), Q, levels_inner = sweep_operand(g, split)
    v = g.new_empty(B, n_int, C, 6)
    fI = g.new_empty(B, C, 6)
    fJ = g.new_empty(B, C, 6)
    lib = build("chain_sweep")
    launch = (lib.chain_sweep_launch_f32 if g.dtype == torch.float32
              else lib.chain_sweep_launch_f64)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = launch(fac.Dinv.data_ptr(), fac.DinvL.data_ptr(),
                     fac.Cprime.data_ptr(), fac.B0.data_ptr(),
                     fac.Cn.data_ptr(), g3.data_ptr(), sb, sl, sm, sq, Q, B,
                     n_int, C, levels_inner, v.data_ptr(), fI.data_ptr(),
                     fJ.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("chain_sweep kernel launch failed: "
                           + lib.chain_sweep_error_string(err).decode())
    chain_sweep_cuda.launches += 1
    if lib.chain_sweep_narrow_rhs(B, n_int, g.element_size()) > 0:
        chain_sweep_cuda.narrow_launches += 1
    return (fI.reshape(*batch, C, 6), fJ.reshape(*batch, C, 6),
            v.reshape(*batch, n_int, C, 6))


chain_sweep_cuda.launches = 0
chain_sweep_cuda.narrow_launches = 0


def launch_counts(reset: bool = False) -> dict:
    """The kernel launch counters of this process: ``sweep`` (the chain
    sweep, both forms), ``sweep_narrow`` (its narrow form), ``k1`` (every
    phase-batch Morison kernel launch) and one per K1 instance, and
    ``pointwise`` (the pointwise Morison kernel's launches); with
    ``reset`` every counter is set to 0 after it is read (a rank of a
    process group reads its own counters this way)."""
    counts = {"sweep": chain_sweep_cuda.launches,
              "sweep_narrow": chain_sweep_cuda.narrow_launches,
              "k1": morison_phase_batch_cuda.launches,
              **morison_phase_batch_cuda.instance_launches,
              "pointwise": morison_pointwise_cuda.launches}
    if reset:
        chain_sweep_cuda.launches = 0
        chain_sweep_cuda.narrow_launches = 0
        morison_pointwise_cuda.launches = 0
        morison_phase_batch_cuda.launches = 0
        inst = morison_phase_batch_cuda.instance_launches
        inst.update({k: 0 for k in inst})
    return counts
