"""ctypes bindings of the native host-side mesh kit (the port's own copy
of the part of ``small_fem_solver_tpu/native.py`` it needs).

``native/mesh_kit.cpp`` holds

- ``rainflow_damage_sums``, a batched ASTM E1049 rainflow Miner sum over
  [S, M] float64 histories, identical in its results to the Python stack
  of ``ops/spectrum.py::_rainflow_ranges``;
- ``bcsr_pattern_count`` / ``bcsr_pattern_fill``, the block-sparsity
  pattern of the global stiffness in O(M) with a hash map (integer-equal
  to the numpy builder of ``ops/assembly.py::build_bcsr_pattern``);
- ``aggregate_nodes``, the greedy BFS node aggregation of the two-level
  preconditioner (integer-equal to the Python BFS of
  ``ops/coarse.py::aggregate_nodes``);
- ``rcm_ordering``, a reverse Cuthill-McKee node permutation (with a
  Python BFS when the library is absent), and ``refine_members``, the
  chain refinement's coordinates and connectivity (``None`` when the
  library is absent), the JAX package's two mesh helpers that no library
  path calls.

At first use the file is compiled with the host C++ compiler into
``small_fem_solver_tpu_torch/_build/`` (named by a hash of the source and
flags; ``native/`` is never written) and loaded with ``ctypes``.  The
build holds a file lock in that directory (:func:`build_lock`, shared with
the CUDA kernels' build) and writes a temporary name that it renames into
place, so processes that start at once (the ranks of a group) compile it
once and never load a half-written file.  Without
a compiler, or when the build fails, each function returns ``None`` and
its caller runs the numpy or Python version.  These are host-side
routines, not device paths.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_SOURCE = _ROOT / "native" / "mesh_kit.cpp"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lib = None
_tried = False


@contextlib.contextmanager
def build_lock(build_dir: pathlib.Path):
    """An exclusive lock on ``build_dir/.lock`` (created as needed) for
    the enclosed build: a process that finds it held waits, then sees the
    finished library."""
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / ".lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _build(build_dir: pathlib.Path | None = None) -> pathlib.Path | None:
    """The compiled library in ``build_dir`` (default ``_build/``; built if
    needed, under :func:`build_lock`), or None."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None or not _SOURCE.exists():
        return None
    build_dir = pathlib.Path(build_dir or _BUILD_DIR)
    tag = hashlib.sha256(_SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    so = build_dir / f"libmesh_kit_{tag}.so"
    if so.exists():
        return so
    with build_lock(build_dir):
        if so.exists():         # built by another process meanwhile
            return so
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        try:
            subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(_SOURCE)],
                           check=True, capture_output=True, timeout=300)
        except (OSError, subprocess.SubprocessError):
            os.unlink(tmp)
            return None
        os.replace(tmp, so)
    return so


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    i64 = ctypes.c_int64
    lib.rainflow_damage_sums.restype = ctypes.c_int
    lib.rainflow_damage_sums.argtypes = [f64p, i64, i64, ctypes.c_double,
                                         f64p, f64p]
    lib.bcsr_pattern_count.restype = i64
    lib.bcsr_pattern_count.argtypes = [i32p, i64, i64]
    lib.bcsr_pattern_fill.restype = ctypes.c_int
    lib.bcsr_pattern_fill.argtypes = [i32p, i64, i64, i32p, i32p, i64p,
                                      i32p, i64]
    lib.aggregate_nodes.restype = i64
    lib.aggregate_nodes.argtypes = [i32p, i64, i64, i64, i64p]
    lib.rcm_ordering.restype = ctypes.c_int
    lib.rcm_ordering.argtypes = [i32p, i64, i64, i32p]
    lib.refine_members.restype = ctypes.c_int
    lib.refine_members.argtypes = [f64p, i64, i32p, i64, i32p,
                                   ctypes.c_int32, f64p, i32p, i32p]
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native library is built and loaded."""
    return _load() is not None


def rainflow_damage_sums_native(y, m_slope: float):
    """Batched rainflow Miner sums ``(sum w * range^m, sum w)`` per member
    of ``y`` [S, M] (float64 on the host), or None when the library is
    absent."""
    lib = _load()
    if lib is None:
        return None
    y = np.ascontiguousarray(y, dtype=np.float64)
    S, M = y.shape
    out_sum = np.empty(M, np.float64)
    out_n = np.empty(M, np.float64)
    if lib.rainflow_damage_sums(y, S, M, float(m_slope), out_sum, out_n):
        raise RuntimeError("rainflow_damage_sums failed")
    return out_sum, out_n


def bcsr_pattern_native(conn, n_nodes: int):
    """(block_rows, block_cols, row_ptr, elem_slot) of the BCSR pattern of
    ``conn`` [M, 2] (numpy, on the host), or None when the library is
    absent."""
    lib = _load()
    if lib is None:
        return None
    conn = np.ascontiguousarray(conn, dtype=np.int32)
    m = conn.shape[0]
    nb = lib.bcsr_pattern_count(conn, m, n_nodes)
    block_rows = np.empty(nb, np.int32)
    block_cols = np.empty(nb, np.int32)
    row_ptr = np.empty(n_nodes + 1, np.int64)
    elem_slot = np.empty((m, 4), np.int32)
    if lib.bcsr_pattern_fill(conn, m, n_nodes, block_rows, block_cols,
                             row_ptr, elem_slot, nb):
        raise RuntimeError("bcsr_pattern_fill failed")
    return block_rows, block_cols, row_ptr, elem_slot


def aggregate_nodes_native(edges, n_nodes: int, target_size: int):
    """Aggregate id [n_nodes] int64 of each node (greedy BFS over
    ``edges`` [E, 2]), or None when the library is absent."""
    lib = _load()
    if lib is None:
        return None
    edges = np.ascontiguousarray(edges, dtype=np.int32).reshape(-1, 2)
    out = np.empty(n_nodes, np.int64)
    if lib.aggregate_nodes(edges, edges.shape[0], n_nodes, int(target_size),
                           out) < 0:
        raise RuntimeError("aggregate_nodes failed")
    return out


def rcm_ordering(conn, n_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (``perm[new] = old``, int32) of
    the node graph of ``conn`` [M, 2]: the native library's, else a BFS in
    Python that gives the same permutation."""
    lib = _load()
    conn = np.ascontiguousarray(conn, dtype=np.int32).reshape(-1, 2)
    if lib is not None:
        perm = np.empty(n_nodes, np.int32)
        if lib.rcm_ordering(conn, conn.shape[0], n_nodes, perm):
            raise RuntimeError("rcm_ordering failed")
        return perm
    from collections import deque
    adj = [[] for _ in range(n_nodes)]
    for i, j in conn:
        if i != j:
            adj[i].append(int(j))
            adj[j].append(int(i))
    adj = [sorted(set(a)) for a in adj]
    visited = np.zeros(n_nodes, bool)
    order = []
    while not visited.all():
        unv = np.where(~visited)[0]
        start = min(unv, key=lambda v: len(adj[v]))
        q = deque([int(start)])
        visited[start] = True
        while q:
            v = q.popleft()
            order.append(v)
            for u in sorted((u for u in adj[v] if not visited[u]),
                            key=lambda u: len(adj[u])):
                visited[u] = True
                q.append(u)
    return np.array(order[::-1], np.int32)


def refine_members_native(coords, conn, sect, n_seg: int):
    """``(new_coords, new_conn, new_sect)`` of every member of ``conn``
    subdivided into ``n_seg`` elements (interior nodes appended member by
    member, as ``models.model.refine_model`` lays them out), or None when
    the library is absent."""
    lib = _load()
    if lib is None:
        return None
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    conn = np.ascontiguousarray(conn, dtype=np.int32)
    sect = np.ascontiguousarray(sect, dtype=np.int32)
    n, m = coords.shape[0], conn.shape[0]
    new_coords = np.empty((n + m * (n_seg - 1), 3), np.float64)
    new_conn = np.empty((m * n_seg, 2), np.int32)
    new_sect = np.empty(m * n_seg, np.int32)
    if lib.refine_members(coords, n, conn, m, sect, n_seg, new_coords,
                          new_conn, new_sect):
        raise RuntimeError("refine_members failed")
    return new_coords, new_conn, new_sect
