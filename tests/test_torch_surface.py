"""The port's public API held to the JAX package's.

Every module of ``small_fem_solver_tpu`` has a module of the same path in
``small_fem_solver_tpu_torch`` that offers the same public names: the
functions and classes defined in the JAX module, the upper-case constants
assigned at its top level (with equal values) and, for a package, every
public name it re-exports.  Every function and class takes the JAX
parameters in the JAX order, each of the same kind and with the same
scalar default; a parameter the port adds needs a default, so that every
call written for the JAX package runs on the port.

``MISSING_MODULES`` and ``ALLOWED`` list the deliberate differences, each
with its reason; an entry that no longer matches a difference fails too,
so the lists stay true."""
import ast
import importlib
import inspect
import pathlib
import pkgutil

import numpy as np
import pytest

import small_fem_solver_tpu as sf

JAX_ROOT, PORT_ROOT = "small_fem_solver_tpu", "small_fem_solver_tpu_torch"

# JAX modules with no module of the same path in the port: module -> reason
MISSING_MODULES = {
    "ops.pallas_kernels": "the TPU kernels; the port's hand-written CUDA "
                          "kernels are ops/hopper_kernels.py and csrc/",
    "ops.structured": "the chunked PCG's band operators on the TPU's "
                      "(8,128)-tile layout; the port's BCSR operators "
                      "serve every PCG route",
}

# Deliberate differences: (module, name, parameter) -> reason.  The
# parameter None stands for the name itself (missing, or a constant's
# value); "*" for a whole signature.
ALLOWED = {
    ("api", "analyze", "_jit"):
        "a jax.jit switch; the port has no tracing step",
    ("api", "phase_scan_prepared", "kinematics"):
        "default 'fused': the CUDA kernel, in the model's dtype, equal to "
        "JAX's default 'separable' to roundoff",
    ("api", "phase_scan_condensed", "kinematics"):
        "default 'fused', as phase_scan_prepared",
    ("api", "design_envelope_condensed", "kinematics"):
        "default 'fused', as phase_scan_prepared",
    ("gui", "INFO_TEXT", None):
        "the port's GUI text names PyTorch/CUDA where JAX's names the TPU",
    ("models.presets", "default_3leg_jacket", "dtype"):
        "default torch.float64; JAX's None means float64 too",
    ("ops.sections", "tube_sections", "dtype"):
        "default torch.float64; JAX's None means float64 too",
    ("ops.assembly", "BCSRPattern", "*"):
        "the port's own index layout of the block-sparse pattern "
        "(index_add_ plans in place of JAX's gather tables)",
    ("ops.assembly", "DirectAssembly", "*"):
        "the port's own index layout of the direct assembly plan",
    ("ops.beams", "congruence", None):
        "hand-rolled 12x12 products for the TPU's matrix units; the port "
        "uses plain @",
    ("ops.beams", "matmul12", None):
        "a TPU workaround, as congruence",
    ("ops.coarse", "CoarseSpace", "*"):
        "the port's own index layout of the coarse space (prolongation "
        "rows and restriction sums precomputed)",
    ("ops.coarse", "SparsePPlan", "*"):
        "the port's own index layout of the Galerkin product plan",
    ("ops.coarse", "galerkin_coarse_operator", "p_cols"):
        "takes the SparsePPlan that holds p_cols with the port's index sums",
    ("ops.coarse", "galerkin_coarse_operator", "plan"):
        "the SparsePPlan in place of p_cols",
    ("ops.dynamics", "CBReduction", "btable"):
        "the port keeps the boundary-DOF gather table it builds once",
    ("ops.fenton", "fenton_wave_from_solution", "dtype"):
        "the port takes the dtype (and device) from the solution q",
    ("ops.morison", "MorisonPhaseBatch", "F1"):
        "the port's phase batch always carries its end forces",
    ("ops.morison", "MorisonPhaseBatch", "F2"):
        "the port's phase batch always carries its end forces",
    ("parallel.multihost", "init_multihost", "*"):
        "torch.distributed's init_method / world_size / rank in place of "
        "jax.distributed's coordinator_address / num_processes / process_id",
    ("parallel.multihost", "shard_cases_from_local", "pytree_local"):
        "named local: the port takes tensors, not a JAX pytree",
    ("parallel.multihost", "shard_cases_from_local", "local"):
        "the port's name of pytree_local",
}

SCALARS = (bool, int, float, str, type(None))


def _jax_modules():
    names = [JAX_ROOT] + [i.name for i in pkgutil.walk_packages(
        sf.__path__, JAX_ROOT + ".")]
    return [n[len(JAX_ROOT) + 1:] for n in names]


def _assigned_constants(module) -> set:
    """Upper-case names assigned at the module's top level."""
    tree = ast.parse(pathlib.Path(module.__file__).read_text())
    out = set()
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign) else
                   [node.target] if isinstance(node, ast.AnnAssign) else [])
        out |= {t.id for t in targets
                if isinstance(t, ast.Name) and t.id.isupper()}
    return out


def _public_names(module) -> dict:
    """The JAX module's public names: kind ('callable', 'constant', or
    'reexport' for a package's names defined in another module, whose
    signatures are compared where they are defined)."""
    names = {n: "callable" for n, v in vars(module).items()
             if not n.startswith("_")
             and (inspect.isfunction(v) or inspect.isclass(v))
             and v.__module__ == module.__name__}
    names.update((n, "constant") for n in _assigned_constants(module)
                 if not n.startswith("_"))
    if hasattr(module, "__path__"):          # a package's re-exports
        names.update((n, "reexport") for n, v in vars(module).items()
                     if not n.startswith("_") and not inspect.ismodule(v)
                     and n not in names)
    return names


def _scalar(v) -> bool:
    if isinstance(v, tuple):
        return all(_scalar(x) for x in v)
    return isinstance(v, SCALARS)


def _same_value(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def _signature_diffs(a, b) -> list:
    """(parameter, what) of every difference between JAX's signature ``a``
    and the port's ``b``."""
    pa, pb = a.parameters, b.parameters
    out = [(n, "missing in the port") for n in pa if n not in pb]
    common = [n for n in pa if n in pb]
    if common != [n for n in pb if n in pa]:
        out.append(("*", f"order {common} against "
                         f"{[n for n in pb if n in pa]}"))
    for n in common:
        x, y = pa[n], pb[n]
        if x.kind != y.kind:
            out.append((n, f"kind {x.kind.name} against {y.kind.name}"))
        if (x.default is x.empty) != (y.default is y.empty):
            out.append((n, f"default {x.default!r} against {y.default!r}"))
        elif x.default is not x.empty and (
                _scalar(x.default) or _scalar(y.default)) and not (
                _scalar(x.default) and _same_value(x.default, y.default)):
            out.append((n, f"default {x.default!r} against {y.default!r}"))
    out += [(n, "added without a default") for n, y in pb.items()
            if n not in pa and y.default is y.empty
            and y.kind not in (y.VAR_POSITIONAL, y.VAR_KEYWORD)]
    return out


def _diffs(rel: str) -> list:
    """(name, parameter, message) of every difference in one module."""
    jm = importlib.import_module(".".join(filter(None, (JAX_ROOT, rel))))
    tm = importlib.import_module(".".join(filter(None, (PORT_ROOT, rel))))
    out = []
    for name, kind in sorted(_public_names(jm).items()):
        if not hasattr(tm, name):
            out.append((name, None, "missing in the port"))
            continue
        a, b = getattr(jm, name), getattr(tm, name)
        if kind == "reexport":
            continue
        if kind == "constant":
            if not _same_value(a, b):
                out.append((name, None, f"value {a!r:.60} against {b!r:.60}"))
            continue
        try:
            sa = inspect.signature(a)
        except (TypeError, ValueError):
            continue                          # a builtin without one
        out += [(name, p, msg)
                for p, msg in _signature_diffs(sa, inspect.signature(b))]
    return out


@pytest.mark.parametrize("rel", _jax_modules(), ids=lambda r: r or "<root>")
def test_port_module_matches_jax_api(rel):
    """One JAX module: its public API in the port's module of the same
    path, every difference on the allow-list and every allow-list entry of
    the module a difference."""
    if rel in MISSING_MODULES:
        with pytest.raises(ImportError):
            importlib.import_module(f"{PORT_ROOT}.{rel}")
        return
    diffs = _diffs(rel)
    unlisted = [f"{PORT_ROOT}.{rel}: {name}"
                + (f"({p})" if p else "") + f": {msg}"
                for name, p, msg in diffs
                if (rel, name, p) not in ALLOWED
                and (rel, name, "*") not in ALLOWED]
    assert not unlisted, "\n".join(unlisted)
    seen = {(rel, n, p) for n, p, _ in diffs} | {
        (rel, n, "*") for n, _, _ in diffs}
    stale = [k for k in ALLOWED if k[0] == rel and k not in seen]
    assert not stale, f"allow-list entries with no difference: {stale}"


def test_allow_list_names_jax_modules():
    """Every allow-list entry names a module of the JAX package."""
    mods = set(_jax_modules())
    assert set(MISSING_MODULES) <= mods
    assert {k[0] for k in ALLOWED} <= mods
    importlib.import_module(f"{PORT_ROOT}.ops.hopper_kernels")
