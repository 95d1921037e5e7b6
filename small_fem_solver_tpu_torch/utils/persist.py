"""Result persistence (npz) and resumable chunked design envelopes
(PyTorch counterpart of ``small_fem_solver_tpu/utils/persist.py``).

Format, shared with the JAX package (a file written by either loads in
the other when both know its result class): one compressed ``.npz`` per
result NamedTuple; fields map to arrays keyed by their dot-joined field
path (nested NamedTuples), ``None`` fields are listed in ``__none__``,
and ``__class__`` names the class so :func:`load_results` rebuilds it;
``__schema__`` is 1.  Arrays come back as CPU tensors.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib

import numpy as np
import torch

SCHEMA = 1

# nested NamedTuple fields: (class name, field) -> nested class name
_NESTED = {("AnalysisResults", "morison"): "MorisonLoads"}


def _result_registry() -> dict:
    """The port's result classes by name."""
    from ..api import AnalysisResults, CondensedScanResults, EnvelopeResults
    from ..ops.morison import MorisonLoads, MorisonPhaseBatch
    return {c.__name__: c for c in (AnalysisResults, CondensedScanResults,
                                    EnvelopeResults, MorisonLoads,
                                    MorisonPhaseBatch)}


def _flatten(nt, prefix=""):
    flat, nones = {}, []
    for name, val in nt._asdict().items():
        key = f"{prefix}{name}"
        if val is None:
            nones.append(key)
        elif hasattr(val, "_asdict"):
            f, n = _flatten(val, prefix=f"{key}.")
            flat.update(f)
            nones.extend(n)
        else:
            flat[key] = (val.detach().cpu().numpy() if torch.is_tensor(val)
                         else np.asarray(val))
    return flat, nones


def save_results(path, results) -> None:
    """Write a result NamedTuple (AnalysisResults, EnvelopeResults, ...)
    to ``path`` (.npz)."""
    flat, nones = _flatten(results)
    np.savez_compressed(
        path, __schema__=SCHEMA, __class__=type(results).__name__,
        __none__=np.asarray(nones, dtype=object) if nones
        else np.zeros(0, dtype=object),
        **flat)


def load_results(path):
    """Rebuild the result written by :func:`save_results` (either
    package's), its arrays as CPU tensors."""
    registry = _result_registry()
    with np.load(path, allow_pickle=True) as z:
        cls_name = str(z["__class__"])
        nones = {str(s) for s in z["__none__"]}
        data = {k: z[k] for k in z.files if not k.startswith("__")}
    if cls_name not in registry:
        raise ValueError(f"{path}: result class {cls_name!r} is not one of "
                         f"this package's ({', '.join(sorted(registry))})")

    def build(name, prefix=""):
        kwargs = {}
        for field in registry[name]._fields:
            key = f"{prefix}{field}"
            if key in nones:
                kwargs[field] = None
            elif (name, field) in _NESTED:
                kwargs[field] = build(_NESTED[(name, field)], f"{key}.")
            else:
                kwargs[field] = torch.from_numpy(np.asarray(data[key]))
        return registry[name](**kwargs)

    return build(cls_name)


def merge_envelope_chunks(chunks):
    """Concatenate per-chunk EnvelopeResults (leading case axis) into one,
    recomputing the cross-chunk reductions."""
    from ..api import EnvelopeResults

    def cat(field):
        return torch.cat([torch.as_tensor(getattr(c, field)).cpu()
                          for c in chunks])
    max_per_case = cat("max_util_per_case")
    return EnvelopeResults(
        ts=cat("ts"),
        utilization=cat("utilization") if all(
            c.utilization is not None for c in chunks) else None,
        max_util_per_phase=cat("max_util_per_phase"),
        max_util_per_case=max_per_case,
        critical_phase=cat("critical_phase"),
        governing_case=torch.argmax(max_per_case),
        member_envelope=torch.stack([torch.as_tensor(c.member_envelope).cpu()
                                     for c in chunks]).amax(dim=0),
        total_morison=cat("total_morison"))


def _case_slice(obj, sl: slice):
    """A wave or case batch restricted to the cases ``sl`` (tensor fields
    with a case axis are sliced; the rest is shared)."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name)[sl] for f in dataclasses.fields(obj)
        if torch.is_tensor(getattr(obj, f.name))
        and getattr(obj, f.name).ndim > 0})


def _sweep_hash(waves, cases) -> str:
    """sha256 over every field of the wave and case batches (tensors by
    their bytes, settings by their repr)."""
    h = hashlib.sha256()
    for obj in (waves, cases):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            h.update(np.ascontiguousarray(v.detach().cpu().numpy()).tobytes()
                     if torch.is_tensor(v) else repr(v).encode())
    return h.hexdigest()


def design_envelope_resumable(model_or_coarse, waves, cases, out_dir,
                              chunk_size: int = 64, refined=None,
                              n_seg: int | None = None,
                              max_chunks: int | None = None, **kw):
    """Chunked, checkpointed storm envelope that resumes after a restart.

    The case axis is split into ``chunk_size`` blocks; each finished
    block's EnvelopeResults goes to ``out_dir/chunk_NNNN.npz`` (written to
    a ``.tmp.npz`` and renamed, so a killed run leaves no partial file) and
    is skipped on the next call.  A ``manifest.json`` describes the sweep;
    resuming into a directory of a different sweep raises.  With
    ``refined``/``n_seg`` the condensed envelope runs, else the dense
    :func:`~..api.design_envelope`.  ``max_chunks`` bounds the blocks
    computed by this call (the return is ``None`` until every chunk
    exists); other keyword arguments go to the envelope, ``mesh=`` among
    them: then every rank of the mesh's group makes the same call, the
    chunks still to compute are listed before any is written (so the ranks
    agree on them), and each rank writes the (identical) files under its
    own temporary names.  Returns the merged EnvelopeResults (CPU
    tensors).
    """
    from ..api import design_envelope, design_envelope_condensed

    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n_cases = int(waves.E.shape[0])
    n_chunks = -(-n_cases // chunk_size)
    manifest = dict(schema=SCHEMA, n_cases=n_cases, chunk_size=chunk_size,
                    n_steps=kw.get("n_steps"),
                    case_hash=_sweep_hash(waves, cases),
                    condensed=refined is not None, n_seg=n_seg)
    mpath = out / "manifest.json"
    if mpath.exists():
        old = json.loads(mpath.read_text())
        if old != manifest:
            diff = {k: (old.get(k), v) for k, v in manifest.items()
                    if old.get(k) != v}
            raise ValueError(
                f"resume directory {out} holds chunks of a DIFFERENT sweep "
                f"(mismatched fields: {diff}); use a fresh out_dir or delete "
                f"the stale chunks")
    todo = [i for i in range(n_chunks)
            if not (out / f"chunk_{i:04d}.npz").exists()]
    if not mpath.exists():
        tmp = mpath.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(json.dumps(manifest))
        tmp.rename(mpath)

    for done, i in enumerate(todo):
        path = out / f"chunk_{i:04d}.npz"
        if max_chunks is not None and done >= max_chunks:
            return None
        sl = slice(i * chunk_size, min((i + 1) * chunk_size, n_cases))
        w_i, c_i = _case_slice(waves, sl), _case_slice(cases, sl)
        if refined is not None:
            env = design_envelope_condensed(model_or_coarse, refined, n_seg,
                                            w_i, c_i, **kw)
        else:
            env = design_envelope(model_or_coarse, w_i, c_i, **kw)
        tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
        save_results(tmp, env)
        tmp.rename(path)
    return merge_envelope_chunks([load_results(out / f"chunk_{i:04d}.npz")
                                  for i in range(n_chunks)])
