"""``small_fem_solver_tpu_torch.convert``: the JAX package's objects handed
to the port as numpy leaves.  The helpers below are shared by the other
``test_torch_*`` files; the tests check that a converted object equals the
port's own construction of the same thing."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import small_fem_solver_tpu as sf
import small_fem_solver_tpu_torch as pt
from small_fem_solver_tpu_torch import convert


def rel_err(a, b) -> float:
    """max |a - b| / max |b| in float64."""
    a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b.detach().cpu() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def leaves(obj):
    """A JAX NamedTuple (possibly nested) as a dict of numpy arrays."""
    if hasattr(obj, "_asdict"):
        return {k: leaves(v) for k, v in obj._asdict().items()}
    return obj if isinstance(obj, int) else np.asarray(obj)


def port_model(m, dtype=torch.float64):
    return convert.model_from_numpy(
        np.asarray(m.coords), np.asarray(m.conn), np.asarray(m.sect_id),
        leaves(m.sections), np.asarray(m.fixed_mask), np.asarray(m.top_mask),
        node_names=m.node_names, member_names=m.member_names,
        member_types=m.member_types, dtype=dtype)


def port_wave(w, dtype=torch.float64):
    return convert.wave_from_numpy(
        *(np.asarray(getattr(w, f)) for f in ("k", "omega", "c", "d", "U_c",
                                              "H", "T", "E", "U")),
        clamp_z=w.clamp_z, dt_fd=w.dt_fd, model=w.model, order=w.order,
        dtype=dtype)


def port_case(case):
    return convert.case_from_numpy(**{f.name: getattr(case, f.name)
                                      for f in dataclasses.fields(case)})


def port_prepared(prep, coarse, refined, dtype=torch.float64):
    """A port handle holding exactly the JAX handle's factorization."""
    return convert.prepared_from_numpy(
        coarse, refined, np.asarray(prep.Kg), np.asarray(prep.KT),
        np.asarray(prep.L_m), leaves(prep.fac), leaves(prep.dfac),
        np.asarray(prep.K_I), np.asarray(prep.free), np.asarray(prep.fixed),
        np.asarray(prep.E), np.asarray(prep.nu), prep.n_seg,
        prep.chain_solver, dtype=dtype)


@pytest.mark.parametrize("n_seg", [1, 3])
def test_converted_model_equals_port_model(n_seg):
    jm = sf.refine_model(sf.default_3leg_jacket(), n_seg)
    tm = pt.refine_model(pt.default_3leg_jacket(), n_seg)
    cm = port_model(jm)
    for name in ("coords", "conn", "sect_id", "fixed_mask", "top_mask"):
        assert torch.equal(getattr(cm, name), getattr(tm, name)), name
    for name in pt.TubeSections._fields:
        assert rel_err(getattr(cm.sections, name),
                       getattr(tm.sections, name)) < 1e-15, name
    assert (cm.node_names, cm.member_names, cm.member_types) == \
        (tm.node_names, tm.member_names, tm.member_types)


def test_converted_case_and_wave():
    case = sf.LoadCase(wave_dir_deg=38.0, F_shear_kN=2900.0,
                       sw_mode="calculated")
    tc = port_case(case)
    assert tc == pt.LoadCase(wave_dir_deg=38.0, F_shear_kN=2900.0,
                             sw_mode="calculated")
    cast = tc.cast(torch.float32)
    assert cast.E.dtype == torch.float32 and cast.sw_mode == "calculated"
    jw = sf.airy_wave(9.5, 9.4, 50.0, 1.2, n_modes=3, dtype=jnp.float32)
    tw = port_wave(jw, torch.float32)
    assert (tw.model, tw.order, tw.n_modes) == ("airy", 1, 3)
    assert tw.E.dtype == torch.float32


def test_converting_unported_model_options_raises():
    jm = sf.default_3leg_jacket()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        convert.model_from_numpy(
            np.asarray(jm.coords), np.asarray(jm.conn),
            np.asarray(jm.sect_id), leaves(jm.sections),
            np.asarray(jm.fixed_mask), np.asarray(jm.top_mask),
            release=np.zeros(jm.n_members, np.int32))
