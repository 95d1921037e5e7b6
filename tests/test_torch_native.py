"""The port's mesh-kit helpers ``native.rcm_ordering`` and
``native.refine_members_native`` against the JAX package's, bit for bit,
on the default jacket and on it refined 4x: with the native library, and
without it (``rcm_ordering``'s Python BFS; ``refine_members_native`` gives
None).  Host numpy routines: no device."""
import numpy as np
import pytest

import small_fem_solver_tpu as sf
from small_fem_solver_tpu import native as j_native
import small_fem_solver_tpu_torch as pt
from small_fem_solver_tpu_torch import native as t_native
import test_torch_convert  # noqa: F401  (the port tests' thread policy)


def _meshes():
    coarse = pt.default_3leg_jacket(device="cpu")
    return {"coarse": coarse, "refined4": pt.refine_model(coarse, 4)}


@pytest.fixture(params=["native", "fallback"])
def route(request, monkeypatch):
    if request.param == "native":
        if not (t_native.available() and j_native.available()):
            pytest.skip("no C++ compiler: the native mesh kit is not built")
    else:
        monkeypatch.setattr(t_native, "_load", lambda: None)
        monkeypatch.setattr(j_native, "_load", lambda: None)
    return request.param


@pytest.mark.parametrize("mesh", ["coarse", "refined4"])
def test_rcm_ordering_matches_jax(route, mesh):
    m = _meshes()[mesh]
    conn = m.conn.numpy()
    perm = t_native.rcm_ordering(conn, m.n_nodes)
    want = j_native.rcm_ordering(conn, m.n_nodes)
    assert perm.dtype == np.int32 and np.array_equal(perm, want)
    assert np.array_equal(np.sort(perm), np.arange(m.n_nodes))


@pytest.mark.parametrize("mesh", ["coarse", "refined4"])
def test_refine_members_native_matches_jax(route, mesh):
    m = _meshes()[mesh]
    args = (m.coords.numpy(), m.conn.numpy(), m.sect_id.numpy(), 4)
    out, want = t_native.refine_members_native(*args), \
        j_native.refine_members_native(*args)
    if route == "fallback":
        assert out is None and want is None
        return
    for a, b in zip(out, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the layout of refine_model: the same coordinates and connectivity
    r = pt.refine_model(m, 4)
    assert np.array_equal(out[0], r.coords.numpy())
    assert np.array_equal(out[1], r.conn.numpy())
    jr = sf.refine_model(sf.default_3leg_jacket(), 4) if mesh == "coarse" \
        else None
    if jr is not None:
        assert np.array_equal(out[0], np.asarray(jr.coords))
