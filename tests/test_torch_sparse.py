"""PyTorch port vs the JAX package: the sparse tier's building blocks.

The default jacket (126 DOF, hub nodes and duplicate-free edges) and its
4x / 8x refinements (mostly chain nodes), f64 unless a case says f32, the
same numpy-seeded vectors through both packages:

- the BCSR pattern (native mesh kit and numpy routes) and the direct-write
  plan: integer-equal;
- ``assemble_bcsr``, ``assemble_bcsr_direct``, ``bcsr_matvec`` (one and
  three right-hand sides), the block diagonal and the dense form: 1e-12 of
  the largest value in f64, 5e-6 in f32 (``tests/test_assembly_direct.py``'s
  limits);
- the aggregation (native and Python routes) and the prolongator's slot
  plan: integer-equal; the smoothed P blocks, the coarse operator's
  scaling and explicit inverse, P r / P^T r and the two-level
  preconditioner: 1e-12; the dense-P oracle agrees with the sparse form;
- the fixed-order segment sums against ``np.add.at``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.api import _cached_bcsr_pattern as j_pattern
from small_fem_solver_tpu.ops import assembly as ja
from small_fem_solver_tpu.ops import coarse as jc
from small_fem_solver_tpu.ops import solve as js
from small_fem_solver_tpu.ops.beams import element_global_stiffness as j_egs
from small_fem_solver_tpu_torch import native as t_native
from small_fem_solver_tpu_torch.ops import assembly as ta
from small_fem_solver_tpu_torch.ops import beams as tb
from small_fem_solver_tpu_torch.ops import coarse as tc
from small_fem_solver_tpu_torch.ops import solve as ts
from test_torch_convert import port_model, rel_err

E_MPA = 210000.0
G_MPA = E_MPA / 2.6
PATTERN_FIELDS = ("block_rows", "block_cols", "row_ptr", "elem_slot")

# the JAX side as whole programs (one compile each, not one per primitive)
_j_stiffness = jax.jit(lambda m, E, G: j_egs(m.coords, m.conn, m.sections,
                                             m.sect_id, E, G))
_j_direct = jax.jit(ja.assemble_bcsr_direct)
_j_coarse = jax.jit(jc.build_coarse_space, static_argnames=("n_agg",))


def _jacket(n_seg, jdt=jnp.float64, tdt=torch.float64):
    jm = sf.refine_model(sf.default_3leg_jacket(dtype=jdt), n_seg)
    return jm, port_model(jm, tdt)


@pytest.fixture(scope="module")
def meshes():
    """Both packages' refined jackets with their patterns and generic
    assemblies (f64 at n_seg 1 and 8, f32 at 8)."""
    out = {}
    for key, (n_seg, jdt, tdt) in {
            "f64-1": (1, jnp.float64, torch.float64),
            "f64-8": (8, jnp.float64, torch.float64),
            "f32-8": (8, jnp.float32, torch.float32)}.items():
        jm, tm = _jacket(n_seg, jdt, tdt)
        jp = j_pattern(jm.conn, jm.n_nodes)
        tp = ta.build_bcsr_pattern(tm.conn, tm.n_nodes)
        jK = _j_stiffness(jm, jnp.asarray(E_MPA, jdt),
                          jnp.asarray(G_MPA, jdt))
        tK = tb.element_global_stiffness(tm.coords, tm.conn, tm.sections,
                                         tm.sect_id, E_MPA, G_MPA)
        out[key] = dict(jm=jm, tm=tm, jp=jp, tp=tp, jK=jK, tK=tK,
                        jA=ja.assemble_bcsr(jK, jp),
                        tA=ta.assemble_bcsr(tK, tp), jdt=jdt, tdt=tdt)
    return out


def _ints_equal(jobj, tobj, names):
    for name in names:
        np.testing.assert_array_equal(
            np.asarray(getattr(jobj, name)),
            getattr(tobj, name).cpu().numpy(), err_msg=name)


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("n_seg", [1, 4])
def test_bcsr_pattern_integer_equal(route, n_seg, monkeypatch):
    if route == "native" and not t_native.available():
        pytest.skip("no C++ compiler: the native mesh kit is not built")
    if route == "numpy":
        monkeypatch.setattr(t_native, "bcsr_pattern_native",
                            lambda conn, n: None)
    jm, tm = _jacket(n_seg)
    tp = ta.build_bcsr_pattern(tm.conn, tm.n_nodes)
    _ints_equal(j_pattern(jm.conn, jm.n_nodes), tp, PATTERN_FIELDS)
    assert tp.n_blocks == int(np.asarray(
        j_pattern(jm.conn, jm.n_nodes).block_rows).shape[0])


@pytest.mark.parametrize("key,tol", [("f64-1", 1e-12), ("f64-8", 1e-12),
                                     ("f32-8", 5e-6)])
def test_bcsr_assembly_and_operators_match_jax(meshes, key, tol):
    m = meshes[key]
    jm, jA, tA, tdt = m["jm"], m["jA"], m["tA"], m["tdt"]
    assert rel_err(m["tK"], m["jK"]) < tol
    assert tA.blocks.dtype == tdt
    assert rel_err(tA.blocks, jA.blocks) < tol
    # the [M, 12, 12] stack and the quadrant stack assemble alike
    R = tb.local_axes(*_axes_inputs(m["tm"]))
    quads = tb.global_stiffness_quadrants(R, tb.stiffness_coeffs(
        _lengths(m["tm"]) * 1000.0, m["tm"].sections, m["tm"].sect_id,
        E_MPA, G_MPA))
    assert rel_err(ta.assemble_bcsr(quads, m["tp"]).blocks, jA.blocks) < tol
    rng = np.random.default_rng(0)
    x = rng.standard_normal(jm.n_dof)
    X = rng.standard_normal((jm.n_dof, 3))
    assert rel_err(ta.bcsr_matvec(tA, torch.tensor(x, dtype=tdt)),
                   ja.bcsr_matvec(jA, jnp.asarray(x, m["jdt"]))) < tol
    assert rel_err(ta.bcsr_matvec(tA, torch.tensor(X, dtype=tdt)),
                   ja.bcsr_matvec(jA, jnp.asarray(X, m["jdt"]))) < tol
    assert rel_err(ta.bcsr_block_diagonal(tA),
                   ja.bcsr_block_diagonal(jA)) < tol
    assert rel_err(ta.bcsr_to_dense(tA), ja.bcsr_to_dense(jA)) < tol


def _axes_inputs(tm):
    dL = tm.coords[tm.conn[:, 1]] - tm.coords[tm.conn[:, 0]]
    return dL, torch.linalg.norm(dL, dim=-1)


def _lengths(tm):
    return _axes_inputs(tm)[1]


@pytest.mark.parametrize("key,tol", [("f64-1", 1e-12), ("f32-8", 5e-6)])
def test_direct_assembly_matches_jax(meshes, key, tol):
    """The direct-write plan is the JAX package's (integer-equal), its
    blocks match JAX's direct assembly and the port's generic one, and
    every order-agnostic consumer agrees."""
    m = meshes[key]
    jm, tm, jdt, tdt = m["jm"], m["tm"], m["jdt"], m["tdt"]
    jd = ja.prepare_direct_assembly(jm.coords, jm.conn, jm.sect_id,
                                    jm.n_nodes)
    td = ta.prepare_direct_assembly(tm.coords, tm.conn, tm.sect_id,
                                    tm.n_nodes)
    _ints_equal(jd.pattern, td.pattern, PATTERN_FIELDS)
    jAd = _j_direct(jd, jm.sections, jnp.asarray(E_MPA, jdt),
                    jnp.asarray(G_MPA, jdt))
    tAd = ta.assemble_bcsr_direct(td, tm.sections, E_MPA, G_MPA)
    assert tAd.blocks.dtype == tdt
    assert rel_err(tAd.blocks, jAd.blocks) < tol
    assert rel_err(ta.bcsr_to_dense(tAd), ta.bcsr_to_dense(m["tA"])) < tol
    x = torch.tensor(np.random.default_rng(1).standard_normal(jm.n_dof),
                     dtype=tdt)
    assert rel_err(ta.bcsr_matvec(tAd, x), ta.bcsr_matvec(m["tA"], x)) < tol
    assert rel_err(ta.bcsr_block_diagonal(tAd),
                   ta.bcsr_block_diagonal(m["tA"])) < tol


def test_direct_assembly_scale_matches_scaled_coords(meshes):
    """The call-time uniform geometry scale equals a new prepare with
    scaled coordinates, and JAX's scaled assembly."""
    jm, tm = meshes["f64-8"]["jm"], meshes["f64-8"]["tm"]
    s = 1.007
    td = ta.prepare_direct_assembly(tm.coords, tm.conn, tm.sect_id,
                                    tm.n_nodes)
    out = ta.assemble_bcsr_direct(td, tm.sections, E_MPA, G_MPA, scale=s)
    td2 = ta.prepare_direct_assembly(tm.coords * s, tm.conn, tm.sect_id,
                                     tm.n_nodes)
    ref = ta.assemble_bcsr_direct(td2, tm.sections, E_MPA, G_MPA)
    assert rel_err(out.blocks, ref.blocks) < 1e-12
    jd = ja.prepare_direct_assembly(jm.coords, jm.conn, jm.sect_id,
                                    jm.n_nodes)
    jref = _j_direct(jd, jm.sections, jnp.float64(E_MPA),
                     jnp.float64(G_MPA), scale=jnp.float64(s))
    assert rel_err(out.blocks, jref.blocks) < 1e-12


@pytest.mark.parametrize("route", ["native", "python"])
def test_aggregates_and_slot_plan_integer_equal(meshes, route, monkeypatch):
    if route == "native" and not t_native.available():
        pytest.skip("no C++ compiler: the native mesh kit is not built")
    if route == "python":
        monkeypatch.setattr(t_native, "aggregate_nodes_native",
                            lambda edges, n, t: None)
    m = meshes["f64-8"]
    jagg = jc.aggregates_from_pattern(m["jp"])
    tagg = tc.aggregates_from_pattern(m["tp"])
    np.testing.assert_array_equal(tagg, jagg)
    for target in (5, 17):     # several aggregates, ragged last ones
        np.testing.assert_array_equal(
            tc.aggregates_from_pattern(m["tp"], target_size=target),
            jc.aggregates_from_pattern(m["jp"], target_size=target))
    n_agg = int(jagg.max()) + 1
    jplan = jc.plan_sparse_p(m["jp"], jagg, n_agg)
    tplan = tc.plan_sparse_p(m["tp"], tagg, n_agg)
    _ints_equal(jplan, tplan, ("p_cols", "entry_slot", "tent_slot"))
    assert tplan.K == jplan.K


def test_coarse_space_matches_jax(meshes):
    """Smoothed P blocks, the coarse scaling, factor and explicit inverse,
    P^T r, P x_c, the block-Jacobi, scalar Jacobi and two-level
    preconditioners at 1e-12 (8x refined jacket, aggregates of 8 nodes);
    the dense-P oracle agrees with the sparse form."""
    m = meshes["f64-8"]
    jm, tm, jA, tA = m["jm"], m["tm"], m["jA"], m["tA"]
    agg = jc.aggregates_from_pattern(m["jp"], target_size=8)
    n_agg = int(agg.max()) + 1
    jcs = _j_coarse(jA, jm.coords, jm.fixed_mask, agg=jnp.asarray(agg),
                    n_agg=n_agg, plan=jc.plan_sparse_p(m["jp"], agg, n_agg))
    tcs = tc.build_coarse_space(tA, tm.coords, tm.fixed_mask, agg=agg,
                                n_agg=n_agg)
    for name in ("p_blocks", "scale", "L_c", "Ac_inv"):
        assert rel_err(getattr(tcs, name), getattr(jcs, name)) < 1e-12, name
    rng = np.random.default_rng(2)
    r = rng.standard_normal(jm.n_dof) * 1e5
    xc = rng.standard_normal(6 * n_agg)
    assert rel_err(tc.restrict(tcs, torch.tensor(r)),
                   jc.restrict(jcs, jnp.asarray(r))) < 1e-12
    assert rel_err(tc.prolong(tcs, torch.tensor(xc)),
                   jc.prolong(jcs, jnp.asarray(xc))) < 1e-12
    jfm = js.dof_free_mask(jm.fixed_mask).astype(jnp.float64)
    tfm = ts.dof_free_mask(tm.fixed_mask).double()
    jbj = js.block_jacobi_preconditioner(ja.bcsr_block_diagonal(jA), jfm)
    tbj = ts.block_jacobi_preconditioner(ta.bcsr_block_diagonal(tA), tfm)
    assert rel_err(tbj(torch.tensor(r)), jbj(jnp.asarray(r))) < 1e-12
    assert rel_err(tc.two_level_preconditioner(tbj, tcs)(torch.tensor(r)),
                   jc.two_level_preconditioner(jbj, jcs)(
                       jnp.asarray(r))) < 1e-12
    d = ta.bcsr_matvec(tA, torch.ones(jm.n_dof, dtype=torch.float64))
    assert rel_err(ts.jacobi_preconditioner(d, tfm)(torch.tensor(r)),
                   js.jacobi_preconditioner(jnp.asarray(d.numpy()), jfm)(
                       jnp.asarray(r))) < 1e-12
    cd = tc.build_coarse_space_dense(tA, tm.coords, tm.fixed_mask, agg=agg,
                                     n_agg=n_agg)
    assert rel_err(tc.prolongator_dense(tcs), cd.P) < 1e-12
    corr = tc.two_level_preconditioner_dense(tbj, cd)(torch.tensor(r))
    assert rel_err(tc.two_level_preconditioner(tbj, tcs)(torch.tensor(r)),
                   corr) < 1e-10


def test_spd_block_inv_matches_jax():
    """Batched 6x6 inverses over a 1e10 spread of scales (Cholesky of the
    Jacobi-scaled blocks, then cholesky_inverse) at 1e-12 of each
    block's largest entry."""
    rng = np.random.default_rng(3)
    B = rng.standard_normal((40, 6, 6))
    D = B @ np.swapaxes(B, 1, 2) + 6 * np.eye(6)
    s = 10.0 ** rng.uniform(-5, 5, size=(40, 6))
    D = D * s[:, :, None] * s[:, None, :]
    out = ts.spd_block_inv(torch.tensor(D)).numpy()
    ref = np.asarray(js.spd_block_inv(jnp.asarray(D)))
    err = np.abs(out - ref).max(axis=(1, 2)) / np.abs(ref).max(axis=(1, 2))
    assert err.max() < 1e-12


@pytest.mark.parametrize("n_segments,counts", [
    (50, "even"), (50, "skewed"), (7, "empty rows")])
def test_segment_sum_ordered_matches_add_at(n_segments, counts):
    """One padded table and the bucketed form both equal np.add.at, entries
    marked -1 left out."""
    rng = np.random.default_rng(4)
    if counts == "even":
        seg = rng.integers(0, n_segments, 400)
    elif counts == "skewed":       # one long segment: buckets
        seg = np.concatenate([np.zeros(300, int),
                              rng.integers(0, n_segments, 100)])
    else:
        seg = np.array([0, 0, 3, -1, 3, 6, -1, 0])
    values = rng.standard_normal((seg.size, 2, 3))
    st = ta.segment_table(seg, n_segments, "cpu")
    assert (len(st.tables) > 1) == (counts == "skewed")
    ref = np.zeros((n_segments, 2, 3))
    np.add.at(ref, seg[seg >= 0], values[seg >= 0])
    out = ta.segment_sum_ordered(torch.tensor(values), st).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-13, atol=1e-13)
