"""PyTorch port vs the JAX package: ``analyze(solver="pcg")`` and the CG
loop.

The storm and ``accel="analytic"`` of ``tests/test_pcg_precond.py`` on the
default jacket refined 4x (174 nodes, 1,044 DOF), f64, the port's torch on
one thread (its solves are thousands of small operations):

- block-Jacobi, two-level and 'auto' at tol 1e-10 against JAX's
  single-program PCG: iteration counts within 1, U at rtol 1e-8 / atol
  1e-9 x max |U| and utilization at rtol 1e-7 (that file's limits), and
  against the port's own Cholesky solve;
- the CG chunk length (how often the host reads the running flag) does not
  change a bit of the result: ``pcg_chunk`` 1, 7, 50 and 0 are bit-equal;
- the chunked route against JAX's (which runs its TPU band operators) at
  1e-5 x max |U|, as ``test_chunked_pcg_matches_single_program`` holds them;
- the non-convergence warning (a small ``pcg_maxiter``, a NaN residual),
  an unknown ``pcg_precond`` raising, a ``mesh=`` that is not a
  DeviceMesh raising;
- ``ops.solve.pcg`` against JAX's on a seeded right-hand side, with the
  sparse and the dense-oracle two-level preconditioners.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.api import _cached_bcsr_pattern as j_pattern
from small_fem_solver_tpu.ops import assembly as ja
from small_fem_solver_tpu.ops import solve as js
from small_fem_solver_tpu.ops.beams import element_stiffness as j_es
import small_fem_solver_tpu_torch as pt
from small_fem_solver_tpu_torch.ops import assembly as ta
from small_fem_solver_tpu_torch.ops import beams as tb
from small_fem_solver_tpu_torch.ops import coarse as tc
from small_fem_solver_tpu_torch.ops import solve as ts
from test_torch_convert import port_case, port_model, port_wave, rel_err

TOL = 1e-10
STORM = dict(wave_dir_deg=38.0, current_dir_deg=38.0, F_axial_kN=25100.0,
             F_shear_kN=2900.0, custom_sw_tonnes=1100.0, sw_mode="custom")
PRECONDS = ("block_jacobi", "two_level")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small solves are thousands of small operations: intra-op threads
    only add contention (several test processes share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pcg(s, **kw):
    return pt.analyze(s["tm"], s["tw"], s["tc"], solver="pcg",
                      accel="analytic", **{"pcg_maxiter": 20000, **kw})


@pytest.fixture(scope="module")
def storm():
    """The 4x refined jacket and the Stokes-5 storm in both packages, and
    both packages' block-Jacobi and two-level solves of it."""
    wave = sf.make_wave(9.5, 9.4, 50.0, U_c=1.2, model="stokes", N=5)
    case = sf.LoadCase(**STORM)
    jm = sf.refine_model(sf.default_3leg_jacket(), 4)
    s = dict(jm=jm, tm=port_model(jm), jw=wave, tw=port_wave(wave),
             jc=case, tc=port_case(case))
    s["ref"] = {pre: sf.analyze(jm, wave, case, solver="pcg",
                                accel="analytic", pcg_precond=pre,
                                pcg_maxiter=20000) for pre in PRECONDS}
    s["out"] = {pre: _pcg(s, pcg_precond=pre) for pre in PRECONDS}
    return s


@pytest.mark.parametrize("precond", ["block_jacobi", "two_level", "auto"])
def test_analyze_pcg_matches_jax(storm, precond):
    """'auto' is two-level at 174 nodes (>= 120), as in JAX."""
    ref = storm["ref"]["block_jacobi" if precond == "block_jacobi"
                       else "two_level"]
    out = (_pcg(storm, pcg_precond="auto") if precond == "auto"
           else storm["out"][precond])
    assert abs(int(out.solver_iters) - int(ref.solver_iters)) <= 1
    assert float(out.solver_residual) <= TOL
    scale = float(np.abs(np.asarray(ref.U)).max())
    np.testing.assert_allclose(out.U.numpy(), np.asarray(ref.U), rtol=1e-8,
                               atol=1e-9 * scale)
    np.testing.assert_allclose(out.utilization.numpy(),
                               np.asarray(ref.utilization), rtol=1e-7)
    for name in ("reactions", "total_reaction", "F_applied"):
        assert rel_err(getattr(out, name), getattr(ref, name)) < 1e-7, name
    assert int(out.max_displacement_node) == int(ref.max_displacement_node)


def test_pcg_matches_cholesky(storm):
    """The converged two-level solve is the direct solve, to the limits of
    ``test_two_level_cuts_iterations_10kdof``."""
    out = storm["out"]["two_level"]
    chol = pt.analyze(storm["tm"], storm["tw"], storm["tc"], solver="chol",
                      accel="analytic")
    scale = float(chol.U.abs().max())
    np.testing.assert_allclose(out.U.numpy(), chol.U.numpy(), rtol=1e-8,
                               atol=1e-9 * scale)
    np.testing.assert_allclose(out.utilization.numpy(),
                               chol.utilization.numpy(), rtol=1e-7)


def test_pcg_chunks_are_bit_equal(storm):
    """The host reads the running flag every 50 (``pcg_chunk`` 0, the
    default), 1, 7 or 50 iterations; the iterates stop on the device, so
    all are bit-equal, with equal iteration counts and residuals."""
    runs = [storm["out"]["two_level"]] + [
        _pcg(storm, pcg_precond="two_level", pcg_chunk=c)
        for c in (1, 7, 50)]
    for r in runs[1:]:
        assert int(r.solver_iters) == int(runs[0].solver_iters)
        assert torch.equal(r.solver_residual, runs[0].solver_residual)
        for name in ("U", "utilization", "reactions"):
            assert torch.equal(getattr(r, name), getattr(runs[0], name)), \
                name


def test_chunked_pcg_matches_jax_chunked(storm):
    """JAX's chunked route (its band operators on this chain-refined mesh)
    at tol 1e-9: the port's one route converges to the same tolerance and
    agrees to 1e-5 x max |U|."""
    ref = sf.analyze(storm["jm"], storm["jw"], storm["jc"], solver="pcg",
                     accel="analytic", pcg_precond="two_level",
                     pcg_tol=1e-9, pcg_maxiter=8000, pcg_chunk=50)
    out = _pcg(storm, pcg_precond="two_level", pcg_tol=1e-9,
               pcg_maxiter=8000, pcg_chunk=50)
    assert float(out.solver_residual) <= 1e-9
    scale = float(np.abs(np.asarray(ref.U)).max())
    np.testing.assert_allclose(out.U.numpy(), np.asarray(ref.U),
                               atol=1e-5 * scale)


def _true_residual(tm, U, F) -> float:
    """||P(K U - F)|| / ||P F|| member by member in numpy longdouble."""
    ld = np.longdouble
    Kg = tb.element_stiffness(tm.coords, tm.conn, tm.sections, tm.sect_id,
                              210000.0, 210000.0 / 2.6)[0].numpy().astype(ld)
    dofs = (6 * tm.conn.numpy()[:, :, None] + np.arange(6)).reshape(-1, 12)
    U, F = np.asarray(U).astype(ld), np.asarray(F).astype(ld)
    KU = np.zeros(tm.n_dof, ld)
    np.add.at(KU, dofs, np.einsum("mij,mj->mi", Kg, U[dofs]))
    free = ~np.repeat(tm.fixed_mask.numpy(), 6)
    d, f = (KU - F)[free], F[free]
    return float(np.sqrt((d * d).sum() / (f * f).sum()))


def test_true_residual_drift_is_bounded(storm):
    """CG stops on its recurrence's residual, which drifts from the true
    ||P(K U - F)|| / ||P F|| by rounding over the iterations (the stiff
    axial modes): in JAX and in the port alike the true residual of the
    converged iterate stays within 2 x tol."""
    out = storm["out"]["two_level"]
    ref = storm["ref"]["two_level"]
    for U, F in ((out.U, out.F_applied), (ref.U, ref.F_applied)):
        assert _true_residual(storm["tm"], U, F) <= 2 * TOL


def test_pcg_warns_when_not_converged(storm):
    """A small pcg_maxiter leaves the residual above tol: a warning names
    it, and solver_iters is pcg_maxiter; a NaN residual warns too."""
    with pytest.warns(UserWarning, match="PCG did not converge"):
        out = _pcg(storm, pcg_precond="block_jacobi", pcg_maxiter=7)
    assert int(out.solver_iters) == 7
    assert float(out.solver_residual) > TOL
    coarse = pt.default_3leg_jacket(device="cpu")
    nan_case = pt.LoadCase(**{**STORM, "E": float("nan")})
    with pytest.warns(UserWarning, match="did not converge: relative "
                                         "residual nan"):
        pt.analyze(coarse, storm["tw"], nan_case, solver="pcg",
                   pcg_maxiter=5)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _pcg(storm, pcg_precond="block_jacobi", pcg_tol=1e-6)


def test_pcg_options_validated(storm):
    with pytest.raises(ValueError, match="pcg_precond"):
        _pcg(storm, pcg_precond="ilu")
    with pytest.raises(TypeError, match="mesh="):
        _pcg(storm, mesh=object())


def test_pcg_function_matches_jax_with_dense_oracle(storm):
    """``ops.solve.pcg`` on the projected operator with a seeded
    right-hand side: the sparse two-level preconditioner and its dense
    oracle give the same trajectory (iterations within 2, x at 1e-8 of
    its largest value), and JAX's ``pcg`` the same count within 1."""
    jm, tm = storm["jm"], storm["tm"]
    E, G = 210000.0, 210000.0 / 2.6
    Kg = tb.element_stiffness(tm.coords, tm.conn, tm.sections, tm.sect_id,
                              E, G)[0]
    A = ta.assemble_bcsr(Kg, ta.build_bcsr_pattern(tm.conn, tm.n_nodes))
    fmask = ts.dof_free_mask(tm.fixed_mask).double()
    b = fmask * torch.tensor(np.random.default_rng(7).normal(
        size=tm.n_dof) * 1e5)
    op = ts.projected_operator(lambda x: ta.bcsr_matvec(A, x), fmask)
    bj = ts.block_jacobi_preconditioner(ta.bcsr_block_diagonal(A), fmask)
    agg = tc.aggregates_from_pattern(A.pattern)
    cs = tc.build_coarse_space(A, tm.coords, tm.fixed_mask, agg=agg)
    cd = tc.build_coarse_space_dense(A, tm.coords, tm.fixed_mask, agg=agg)
    rs = ts.pcg(op, b, precond=tc.two_level_preconditioner(bj, cs),
                tol=TOL, maxiter=20000)
    rd = ts.pcg(op, b, precond=tc.two_level_preconditioner_dense(bj, cd),
                tol=TOL, maxiter=20000)
    assert abs(int(rs.n_iter) - int(rd.n_iter)) <= 2
    assert rel_err(rs.x, rd.x) < 1e-8

    @jax.jit
    def j_solve(m, pattern, b):
        jA = ja.assemble_bcsr(j_es(m.coords, m.conn, m.sections, m.sect_id,
                                   E, G)[0], pattern)
        jf = js.dof_free_mask(m.fixed_mask).astype(jnp.float64)
        return js.pcg(js.projected_operator(lambda x: ja.bcsr_matvec(jA, x),
                                            jf), b,
                      precond=js.block_jacobi_preconditioner(
                          ja.bcsr_block_diagonal(jA), jf),
                      tol=TOL, maxiter=20000)
    jr = j_solve(jm, j_pattern(jm.conn, jm.n_nodes), jnp.asarray(b.numpy()))
    rb = ts.pcg(op, b, precond=bj, tol=TOL, maxiter=20000)
    assert abs(int(rb.n_iter) - int(jr.n_iter)) <= 1
    assert rel_err(rb.x, jr.x) < 1e-8
