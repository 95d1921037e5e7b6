"""PyTorch port vs the JAX package: element stiffness, dense assembly, the
dense factor-once solve and the chain condensation (flat Thomas and nested)
on the default jacket refined 4x (f64, CPU; 1e-10 relative)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.ops import condense as jcond
from small_fem_solver_tpu.ops import solve as jsolve
from small_fem_solver_tpu.ops.assembly import assemble_dense as j_assemble
from small_fem_solver_tpu.ops.beams import element_stiffness as j_element
from small_fem_solver_tpu_torch.ops import condense as tcond
from small_fem_solver_tpu_torch.ops import solve as tsolve
from small_fem_solver_tpu_torch.ops.assembly import assemble_dense
from small_fem_solver_tpu_torch.ops.beams import element_stiffness
from test_torch_convert import port_model, rel_err

TOL = 1e-10
N_SEG = 4
E, G = 210000.0, 210000.0 / 2.6


@pytest.fixture(scope="module")
def models():
    coarse = sf.default_3leg_jacket()
    refined = sf.refine_model(coarse, N_SEG)
    return coarse, refined, port_model(coarse), port_model(refined)


@pytest.fixture(scope="module")
def stiffness(models):
    _, refined, _, tref = models
    jout = j_element(refined.coords, refined.conn, refined.sections,
                     refined.sect_id, E, G)
    tout = element_stiffness(tref.coords, tref.conn, tref.sections,
                             tref.sect_id, E, G)
    return jout, tout


def test_element_stiffness_matches_jax(stiffness):
    jout, tout = stiffness
    for name, a, b in zip(("K_global", "K_local", "T", "L_m"), tout, jout):
        assert rel_err(a, b) < TOL, name


def test_assemble_dense_and_factored_solve_match_jax(models, stiffness):
    coarse, _, tcoarse, _ = models
    (jKg, *_), (tKg, *_) = stiffness
    # the interface system of the condensed solver
    jfac = jcond.factor_chains(jKg, N_SEG)
    tfac = tcond.factor_chains(tKg, N_SEG)
    n_dof = 6 * coarse.n_nodes
    jK = j_assemble(jfac.K_super, coarse.conn, n_dof)
    tK = assemble_dense(tfac.K_super, tcoarse.conn, n_dof)
    assert rel_err(tK, jK) < TOL
    free, _ = jsolve.free_fixed_dofs(coarse.fixed_mask)
    tfree, _ = tsolve.free_fixed_dofs(tcoarse.fixed_mask)
    np.testing.assert_array_equal(tfree, free)
    jd = jsolve.factor_dense(jK, free)
    td = tsolve.factor_dense(tK, tfree)
    assert rel_err(td.chol, jd.chol) < TOL
    F = np.random.default_rng(0).normal(size=(3, n_dof)) * 1e5
    for steps in (0, 1):
        jU = jsolve.solve_factored(jd, jnp.asarray(F), refine_steps=steps)
        tU = tsolve.solve_factored(td, torch.tensor(F), refine_steps=steps)
        assert rel_err(tU, jU) < TOL
    assert rel_err(tsolve.solve_factored(td, torch.tensor(F[0])),
                   jsolve.solve_factored(jd, jnp.asarray(F[0]))) < TOL


@pytest.mark.parametrize("solver", ["thomas", "nested"])
def test_chain_condensation_matches_jax(models, stiffness, solver):
    coarse, _, tcoarse, _ = models
    (jKg, *_), (tKg, *_) = stiffness
    if solver == "thomas":
        jf, tf = jcond.factor_chains(jKg, N_SEG), tcond.factor_chains(tKg,
                                                                       N_SEG)
        j_cl, j_bs = jcond.condense_loads, jcond.back_substitute
        t_cl, t_bs = tcond.condense_loads, tcond.back_substitute
        pairs = zip(tf, jf)
    else:
        assert tcond.nested_split(N_SEG) == jcond.nested_split(N_SEG) == 2
        jf = jcond.factor_chains_nested(jKg, N_SEG)
        tf = tcond.factor_chains_nested(tKg, N_SEG)
        j_cl, j_bs = jcond.condense_loads_nested, jcond.back_substitute_nested
        t_cl, t_bs = tcond.condense_loads_nested, tcond.back_substitute_nested
        pairs = [(tf.K_super, jf.K_super), *zip(tf.fac1, jf.fac1),
                 *zip(tf.fac2, jf.fac2)]
    for a, b in pairs:
        assert rel_err(a, b) < TOL

    rng = np.random.default_rng(1)
    Mc, n_int = coarse.n_members, N_SEG - 1
    g = rng.normal(size=(2, n_int, Mc, 6)) * 1e5
    jfI, jfJ, jv = j_cl(jf, jnp.asarray(g))
    tfI, tfJ, tv = t_cl(tf, torch.tensor(g))
    assert rel_err(tfI, jfI) < TOL and rel_err(tfJ, jfJ) < TOL
    uI, uJ = rng.normal(size=(2, 2, Mc, 6))
    jb = j_bs(jf, jv, jnp.asarray(uI), jnp.asarray(uJ))
    tb = t_bs(tf, tv, torch.tensor(uI), torch.tensor(uJ))
    assert rel_err(tb, jb) < TOL

    U_I = rng.normal(size=(2, coarse.n_nodes, 6))
    v = rng.normal(size=(2, n_int, Mc, 6))
    jy = jcond.chain_matvec(jKg, N_SEG, coarse.conn, jnp.asarray(U_I),
                            jnp.asarray(v))
    ty = tcond.chain_matvec(tKg, N_SEG, tcoarse.conn, torch.tensor(U_I),
                            torch.tensor(v))
    for a, b in zip(ty, jy):
        assert rel_err(a, b) < TOL


def test_nested_split_rejects_primes():
    assert tcond.nested_split(32) == 8 and tcond.nested_split(324) == 18
    with pytest.raises(ValueError):
        tcond.nested_split(317)
