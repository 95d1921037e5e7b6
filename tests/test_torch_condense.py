"""PyTorch port vs the JAX package: element stiffness, dense assembly, the
dense factor-once solve and the chain condensation (flat Thomas and nested)
on the default jacket refined 4x (f64, CPU; 1e-10 relative); the index
arithmetic of the chain-sweep kernel, emulated on the CPU."""
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
from small_fem_solver_tpu_torch.ops import hopper_kernels as hk
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


def _mv(A, x):
    """A[c] @ x[c, b] for row-major A [c, 36], x [c, b, 6]."""
    return torch.einsum("cij,cbj->cbi", A.reshape(-1, 6, 6), x)


def _emulate_sweep_kernel(fac, g, split):
    """The index arithmetic of csrc/chain_sweep.cu's tiled form in
    PyTorch: blocks of 32 right-hand sides x Ct chains, the staged factor
    rows, the g tile read through the strides (b, l, m, q) in the kernel's
    walk order into the padded slots, the per-thread sweeps on those slots,
    and the v / fI / fJ tile stores at the kernel's output offsets.  Every
    output starts as NaN, so an element no block writes shows."""
    g3, B, (sb, sl, sm, sq), Q, levels_inner = hk.sweep_operand(g, split)
    n_int, C = fac.Cprime.shape[:2]
    Ct = hk.sweep_chains_per_block(n_int, g.element_size())
    assert Ct >= 1
    lanes, pad = hk.SWEEP_LANES, hk.SWEEP_LANES + 1
    span = (B - 1) * sb + (n_int - 1) * sl + (C // Q - 1) * sm \
        + (Q - 1) * sq + 6
    flat = g3.as_strided((span,), (1,), g3.storage_offset())
    mats = [t.reshape(-1) for t in (fac.Dinv, fac.DinvL, fac.Cprime)]
    ends_src = [fac.B0.reshape(-1), fac.Cn.reshape(-1)]
    nan = float("nan")
    v = torch.full((B * n_int * C * 6,), nan, dtype=g.dtype)
    fI = torch.full((B * C * 6,), nan, dtype=g.dtype)
    fJ = torch.full((B * C * 6,), nan, dtype=g.dtype)
    for b0 in range(0, B, lanes):
        for c0 in range(0, C, Ct):
            nb, nc = min(lanes, B - b0), min(Ct, C - c0)
            facs = torch.zeros(n_int, Ct, 3, 36, dtype=g.dtype)
            ends = torch.zeros(Ct, 2, 36, dtype=g.dtype)
            buf = torch.zeros(max(n_int, 2), Ct, 6, pad, dtype=g.dtype)
            row = nc * 36
            i = torch.arange(n_int * 3 * row)
            r, mat, lv = i % row, (i // row) % 3, i // (3 * row)
            for mm in range(3):
                sel = mat == mm
                facs[lv[sel], r[sel] // 36, mm, r[sel] % 36] = \
                    mats[mm][(lv[sel] * C + c0) * 36 + r[sel]]
            i = torch.arange(2 * row)
            r, mat = i % row, i // row
            for mm in range(2):
                sel = mat == mm
                ends[r[sel] // 36, mm, r[sel] % 36] = \
                    ends_src[mm][c0 * 36 + r[sel]]
            i = torch.arange(nb * n_int * nc * 6)
            k, t = i % 6, i // 6
            if levels_inner:
                lv, cc, bb = t % n_int, (t // n_int) % nc, t // n_int // nc
            else:
                cc, lv, bb = t % nc, (t // nc) % n_int, t // nc // n_int
            c = c0 + cc
            buf[lv, cc, k, bb] = flat[(b0 + bb) * sb + lv * sl
                                      + (c // Q) * sm + (c % Q) * sq + k]
            # the threads (lane bb < nb, warp cc < nc) sweep on the slots
            y = torch.zeros(nc, nb, 6, dtype=g.dtype)
            for lv in range(n_int):
                gl = buf[lv, :nc, :, :nb].transpose(1, 2)
                y = _mv(facs[lv, :nc, 0], gl) - _mv(facs[lv, :nc, 1], y)
                buf[lv, :nc, :, :nb] = y.transpose(1, 2)
            vn = torch.zeros(nc, nb, 6, dtype=g.dtype)
            for lv in reversed(range(n_int)):
                vn = buf[lv, :nc, :, :nb].transpose(1, 2) \
                    - _mv(facs[lv, :nc, 2], vn)
                buf[lv, :nc, :, :nb] = vn.transpose(1, 2)
                if lv == n_int - 1:
                    v_last = vn
            fi, fj = _mv(ends[:nc, 0], vn), _mv(ends[:nc, 1], v_last)
            row6 = nc * 6
            i = torch.arange(nb * n_int * row6)
            r, lv, bb = i % row6, (i // row6) % n_int, i // (row6 * n_int)
            v[(((b0 + bb) * n_int + lv) * C + c0) * 6 + r] = \
                buf[lv, r // 6, r % 6, bb]
            buf[0, :nc, :, :nb] = -fi.transpose(1, 2)
            buf[1, :nc, :, :nb] = -fj.transpose(1, 2)
            i = torch.arange(nb * row6)
            r, bb = i % row6, i // row6
            o = ((b0 + bb) * C + c0) * 6 + r
            fI[o] = buf[0, r // 6, r % 6, bb]
            fJ[o] = buf[1, r // 6, r % 6, bb]
    return fI.reshape(B, C, 6), fJ.reshape(B, C, 6), v.reshape(B, n_int, C, 6)


def _random_factor(rng, n_int, C):
    mats = [torch.tensor(rng.normal(size=(n_int, C, 6, 6)) / 6.0)
            for _ in range(3)]
    ends = [torch.tensor(rng.normal(size=(C, 6, 6))) for _ in range(2)]
    return tcond.ChainFactor(K_super=torch.zeros(C, 12, 12), Dinv=mats[0],
                             DinvL=mats[1], Cprime=mats[2], Z0=mats[0],
                             Zn=mats[0], B0=ends[0], Cn=ends[1])


@pytest.mark.parametrize("layout,B,n_int,C", [
    ("contiguous", 37, 3, 13),     # ragged right-hand-side and chain tiles
    ("contiguous", 64, 7, 16),     # whole tiles
    ("transposed", 37, 16, 11),    # the scan's chain layout: levels inner
    ("nested level 1", 37, 3, 12),  # the (m, q) view, Q = 4
    ("scan nested level 1", 37, 3, 12),  # the same view of the scan layout
    ("thomas depth", 33, 31, 3),   # one chain per block in f64
    ("batched", 5, 4, 9),          # two leading dims [2, 5]
])
def test_sweep_kernel_index_arithmetic(layout, B, n_int, C):
    """The sweep kernel's tiling, emulated on the CPU in f64, equals the
    plain sweep for ragged tiles, strided layouts and the nested level-1
    view, and writes every output element."""
    rng = np.random.default_rng(n_int * 100 + C)
    fac = _random_factor(rng, n_int, C)
    split = False
    if layout == "transposed":
        g = torch.tensor(rng.normal(size=(B, C, n_int, 6))).transpose(1, 2)
    elif layout in ("nested level 1", "scan nested level 1"):
        # as condense_loads_nested builds it: n_sub = n_int + 1 positions per
        # sub-chain, Q = n_outer sub-chains, chain c = m * Q + q
        Q, n_sub = 4, n_int + 1
        Mc = C // Q
        gpos = torch.tensor(rng.normal(size=(B, Q * n_sub - 1, Mc, 6)))
        if layout.startswith("scan"):   # [B, Mc, positions, 6] in memory
            gpos = torch.tensor(rng.normal(
                size=(B, Mc, Q * n_sub - 1, 6))).transpose(1, 2)
        sP, sM, sK = gpos.stride()[-3:]
        g = gpos.as_strided((B, n_sub - 1, Mc, Q, 6),
                            (gpos.stride(0), sP, sM, n_sub * sP, sK))
        split = True
    elif layout == "batched":
        g = torch.tensor(rng.normal(size=(2, B, n_int, C, 6)))
    else:
        g = torch.tensor(rng.normal(size=(B, n_int, C, 6)))
    g_chain = (g.reshape(*g.shape[:-3], C, 6) if split else g)
    levels_inner = hk.sweep_operand(g, split)[4]
    assert levels_inner == (layout == "transposed")
    if layout == "thomas depth":
        assert hk.sweep_chains_per_block(n_int, 8) == 1
    out = _emulate_sweep_kernel(fac, g, split)
    ref = tcond.chain_sweep_plain(fac, g_chain.reshape(-1, n_int, C, 6))
    for a, b in zip(out, ref):
        assert not torch.isnan(a).any()
        assert rel_err(a, b) < 1e-12
    plain = tcond.condense_loads(fac, g, split=split)
    for a, b in zip(plain, tcond.chain_sweep_plain(fac, g_chain)):
        assert torch.equal(a, b)
