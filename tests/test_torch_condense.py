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


def _emulate_narrow_sweep(fac, g, split):
    """The index arithmetic of csrc/chain_sweep.cu's narrow form in
    PyTorch: one warp a (chain, group of rg right-hand sides) block, lane
    6 bb + r owning row r of right-hand side bb, the RING-deep ring of
    stages (a forward level's Dinv, DinvL and g_l, a backward level's C'
    in DinvL's place) filled in groups of NARROW_UNROLL levels, RING -
    NARROW_UNROLL levels ahead, and read two stages ahead of their use,
    the carry gathered from the right-hand side's six lanes through the
    exchange row, y_l in
    its store, and the v / fI / fJ stores at the kernel's offsets.  Every
    output starts as NaN, so an element no lane writes shows."""
    g3, B, (sb, sl, sm, sq), Q, _ = hk.sweep_operand(g, split)
    n_int, C = fac.Cprime.shape[:2]
    size = g.element_size()
    rg = hk.sweep_narrow_rhs(B, n_int, size)
    assert rg >= 1
    SW, RING = hk.sweep_stage_elems(rg, size), hk.SWEEP_RING
    U, YW, stages = hk.SWEEP_NARROW_UNROLL, 6 * rg, 2 * n_int
    span = (B - 1) * sb + (n_int - 1) * sl + (C // Q - 1) * sm \
        + (Q - 1) * sq + 6
    flat = g3.as_strided((span,), (1,), g3.storage_offset())
    Dinv, DinvL, Cp, B0, Cn = (t.reshape(-1) for t in (
        fac.Dinv, fac.DinvL, fac.Cprime, fac.B0, fac.Cn))
    nan = float("nan")
    v = torch.full((B * n_int * C * 6,), nan, dtype=g.dtype)
    fI = torch.full((B * C * 6,), nan, dtype=g.dtype)
    fJ = torch.full((B * C * 6,), nan, dtype=g.dtype)
    lane = torch.arange(32)
    r, bb, k = lane % 6, lane // 6, torch.arange(6)
    # the exchange row's entries each lane reads (dead lanes: the last group)
    src = 6 * torch.clamp(bb, max=rg - 1)[:, None] + k[None, :]
    ylanes, yl = lane < YW, torch.clamp(lane, max=YW - 1)

    def matrow(A, x):       # row r of A x, FMAs in matvec6's order
        acc = torch.zeros(32, dtype=g.dtype)
        for kk in range(6):
            acc = acc + A[:, kk] * x[:, kk]
        return acc
    for c in range(C):
        for b0 in range(0, B, rg):
            nb = min(rg, B - b0)
            live = bb < nb
            bc = torch.clamp(bb, max=rg - 1)
            goff = ((b0 + bc) * sb + (c // Q) * sm + (c % Q) * sq + r)
            ring = torch.full((RING * SW,), nan, dtype=g.dtype)
            ys = torch.full((n_int * YW,), nan, dtype=g.dtype)

            def issue(t):
                if t >= stages:
                    return
                st = (t % RING) * SW
                if t < n_int:
                    o = (t * C + c) * 36
                    ring[st:st + 36] = Dinv[o:o + 36]
                    ring[st + 36:st + 72] = DinvL[o:o + 36]
                    ring[st + 72 + lane[live]] = flat[goff[live] + t * sl]
                else:
                    o = ((stages - 1 - t) * C + c) * 36
                    ring[st + 36:st + 72] = Cp[o:o + 36]

            def fetch(t):
                st = (t % RING) * SW
                row = ring[st + 36 + r[:, None] * 6 + k[None, :]]
                av = matrow(ring[st + r[:, None] * 6 + k[None, :]],
                            ring[st + 72 + 6 * bc[:, None] + k[None, :]])
                return av, row
            for t in range(0, RING - U, U):
                for u in range(U):
                    issue(t + u)
            nxt = [fetch(0), fetch(1)]
            x = torch.zeros(32, dtype=g.dtype)
            for t0 in range(0, stages, U):
                for u in range(U):
                    issue(t0 + RING - U + u)
                for t in range(t0, t0 + U):
                    (a_t, R), nxt = nxt[0], [nxt[1], fetch(t + 2)]
                    fwd = t < n_int
                    lv = t if fwd else max(stages - 1 - t, 0)
                    base = a_t if fwd else ys[lv * YW + yl]
                    if t == n_int:
                        x = torch.zeros(32, dtype=g.dtype)
                    x = base - matrow(R, x[src])
                    if fwd:
                        ys[lv * YW + lane[ylanes]] = x[ylanes]
                    elif t < stages:
                        v[(((b0 + bb[live]) * n_int + lv) * C + c) * 6
                          + r[live]] = x[live]
                        if t == n_int:
                            v_last = x
                        if t == stages - 1:
                            v0 = x
            e0 = B0[c * 36 + r[:, None] * 6 + k[None, :]]
            e1 = Cn[c * 36 + r[:, None] * 6 + k[None, :]]
            fi, fj = matrow(e0, v0[src]), matrow(e1, v_last[src])
            o = ((b0 + bb[live]) * C + c) * 6 + r[live]
            fI[o], fJ[o] = -fi[live], -fj[live]
    return fI.reshape(B, C, 6), fJ.reshape(B, C, 6), v.reshape(B, n_int, C, 6)


@pytest.mark.parametrize("layout,B,n_int,C,dtype", [
    ("contiguous", 1, 3, 13, torch.float64),    # one lane group a chain
    ("contiguous", 18, 31, 5, torch.float64),   # groups 5, 5, 5, 3; the
                                                # ring wraps
    ("contiguous", 18, 31, 5, torch.float32),   # 16-byte stages of floats
    ("transposed", 5, 16, 3, torch.float64),    # the scan's chain layout
    ("nested level 1", 7, 3, 12, torch.float64),  # the (m, q) view, Q = 4
    ("deep", 5, 400, 1, torch.float64),         # y of 5 does not fit: rg 4
])
def test_narrow_sweep_index_arithmetic(layout, B, n_int, C, dtype):
    """The sweep kernel's narrow form, emulated on the CPU, equals the
    plain sweep (1e-12 in f64, 1e-5 of the largest value in f32) for
    ragged right-hand-side groups, a ring that wraps, strided layouts,
    the nested level-1 view and a depth whose y store forces fewer
    right-hand sides a warp, and writes every output element; the form
    rule takes these batches narrow and B >= 32 wide."""
    rng = np.random.default_rng(B * 1000 + n_int)
    fac = _random_factor(rng, n_int, C)
    fac = tcond.ChainFactor(*(t.to(dtype) for t in fac))
    split = False
    if layout == "transposed":
        g = torch.tensor(rng.normal(size=(B, C, n_int, 6)),
                         dtype=dtype).transpose(1, 2)
    elif layout == "nested level 1":
        Q, n_sub = 4, n_int + 1
        gpos = torch.tensor(rng.normal(size=(B, Q * n_sub - 1, C // Q, 6)),
                            dtype=dtype)
        sP, sM, sK = gpos.stride()[-3:]
        g = gpos.as_strided((B, n_sub - 1, C // Q, Q, 6),
                            (gpos.stride(0), sP, sM, n_sub * sP, sK))
        split = True
    else:
        g = torch.tensor(rng.normal(size=(B, n_int, C, 6)), dtype=dtype)
    size = g.element_size()
    assert hk.sweep_narrow_rhs(B, n_int, size) == (4 if layout == "deep"
                                                   else min(5, B))
    assert hk.sweep_narrow_rhs(hk.SWEEP_NARROW_B, n_int, size) == 0
    g_chain = (g.reshape(*g.shape[:-3], C, 6) if split else g)
    out = _emulate_narrow_sweep(fac, g, split)
    ref = tcond.chain_sweep_plain(
        tcond.ChainFactor(*(t.double() for t in fac)),
        g_chain.double().reshape(-1, n_int, C, 6))
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for a, b in zip(out, ref):
        assert not torch.isnan(a).any()
        assert rel_err(a, b) < tol
