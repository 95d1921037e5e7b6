"""PyTorch port vs the JAX package: the collapse tier, ``ops/pushover.py``
(``pushover``, ``pushover_rose``) and ``ops/robustness.py``
(``member_removal_screen``), and the batched dense factorization both run
on (``ops/solve.py``).

Mirrors ``tests/test_pushover.py`` and ``tests/test_robustness.py``: the
statically determinate V-truss's capacity (the port alone), the default
jacket's curves, RSR and first yield against JAX, the removal screen of
the jacket and of V-frames against JAX, in f64 on the CPU.  RSR,
first-yield lambda, ``converged``, ``n_yielded``, ``stable`` and
``critical`` are held exactly (a member sitting at its capacity could
flip on roundoff; none does here); the curves and utilizations at 1e-10
(max |port - JAX| / max |JAX|).  JAX's references run jitted: its
``curves`` (the vmapped secant iteration) and its removal screen, the
rose as its sharded path computes it (``vmap`` of ``curves`` over the
headings' environmental loads)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.ops import pushover as jp
from small_fem_solver_tpu.ops import robustness as jrob
import small_fem_solver_tpu_torch as pt
from small_fem_solver_tpu_torch.api import _dense_system
from small_fem_solver_tpu_torch.ops import solve as tsolve
from test_torch_convert import port_case, port_model, port_wave, rel_err

TOL = 1e-10
STORM = dict(wave_dir_deg=38.0, current_dir_deg=38.0, F_axial_kN=25100.0,
             F_shear_kN=2900.0, custom_sw_tonnes=1100.0, sw_mode="custom",
             t_analysis=0.34)
KW = dict(lambda_max=16.0, n_lambda=5, n_iter=30)
CURVE = ("max_displacement_mm", "max_util", "axial_N")
EXACT = ("lambdas", "converged", "n_yielded")


def _v_frame(build, keepers=1, **kw):
    """Pinned V bars on a feather-soft keeper column (two with
    ``keepers=2``, one redundant): the pushover's determinate truss and
    the removal screen's frame (``tests/test_pushover.py``,
    ``tests/test_robustness.py``)."""
    h, b = 6.0, 4.0
    nodes = {"L": (-b, 0.0, 0.0), "R": (b, 0.0, 0.0), "TOP": (0.0, 0.0, h)}
    members = [
        {"name": "bl", "node1": "L", "node2": "TOP", "type": "brace",
         "release": "pinned"},
        {"name": "br", "node1": "R", "node2": "TOP", "type": "brace",
         "release": "pinned"}]
    xs = [0.0] if keepers == 1 else [-0.5, 0.5]
    for i, x in enumerate(xs):
        nodes[f"K{i}"] = (x, 0.0, 0.0)
        members.append({"name": f"k{i}", "node1": f"K{i}", "node2": "TOP",
                        "type": "leg"})
    return build(nodes, members, ["L", "R"] + [f"K{i}" for i in
                                               range(len(xs))], ["TOP"],
                 leg_section=(60.0, 2.0), brace_section=(400.0, 20.0), **kw)


def jax_curves(jm, jw, jcase, headings, n_iter, lambda_max, n_lambda,
               k_factor=1.0, residual=1.0, support_stiffness=None):
    """JAX's pushover curves at each heading, jitted: ``vmap`` of its
    ``curves`` over the headings' environmental loads, as its sharded
    rose computes them; (lambdas, [(first_yield, rsr, curve dict)])."""
    rel = jcase.current_dir_deg - jcase.wave_dir_deg
    with jax.default_matmul_precision("highest"):
        curves, _ = jp._make_curves_fn(jm, jcase, n_iter, k_factor,
                                       residual, 1e-2, support_stiffness)
        loads = [jax.jit(lambda c=dataclasses.replace(
            jcase, wave_dir_deg=h, current_dir_deg=h + rel):
            jp._split_loads(jm, jw, c, 15, "analytic"))() for h in headings]
        lambdas = jnp.linspace(0.0, lambda_max, n_lambda)
        out = jax.jit(jax.vmap(curves, in_axes=(None, 0, None)))(
            loads[0][0], jnp.stack([f[1] for f in loads]), lambdas)
    lam = np.asarray(lambdas)
    res = []
    for i in range(len(headings)):
        conv, disp, ny, util, axial = (np.asarray(a[i]) for a in out)
        fy, rsr = jp._rsr_from_curve(lam, conv, disp, ny, 20.0)
        res.append((fy, rsr, dict(lambdas=lam, converged=conv,
                                  max_displacement_mm=disp, n_yielded=ny,
                                  max_util=util, axial_N=axial,
                                  F_perm=np.asarray(loads[i][0]),
                                  F_env=np.asarray(loads[i][1]))))
    return res


def assert_pushover_equal(out, fy, rsr, ref):
    for f in EXACT:
        assert np.array_equal(getattr(out, f).numpy(), ref[f]), f
    assert float(out.first_yield_lambda) == fy
    assert float(out.rsr) == rsr
    for f in CURVE + ("F_perm", "F_env"):
        assert rel_err(getattr(out, f), ref[f]) < TOL, f


@pytest.fixture(scope="module")
def jacket():
    jm = sf.default_3leg_jacket()
    jw = sf.airy_wave(17.038, 9.4, 50.0, 1.7)
    jc = sf.LoadCase(**STORM)
    return jm, jw, jc, port_model(jm), port_wave(jw), port_case(jc)


def test_batched_factor_equals_single_bit_for_bit(jacket):
    """``factor_dense`` / ``solve_factored`` on a [B, n, n] stack (seeded
    secant states of the jacket) equal the single-matrix calls bit for
    bit: the factors, and the solves with one right-hand side each and
    with one shared; a non-SPD state gives an all-NaN factor alone."""
    *_, tm, _, _ = jacket
    rng = np.random.default_rng(0)
    K = _dense_system(tm, pt.LoadCase().cast(torch.float64, "cpu"))[0]
    scale = torch.tensor(rng.uniform(0.5, 2.0, (5, 1, 1)))
    Ks = K * scale + torch.diag(torch.tensor(rng.uniform(0, 1e3, tm.n_dof)))
    Ks[3, 30, 30] = -1.0                      # not positive definite
    free = tsolve.free_fixed_dofs(tm.fixed_mask)[0]
    F = torch.tensor(rng.normal(size=(5, tm.n_dof)) * 1e5)
    fac = tsolve.factor_dense(Ks, free)
    U, U1 = tsolve.solve_factored(fac, F), tsolve.solve_factored(fac, F[0])
    for b in range(5):
        single = tsolve.factor_dense(Ks[b], free)
        for f in ("chol", "scale", "K_ff"):
            assert torch.equal(getattr(fac, f)[b].nan_to_num(),
                               getattr(single, f).nan_to_num()), f
        assert torch.equal(U[b].nan_to_num(),
                           tsolve.solve_factored(single, F[b]).nan_to_num())
        assert torch.equal(U1[b].nan_to_num(),
                           tsolve.solve_factored(single, F[0]).nan_to_num())
        assert bool(torch.isnan(fac.chol[b]).all()) == (b == 3)


def test_v_truss_capacity_closed_form():
    """The determinate V-truss (the port alone): first yield at the
    closed-form capacity 2 sin(theta) A fy / F0 (8%), practical collapse
    there (0.25), the displacement jump past it, and axial forces linear
    in lambda in the elastic range (1e-6)."""
    model = _v_frame(pt.build_model, device="cpu")
    wave = pt.airy_wave(1e-9, 9.4, 50.0, device="cpu")
    F0 = 5000.0
    case = pt.LoadCase(sw_mode="none", F_shear_kN=F0, wave_dir_deg=90.0,
                       current_dir_deg=90.0)
    res = pt.pushover(model, wave, case, lambda_max=3.0, n_lambda=31,
                      n_iter=120)
    A = float(model.sections.Ax[1])
    lam_c = 2.0 * (4.0 / np.hypot(4.0, 6.0)) * (A * 355.0) / (F0 * 1e3)
    assert 1.0 < lam_c < 2.5
    assert float(res.first_yield_lambda) == pytest.approx(lam_c, rel=0.08)
    assert float(res.rsr) == pytest.approx(lam_c, abs=0.25)
    lam, disp = res.lambdas.numpy(), res.max_displacement_mm.numpy()
    conv = res.converged.numpy()
    below = disp[(lam < 0.9 * lam_c) & (lam > 0) & conv]
    above = disp[(lam > 1.2 * lam_c) & conv]
    if len(above):
        assert above.min() > 10.0 * below.max()
    ax = res.axial_N.numpy()
    np.testing.assert_allclose(ax[4, :2], ax[2, :2] * lam[4] / lam[2],
                               rtol=1e-6)
    with pytest.raises(ValueError, match="residual"):
        pt.pushover(model, wave, case, residual=0.0)


def test_pushover_rose_matches_jax(jacket):
    """``pushover_rose`` (mesh=None: every heading's grid in one batch)
    against JAX at 4 headings: each heading's curve, RSR and first yield,
    the loads, the 3-fold symmetry of 10 / 130 / 250 deg, and a single
    ``pushover`` at one heading equal to its rose entry (1e-12)."""
    jm, jw, jc, tm, tw, tc = jacket
    headings = [10.0, 130.0, 250.0, 70.0]
    ref = jax_curves(jm, jw, jc, headings, **KW)
    hs, rsr, fy, per = pt.pushover_rose(tm, tw, tc, headings, **KW)
    assert np.array_equal(hs, headings) and len(per) == 4
    for out, (fy_j, rsr_j, curve) in zip(per, ref):
        assert_pushover_equal(out, fy_j, rsr_j, curve)
    assert np.array_equal(rsr, [r[1] for r in ref])
    assert np.array_equal(fy, [r[0] for r in ref])
    assert rsr[0] == rsr[1] == rsr[2] and rsr.min() > 1.0
    one = pt.pushover(tm, tw, dataclasses.replace(
        tc, wave_dir_deg=70.0, current_dir_deg=70.0), **KW)
    assert float(one.rsr) == rsr[3]
    for f in CURVE:
        assert rel_err(getattr(one, f), getattr(per[3], f)) < 1e-12, f
    with pytest.raises(TypeError, match="unknown"):
        pt.pushover_rose(tm, tw, tc, headings, n_lamda=3)


def test_pushover_on_springs_with_residual_matches_jax(jacket):
    """The pushover on per-support foundation springs with post-peak
    residual 0.8 and k_factor 1.2 against JAX (curve 1e-10; RSR, first
    yield, convergence and yielded counts exactly)."""
    jm, jw, jc, tm, tw, tc = jacket
    opts = dict(KW, k_factor=1.2, residual=0.8,
                support_stiffness=np.outer([1.0, 2.0, 0.5],
                                           [1e6] * 3 + [1e12] * 3))
    (fy, rsr, ref), = jax_curves(jm, jw, jc, [jc.wave_dir_deg], **opts)
    out = pt.pushover(tm, tw, tc, **opts)
    assert_pushover_equal(out, fy, rsr, ref)
    assert int(out.n_yielded[-1]) > 0


@pytest.mark.parametrize("frame", ["jacket", "v_frame", "keeper_lost"])
def test_removal_screen_matches_jax(jacket, frame):
    """``member_removal_screen`` against JAX: the storm jacket (every
    brace loss stable, a lower leg's critical), the two-keeper V-frame
    (each bar critical, each keeper redundant) and the one-keeper V-frame,
    whose keeper's loss leaves a mechanism (NaN: unstable and critical on
    both sides).  Flags and governing members exactly, utilizations and
    displacements 1e-10."""
    if frame == "jacket":
        jm, jw, jc, tm, tw, tc = jacket
    else:
        jm = _v_frame(sf.build_model, keepers=1 if frame == "keeper_lost"
                      else 2)
        jw = sf.airy_wave(1e-9, 9.4, 50.0)
        jc = sf.LoadCase(sw_mode="none", F_shear_kN=3000.0,
                         wave_dir_deg=90.0, current_dir_deg=90.0)
        tm, tw, tc = port_model(jm), port_wave(jw), port_case(jc)
    ref = jax.jit(lambda: jrob.member_removal_screen(jm, jw, jc))()
    out = pt.member_removal_screen(tm, tw, tc)
    for f in ("stable", "critical", "governing_member"):
        assert np.array_equal(getattr(out, f).numpy(),
                              np.asarray(getattr(ref, f))), f
    live = out.stable.numpy()
    for f in ("max_util", "max_displacement_mm"):
        assert rel_err(getattr(out, f)[live],
                       np.asarray(getattr(ref, f))[live]) < TOL, f
    assert rel_err(out.intact_util, ref.intact_util) < TOL
    crit = out.critical.numpy()
    if frame == "jacket":
        braces = np.array([t != "leg" for t in tm.member_types])
        assert live.all() and not crit[braces].any() and crit[~braces].any()
    elif frame == "v_frame":
        assert list(crit) == [True, True, False, False]
    else:
        assert list(live) == [True, True, False] and crit.all()
