"""PyTorch port vs the JAX package: response-spectrum seismic analysis,
``ops/seismic.py`` (EC8 and table spectra, the CQC correlation, the dense
``response_spectrum`` and the Craig-Bampton ``response_spectrum_condensed``).

Mirrors ``tests/test_seismic.py``: the tip-mass cantilever's SDOF peak,
the effective-mass completeness identity, and the jacket against JAX in
f64 on the CPU (max |port - JAX| / max |JAX| <= 1e-10).  The 3-leg
jacket's bending pairs are (near-)degenerate, and inside such a pair two
eigensolvers pick different bases: CQC is invariant to that choice, SRSS
and 100/40/40 of member forces are not.  So the whole pipeline is held
against JAX with CQC, frequencies and effective masses on their own, and
SRSS and 100/40/40 by feeding JAX's frequencies and mode shapes into the
port's ``_spectrum_core``.  JAX's references are jitted (op-by-op
dispatch of its eigen pipeline costs ~10 s)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.ops import seismic as jsm
import small_fem_solver_tpu_torch as pt
from small_fem_solver_tpu_torch.ops import seismic as tsm
from small_fem_solver_tpu_torch.ops.dynamics import _build_km
from test_torch_convert import port_model, rel_err

TOL = 1e-10
G = 9.80665
N_SEG = 2
DIRS = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
KW = dict(pga_g=0.2, ground="C", topside_mass_t=1100.0, directions=DIRS)
DEMANDS = ("U_peak", "F1_local", "F2_local", "von_mises", "utilization",
           "base_shear_kN", "max_displacement_mm")


def _cantilever(build, n_el=8, L=30.0, D=800.0, t=30.0, **kw):
    nodes = {f"N{i}": (0.0, 0.0, i * L / n_el) for i in range(n_el + 1)}
    members = [{"name": f"E{i}", "node1": f"N{i}", "node2": f"N{i+1}",
                "type": "leg"} for i in range(n_el)]
    return build(nodes, members, ["N0"], [f"N{n_el}"], leg_section=(D, t),
                 brace_section=(D, t), **kw)


@pytest.fixture(scope="module")
def jacket():
    """The default jacket and its 2x refinement in both packages."""
    jm = sf.default_3leg_jacket()
    jr = sf.refine_model(jm, N_SEG)
    return jm, jr, port_model(jm), port_model(jr)


def test_spectra_and_correlation_match_jax():
    """EC8 horizontal (every ground class, the eta floor) and vertical,
    the table spectrum (clamped ends, a knot) and the CQC correlation with
    an equal pair and a zero-frequency mode, against JAX (1e-12 on these
    closed forms); the EC8 anchors of the JAX test."""
    T = np.array([0.0, 0.05, 0.15, 0.2, 0.3, 0.5, 0.6, 1.0, 2.0, 4.0,
                  np.inf])
    for ground in "ABCDE":
        for zeta, vertical in ((0.05, False), (0.02, True), (0.5, False)):
            out = tsm.ec8_spectrum(torch.tensor(T), 0.3, ground, zeta,
                                   vertical=vertical)
            ref = jsm.ec8_spectrum(jnp.asarray(T), 0.3, ground, zeta,
                                   vertical=vertical)
            assert rel_err(out, ref) < 1e-12
    Sa = tsm.ec8_spectrum([0.0, 0.15, 0.5, 2.0, 4.0], 0.3, "B")
    plateau = 2.5 * 0.3 * G * 1.2
    np.testing.assert_allclose(Sa.numpy(), [0.3 * G * 1.2, plateau, plateau,
                                            plateau * 0.25,
                                            plateau * 0.5 * 2.0 / 16.0],
                               rtol=1e-12)
    with pytest.raises(ValueError):
        tsm.ec8_spectrum(torch.tensor([1.0]), 0.3, "Z")
    tab = ([0.1, 1.0, 2.0], [2.0, 4.0, 1.0])
    Tq = np.array([0.05, 0.1, 0.55, 1.0, 3.0])
    assert rel_err(tsm.table_spectrum(torch.tensor(Tq), *tab),
                   jsm.table_spectrum(Tq, *tab)) < 1e-12
    w = np.array([2.0, 2.0, 6.0, 0.0])
    rho = tsm.cqc_correlation(torch.tensor(w), 0.02)
    assert rel_err(rho, jsm.cqc_correlation(jnp.asarray(w), 0.02)) < 1e-12
    assert float(rho[0, 1]) == 1.0 and float(rho[0, 3]) == 0.0


def test_sdof_peak_and_effective_mass_identity():
    """The tip-mass cantilever (the port alone): its degenerate first pair
    combined by CQC gives |sum Gamma_i phi_i,tip| Sa(T1) / omega1^2 and
    base shear (G1^2 + G2^2) Sa (1e-6), SDOF-like (5%); with every mode
    kept, sum Gamma_i^2 = b^T M_ff^-1 b (1e-8)."""
    model = _cantilever(pt.build_model, device="cpu")
    res = pt.response_spectrum(model, 0.2, ground="A", zeta=0.05,
                               topside_mass_t=500.0, n_modes=2,
                               directions=((1.0, 0.0, 0.0),))
    tip_x = 6 * (model.n_nodes - 1)
    gp = float(res.participation[0] @ res.mode_shapes[:, tip_x])
    omega = 2.0 * np.pi / float(res.periods_s[0])
    Sa = float(pt.ec8_spectrum(res.periods_s[0], 0.2, "A", 0.05))
    np.testing.assert_allclose(float(res.U_peak[tip_x]),
                               abs(gp) * Sa * 1e3 / omega**2, rtol=1e-6)
    assert abs(gp) == pytest.approx(1.0, rel=0.05)
    np.testing.assert_allclose(float(res.base_shear_kN[0]),
                               float(torch.sum(res.participation[0] ** 2))
                               * Sa, rtol=1e-6)

    small = _cantilever(pt.build_model, n_el=4, device="cpu")
    full = pt.response_spectrum(small, 0.2, n_modes=24,
                                directions=((1, 0, 0), (0, 0, 1)))
    _, M, free, _ = _build_km(small, 210000.0, 0.3, 0.0)
    M, free = M.numpy(), free.numpy()
    for d, vec in enumerate([(1, 0, 0), (0, 0, 1)]):
        r = np.zeros(small.n_dof)
        for c in range(3):
            r[c::6] = vec[c]
        b = (M @ r)[free]
        np.testing.assert_allclose(float(torch.sum(full.effective_mass_t[d])),
                                   b @ np.linalg.solve(M[np.ix_(free, free)],
                                                       b), rtol=1e-8)
    with pytest.raises(ValueError):
        pt.response_spectrum(small, 0.2, combination="abs")
    with pytest.raises(ValueError):
        pt.response_spectrum(small, 0.2, dir_rule="cqc")


# per-support springs of three stiffnesses split the bending pairs (equal
# springs keep them degenerate to ~1e-7, and inside such a pair the
# eigenbasis is the solver's choice while the 1/omega^2 and table Sa
# weights differ across it at that level)
SITE = dict(KW, spectrum=([0.1, 0.5, 1.0, 3.0], [2.0, 5.0, 4.0, 1.0]),
            support_stiffness=np.outer([1.0, 2.0, 0.5],
                                       [1e6] * 3 + [1e12] * 3),
            added_mass_Ca=1.0)


@pytest.mark.parametrize("site", [False, True])
def test_dense_cqc_pipeline_matches_jax(jacket, site):
    """The dense jacket (1,100 t topside, EC8 ground C, three directions,
    the vertical one on the vertical spectrum; then a site table spectrum
    on per-support springs with added mass): periods, spectral
    accelerations, effective masses, total mass and every CQC demand
    against JAX (1e-10)."""
    jm, _, tm, _ = jacket
    kw = SITE if site else KW
    ref = jax.jit(lambda: jsm.response_spectrum(jm, **kw))()
    out = pt.response_spectrum(tm, **kw)
    for f in ("periods_s", "frequencies_hz", "Sa_ms2", "effective_mass_t",
              "total_mass_t") + DEMANDS:
        assert rel_err(getattr(out, f), getattr(ref, f)) < TOL, f
    assert np.array_equal(out.directions, ref.directions)


@pytest.mark.parametrize("combination,dir_rule", [
    ("srss", "srss"), ("cqc", "100-40-40"), ("srss", "100-40-40")])
def test_srss_and_100_40_40_on_jax_shapes(jacket, combination, dir_rule):
    """SRSS over modes and the 100/40/40 direction rule: the port's
    ``_spectrum_core`` on JAX's frequencies, shapes and participation
    against JAX's result (1e-10)."""
    jm, _, tm, _ = jacket
    kw = dict(KW, combination=combination, dir_rule=dir_rule)
    ref = jax.jit(lambda: jsm.response_spectrum(jm, **kw))()
    _, _, _, (K_local, T, _) = _build_km(tm, 210000.0, 0.3, 1100.0)
    out = tsm._spectrum_core(
        tm.conn, tm.sections, tm.sect_id,
        torch.tensor(np.asarray(ref.frequencies_hz)) * 2.0 * np.pi,
        torch.tensor(np.asarray(ref.mode_shapes)),
        torch.tensor(np.asarray(ref.participation)), K_local, T, 0.2, "C",
        0.05, ref.directions, None, True, combination, dir_rule, 355.0,
        torch.float64)
    for f in DEMANDS + ("Sa_ms2",):
        assert rel_err(getattr(out, f), getattr(ref, f)) < TOL, f


def test_condensed_matches_jax_and_dense(jacket):
    """``response_spectrum_condensed`` (n_seg 2, 6 chain modes) against
    JAX's (CQC, 1e-10), and against the dense analysis of the same
    refined mesh (2e-3 on the first six periods: the chain-mode cut)."""
    jm, jr, tm, tr = jacket
    kw = dict(KW, n_chain_modes=6)
    ref = jax.jit(lambda: jsm.response_spectrum_condensed(jm, jr, N_SEG,
                                                          **kw))()
    out = pt.response_spectrum_condensed(tm, tr, N_SEG, **kw)
    for f in ("periods_s", "Sa_ms2", "effective_mass_t",
              "total_mass_t") + DEMANDS:
        assert rel_err(getattr(out, f), getattr(ref, f)) < TOL, f
    dense = pt.response_spectrum(tr, **KW)
    assert rel_err(out.periods_s[:6], dense.periods_s[:6]) < 2e-3
