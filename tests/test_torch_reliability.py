"""PyTorch port vs the JAX package: long-term metocean statistics and
reliability — the joint (Hs, Tp) model and IFORM contours, the numpy FORM,
SORM, importance sampling and system bounds (bit-equal or 1e-12), the
response closures on the default jacket (1e-10), and member and
environmental reliability end to end (same flags and counts, beta and
design storms 1e-8).  f64 on the CPU; the response closures' envelopes run
the Morison kernel's plain version there (no launch)."""
import numpy as np
import pytest

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.ops import metocean as jmet
from small_fem_solver_tpu.ops import reliability as jrel
import small_fem_solver_tpu_torch as pt
from small_fem_solver_tpu_torch import convert
from small_fem_solver_tpu_torch.ops import hopper_kernels as hk
from small_fem_solver_tpu_torch.ops import metocean as tmet
from small_fem_solver_tpu_torch.ops import reliability as trel
from test_torch_convert import port_case, port_model

NUMPY_TOL = 1e-12     # the host numpy functions (the same code in both)
RESPONSE_TOL = 1e-10  # the response closures
FORM_TOL = 1e-8       # reliability indices and design storms end to end
STORM = dict(wave_dir_deg=38.0, current_dir_deg=38.0, F_axial_kN=25100.0,
             F_shear_kN=2900.0, custom_sw_tonnes=1100.0, sw_mode="custom")
RESPONSE = dict(d=50.0, U_c=1.7, wave_model="airy", n_steps=8)
THRESHOLD = 0.5       # member reliability: 6 of 51 members reachable


def _samples(seed=3, n=30_000, scale=2.0):
    """The JAX package's synthetic climate (tests/test_reliability.py):
    Hs ~ Weibull(1.5, 2.5), ln Tp | Hs ~ N(ln(5.5 + 1.4 sqrt Hs), 0.12),
    scaled up to storm waves."""
    rng = np.random.default_rng(seed)
    hs = 2.5 * rng.weibull(1.5, size=n)
    tp = np.exp(np.log(5.5 + 1.4 * np.sqrt(hs))
                + 0.12 * rng.standard_normal(hs.size))
    return scale * hs, tp + scale


@pytest.fixture(scope="module")
def climate():
    """(JAX joint model, the port's fit of the same samples)."""
    hs, tp = _samples()
    return (jmet.fit_joint_hs_tp(hs, tp, n_bins=8, state_hours=3.0),
            tmet.fit_joint_hs_tp(hs, tp, n_bins=8, state_hours=3.0))


@pytest.fixture(scope="module")
def jacket():
    """The default jacket and the storm case in both packages."""
    jm, jc = sf.default_3leg_jacket(), sf.LoadCase(**STORM)
    return jm, jc, port_model(jm), port_case(jc)


def _same(a, b, tol=NUMPY_TOL):
    """Two results (numbers, arrays, NamedTuples) equal to ``tol``
    relative, booleans and integers exactly."""
    if hasattr(a, "_fields"):
        assert type(a).__name__ == type(b).__name__
        for f in a._fields:
            _same(getattr(a, f), getattr(b, f), tol)
        return
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y, tol)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=tol, atol=0.0)


def test_joint_model_matches_jax(climate):
    """The fit bit for bit, and the carry-over of a JAX joint model."""
    jj, tj = climate
    for f in jj._fields:
        np.testing.assert_array_equal(getattr(tj, f), getattr(jj, f))
    cj = convert.joint_from_fields(**jj._asdict())
    assert isinstance(cj, pt.JointHsTp)
    for f in jj._fields:
        np.testing.assert_array_equal(getattr(cj, f), getattr(jj, f))


@pytest.mark.parametrize("fn", ["phi", "weibull", "rosenblatt", "beta",
                                "contour", "n_year", "breaking_clip"])
def test_metocean_functions_match_jax(climate, fn):
    jj, tj = climate
    u = np.linspace(-9.0, 9.0, 37)
    calls = {
        "phi": lambda m: (m._phi(u), m._phi_inv(np.array(
            [1e-300, 1e-12, 0.01, 0.5, 0.97, 1 - 1e-16]))),
        "weibull": lambda m: m.fit_weibull(_samples(n=2_000)[0]),
        "rosenblatt": lambda m: m.rosenblatt_hs_tp(
            jj if m is jmet else tj, u, u[::-1]),
        "beta": lambda m: [m.return_period_beta(jj if m is jmet else tj, r)
                           for r in (1.0, 100.0, 1e4)],
        "contour": lambda m: m.iform_contour(jj if m is jmet else tj, 100.0,
                                             n_points=16),
        "n_year": lambda m: m.n_year_sea_states(jj if m is jmet else tj,
                                                50.0, n_points=12),
        "breaking_clip": lambda m: (jrel if m is jmet else trel)
        ._breaking_clip(np.linspace(0.0, 60.0, 9), np.linspace(0.5, 40.0, 9),
                        50.0, 0.05, 37.5),
    }
    _same(calls[fn](tmet), calls[fn](jmet), 0.0)


def _parabola(u):
    return 0.1 * (u[0] - u[1]) ** 2 - (u[0] + u[1]) / np.sqrt(2.0) + 2.5


def _lin(u):
    return 10.0 - np.array([3.0, 4.0]) @ u


@pytest.mark.parametrize("case", ["form_linear", "form_parabola",
                                  "form_grad", "sorm", "importance",
                                  "importance_batch", "bivariate",
                                  "ditlevsen", "limit_state"])
def test_numpy_reliability_matches_jax(climate, case):
    """The numpy FORM machinery on the same inputs: FORM on a linear, a
    curved and a 3-D limit state with a gradient closure, Breitung's SORM,
    importance sampling (scalar and batched), the bivariate normal CDF,
    Ditlevsen bounds and the (Hs, Tp) limit-state closures."""
    jj, tj = climate
    a3 = np.array([1.0, -2.0, 0.5])

    def run(m, joint):
        if case == "form_linear":
            return m.form(_lin, 2)
        if case == "form_parabola":
            return m.form(_parabola, 2, u0=np.array([1.0, 0.0]), tol=1e-8)
        if case == "form_grad":
            return m.form(lambda u: 4.0 - a3 @ u - 0.05 * float(u @ u), 3,
                          grad=lambda u: -a3 - 0.1 * u)
        res = m.form(_parabola, 2, u0=np.array([1.0, 0.0]), tol=1e-8)
        if case == "sorm":
            return m.sorm_correction(_parabola, res, fd_step=1e-3)
        if case == "importance":
            return m.importance_sample(_parabola, res, n_samples=500, seed=2)
        if case == "importance_batch":
            return m.importance_sample_batch(
                lambda U: np.array([_parabola(x) for x in U]), res,
                n_samples=64, seed=5)
        if case == "bivariate":
            return [m.bivariate_normal_cdf(a, b, r) for a, b, r in
                    ((-1.2, -0.8, 0.5), (-1.0, -2.0, 0.6), (0.5, 0.7, -1.0),
                     (-2.0, -1.5, -0.3))]
        if case == "ditlevsen":
            return m.ditlevsen_bounds([2.0, 2.5, np.inf, 3.1],
                                      [[1.0, 0.0], [0.6, 0.8], [0.0, 1.0],
                                       [0.8, -0.6]])
        g, x = m.hs_tp_limit_state(lambda hs, tp: hs * tp / 100.0, joint,
                                   1.5)
        gb = m.hs_tp_limit_state_batch(lambda hs, tp: hs * tp / 100.0,
                                       joint, 1.5)
        U = np.array([[0.0, 0.0], [2.0, -1.0], [4.5, 1.0]])
        return [g(U[1]), x(U[2]), gb(U)]
    _same(run(trel, tj), run(jrel, jj))


def test_response_closures_match_jax(jacket):
    """``utilization_response`` (``analyze_phase_batch``),
    ``utilization_response_batch`` and
    ``member_utilization_response_batch`` (one ``design_envelope`` each)
    on five sea states (the batch size of member reliability's ring
    screen, so JAX compiles its envelope once for both tests), one past
    the Miche breaking limit; on CPU tensors no kernel launches."""
    jm, jc, tm, tc = jacket
    hs = np.array([6.0, 12.0, 36.0, 3.0, 17.0])
    tp = np.array([9.0, 11.0, 6.0, 14.0, 9.4])
    before = hk.morison_phase_batch_cuda.launches
    for name in ("utilization_response_batch",
                 "member_utilization_response_batch"):
        out = getattr(pt, name)(tm, tc, **RESPONSE)(hs, tp)
        ref = getattr(sf, name)(jm, jc, **RESPONSE)(hs, tp)
        assert out.shape == np.shape(ref), name
        assert isinstance(out, np.ndarray), name
        assert rel_err_np(out, ref) < RESPONSE_TOL, name
    scalar, jscalar = (pt.utilization_response(tm, tc, **RESPONSE),
                       sf.utilization_response(jm, jc, **RESPONSE))
    for h, t in zip(hs, tp):
        out, ref = scalar(h, t), jscalar(h, t)
        assert isinstance(out, float)
        assert abs(out - ref) / ref < RESPONSE_TOL
    assert hk.morison_phase_batch_cuda.launches == before


def rel_err_np(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_member_reliability_matches_jax(climate, jacket):
    """Component FORM of every member on batched envelopes and the
    Ditlevsen bounds: reachable and converged flags and the envelope count
    equal, beta, alpha and the design storms 1e-8; then a 30-sample
    importance check of the governing member's design point through the
    system response batch (pf and cov 1e-10; 30 = the search's own batch
    of 5 x 6 reachable members, which JAX has compiled)."""
    jj, tj = climate
    jm, jc, tm, tc = jacket
    ref = sf.member_reliability(
        sf.member_utilization_response_batch(jm, jc, **RESPONSE), jj,
        THRESHOLD)
    out = pt.member_reliability(
        pt.member_utilization_response_batch(tm, tc, **RESPONSE), tj,
        THRESHOLD)
    assert out.reachable.any() and (~out.reachable).any()
    for f in ("reachable", "converged"):
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f))
    assert out.n_envelopes == ref.n_envelopes
    r = ref.reachable
    for f in ("beta", "pf", "hs_star", "tp_star"):
        np.testing.assert_allclose(getattr(out, f)[r], getattr(ref, f)[r],
                                   rtol=FORM_TOL, err_msg=f)
    np.testing.assert_allclose(out.alpha[r], ref.alpha[r], rtol=0.0,
                               atol=FORM_TOL)
    np.testing.assert_array_equal(out.system.order, ref.system.order)
    for f in ("p_lower", "p_upper"):
        assert abs(getattr(out.system, f) / getattr(ref.system, f) - 1.0) \
            < FORM_TOL, f

    # importance sampling around the governing member's design point
    i = int(np.argmin(np.where(r, ref.beta, np.inf)))
    u_star = ref.beta[i] * ref.alpha[i]
    res = trel.FormResult(beta=float(ref.beta[i]), pf=float(ref.pf[i]),
                          u_star=u_star, x_star=u_star,
                          alpha=ref.alpha[i], g_star=0.0, n_iter=0,
                          n_evals=0, converged=True)
    kw = dict(n_samples=30, seed=3)
    pf, cov = pt.importance_sample_batch(pt.hs_tp_limit_state_batch(
        pt.utilization_response_batch(tm, tc, **RESPONSE), tj, THRESHOLD),
        res, **kw)
    jpf, jcov = sf.importance_sample_batch(sf.hs_tp_limit_state_batch(
        sf.utilization_response_batch(jm, jc, **RESPONSE), jj, THRESHOLD),
        jrel.FormResult(*res), **kw)
    assert jpf > 0.0
    assert abs(pf / jpf - 1.0) < RESPONSE_TOL
    assert abs(cov / jcov - 1.0) < RESPONSE_TOL


def test_environmental_reliability_matches_jax(climate, jacket):
    """Scalar FORM through ``analyze_phase_batch`` with the threshold
    between the 1- and 100-year responses: the same convergence,
    iteration and evaluation counts; beta, pf and the design storm
    1e-8."""
    jj, tj = climate
    jm, jc, tm, tc = jacket
    jresp = sf.utilization_response(jm, jc, **RESPONSE)
    resp = pt.utilization_response(tm, tc, **RESPONSE)
    r = [jresp(*map(float, jmet.rosenblatt_hs_tp(
        jj, jmet.return_period_beta(jj, y), 0.0))) for y in (1.0, 100.0)]
    thr = 0.5 * (r[0] + r[1])
    ref = sf.environmental_reliability(jresp, jj, thr, max_iter=25)
    out = pt.environmental_reliability(resp, tj, thr, max_iter=25)
    assert ref.form.converged and out.form.converged
    assert (out.form.n_iter, out.form.n_evals) == (ref.form.n_iter,
                                                   ref.form.n_evals)
    for f in ("hs_star", "tp_star", "pf_state", "pf_annual", "return_years"):
        assert abs(getattr(out, f) / getattr(ref, f) - 1.0) < FORM_TOL, f
    for f in ("beta", "pf", "g_star"):
        assert abs(getattr(out.form, f) - getattr(ref.form, f)) \
            <= FORM_TOL * max(abs(getattr(ref.form, f)), 1.0), f
    np.testing.assert_allclose(out.form.u_star, ref.form.u_star,
                               rtol=FORM_TOL)
