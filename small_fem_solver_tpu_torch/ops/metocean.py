"""Long-term metocean statistics: joint (Hs, Tp) models and IFORM
environmental contours (the port's own copy of
``small_fem_solver_tpu/ops/metocean.py``: host numpy, no tensors).

Design practice needs the N-YEAR response: sea states on the N-year
environmental contour of the joint (Hs, Tp) distribution, each run through
the response envelope.  The standard recipe (DNV-RP-C205 / NORSOK N-003
practice):

1. joint model: 2-parameter Weibull for Hs (MLE via a fixed-count Newton
   on the shape parameter) and a conditional lognormal for ln Tp | Hs
   with mean/std interpolated from per-Hs-bin fits of a scatter diagram;
2. IFORM (inverse first-order reliability method): the return period maps
   to a radius beta = Phi^-1(1 - 1/N_states) in standard-normal space
   (N_states = return_years x states/year); the contour is the circle of
   radius beta mapped back through the Rosenblatt transform
   u1 -> Hs = F_Hs^-1(Phi(u1)), u2 -> Tp = F_Tp|Hs^-1(Phi(u2));
3. feed the contour's (Hs, Tp) points to ``make_wave_batch`` +
   ``design_envelope`` for the N-year extreme response.

``_phi`` / ``_phi_inv`` are the JAX package's to the bit, so FORM
(``ops/reliability.py``) and IFORM stay consistent in both packages.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

# Phi / Phi^-1 via the complementary error function (scipy-free;
# erfc avoids the tail cancellation 1 + erf(-large) would suffer)
from math import erfc, sqrt


def _phi(x):
    return 0.5 * np.vectorize(erfc)(-np.asarray(x) / sqrt(2.0))


def _phi_inv(p):
    # Acklam/Moro-style rational approximation refined by one Halley step
    # against the exact CDF — |error| < 1e-12 over (1e-300, 1-1e-16)
    p = np.asarray(p, dtype=np.float64)
    a = [-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    x = np.empty_like(p)
    lo = p < plow
    hi = p > phigh
    mid = ~(lo | hi)
    if lo.any():
        q = np.sqrt(-2 * np.log(p[lo]))
        x[lo] = (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                 * q + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q
                                 + d[3]) * q + 1)
    if hi.any():
        q = np.sqrt(-2 * np.log(1 - p[hi]))
        x[hi] = -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                  * q + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q
                                  + d[3]) * q + 1)
    if mid.any():
        q = p[mid] - 0.5
        r = q * q
        x[mid] = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
                  * r + a[5]) * q / (((((b[0] * r + b[1]) * r + b[2]) * r
                                       + b[3]) * r + b[4]) * r + 1)
    # two Halley refinements (the far tail needs the second)
    for _ in range(2):
        e = _phi(x) - p
        u = e * np.sqrt(2 * np.pi) * np.exp(0.5 * x * x)
        x = x - u / (1.0 + 0.5 * x * u)
    return x


class JointHsTp(NamedTuple):
    """Weibull Hs + conditional lognormal Tp | Hs joint model.

    ``mu_lnTp`` / ``sigma_lnTp`` are tabulated against ``hs_grid`` and
    linearly interpolated (clamped at the ends)."""

    weibull_k: float        # Hs shape
    weibull_lam: float      # Hs scale [m]
    hs_grid: np.ndarray     # [G] bin centers [m]
    mu_lnTp: np.ndarray     # [G] mean of ln Tp per bin
    sigma_lnTp: np.ndarray  # [G] std of ln Tp per bin
    state_hours: float      # sea-state duration [h]


def fit_weibull(samples, n_iter: int = 60) -> tuple[float, float]:
    """2-parameter Weibull MLE (shape k, scale lam) by Newton on the
    profile likelihood for k (the classical one-dimensional reduction)."""
    x = np.asarray(samples, dtype=np.float64)
    if (x <= 0).any():
        raise ValueError("Weibull samples must be positive")
    lx = np.log(x)
    k = 1.0
    for _ in range(n_iter):
        xk = x**k
        A = (xk * lx).sum() / xk.sum()
        f = A - 1.0 / k - lx.mean()
        xk2 = (xk * lx * lx).sum()
        dA = xk2 / xk.sum() - A * A
        df = dA + 1.0 / k**2
        k = max(k - f / df, 1e-3)
    lam = (x**k).mean() ** (1.0 / k)
    return float(k), float(lam)


def fit_joint_hs_tp(hs, tp, occurrence=None, n_bins: int = 8,
                    state_hours: float = 3.0) -> JointHsTp:
    """Fit the joint model from scatter data (or a scatter diagram).

    ``hs``/``tp``: per-state samples (pass a scatter diagram by repeating
    or weighting rows via ``occurrence``).  Tp bins with fewer than 2
    effective states inherit their neighbor's lognormal parameters.
    """
    hs = np.asarray(hs, dtype=np.float64)
    tp = np.asarray(tp, dtype=np.float64)
    w = (np.ones_like(hs) if occurrence is None
         else np.asarray(occurrence, dtype=np.float64))
    if hs.shape != tp.shape or hs.shape != w.shape:
        raise ValueError("hs, tp and occurrence must have matching shapes")
    if (hs <= 0).any() or (tp <= 0).any() or (w < 0).any():
        raise ValueError("Hs/Tp must be positive and occurrences >= 0")
    # weighted Weibull fit via resampling-free trick: MLE equations with
    # weights reduce to the same sums
    x, lx = hs, np.log(hs)
    k = 1.0
    for _ in range(60):
        xk = w * x**k
        A = (xk * lx).sum() / xk.sum()
        f = A - 1.0 / k - (w * lx).sum() / w.sum()
        dA = (xk * lx * lx).sum() / xk.sum() - A * A
        k = max(k - f / (dA + 1.0 / k**2), 1e-3)
    lam = ((w * x**k).sum() / w.sum()) ** (1.0 / k)

    edges = np.linspace(hs.min(), hs.max() * (1 + 1e-12), n_bins + 1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    mu = np.full(n_bins, np.nan)
    sg = np.full(n_bins, np.nan)
    ln_tp = np.log(tp)
    for i in range(n_bins):
        m = (hs >= edges[i]) & (hs < edges[i + 1])
        if w[m].sum() > 1.5:
            wm = w[m] / w[m].sum()
            mu[i] = (wm * ln_tp[m]).sum()
            var = (wm * (ln_tp[m] - mu[i]) ** 2).sum()
            sg[i] = max(np.sqrt(var), 1e-3)
    # fill empty bins from the nearest fitted neighbor
    ok = np.where(np.isfinite(mu))[0]
    if ok.size == 0:
        raise ValueError("no Hs bin has enough states to fit Tp | Hs")
    for i in range(n_bins):
        if not np.isfinite(mu[i]):
            j = ok[np.argmin(np.abs(ok - i))]
            mu[i], sg[i] = mu[j], sg[j]
    return JointHsTp(float(k), float(lam), centers, mu, sg,
                     float(state_hours))


def rosenblatt_hs_tp(model: JointHsTp, u1, u2):
    """Map standard-normal (u1, u2) to physical (Hs, Tp) through the joint
    model: u1 -> Hs by the inverse Weibull CDF at Phi(u1), u2 -> Tp by the
    conditional lognormal quantile.  The single Rosenblatt transform shared
    by the IFORM contour and the FORM search (`ops/reliability.py`)."""
    u1 = np.asarray(u1, dtype=np.float64)
    u2 = np.asarray(u2, dtype=np.float64)
    # clip away from p = 1: u1 > ~8.2 saturates Phi in f64 and would map to
    # Hs = inf (FORM trial steps can probe that far out)
    p1 = np.clip(_phi(u1), 0.0, 1.0 - 1e-16)
    hs = model.weibull_lam * (-np.log1p(-p1)) ** (1.0 / model.weibull_k)
    mu = np.interp(hs, model.hs_grid, model.mu_lnTp)
    sg = np.interp(hs, model.hs_grid, model.sigma_lnTp)
    # cap the exponent: FORM trial steps can probe |u2| large enough that
    # exp overflows to inf; 1e9 s is already far beyond any physical Tp and
    # keeps downstream dispersion solves finite
    tp = np.exp(np.minimum(mu + sg * u2, np.log(1e9)))
    return hs, tp


def return_period_beta(model: JointHsTp, return_years: float) -> float:
    """Reliability index beta = Phi^-1(1 - 1/N) of an N-year return period
    (N = return_years x sea states per year)."""
    n_states = return_years * 8766.0 / model.state_hours
    if n_states <= 1:
        raise ValueError("return period shorter than one sea state")
    return float(_phi_inv(np.array(1.0 - 1.0 / n_states)))


def iform_contour(model: JointHsTp, return_years: float,
                  n_points: int = 32) -> tuple[np.ndarray, np.ndarray]:
    """(Hs, Tp) points of the IFORM environmental contour.

    beta = Phi^-1(1 - 1/N) with N = return_years * 8766 / state_hours;
    the contour is the radius-beta circle mapped through the Rosenblatt
    transform.  The theta = 0 point is the pure-Hs extreme: EXACTLY the
    inverse Weibull at the beta quantile (tested identity).
    """
    beta = return_period_beta(model, return_years)
    th = np.linspace(0.0, 2.0 * np.pi, n_points, endpoint=False)
    return rosenblatt_hs_tp(model, beta * np.cos(th), beta * np.sin(th))


def n_year_sea_states(model: JointHsTp, return_years: float,
                      n_points: int = 32):
    """Contour (Hs, Tp) pairs, de-duplicated and sorted by Hs — ready for
    ``parallel.sweep.make_wave_batch`` + ``design_envelope``."""
    hs, tp = iform_contour(model, return_years, n_points)
    order = np.argsort(hs)
    return hs[order], tp[order]
