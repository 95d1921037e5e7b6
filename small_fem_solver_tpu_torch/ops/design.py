"""Differentiable design: section sensitivities and gradient-based sizing
(PyTorch counterpart of ``small_fem_solver_tpu/ops/design.py``).

The dense pointwise analysis (wave kinematics -> Morison -> FEM -> von
Mises, ``api.analyze(solver="chol")``) is plain PyTorch, so the derivative
of any response with respect to any design parameter is one reverse pass of
autograd — through the Fourier kinematics, the quadrature, the element
stiffness, the Cholesky solve with its refinement and the stress recovery.
No kernel is on that path, so none needs a backward.

- :func:`section_sensitivities` — d(max utilization)/d(D, t) and
  d(mass)/d(D, t) for EVERY section group in one reverse pass;
- :func:`optimize_sections` — projected gradient descent sizing all wall
  thicknesses to a target utilization at minimum structural mass.

Both work for any number of section groups.  The governing-member max is
optionally smoothed with a temperature-scaled logsumexp so the optimizer
does not chatter when the critical member flips.  Results are tensors on
the model's device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .sections import tube_sections


def _mass_t(model, D, t):
    """Structural mass [t] — depends only on sections and lengths (no FEM)."""
    sections = tube_sections(D, t, model.sections.rho_steel,
                             dtype=model.dtype, device=model.device)
    L = model.member_geometry()[3]
    return torch.sum(sections.mass_per_m[model.sect_id] * L) / 1000.0


def _respond(model, wave, case, D, t, n_gauss, accel, tau):
    """(util_soft, mass_t, utilization) for per-group section tensors
    ``D``/``t`` [n_sections] (mm); differentiable in both."""
    from ..api import analyze

    sections = tube_sections(D, t, model.sections.rho_steel,
                             dtype=model.dtype, device=model.device)
    m = dataclasses.replace(model, sections=sections)
    res = analyze(m, wave, case, solver="chol", n_gauss=n_gauss, accel=accel)
    util = res.utilization
    if tau is None:
        util_max = torch.amax(util)
    else:
        util_max = tau * torch.logsumexp(util / tau, dim=0)
    mass_t = torch.sum(sections.mass_per_m[m.sect_id] * res.length_m) / 1000.0
    return util_max, mass_t, util


class SectionSensitivities(NamedTuple):
    """Gradients w.r.t. the interleaved section parameter vector
    ``(D_0, t_0, D_1, t_1, ...)`` — for the standard 2-section leg/brace
    layout that is exactly ``(D_leg, t_leg, D_brace, t_brace)`` — all in
    per-mm."""

    dutil: torch.Tensor       # [2 n_sections] d(max utilization)/d(param)
    dmass_t: torch.Tensor     # [2 n_sections] d(structural mass [t])/d(param)
    util_max: torch.Tensor
    mass_t: torch.Tensor


def section_sensitivities(model, wave, case, n_gauss: int = 15,
                          accel: str = "analytic",
                          tau: float | None = None) -> SectionSensitivities:
    """One reverse-mode pass through the full analysis, any section count.

    ``tau`` smooths the member max with a logsumexp of that temperature
    (None = hard max; its gradient is the governing member's, split evenly
    over tied members, which is the correct sensitivity almost everywhere).
    """
    from ..api import _full_f32_matmul

    # interleaved (D_i, t_i) parameter vector [2n], a leaf of its own
    params = torch.stack([model.sections.D_outer, model.sections.t],
                         dim=-1).reshape(-1).detach().requires_grad_(True)
    with torch.enable_grad(), _full_f32_matmul():
        # one differentiated FEM pass for utilization; the mass gradient
        # needs no FEM (sections x lengths only)
        u = _respond(model, wave, case, params[0::2], params[1::2],
                     n_gauss, accel, tau)[0]
        du, = torch.autograd.grad(u, params)
        mt = _mass_t(model, params[0::2], params[1::2])
        dm, = torch.autograd.grad(mt, params)
    return SectionSensitivities(dutil=du, dmass_t=dm, util_max=u.detach(),
                                mass_t=mt.detach())


class SizingResult(NamedTuple):
    t: torch.Tensor           # [n_sections] optimized wall thicknesses [mm]
    t_leg: torch.Tensor       # = t[0] (kept for the standard 2-section layout)
    t_brace: torch.Tensor     # = t[-1]
    util_max: torch.Tensor
    mass_t: torch.Tensor
    history: np.ndarray       # [n_iter, n_sections + 2] (t..., util, mass)


def optimize_sections(model, wave, case, target_util: float = 0.8,
                      n_iter: int = 60, lr: float = 2.0,
                      t_bounds=(10.0, 120.0), penalty: float = 200.0,
                      n_gauss: int = 15, accel: str = "analytic",
                      tau: float = 0.02) -> SizingResult:
    """Size ALL section-group wall thicknesses by projected gradient descent.

    Minimizes NORMALIZED structural mass (mass / starting mass) with a
    quadratic penalty on exceeding ``target_util``; thicknesses are
    projected to ``t_bounds`` and to the thin-wall validity limit D/t > 10
    after each step.  Diameters are held fixed (change the model's sections
    to size them too).  Each iteration is ONE differentiated full analysis,
    whatever the number of section groups (the gradient vector just grows).
    """
    from ..api import _full_f32_matmul

    D = model.sections.D_outer.detach()                   # [n] fixed
    n_sect = int(D.shape[0])
    m0 = float(torch.sum(model.sections.mass_per_m[model.sect_id]
                         * model.member_geometry()[3]) / 1000.0)

    def step(t, step_len):
        tt = t.detach().requires_grad_(True)
        with torch.enable_grad(), _full_f32_matmul():
            u, m, _ = _respond(model, wave, case, D, tt, n_gauss, accel, tau)
            # maximum, not clamp: a tie splits its gradient, as in JAX
            loss = (m / m0 + penalty * torch.maximum(
                u - target_util, torch.zeros_like(u)) ** 2)
            g, = torch.autograd.grad(loss, tt)
        # normalized (sign-like) step: the raw gradient scale is
        # ~1e-2 /mm, so a fixed step length in mm with decay converges
        # in tens of iterations regardless of the penalty balance
        gn = g / torch.clamp(torch.linalg.norm(g), min=1e-12)
        t = t - step_len * gn
        # projections: bounds and thin-wall validity D/t > 10
        t = torch.clamp(t, t_bounds[0], t_bounds[1])
        t = torch.minimum(t, D / 10.0 - 1e-6)
        return t, u.detach(), m.detach()

    t = model.sections.t.detach()
    hist = np.zeros((n_iter, n_sect + 2))
    for i in range(n_iter):
        step_len = lr * (1.0 - 0.9 * i / n_iter)   # decaying step [mm]
        t, u, m = step(t, torch.tensor(step_len, dtype=model.dtype,
                                       device=model.device))
        # (u, m) describe the PRE-step design; history records the pair that
        # was actually evaluated together
        hist[i] = list(t.cpu().numpy()) + [float(u), float(m)]

    # evaluate the RETURNED design (hist carries the pre-step responses, so
    # the final thicknesses would otherwise be reported with the previous
    # iterate's utilization/mass)
    with torch.no_grad():
        u_fin, m_fin, _ = _respond(model, wave, case, D, t, n_gauss, accel,
                                   None)
    return SizingResult(t=t, t_leg=t[0], t_brace=t[-1], util_max=u_fin,
                        mass_t=m_fin, history=hist)
