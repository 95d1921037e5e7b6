"""3D structure and results visualization (headless matplotlib; PyTorch
counterpart of ``small_fem_solver_tpu/utils/plotting.py``).

The reference's plots rendered to files: the geometry preview with water
plane and compass arrows, the utilization-colored results plot with
wave/current direction arrows (green -> yellow for utilization < 0.5,
yellow -> red above), the phase scan, mode shapes, the pushover curve and
stress transfer functions.  Tensors on any device are read back to the
host.  matplotlib is imported here only, never by the package's
``__init__``: a host without it runs everything else.
"""
from __future__ import annotations

import os
import sys

import numpy as np

import matplotlib

# Headless default only: don't clobber a backend the GUI already selected
# (TkAgg) or an interactive session with a display.
if "matplotlib.pyplot" not in sys.modules and not os.environ.get("DISPLAY"):
    matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from ..models.model import JacketModel  # noqa: E402
from .io import _np  # noqa: E402


def _util_color(util: float):
    """Green (low) -> yellow -> red (high), `JacketAnalysisGUI_v2.py:2129-2132`."""
    u = float(np.clip(util, 0.0, 1.0))
    if u < 0.5:
        return (2 * u, 1.0, 0.0)
    return (1.0, 2 * (1 - u), 0.0)


def _draw_structure(ax, model: JacketModel, member_colors=None, lw_leg=5.0,
                    lw_brace=2.5):
    coords = _np(model.coords)
    conn = _np(model.conn)
    for e in range(model.n_members):
        c1, c2 = coords[conn[e, 0]], coords[conn[e, 1]]
        color = member_colors[e] if member_colors is not None else "steelblue"
        lw = lw_leg if model.member_types[e] == "leg" else lw_brace
        ax.plot([c1[0], c2[0]], [c1[1], c2[1]], [c1[2], c2[2]],
                color=color, linewidth=lw, alpha=0.8)
    if model.n_appurtenances:
        app = _np(model.app_conn)
        for a in range(app.shape[0]):
            c1, c2 = coords[app[a, 0]], coords[app[a, 1]]
            ax.plot([c1[0], c2[0]], [c1[1], c2[1]], [c1[2], c2[2]],
                    color="darkorange", linewidth=1.5, linestyle="--",
                    alpha=0.9)
    fixed = _np(model.fixed_mask)
    top = _np(model.top_mask)
    for i in range(model.n_nodes):
        if fixed[i]:
            c, m, s = "red", "^", 90
        elif top[i]:
            c, m, s = "blue", "s", 70
        else:
            c, m, s = "gray", "o", 25
        ax.scatter(*coords[i], c=c, marker=m, s=s, edgecolors="black",
                   linewidths=0.8)
    # water plane at z=0 (`:2149-2154`)
    x0, x1 = coords[:, 0].min() - 5, coords[:, 0].max() + 5
    y0, y1 = coords[:, 1].min() - 5, coords[:, 1].max() + 5
    X, Y = np.meshgrid(np.linspace(x0, x1, 10), np.linspace(y0, y1, 10))
    ax.plot_surface(X, Y, np.zeros_like(X), alpha=0.2, color="cyan")
    # north arrow (`:2159-2176`)
    ax.quiver(x0, y0, coords[:, 2].max() + 5, 0, 8, 0, color="darkgreen",
              arrow_length_ratio=0.15, linewidth=3)
    ax.text(x0, y0 + 9, coords[:, 2].max() + 5, "N\n(+Y)", fontsize=11,
            fontweight="bold", color="darkgreen", ha="center")
    ax.set_xlabel("X [m] -> EAST", fontweight="bold")
    ax.set_ylabel("Y [m] -> NORTH", fontweight="bold")
    ax.set_zlabel("Z [m] -> UP", fontweight="bold")


def plot_structure(model: JacketModel, path: str, title: str | None = None):
    """Geometry preview (`JacketAnalysisGUI_v2.py:1038-1135`)."""
    fig = plt.figure(figsize=(10, 9))
    ax = fig.add_subplot(111, projection="3d")
    _draw_structure(ax, model)
    ax.set_title(title or f"Jacket structure: {model.n_nodes} nodes / "
                 f"{model.n_members} members")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_utilization(model: JacketModel, results, path: str,
                     wave_dir: float | None = None,
                     current_dir: float | None = None):
    """Results plot colored by member utilization (`JacketAnalysisGUI_v2.py:2099-2230`)."""
    util = _np(results.utilization)
    colors = [_util_color(u) for u in util]
    fig = plt.figure(figsize=(11, 10))
    ax = fig.add_subplot(111, projection="3d")
    _draw_structure(ax, model, member_colors=colors)
    coords = _np(model.coords)
    cx, cy = coords[:, 0].mean(), coords[:, 1].mean()
    for dir_deg, color, label, zoff in [(wave_dir, "blue", "Wave", 3),
                                        (current_dir, "cyan", "Current", -2)]:
        if dir_deg is None:
            continue
        th = np.deg2rad(90.0 - dir_deg)
        ax.quiver(cx, cy, zoff, 12 * np.cos(th), 12 * np.sin(th), 0,
                  color=color, arrow_length_ratio=0.12, linewidth=3, alpha=0.8)
        ax.text(cx + 13 * np.cos(th), cy + 13 * np.sin(th), zoff + 1,
                f"{label}\n{dir_deg:.0f} deg", fontsize=9, color=color,
                ha="center")
    ax.set_title(f"Max utilization: {util.max():.1%} | "
                 f"green (low) -> yellow -> red (high)")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_phase_scan(scan, path: str):
    """Total/drag/inertia force magnitude over one wave period."""
    t = _np(scan.t)
    fig, ax = plt.subplots(figsize=(9, 5))
    ax.plot(t, _np(scan.total_kN), label="total", lw=2)
    ax.plot(t, _np(scan.drag_kN), label="drag", ls="--")
    ax.plot(t, _np(scan.inertia_kN), label="inertia", ls=":")
    ci = int(scan.critical_index)
    ax.axvline(t[ci], color="red", alpha=0.5,
               label=f"critical t={t[ci]:.2f}s")
    ax.set_xlabel("t [s]")
    ax.set_ylabel("|F| [kN]")
    ax.set_title("Morison force over one wave period")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_mode(model: JacketModel, shape, path: str, scale: float = 5.0,
              title: str | None = None):
    """Deformed-shape overlay for a modal / buckling mode vector.

    ``shape``: [n_dof] mode vector (mm / rad; e.g.
    ``modal_analysis(...).mode_shapes[i]`` or a buckling mode).  The
    translations are normalized to ``scale`` metres at the largest node
    and drawn over the undeformed geometry.
    """
    coords = _np(model.coords)
    conn = _np(model.conn)
    u = _np(shape).reshape(-1, 6)[:, :3]
    umax = np.abs(u).max()
    disp = coords + (u / umax * scale if umax > 0 else 0.0)
    fig = plt.figure(figsize=(10, 9))
    ax = fig.add_subplot(111, projection="3d")
    _draw_structure(ax, model)
    for e in range(model.n_members):
        c1, c2 = disp[conn[e, 0]], disp[conn[e, 1]]
        ax.plot([c1[0], c2[0]], [c1[1], c2[1]], [c1[2], c2[2]],
                color="crimson", linewidth=1.8, alpha=0.9)
    ax.set_title(title or f"Mode shape (x{scale:g} m normalized)")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_pushover(result, path: str, title: str | None = None):
    """Pushover curve: lambda vs max displacement, with first yield and
    the RSR marked (``result``: ops.pushover.PushoverResults)."""
    lam = _np(result.lambdas)
    disp = _np(result.max_displacement_mm)
    conv = _np(result.converged)
    ny = _np(result.n_yielded)
    fig, ax = plt.subplots(figsize=(8, 5.5))
    ax.plot(disp[conv], lam[conv], "-o", color="steelblue", ms=4,
            label="converged states")
    if (~conv).any():
        ax.plot(disp[~conv], lam[~conv], "x", color="red",
                label="not converged")
    fy = float(result.first_yield_lambda)
    if np.isfinite(fy):
        ax.axhline(fy, color="orange", ls="--", alpha=0.7,
                   label=f"first yield  $\\lambda$={fy:.2f}")
    ax.axhline(float(result.rsr), color="crimson", ls="-", alpha=0.7,
               label=f"RSR = {float(result.rsr):.2f}")
    for i in range(0, len(lam), max(len(lam) // 8, 1)):
        if conv[i] and ny[i]:
            ax.annotate(f"{int(ny[i])}", (disp[i], lam[i]), fontsize=8,
                        textcoords="offset points", xytext=(6, -2))
    ax.set_xlabel("max nodal displacement [mm]")
    ax.set_ylabel("environmental load factor $\\lambda$")
    ax.set_title(title or "Pushover curve (yielded-member counts annotated)")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_transfer(tr, sea, path: str, member_names=None, top: int = 5,
                  title: str | None = None):
    """Stress transfer functions + response spectra from FD transfer rows.

    Left panel: |H_sigma(omega)| per unit amplitude for the ``top``
    largest-variance members (amplitude of the stress response to a unit-
    amplitude component at each frequency, at the governing of the 8
    circumferential points).  Right panel: the wave spectrum S_eta and
    the resulting stress response spectra
    S_sigma = |H|^2 S_eta on a twin axis.

    ``tr``: a :class:`..api.FreqTransfer` (quasi-static or dynamic);
    ``sea``: the :class:`..ops.spectrum.SpectralSea` it was built from.
    """
    om = _np(tr.omega)
    a = _np(sea.a)
    # per-mode stress amplitude at the governing point per member
    amp2 = 0.5 * (_np(tr.stress_cos) ** 2
                  + _np(tr.stress_sin) ** 2)      # [N, M, 8]
    m0 = amp2.sum(axis=0)                                # [M, 8]
    pt = np.argmax(m0, axis=-1)                          # governing point
    Mn = amp2.shape[1]
    amp = np.sqrt(_np(tr.stress_cos) ** 2
                  + _np(tr.stress_sin) ** 2)[
        :, np.arange(Mn), pt]                            # [N, M]
    H = amp / np.maximum(a[:, None], 1e-30)              # per unit amplitude
    sig2 = m0[np.arange(Mn), pt]
    order = np.argsort(sig2)[::-1][:top]

    # spectra on the component grid: S dw = a^2/2 -> S = a^2/(2 dw)
    dw = np.gradient(om)
    S_eta = a**2 / (2.0 * np.maximum(dw, 1e-30))

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
    for e in order:
        name = member_names[e] if member_names is not None else f"m{e}"
        ax1.plot(om, H[:, e], marker="o", ms=3, label=name)
        ax2.plot(om, H[:, e] ** 2 * S_eta, marker="o", ms=3, label=name)
    ax1.set_xlabel("omega [rad/s]")
    ax1.set_ylabel("|H_sigma| [MPa per m amplitude]")
    ax1.set_title(title or "stress transfer functions")
    ax1.grid(alpha=0.3)
    ax1.legend(fontsize=8)
    axw = ax2.twinx()
    axw.fill_between(om, np.zeros_like(S_eta), S_eta, alpha=0.15,
                     color="gray")
    axw.set_ylabel("S_eta [m^2 s/rad]", color="gray")
    ax2.set_xlabel("omega [rad/s]")
    ax2.set_ylabel("S_sigma [MPa^2 s/rad]")
    ax2.set_title("stress response spectra (wave spectrum shaded)")
    ax2.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
