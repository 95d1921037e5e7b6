"""Steady waves in one canonical Fourier form (PyTorch counterpart of
``small_fem_solver_tpu/ops/waves.py``).

Every supported wave theory is lowered at construction to a
:class:`FourierWave` of fixed-size coefficient tensors (theta = k x -
omega t, z from MWL, d = depth):

    eta(x, t)  = sum_j E_j cos(j theta)
    u(x, z, t) = sum_j U_j C_j(z) cos(j theta)      (+ current U_c)
    w(x, z, t) = sum_j U_j S_j(z) sin(j theta)
    C_j = cosh(j k (z + d)) / cosh(j k d),  S_j = sinh(j k (z + d)) / cosh(j k d)

The phase-batch Morison engines (``ops/morison.py`` and its fused kernel)
consume these coefficients directly; :func:`kinematics` evaluates them
pointwise with the reference's semantics:

- dry points (z > eta) have zero kinematics;
- the evaluation-height clamp z + d in [0.01, d + eta - 0.01] applies to
  Stokes and Fenton waves (``clamp_z``), not to the closed-form Airy wave;
- acceleration defaults to the forward difference with dt = 1e-3 through
  the dry-masked velocity at both times, so the uniform current cancels;
  ``accel='analytic'`` is the exact d/dt of the series.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..device import resolve_device
from .dispersion import solve_dispersion


@dataclasses.dataclass(frozen=True)
class FourierWave:
    """Canonical steady-wave representation.  Scalars are 0-d tensors;
    ``E`` and ``U`` are ``[N]`` (N Fourier modes, zero-padded).  A batch of
    waves (:func:`stack_waves`) carries a leading case axis on every
    tensor field: scalars ``[C]``, ``E``/``U`` ``[C, N]``."""

    k: torch.Tensor       # wavenumber [1/m]
    omega: torch.Tensor   # angular frequency [rad/s]
    c: torch.Tensor       # phase speed [m/s]
    d: torch.Tensor       # water depth [m]
    U_c: torch.Tensor     # uniform current speed [m/s]
    H: torch.Tensor       # wave height [m]
    T: torch.Tensor       # period [s]
    E: torch.Tensor       # [N] surface-elevation cosine coefficients [m]
    U: torch.Tensor       # [N] velocity coefficients [m/s]
    clamp_z: bool = False
    dt_fd: float = 1e-3
    model: str = "airy"
    order: int = 1

    @property
    def n_modes(self) -> int:
        return self.E.shape[-1]

    @property
    def length(self) -> torch.Tensor:
        return 2.0 * math.pi / self.k

    @property
    def steepness(self) -> torch.Tensor:
        return self.H / self.length

    def model_info(self) -> str:
        """Human-readable summary (theory, order, steepness H/L)."""
        return (f"{self.model.capitalize()} (Order/N={self.order}), "
                f"Steepness H/L={float(self.steepness):.4f}")

    def _map(self, fn) -> "FourierWave":
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def to(self, dtype: torch.dtype, device=None) -> "FourierWave":
        """Every coefficient tensor cast to ``dtype`` (and moved)."""
        return self._map(lambda t: t.to(dtype=dtype, device=device))

    def case(self, i: int) -> "FourierWave":
        """Wave ``i`` of a batch (see :func:`stack_waves`)."""
        return self._map(lambda t: t[i])


def stack_waves(waves) -> FourierWave:
    """Stack same-shaped waves along a new leading case axis."""
    waves = list(waves)
    if len({w.n_modes for w in waves}) != 1:
        raise ValueError("pad waves to a common n_modes before stacking")
    if len({(w.clamp_z, w.dt_fd, w.model, w.order) for w in waves}) != 1:
        raise ValueError("waves of one batch share clamp_z, dt_fd, model "
                         "and order; rebuild them uniformly")
    return dataclasses.replace(waves[0], **{
        f.name: torch.stack([getattr(w, f.name) for w in waves])
        for f in dataclasses.fields(FourierWave)
        if isinstance(getattr(waves[0], f.name), torch.Tensor)})


def airy_wave(H, T, d, U_c=0.0, n_modes: int = 1,
              dtype: torch.dtype = torch.float64, device=None) -> FourierWave:
    """First-order (linear) wave: eta = (H/2) cos(theta), canonical
    U_1 = (H/2) omega / tanh(k d); ``n_modes`` zero-pads the coefficients;
    ``device=None`` is the CUDA card.  ``H``, ``T``, ``d`` and ``U_c`` may
    be arrays of one shape: a batch of waves with that leading shape, built
    elementwise."""
    device = resolve_device(device)

    def scal(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    H, T, d, U_c = scal(H), scal(T), scal(d), scal(U_c)
    omega = 2.0 * math.pi / T
    k = solve_dispersion(omega, d)
    a = H / 2.0
    pad = torch.zeros(*a.shape, n_modes - 1, dtype=dtype, device=device)
    E = torch.cat([a[..., None], pad], dim=-1)
    U = torch.cat([(a * omega / torch.tanh(k * d))[..., None], pad], dim=-1)
    return FourierWave(k=k, omega=omega, c=omega / k, d=d, U_c=U_c, H=H,
                       T=T, E=E, U=U, clamp_z=False, model="airy", order=1)


def _as_wave(v, wave: FourierWave) -> torch.Tensor:
    """``v`` (number or tensor) in the wave's dtype and on its device."""
    return torch.as_tensor(v, dtype=wave.k.dtype, device=wave.k.device)


def _mode_numbers(E: torch.Tensor) -> torch.Tensor:
    return torch.arange(1, E.shape[-1] + 1, dtype=E.dtype, device=E.device)


def _phase(wave: FourierWave, x, t) -> torch.Tensor:
    """theta = k x - omega t."""
    return wave.k * _as_wave(x, wave) - wave.omega * _as_wave(t, wave)


def surface_elevation(wave: FourierWave, x, t) -> torch.Tensor:
    """eta(x, t) relative to MWL, elementwise over x and t."""
    j = _mode_numbers(wave.E)
    return torch.sum(wave.E * torch.cos(j * _phase(wave, x, t)[..., None]),
                     dim=-1)


def surface_velocity(wave: FourierWave, x, t) -> torch.Tensor:
    """d(eta)/dt (x, t) = sum_j E_j j omega sin(j theta): the vertical rise
    velocity of the surface (the slamming term reads it)."""
    j = _mode_numbers(wave.E)
    return torch.sum(wave.E * j * wave.omega
                     * torch.sin(j * _phase(wave, x, t)[..., None]), dim=-1)


def _depth_profiles(wave: FourierWave, z):
    """Overflow-safe C_j(z), S_j(z), shaped ``z.shape + (N,)``.

    cosh(A)/cosh(B) and sinh(A)/cosh(B) with A = j k (z+d), B = j k d are
    written exp(|A|-B) (1 +/- exp(-2|A|)) / (1 + exp(-2B)), so that no
    intermediate exceeds exp(|A|-B) <= 1 for submerged points.
    """
    j = _mode_numbers(wave.E)
    A = j * wave.k * (_as_wave(z, wave)[..., None] + wave.d)
    B = j * wave.k * wave.d
    Aa = torch.abs(A)
    scale = torch.exp(Aa - B) / (1.0 + torch.exp(-2.0 * B))
    C = scale * (1.0 + torch.exp(-2.0 * Aa))
    S = torch.sign(A) * scale * (1.0 - torch.exp(-2.0 * Aa))
    return C, S


def _uw_raw(wave: FourierWave, x, z, t):
    """Wave-only (no current) u, w at the (possibly clamped) height z."""
    j = _mode_numbers(wave.E)
    C, S = _depth_profiles(wave, z)
    ph = j * _phase(wave, x, t)[..., None]
    return (torch.sum(wave.U * C * torch.cos(ph), dim=-1),
            torch.sum(wave.U * S * torch.sin(ph), dim=-1))


def _eval_height(wave: FourierWave, z, eta, stretching: str = "none"):
    """Evaluation height: optional Wheeler stretching, then (``clamp_z``)
    the reference's z-clamp z' + d in [0.01, d + eta - 0.01].

    ``stretching='wheeler'`` maps the instantaneous water column [-d, eta]
    linearly onto [-d, 0] (Wheeler 1970), so the depth profiles are never
    extrapolated above MWL.
    """
    z = _as_wave(z, wave)
    if stretching == "wheeler":
        z = (z + wave.d) * wave.d / (wave.d + eta) - wave.d
    elif stretching != "none":
        raise ValueError(f"unknown stretching mode {stretching!r}")
    if not wave.clamp_z:
        return z
    z_abs = torch.minimum(torch.clamp(z + wave.d, min=0.01),
                          wave.d + eta - 0.01)
    return z_abs - wave.d


def _velocity(wave: FourierWave, x, z, t, eta, stretching: str):
    """:func:`velocity` given the surface elevation ``eta`` at (x, t)."""
    dry = _as_wave(z, wave) > eta
    u, w = _uw_raw(wave, x, _eval_height(wave, z, eta, stretching), t)
    zero = torch.zeros_like(u)
    return torch.where(dry, zero, u + wave.U_c), torch.where(dry, zero, w)


def velocity(wave: FourierWave, x, z, t, stretching: str = "none"):
    """(u, w) including the current, zero above the instantaneous surface:
    dry check against eta(x, t), optional stretching and z-clamp, current
    added to u only where submerged."""
    return _velocity(wave, x, z, t, surface_elevation(wave, x, t),
                     stretching)


class Kinematics(NamedTuple):
    u: torch.Tensor
    w: torch.Tensor
    du_dt: torch.Tensor
    dw_dt: torch.Tensor
    submerged: torch.Tensor   # bool
    eta: torch.Tensor


def kinematics(wave: FourierWave, x, z, t, accel: str = "fd",
               stretching: str = "none") -> Kinematics:
    """Full kinematics bundle, elementwise over x, z, t of any broadcast
    shape.

    ``accel='fd'`` is the reference's forward difference
    (v(t + dt) - v(t)) / dt through the dry-masked velocity, dt =
    ``wave.dt_fd``; ``accel='analytic'`` is the exact d/dt of the series at
    the (clamped) evaluation height.  With ``stretching='wheeler'`` 'fd'
    differentiates through the moving stretch, while 'analytic' holds the
    stretch frozen.
    """
    x, z, t = torch.broadcast_tensors(*(_as_wave(v, wave) for v in (x, z, t)))
    eta = surface_elevation(wave, x, t)
    dry = z > eta
    u, w = _velocity(wave, x, z, t, eta, stretching)
    if accel == "fd":
        u1, w1 = velocity(wave, x, z, t + wave.dt_fd, stretching)
        du = (u1 - u) / wave.dt_fd
        dw = (w1 - w) / wave.dt_fd
    elif accel == "analytic":
        j = _mode_numbers(wave.E)
        C, S = _depth_profiles(wave, _eval_height(wave, z, eta, stretching))
        ph = j * _phase(wave, x, t)[..., None]
        jw = j * wave.omega
        du = torch.sum(wave.U * C * jw * torch.sin(ph), dim=-1)
        dw = -torch.sum(wave.U * S * jw * torch.cos(ph), dim=-1)
    else:
        raise ValueError(f"unknown accel mode {accel!r}")
    zero = torch.zeros_like(u)
    return Kinematics(
        u=torch.where(dry, zero, u), w=torch.where(dry, zero, w),
        du_dt=torch.where(dry, zero, du), dw_dt=torch.where(dry, zero, dw),
        submerged=torch.logical_not(dry), eta=eta)
