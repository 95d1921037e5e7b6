"""PyTorch port vs the JAX package: phase-batch Morison loads.

- the plain port (``ops/morison.py::morison_phase_batch``) against JAX's
  ``morison_phase_batch`` in f64, 1e-10 relative;
- the plain port in f32 against JAX's Pallas kernel in interpret mode,
  2e-6 x max (the tolerance of tests/test_pallas.py);
- the CUDA kernel's operand packing (``kernel_inputs``) through a PyTorch
  emulation of the kernel's arithmetic against the plain port;
- the CUDA wrapper's guards (the kernel itself: tests/test_torch_cuda.py).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.ops.morison import morison_phase_batch as jax_mpb
from small_fem_solver_tpu.ops.pallas_kernels import morison_phase_batch_pallas
from small_fem_solver_tpu_torch.ops import hopper_kernels as hk
from small_fem_solver_tpu_torch.ops.morison import morison_phase_batch
from test_torch_convert import port_model, port_wave, rel_err

FIELDS = ("nodal_forces", "total_drag", "total_inertia", "total_morison",
          "F1", "F2")


def _inputs(jdt, tdt, model_name, N, n_members=None, refine=1):
    model = sf.refine_model(sf.default_3leg_jacket(dtype=jdt), refine)
    if n_members is not None:
        model = dataclasses.replace(
            model, conn=model.conn[:n_members],
            sect_id=model.sect_id[:n_members],
            member_names=model.member_names[:n_members],
            member_types=model.member_types[:n_members])
    H = 8.0 if model_name == "airy" else 12.0
    wave = sf.make_wave(H, 9.4, 50.0, U_c=1.2, model=model_name, N=N,
                        dtype=jdt)
    D = np.asarray(model.sections.D_outer[model.sect_id]) / 1000.0
    ts = np.arange(12) * 9.4 / 12
    return (model, wave, D, ts, port_model(model, tdt), port_wave(wave, tdt))


@pytest.mark.parametrize("model_name,N,stretching,alpha,per_member_cd", [
    ("airy", 1, "none", None, False),
    ("fenton", 12, "none", None, False),
    ("fenton", 12, "wheeler", None, False),
    ("airy", 1, "wheeler", 1.0 / 7.0, True),
    ("fenton", 12, "none", 1.0 / 7.0, True),
])
def test_plain_morison_matches_jax_f64(model_name, N, stretching, alpha,
                                       per_member_cd):
    model, wave, D, ts, tm, tw = _inputs(jnp.float64, torch.float64,
                                         model_name, N, refine=2)
    Cd = 0.7
    if per_member_cd:
        Cd = np.random.default_rng(1).uniform(0.6, 1.1, model.n_members)
    ref = jax_mpb(wave, model.coords, model.conn, D, 38.0, 120.0, Cd, 2.0,
                  1025.0, ts, current_alpha=alpha, stretching=stretching)
    out = morison_phase_batch(tw, tm.coords, tm.conn, torch.tensor(D), 38.0,
                              120.0, Cd, 2.0, 1025.0, torch.tensor(ts),
                              current_alpha=alpha, stretching=stretching)
    for name in FIELDS:
        assert rel_err(getattr(out, name), getattr(ref, name)) < 1e-10, name


@pytest.mark.parametrize("model_name,N,n_members,stretching", [
    ("airy", 1, None, "none"),
    ("fenton", 12, None, "none"),
    ("fenton", 12, None, "wheeler"),
    ("airy", 1, 13, "none"),        # member count not a multiple of 8
])
def test_plain_f32_matches_pallas_kernel(model_name, N, n_members,
                                         stretching):
    model, wave, D, ts, tm, tw = _inputs(jnp.float32, torch.float32,
                                         model_name, N, n_members)
    ts32 = ts.astype(np.float32)
    ref = morison_phase_batch_pallas(
        wave, model.coords, model.conn, jnp.asarray(D, jnp.float32), 38.0,
        120.0, 0.7, 2.0, 1025.0, jnp.asarray(ts32), interpret=True,
        stretching=stretching)
    out = morison_phase_batch(tw, tm.coords, tm.conn,
                              torch.tensor(D, dtype=torch.float32), 38.0,
                              120.0, 0.7, 2.0, 1025.0, torch.tensor(ts32),
                              stretching=stretching)
    for name in FIELDS:
        a, b = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=2e-6 * max(np.abs(b).max(), 1e-9),
                                   err_msg=name)


def _emulate_kernel(k, M, n_gauss, wheeler):
    """The arithmetic of csrc/morison_phase_batch.cu on the packed operands
    (same formulas, same order of the per-mode terms), in PyTorch f32."""
    z, ex, ey, ez, cd, ci, ucx, ucy, xw = k["rows"]
    cosw, sinw, d = k["scal"]
    E, U, jw, jk = k["modes"].T
    N = E.shape[0]
    ct, st = k["ctst"][:, None, :N], k["ctst"][:, None, N:]   # [S, 1, N]
    sjx, cjx = torch.sin(jk * xw[:, None]), torch.cos(jk * xw[:, None])
    A = jk * (z[:, None] + d)
    B = jk * d
    Aa = torch.abs(A)
    scale = torch.exp(Aa - B) / (1.0 + torch.exp(-2.0 * B))
    e2 = torch.exp(-2.0 * Aa)
    uc = U * scale * (1.0 + e2)
    us = U * torch.sign(A) * scale * (1.0 - e2)
    cp = cjx * ct + sjx * st                                   # [S, P, N]
    sp = sjx * ct - cjx * st
    eta = (E * cp).sum(-1)
    u, w = (uc * cp).sum(-1), (us * sp).sum(-1)
    du, dw = (uc * jw * sp).sum(-1), (-us * jw * cp).sum(-1)
    if wheeler:
        uz, wz = jk * us, jk * uc
        uzz, wzz = jk * wz, jk * uz
        dz = torch.clip(-(z + d) * eta / (d + eta), -d, d)
        h2 = 0.5 * dz * dz
        u = u + dz * (uz * cp).sum(-1) + h2 * (uzz * cp).sum(-1)
        w = w + dz * (wz * sp).sum(-1) + h2 * (wzz * sp).sum(-1)
        du = du + dz * (uz * jw * sp).sum(-1) + h2 * (uzz * jw * sp).sum(-1)
        dw = dw - dz * (wz * jw * cp).sum(-1) - h2 * (wzz * jw * cp).sum(-1)
    live = z <= eta
    zero = torch.zeros_like(eta)
    Ux = torch.where(live, u * cosw + ucx, zero)
    Uy = torch.where(live, u * sinw + ucy, zero)
    Uz = torch.where(live, w, zero)
    Ax = torch.where(live, du * cosw, zero)
    Ay = torch.where(live, du * sinw, zero)
    Az = torch.where(live, dw, zero)
    Ue = Ux * ex + Uy * ey + Uz * ez
    Ae = Ax * ex + Ay * ey + Az * ez
    Up = torch.stack([Ux - Ue * ex, Uy - Ue * ey, Uz - Ue * ez], -1)
    Umag = torch.sqrt((Up * Up).sum(-1))
    cdf = torch.where(Umag > 1e-10, cd * Umag, zero)
    fd = cdf[..., None] * Up
    fi = ci[:, None] * torch.stack([Ax - Ae * ex, Ay - Ae * ey,
                                    Az - Ae * ez], -1)
    S = eta.shape[0]
    f = (fd + fi).reshape(S, M, n_gauss, 3)
    s = k["sq"][None, None, :, None]
    return (((1.0 - s) * f).sum(2), (s * f).sum(2), fd.sum(1), fi.sum(1))


@pytest.mark.parametrize("stretching,alpha,n_members", [
    ("none", None, None), ("wheeler", 1.0 / 7.0, 13)])
def test_kernel_operand_packing(stretching, alpha, n_members):
    """kernel_inputs feeds the kernel's formulas the right per-point rows,
    mode table and phase table: the emulated kernel equals the plain port."""
    model, wave, D, ts, tm, tw = _inputs(jnp.float64, torch.float32,
                                         "fenton", 12, n_members)
    Cd = np.random.default_rng(2).uniform(0.6, 1.1, tm.n_members)
    args = (tw, tm.coords, tm.conn, torch.tensor(D, dtype=torch.float32),
            38.0, 120.0, Cd, 2.0, 1025.0,
            torch.tensor(ts, dtype=torch.float32))
    k = hk.kernel_inputs(*args, n_gauss=15, current_alpha=alpha)
    assert k["rows"].shape == (9, tm.n_members * 15)
    assert all(v.dtype == torch.float32 for v in k.values())
    F1, F2, drag, inertia = _emulate_kernel(k, tm.n_members, 15,
                                            stretching == "wheeler")
    ref = morison_phase_batch(*args, current_alpha=alpha,
                              stretching=stretching)
    for a, b in ((F1, ref.F1), (F2, ref.F2), (drag, ref.total_drag),
                 (inertia, ref.total_inertia)):
        assert rel_err(a, b) < 2e-5


def test_cuda_wrapper_refuses_cpu_tensors_and_bad_sizes():
    model, wave, D, ts, tm, tw = _inputs(jnp.float64, torch.float32,
                                         "airy", 1)
    args = (tw, tm.coords, tm.conn, torch.tensor(D, dtype=torch.float32),
            38.0, 120.0, 0.7, 2.0, 1025.0,
            torch.tensor(ts, dtype=torch.float32))
    before = hk.morison_phase_batch_cuda.launches
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        hk.morison_phase_batch_cuda(*args)
    assert hk.morison_phase_batch_cuda.launches == before
    # the TPU kernel's limits: n_gauss <= 16 and n_modes <= 32
    with pytest.raises(ValueError, match="n_gauss"):
        hk.morison_phase_batch_cuda(*args, n_gauss=17)
    with pytest.raises(ValueError, match="n_modes"):
        hk.morison_phase_batch_cuda(
            dataclasses.replace(tw, E=torch.zeros(33), U=torch.zeros(33)),
            *args[1:])
    with pytest.raises(ValueError, match="stretching"):
        hk.morison_phase_batch_cuda(*args, stretching="linear")
