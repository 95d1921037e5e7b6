"""PyTorch port vs the JAX package: phase-batch Morison loads.

- the plain port (``ops/morison.py::morison_phase_batch``) against JAX's
  ``morison_phase_batch`` in f64, 1e-10 relative;
- the plain port in f32 against JAX's Pallas kernel in interpret mode,
  2e-6 x max (the tolerance of tests/test_pallas.py);
- the CUDA kernel's operands (``kernel_operands``) through a PyTorch
  emulation of the kernel's prologue and arithmetic against the plain port;
- the CUDA wrapper's CPU dispatch and guards (the kernel itself:
  tests/test_torch_cuda.py).
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


def _emulate_kernel(k, wheeler):
    """The arithmetic of csrc/morison_phase_batch.cu on its operands, in
    PyTorch in the operands' dtype (the kernel instance): the prologue's
    member -> point expansion (geometry, current, cd / ci), the spatial
    records of every (member, point, mode), the phase factors, the same
    mode-sum formulas and F1 = sum f - F2."""
    coords, conn, D = k["coords"], k["conn"], k["D"]

    def val(v):
        return (v if isinstance(v, torch.Tensor)
                else torch.tensor(v, dtype=coords.dtype))
    s, wq = torch.from_numpy(k["s"]), torch.from_numpy(k["w"])
    d, kk, omega, Uc = k["d"], k["k"], k["omega"], k["Uc"]
    th_w = torch.pi * (90.0 - val(k["wave_dir"])) / 180.0
    th_c = torch.pi * (90.0 - val(k["current_dir"])) / 180.0
    cosw, sinw, cosc, sinc = (torch.cos(th_w), torch.sin(th_w),
                              torch.cos(th_c), torch.sin(th_c))
    # prologue 1: per (member, point)
    x1 = coords[conn[:, 0]]
    dL = coords[conn[:, 1]] - x1
    L = torch.sqrt((dL * dL).sum(-1))
    pos = x1[:, None, :] + s[None, :, None] * dL[:, None, :]   # [M, Q, 3]
    z = pos[..., 2]
    xw = pos[..., 0] * cosw + pos[..., 1] * sinw
    uc_pt = Uc.expand(z.shape)
    if k["alpha"] is not None:
        uc_pt = Uc * torch.clip((z + d) / d, 0.0, 1.0) ** val(k["alpha"])
    rho = val(k["rho"])

    def per_member(v):
        v = val(v)
        return v[:, None] if v.ndim == 1 else v
    Lw = L[:, None] * wq[None, :]
    cd = 0.5 * rho * per_member(k["Cd"]) * D[:, None] * Lw
    ci = rho * per_member(k["Cm"]) * (torch.pi * D[:, None] ** 2 / 4.0) * Lw
    ex, ey, ez = ((dL[:, c] / L)[:, None] for c in range(3))
    # prologue 2: records of every (member, point, mode)
    N = k["E"].shape[0]
    j = torch.arange(1, N + 1, dtype=coords.dtype)
    jk, jw = j * kk, j * omega
    sjx, cjx = torch.sin(jk * xw[..., None]), torch.cos(jk * xw[..., None])
    A = jk * (z[..., None] + d)
    B = jk * d
    Aa = torch.abs(A)
    scale = torch.exp(Aa - B) / (1.0 + torch.exp(-2.0 * B))
    e2 = torch.exp(-2.0 * Aa)
    uc = k["U"] * scale * (1.0 + e2)
    us = k["U"] * torch.sign(A) * scale * (1.0 - e2)
    # the phase registers and the mode sums: [S, M, Q, N]
    t = k["ts"][:, None, None, None]
    ct, st = torch.cos(jw * t), torch.sin(jw * t)
    cp = cjx * ct + sjx * st
    sp = sjx * ct - cjx * st
    eta = (k["E"] * cp).sum(-1)
    u, w = (uc * cp).sum(-1), (us * sp).sum(-1)
    du, dw = (jw * uc * sp).sum(-1), (-jw * us * cp).sum(-1)
    if wheeler:
        u_z, w_z = (jk * us * cp).sum(-1), (jk * uc * sp).sum(-1)
        du_z, dw_z = ((jk * jw * us * sp).sum(-1),
                      (-jk * jw * uc * cp).sum(-1))
        u_zz, w_zz = (jk**2 * uc * cp).sum(-1), (jk**2 * us * sp).sum(-1)
        du_zz, dw_zz = ((jk**2 * jw * uc * sp).sum(-1),
                        (-jk**2 * jw * us * cp).sum(-1))
        dz = torch.clip(-(z + d) * eta / (d + eta), -d, d)
        h2 = 0.5 * dz * dz
        u = u + dz * u_z + h2 * u_zz
        w = w + dz * w_z + h2 * w_zz
        du = du + dz * du_z + h2 * du_zz
        dw = dw + dz * dw_z + h2 * dw_zz
    live = z <= eta
    zero = torch.zeros_like(eta)
    Ux = torch.where(live, u * cosw + uc_pt * cosc, zero)
    Uy = torch.where(live, u * sinw + uc_pt * sinc, zero)
    Uz = torch.where(live, w, zero)
    Ax = torch.where(live, du * cosw, zero)
    Ay = torch.where(live, du * sinw, zero)
    Az = torch.where(live, dw, zero)
    Ue = Ux * ex + Uy * ey + Uz * ez
    Ae = Ax * ex + Ay * ey + Az * ez
    Up = torch.stack([Ux - Ue * ex, Uy - Ue * ey, Uz - Ue * ez], -1)
    Umag = torch.sqrt((Up * Up).sum(-1))
    cdf = torch.where(Umag > 1e-10, cd * Umag, zero)
    fd = cdf[..., None] * Up                                  # [S, M, Q, 3]
    fi = ci[..., None] * torch.stack([Ax - Ae * ex, Ay - Ae * ey,
                                      Az - Ae * ez], -1)
    F2 = (s[:, None] * (fd + fi)).sum(2)
    F1 = fd.sum(2) + fi.sum(2) - F2
    return F1, F2, fd.sum((1, 2)), fi.sum((1, 2))


@pytest.mark.parametrize("stretching,alpha,n_members", [
    ("none", None, None), ("wheeler", 1.0 / 7.0, 13)])
def test_kernel_operand_packing(stretching, alpha, n_members):
    """kernel_operands hands the kernel the member arrays, coefficients and
    wave it reads; expanding them as the kernel's prologue does and
    running its formulas equals the plain port."""
    model, wave, D, ts, tm, tw = _inputs(jnp.float64, torch.float32,
                                         "fenton", 12, n_members)
    Cd = np.random.default_rng(2).uniform(0.6, 1.1, tm.n_members)
    args = (tw, tm.coords, tm.conn, torch.tensor(D, dtype=torch.float32),
            38.0, 120.0, Cd, 2.0, 1025.0,
            torch.tensor(ts, dtype=torch.float32))
    k = hk.kernel_operands(*args, n_gauss=15, current_alpha=alpha)
    assert k["coords"].shape == (tm.n_nodes, 3)
    assert k["conn"].dtype == torch.int64
    assert k["Cd"].shape == (tm.n_members,) and k["Cm"] == 2.0
    assert k["s"].dtype == np.float32 and k["s"].shape == (15,)
    assert all(v.dtype == torch.float32 for n, v in k.items()
               if isinstance(v, torch.Tensor) and n != "conn")
    # on tensors already of the kernel's type and device nothing is copied
    assert k["coords"].data_ptr() == tm.coords.data_ptr()
    F1, F2, drag, inertia = _emulate_kernel(k, stretching == "wheeler")
    ref = morison_phase_batch(*args, current_alpha=alpha,
                              stretching=stretching)
    for a, b in ((F1, ref.F1), (F2, ref.F2), (drag, ref.total_drag),
                 (inertia, ref.total_inertia)):
        assert rel_err(a, b) < 2e-5


def test_kernel_operand_packing_f64():
    """float64 operands stay float64 (the kernel's f64 instance): nothing
    is cast or copied, the Gauss rule is float64, and the emulated kernel
    arithmetic equals the plain port at 1e-12; mixed dtypes raise."""
    model, wave, D, ts, tm, tw = _inputs(jnp.float64, torch.float64,
                                         "fenton", 12)
    Cd = np.random.default_rng(2).uniform(0.6, 1.1, tm.n_members)
    args = (tw, tm.coords, tm.conn, torch.tensor(D), 38.0, 120.0, Cd, 2.0,
            1025.0, torch.tensor(ts))
    for stretching, alpha in (("none", None), ("wheeler", 1.0 / 7.0)):
        k = hk.kernel_operands(*args, n_gauss=15, current_alpha=alpha)
        assert k["s"].dtype == np.float64 and k["w"].dtype == np.float64
        assert k["Cd"].dtype == torch.float64
        assert all(v.dtype == torch.float64 for n, v in k.items()
                   if isinstance(v, torch.Tensor) and n != "conn")
        assert k["coords"].data_ptr() == tm.coords.data_ptr()
        assert k["E"].data_ptr() == tw.E.data_ptr()
        F1, F2, drag, inertia = _emulate_kernel(k, stretching == "wheeler")
        ref = morison_phase_batch(*args, current_alpha=alpha,
                                  stretching=stretching)
        for a, b in ((F1, ref.F1), (F2, ref.F2), (drag, ref.total_drag),
                     (inertia, ref.total_inertia)):
            assert rel_err(a, b) < 1e-12
    with pytest.raises(TypeError, match="mixed dtypes"):
        hk.kernel_operands(*args[:-1], torch.tensor(ts, dtype=torch.float32),
                           n_gauss=15, current_alpha=None)
    with pytest.raises(TypeError, match="float32 or float64"):
        hk.kernel_operands(tw.to(torch.float16, "cpu"),
                           tm.coords.to(torch.float16), *args[2:],
                           n_gauss=15, current_alpha=None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cast_operands(dtype):
    """cast_operands gives every float operand of an f64 call the kernel
    instance's dtype: waves and tensors cast, numpy arrays made tensors,
    numbers and None as they are; the result packs without a mixed-dtype
    error and, in f64, is the f64 call itself."""
    model, wave, D, ts, tm, tw = _inputs(jnp.float64, torch.float64,
                                         "fenton", 12)
    Cd = np.random.default_rng(2).uniform(0.6, 1.1, tm.n_members)
    wk, xyz, Dk, wdir, Cdk, ts_k, alpha = hk.cast_operands(
        dtype, "cpu", tw, tm.coords, torch.tensor(D), 38.0, Cd,
        torch.tensor(ts), None)
    assert wk.E.dtype == xyz.dtype == Dk.dtype == Cdk.dtype == ts_k.dtype \
        == dtype
    assert wdir == 38.0 and alpha is None
    assert torch.equal(Cdk, torch.as_tensor(Cd, dtype=dtype))
    k = hk.kernel_operands(wk, xyz, tm.conn, Dk, wdir, 120.0, Cdk, 2.0,
                           1025.0, ts_k, n_gauss=15, current_alpha=alpha)
    assert k["coords"].dtype == dtype and k["Cd"].dtype == dtype
    if dtype == torch.float64:
        assert xyz.data_ptr() == tm.coords.data_ptr()


def test_cuda_wrapper_refuses_cpu_tensors_and_bad_sizes():
    """The kernel's launcher refuses CPU tensors and counts no launch; the
    wrappers run the plain version on them; the TPU kernel's size limits
    raise."""
    model, wave, D, ts, tm, tw = _inputs(jnp.float64, torch.float32,
                                         "airy", 1)
    args = (tw, tm.coords, tm.conn, torch.tensor(D, dtype=torch.float32),
            38.0, 120.0, 0.7, 2.0, 1025.0,
            torch.tensor(ts, dtype=torch.float32))
    before = hk.morison_phase_batch_cuda.launches
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        hk.launch_morison(hk.kernel_operands(*args, n_gauss=15,
                                             current_alpha=None), False)
    out = hk.morison_phase_batch_cuda(*args)
    ref = morison_phase_batch(*args)
    for name in FIELDS:
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
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
