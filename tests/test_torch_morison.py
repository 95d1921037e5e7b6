"""PyTorch port vs the JAX package: phase-batch Morison loads.

- the plain port (``ops/morison.py::morison_phase_batch``) against JAX's
  ``morison_phase_batch`` in f64, 1e-10 relative;
- the plain port in f32 against JAX's Pallas kernel in interpret mode,
  2e-6 x max (the tolerance of tests/test_pallas.py);
- the CUDA kernel's operands (``kernel_operands``) through a PyTorch
  emulation of the kernel's prologue and arithmetic against the plain port;
- the case-batched float64 instance: its packed operands
  (``batch_kernel_operands``, case i = ``kernel_operands`` of case i)
  through an emulation of its records pass, phase table, DMMA k-steps and
  epilogue against the batched plain version
  (``ops/morison.py::morison_end_forces_batch``), which is held against
  JAX per case;
- the CUDA wrapper's CPU dispatch and guards (the kernel itself:
  tests/test_torch_cuda.py).
"""
import dataclasses
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.ops.morison import morison_phase_batch as jax_mpb
from small_fem_solver_tpu.ops.pallas_kernels import morison_phase_batch_pallas
import small_fem_solver_tpu_torch as pt
from small_fem_solver_tpu_torch.ops import hopper_kernels as hk
from small_fem_solver_tpu_torch.ops.morison import (morison_end_forces_batch,
                                                    morison_phase_batch)
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


def _emulate_kernel(k, wheeler, members=False):
    """The arithmetic of csrc/morison_phase_batch.cu on its operands, in
    PyTorch in the operands' dtype (the kernel instance): the prologue's
    member -> point expansion (geometry, current, cd / ci), the spatial
    records of every (member, point, mode), the phase factors, the same
    mode-sum formulas and F1 = sum f - F2.  Returns F1, F2 [S, M, 3] and
    the drag and inertia totals [S, 3], or with ``members`` each member's
    drag and inertia sums [S, M, 3] (what a thread adds to its totals)."""
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
    if members:
        return F1, F2, fd.sum(2), fi.sum(2)
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
    """float64 operands stay float64 and reach the kernel's f64 instance as
    a batch of one case, as ``morison_end_forces_cuda`` hands them over
    (views: nothing is cast or copied, the Gauss rule is float64); the
    emulated arithmetic of the case-batched instance equals the plain port
    at 1e-12; mixed dtypes raise."""
    model, wave, D, ts, tm, tw = _inputs(jnp.float64, torch.float64,
                                         "fenton", 12)
    Cd = np.random.default_rng(2).uniform(0.6, 1.1, tm.n_members)
    args = (tw, tm.coords, tm.conn, torch.tensor(D), 38.0, 120.0, Cd, 2.0,
            1025.0, torch.tensor(ts))
    for stretching, alpha in (("none", None), ("wheeler", 1.0 / 7.0)):
        k = hk.batch_kernel_operands(tw._map(lambda t: t[None]), *args[1:-1],
                                     args[-1][None], n_gauss=15,
                                     current_alpha=alpha)
        assert k["C"] == 1 and k["E"].shape == (1, 12)
        assert k["s"].dtype == np.float64 and k["w"].dtype == np.float64
        assert k["Cd"].dtype == torch.float64
        assert all(v.dtype == torch.float64 for n, v in k.items()
                   if isinstance(v, torch.Tensor) and n != "conn")
        assert k["coords"].data_ptr() == tm.coords.data_ptr()
        assert k["E"].data_ptr() == tw.E.data_ptr()
        F1, F2, drag, inertia = _emulate_batch64(k, stretching == "wheeler")
        ref = morison_phase_batch(*args, current_alpha=alpha,
                                  stretching=stretching)
        for a, b in ((F1[0], ref.F1), (F2[0], ref.F2),
                     (drag[0], ref.total_drag),
                     (inertia[0], ref.total_inertia)):
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
    wrappers run the plain version on them at any size (the kernel's
    limits, n_gauss <= 16 and n_modes <= 32, bind on the CUDA route only,
    where callers pick the plain version first: ``kernel_route``); an
    unknown stretching mode raises."""
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
    # past the kernel's limits the CPU route is still the plain version
    wide = dataclasses.replace(tw, E=torch.zeros(33), U=torch.zeros(33))
    for big_args, kw in (((*args,), dict(n_gauss=17)),
                         ((wide, *args[1:]), {})):
        out = hk.morison_phase_batch_cuda(*big_args, **kw)
        ref = morison_phase_batch(*big_args, **kw)
        for name in FIELDS:
            assert torch.equal(getattr(out, name), getattr(ref, name)), name
    assert hk.morison_phase_batch_cuda.launches == before
    # the limits, as callers read them before they pick a route
    assert hk.kernel_takes(16, 32) and hk.kernel_takes(16)
    assert not hk.kernel_takes(17) and not hk.kernel_takes(15, 33)
    routes = hk.morison_phase_batch_cuda.plain_routes
    assert hk.kernel_route(torch.device("cpu"), 17, 40)
    assert hk.morison_phase_batch_cuda.plain_routes == routes
    with pytest.raises(ValueError, match="n_gauss"):
        hk._check_limits(17)
    with pytest.raises(ValueError, match="n_modes"):
        hk._check_limits(15, 33)
    with pytest.raises(ValueError, match="stretching"):
        hk.morison_phase_batch_cuda(*args, stretching="linear")


# ---- the case-batched float64 instance ----

def _case_operand(v, i: int, per_member: bool = False):
    """Case ``i``'s value of a batch operand (``batch_kernel_operands``'
    shapes) as ``kernel_operands`` takes it."""
    if isinstance(v, np.ndarray):
        v = torch.as_tensor(v)
    if not isinstance(v, torch.Tensor) or v.ndim == 0:
        return v
    if per_member:
        return v if v.ndim == 1 else (v[i, 0] if v.shape[1] == 1 else v[i])
    return v[i]


def _batch_value(v, C, M, per_member):
    """A batch operand (number, 0-d, [C], [M], [C, M] or [C, 1]) as the
    kernel reads it, broadcast to [C, M] (per member) or [C]."""
    v = torch.as_tensor(v, dtype=torch.float64)
    if per_member:
        return (v if v.ndim == 2 else v.reshape(1, -1)).expand(C, M)
    return v.expand(C)


def _tiles(S, M, Q):
    """The kernel's tiling rule (csrc/morison_phase_batch.cu, HarmTiles):
    phase tiles, member tiles and grid rows from S, M and Q alone."""
    nm = -(-S // 16)
    n_pt = -(-nm // 4)
    mpt = 2 if Q <= 8 else 1
    n_tiles = -(-M // mpt)
    return n_pt, mpt, n_tiles, min(-(-n_tiles // 12), -(-264 // n_pt))


def _emulate_batch64(k, wheeler):
    """The arithmetic of the case-batched float64 instance on its packed
    operands, in PyTorch: the records pass (per (case, point, mode) records,
    slot data, the phase table by sin / cos of (j omega) t with modes padded
    to an even N2), the B tile's fold, the mode sums as DMMA k-steps of two
    modes in order, the epilogue, the lever-rule member sums in the
    kernel's order (a lane's two slots, the quad's reduce-scatter (v0 +
    v2) + (v1 + v3), then the two halves) and the totals summed by grid
    row in order."""
    C, M = k["C"], k["conn"].shape[0]
    coords, conn = k["coords"], k["conn"]
    s = torch.from_numpy(k["s"])
    wq = torch.from_numpy(k["w"])
    Q, N, S = len(s), k["E"].shape[1], k["ts"].shape[1]
    N2 = N + N % 2
    D, Cd, Cm = (_batch_value(k[n], C, M, True) for n in ("D", "Cd", "Cm"))
    wd, cdir, rho = (_batch_value(k[n], C, M, False)
                     for n in ("wave_dir", "current_dir", "rho"))
    d, kk, om = k["d"], k["k"], k["omega"]
    # records pass: per (case, point) slot data
    x1 = coords[conn[:, 0]]
    dL = coords[conn[:, 1]] - x1
    L = torch.sqrt((dL * dL).sum(-1))
    pos = (x1[:, None, :] + s[None, :, None] * dL[:, None, :]).reshape(-1, 3)
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]                 # [P]
    cw, sw = (f(torch.pi * (90.0 - wd) / 180.0)[:, None]
              for f in (torch.cos, torch.sin))                # [C, 1]
    cc, sc = (f(torch.pi * (90.0 - cdir) / 180.0)[:, None]
              for f in (torch.cos, torch.sin))
    px = x * cw + y * sw                                      # [C, P]
    uc = k["Uc"][:, None].expand(C, M * Q)
    if k["alpha"] is not None:
        alpha = _batch_value(k["alpha"], C, M, False)[:, None]
        frac = torch.clip((z + d[:, None]) / d[:, None], 0.0, 1.0)
        uc = uc * frac ** alpha
    Lw = (L[:, None] * wq[None, :]).reshape(-1)               # [P]
    Dp = D.repeat_interleave(Q, dim=1)
    cd = 0.5 * rho[:, None] * Cd.repeat_interleave(Q, dim=1) * Dp * Lw
    ci = (rho[:, None] * Cm.repeat_interleave(Q, dim=1)
          * (torch.pi * Dp * Dp / 4.0) * Lw)
    e = (dL / L[:, None]).repeat_interleave(Q, dim=0)         # [P, 3]
    sq = s.repeat(M)
    # per (case, point, mode) records
    j = torch.arange(1, N + 1, dtype=torch.float64)
    jk = j * kk[:, None]                                      # [C, N]
    ang = jk[:, None, :] * px[:, :, None]                     # [C, P, N]
    cx, sx = torch.cos(ang), torch.sin(ang)
    A_ = jk[:, None, :] * (z[None, :, None] + d[:, None, None])
    B_ = (jk * d[:, None])[:, None, :]
    Aa = A_.abs()
    scale = torch.exp(Aa - B_) / (1.0 + torch.exp(-2.0 * B_))
    e2 = torch.exp(-2.0 * Aa)
    U = k["U"][:, None, :]
    UC = U * scale * (1.0 + e2)
    US = U * torch.sign(A_) * scale * (1.0 - e2)
    # phase table [C, S, 2 N2]: cos, sin (j omega t) side by side
    arg = (j * om[:, None])[:, None, :] * k["ts"][:, :, None]
    pad = (0, N2 - N)
    tab = torch.stack([torch.nn.functional.pad(torch.cos(arg), pad),
                       torch.nn.functional.pad(torch.sin(arg), pad)],
                      -1).reshape(C, S, 2 * N2)
    # the fold (sea_fold with E_j, j omega, j k), SeaLayout's field order
    Ej, jw = k["E"][:, None, :], (j * om[:, None])[:, None, :]
    jkk = jk[:, None, :]
    cos_f = [Ej.expand_as(UC), UC, -jw * US]
    sin_f = [US, jw * UC]
    if wheeler:
        cos_f += [jkk * US, -jw * jkk * UC, jkk**2 * UC, -jw * jkk**2 * US]
        sin_f += [jkk * UC, jw * jkk * US, jkk**2 * US, jw * jkk**2 * UC]
    cf = torch.stack(cos_f + sin_f, -1)                       # [C, P, N, F]
    nc = len(cos_f)
    Bc = torch.cat([cf[..., :nc] * cx[..., None],
                    cf[..., nc:] * sx[..., None]], -1)        # cos row
    Bs = torch.cat([cf[..., :nc] * sx[..., None],
                    -(cf[..., nc:] * cx[..., None])], -1)     # sin row
    Bt = torch.stack([Bc, Bs], 3)                             # [C,P,N,2,F]
    Bt = torch.nn.functional.pad(Bt, (0, 0, 0, 0, 0, N2 - N))
    Bt = Bt.reshape(C, -1, 2 * N2, Bt.shape[-1])              # [C,P,2N2,F]
    # the sums: DMMA k-steps of 4 rows (two modes) in order
    fl = torch.zeros(C, S, Bt.shape[1], Bt.shape[-1], dtype=torch.float64)
    for ks in range(N2 // 2):
        fl = fl + torch.einsum("csk,cpkf->cspf", tab[..., 4 * ks:4 * ks + 4],
                               Bt[:, :, 4 * ks:4 * ks + 4])
    # epilogue (sea_forces)
    zz = z[None, None, :]
    eta, ux, dw = fl[..., 0], fl[..., 1], fl[..., 2]
    w_, dux = fl[..., nc], fl[..., nc + 1]
    if wheeler:
        dz = -(zz + d[:, None, None]) * eta / (d[:, None, None] + eta)
        dz = torch.minimum(torch.maximum(dz, -d[:, None, None]),
                           d[:, None, None])
        h2 = 0.5 * dz * dz
        ux = ux + dz * fl[..., 3] + h2 * fl[..., 5]
        w_ = w_ + dz * fl[..., nc + 2] + h2 * fl[..., nc + 4]
        dux = dux + dz * fl[..., nc + 3] + h2 * fl[..., nc + 5]
        dw = dw + dz * fl[..., 4] + h2 * fl[..., 6]
    live = zz <= eta
    zero = torch.zeros_like(eta)
    cwb, swb = cw[:, :, None], sw[:, :, None]
    Ux = ux * cwb + (uc * cc)[:, None, :]
    Uy = ux * swb + (uc * sc)[:, None, :]
    Ax, Ay = dux * cwb, dux * swb
    ex, ey, ez = e[:, 0], e[:, 1], e[:, 2]
    Ue = Ux * ex + Uy * ey + w_ * ez
    Ae = Ax * ex + Ay * ey + dw * ez
    Up = torch.stack([Ux - Ue * ex, Uy - Ue * ey, w_ - Ue * ez], -1)
    Umag = torch.sqrt((Up * Up).sum(-1))
    cdf = torch.where(Umag > 1e-10, cd[:, None, :] * Umag, zero)
    fd = torch.where(live[..., None], cdf[..., None] * Up, 0.0)
    fi = torch.where(live[..., None], ci[:, None, :, None] * torch.stack(
        [Ax - Ae * ex, Ay - Ae * ey, dw - Ae * ez], -1), 0.0)
    # member sums over 16 slots in the kernel's order
    n_pt, mpt, n_tiles, rows = _tiles(S, M, Q)
    Qp = 16 // mpt
    v = torch.cat([fd, fi, sq[:, None] * (fd + fi)], -1)      # [C,S,P,9]
    v = torch.nn.functional.pad(v.reshape(C, S, M, Q, 9),
                                (0, 0, 0, Qp - Q))
    if mpt == 2:   # two members a tile, one a half
        v = v.reshape(C, S, M, 1, 4, 2, 9)
    else:
        v = v.reshape(C, S, M, 2, 4, 2, 9)
    lane = v[..., 0, :] + v[..., 1, :]
    quad = (lane[..., 0, :] + lane[..., 2, :]) + (lane[..., 1, :]
                                                  + lane[..., 3, :])
    mem = quad[..., 0, :] if mpt == 2 else quad[..., 0, :] + quad[..., 1, :]
    F2 = mem[..., 6:]
    F1 = (mem[..., :3] + mem[..., 3:6]) - F2
    # totals: each grid row's members in order, then the rows in order
    part = torch.zeros(C, rows, S, 6, dtype=torch.float64)
    for t in range(n_tiles):
        for m in range(t * mpt, min(M, (t + 1) * mpt)):
            part[:, t % rows] = part[:, t % rows] + mem[:, :, m, :6]
    tot = part[:, 0]
    for g in range(1, rows):
        tot = tot + part[:, g]
    return F1, F2, tot[..., :3], tot[..., 3:]


@functools.lru_cache(maxsize=None)
def _port_waves(N):
    """Three port waves of N modes (C = 3): Stokes-5, its modes past the
    fifth given seeded amplitudes of the first mode's times 0.5 a mode
    (the kernel's arithmetic weighs at every mode, without a costly
    Fenton solve)."""
    w = pt.make_wave_batch([6.0, 10.0, 13.0], 9.4, 50.0, U_c=1.2,
                           model="stokes", N=5, n_modes=N,
                           dtype=torch.float64, device="cpu")
    if N <= 5:
        return w
    rng = np.random.default_rng(N)
    decay = torch.tensor(0.5 ** np.arange(5, N)
                         * rng.uniform(0.5, 1.5, (3, N - 5)))
    return dataclasses.replace(
        w, E=torch.cat([w.E[:, :5], w.E[:, :1] * decay], 1),
        U=torch.cat([w.U[:, :5], w.U[:, :1] * decay], 1))


def _batch_args(N, n_members=None):
    """A 3-case batch on the default jacket: per-case headings, current
    headings, rho and phase times, per-(case, member) Cd and per-case Cm."""
    m = pt.default_3leg_jacket(device="cpu")
    M = n_members or m.n_members
    waves, C, S = _port_waves(N), 3, 13
    rng = np.random.default_rng(N)
    ts = (torch.arange(S, dtype=torch.float64)[None, :] * waves.T[:, None]
          / S + torch.tensor([[0.0], [0.11], [0.37]]))
    D = (m.sections.D_outer[m.sect_id] / 1000.0)[:M]

    def f64(v):
        return torch.tensor(v, dtype=torch.float64)
    return (waves, m.coords, m.conn[:M], D, f64([0.0, 38.0, 200.0]),
            f64([10.0, 38.0, 175.0]), f64(rng.uniform(0.6, 1.1, (C, M))),
            f64(rng.uniform(1.6, 2.1, (C, 1))), f64([1025.0, 1020.0, 1030.0]),
            ts)


@pytest.mark.parametrize("N", [5, 8, 18])
@pytest.mark.parametrize("stretching", ["none", "wheeler"])
def test_batch64_kernel_emulation(N, stretching):
    """The case-batched float64 instance's arithmetic on its packed
    operands (C = 3 cases, N = 5 (odd: a padded mode), 8, 18, a power-law
    current, per-(case, member) Cd and per-case Cm) equals the batched
    plain version at 1e-12 of the largest value."""
    args = _batch_args(N)
    k = hk.batch_kernel_operands(*args, n_gauss=15, current_alpha=1.0 / 7.0)
    assert k["C"] == 3 and k["E"].shape == (3, N)
    out = _emulate_batch64(k, stretching == "wheeler")
    ref = morison_end_forces_batch(*args, current_alpha=1.0 / 7.0,
                                   stretching=stretching)
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        assert rel_err(a, b) < 1e-12


def test_batch64_emulation_two_members_a_tile():
    """n_gauss <= 8 puts two members in a tile of 16 slots (an odd member
    count leaves the last tile half empty): the emulation of that layout
    against the plain version at 1e-12."""
    args = _batch_args(8, n_members=13)
    k = hk.batch_kernel_operands(*args, n_gauss=6, current_alpha=None)
    out = _emulate_batch64(k, True)
    ref = morison_end_forces_batch(*args, n_gauss=6, stretching="wheeler")
    for a, b in zip(out, ref):
        assert rel_err(a, b) < 1e-12


def test_batch64_operand_packing():
    """Case i of the batched operands is kernel_operands of case i (the
    per-case slices of every operand, the wave's fields, the Gauss rule);
    nothing is copied; shapes the kernel does not take raise."""
    args = _batch_args(8)
    waves, coords, conn, D, wd, cdir, Cd, Cm, rho, ts = args
    k = hk.batch_kernel_operands(*args, n_gauss=15, current_alpha=None)
    assert k["E"].data_ptr() == waves.E.data_ptr()
    assert k["coords"].data_ptr() == coords.data_ptr()
    member = ("D", "Cd", "Cm")
    for i in range(3):
        ki = hk.kernel_operands(waves.case(i), coords, conn, D, wd[i],
                                cdir[i], Cd[i], Cm[i, 0], rho[i], ts[i],
                                n_gauss=15, current_alpha=None)
        for name, v in ki.items():
            got = k[name]
            if name in ("coords", "conn", "s", "w"):
                assert np.array_equal(np.asarray(got), np.asarray(v)), name
            elif v is None:
                assert got is None, name
            else:
                case_i = _case_operand(got, i, name in member)
                assert torch.equal(torch.as_tensor(case_i),
                                   torch.as_tensor(v)), name
    bad = dict(D=D[:5], Cd=Cd[:, :5], wave_dir_deg=wd[:2])
    for name, v in bad.items():
        kw = dict(zip(("D_m", "wave_dir_deg", "current_dir_deg", "Cd", "Cm",
                       "rho_water"), args[3:9]))
        kw[name if name != "D" else "D_m"] = v
        with pytest.raises(ValueError):
            hk.batch_kernel_operands(waves, coords, conn, **kw, ts=ts,
                                     n_gauss=15, current_alpha=None)


@pytest.mark.parametrize("c0,c1", [(0, 1), (1, 3), (0, 3)])
def test_batch64_case_slice(c0, c1):
    """A chunk of the batched operands (``case_slice``, what the launcher
    hands one launch of a chunked batch) is batch_kernel_operands of that
    chunk's cases, as views of the batch's tensors."""
    args = _batch_args(8)
    waves, coords, conn, D, wd, cdir, Cd, Cm, rho, ts = args
    k = hk.batch_kernel_operands(*args, n_gauss=15, current_alpha=1.0 / 7.0)
    got = hk.case_slice(k, c0, c1)
    sub = waves._map(lambda t: t[c0:c1])
    want = hk.batch_kernel_operands(
        sub, coords, conn, D, wd[c0:c1], cdir[c0:c1], Cd[c0:c1], Cm[c0:c1],
        rho[c0:c1], ts[c0:c1], n_gauss=15, current_alpha=1.0 / 7.0)
    assert got.keys() == want.keys() and got["C"] == c1 - c0
    for name, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[name], v), name
        elif isinstance(v, np.ndarray):
            assert np.array_equal(got[name], v), name
        else:
            assert got[name] == v, name
    assert got["Cd"].data_ptr() == Cd[c0:c1].data_ptr()
    assert got["ts"].data_ptr() == ts[c0:c1].data_ptr()


@pytest.mark.parametrize("stretching", ["none", "wheeler"])
def test_batch_plain_matches_jax_per_case(stretching):
    """The batched plain version (torch.func.vmap over 3 cases with
    per-case headings, Cd and phase times) against JAX's
    morison_phase_batch of each case, f64, 1e-10 relative (the inputs of
    test_plain_morison_matches_jax_f64)."""
    model, wave, D, ts, tm, tw = _inputs(jnp.float64, torch.float64,
                                         "fenton", 12, refine=2)
    rng = np.random.default_rng(3)
    Cd = rng.uniform(0.6, 1.1, (3, model.n_members))
    dirs, cdirs = [38.0, 100.0, 250.0], [120.0, 38.0, 300.0]
    tss = np.stack([ts, ts + 0.2, ts + 0.5])
    waves = pt.stack_waves([tw] * 3)
    F1, F2, drag, inertia = morison_end_forces_batch(
        waves, tm.coords, tm.conn, torch.tensor(D), torch.tensor(dirs),
        torch.tensor(cdirs), torch.tensor(Cd), 2.0, 1025.0,
        torch.tensor(tss), current_alpha=1.0 / 7.0, stretching=stretching)
    for i in range(3):
        ref = jax_mpb(wave, model.coords, model.conn, D, dirs[i], cdirs[i],
                      Cd[i], 2.0, 1025.0, tss[i], current_alpha=1.0 / 7.0,
                      stretching=stretching)
        for a, b in ((F1[i], ref.F1), (F2[i], ref.F2),
                     (drag[i], ref.total_drag),
                     (inertia[i], ref.total_inertia)):
            assert rel_err(a, b) < 1e-10


def test_batch_wrapper_on_cpu_tensors():
    """morison_end_forces_batch_cuda on CPU tensors is the batched plain
    version (f64 and f32) and counts no launch, also past the kernel's
    size limits (they bind on the CUDA route only); the case-batched
    launcher refuses CPU tensors."""
    args = _batch_args(5)
    before = dict(hk.morison_phase_batch_cuda.instance_launches)
    for dtype in (torch.float64, torch.float32):
        cast = hk.cast_operands(dtype, "cpu", *args[:2]) + (args[2],) \
            + hk.cast_operands(dtype, "cpu", *args[3:])
        out = hk.morison_end_forces_batch_cuda(*cast)
        ref = morison_end_forces_batch(*cast)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
        assert out[0].dtype == dtype and out[0].shape == (3, 13, 51, 3)
    assert hk.morison_phase_batch_cuda.instance_launches == before
    k = hk.batch_kernel_operands(*args, n_gauss=15, current_alpha=None)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        hk.launch_morison_batch64(k, False)
    out = hk.morison_end_forces_batch_cuda(*args, n_gauss=17)
    ref = morison_end_forces_batch(*args, n_gauss=17)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert hk.morison_phase_batch_cuda.instance_launches == before


# ---- the case-batched float32 instance ----

def _batch32_args(C, S, M, N):
    """A C-case batch on the first M members of the default jacket (f64):
    Stokes-5 waves of C heights with N modes, per-case headings, current
    headings, rho and phase times, per-(case, member) Cd, per-case Cm."""
    m = pt.default_3leg_jacket(device="cpu")
    waves = pt.make_wave_batch(np.linspace(5.0, 13.0, C), 9.4, 50.0,
                               U_c=1.2, model="stokes", N=5, n_modes=N,
                               dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(C * 100 + S)
    ts = (torch.arange(S, dtype=torch.float64)[None, :] * waves.T[:, None]
          / S + torch.tensor(rng.uniform(0.0, 1.0, (C, 1))))

    def f64(v):
        return torch.tensor(v, dtype=torch.float64)
    return (waves, m.coords, m.conn[:M],
            (m.sections.D_outer[m.sect_id] / 1000.0)[:M],
            f64(rng.uniform(0.0, 360.0, C)), f64(rng.uniform(0.0, 360.0, C)),
            f64(rng.uniform(0.6, 1.1, (C, M))),
            f64(rng.uniform(1.6, 2.1, (C, 1))),
            f64(rng.uniform(1020.0, 1030.0, C)), ts)


def _emulate_batch32(k, wheeler):
    """The case-packed tile of csrc/morison_phase_batch.cu's case-batched
    float32 instance in PyTorch (in the operands' dtype): blocks (case
    group or phase tile, grid row) of 192 threads, thread t owning slots
    2 t and 2 t + 1 (case 2 t // S2 of the group at phases 2 t % S2 and
    + 1, or phases 384 tile + 2 t and + 1 of a long case), the record
    region of each case of the group at k RST + q NMAX + j (each thread's
    reads checked to be its own case's records), a thread's arithmetic
    (``_emulate_kernel`` of its case), F1 / F2 at the kernel's offsets, the
    per-thread totals over the row's members in order into partials [C,
    rows, S, 6], and the rows added in order.  Every output starts as
    NaN, so an element no thread writes shows."""
    C, M = k["C"], k["conn"].shape[0]
    S, N, Q = k["ts"].shape[1], k["E"].shape[1], len(k["s"])
    tl = hk.f32_batch_tiles(S, M, Q, N)
    S2, K, n_pt, rows, RST = (tl[n] for n in ("S2", "K", "n_pt", "rows",
                                              "RST"))
    QN = Q * ((N + 3) // 4 * 4)
    member = ("D", "Cd", "Cm")
    cases = []
    for i in range(C):
        ki = {n: v if n in ("coords", "conn", "s", "w", "alpha")
              else _case_operand(v, i, n in member) for n, v in k.items()
              if n != "C"}
        cases.append(_emulate_kernel(ki, wheeler, members=True))
    F1c, F2c, FDc, FIc = (torch.stack(x) for x in zip(*cases))   # [C,S,M,3]
    nan, dtype = float("nan"), k["coords"].dtype
    F1 = torch.full((C * S * M * 3,), nan, dtype=dtype)
    F2 = torch.full((C * S * M * 3,), nan, dtype=dtype)
    part = torch.full((C * rows * S * 6,), nan, dtype=dtype)
    slot = 2 * torch.arange(hk.F32B_SLOTS // 2)
    three, six, qj = torch.arange(3), torch.arange(6), torch.arange(QN)
    for blk in range(-(-C // K) * n_pt):
        grp, tile = divmod(blk, n_pt)
        kk = slot // S2 if n_pt == 1 else torch.zeros_like(slot)
        s0 = slot - kk * S2 if n_pt == 1 else tile * hk.F32B_SLOTS + slot
        kc = torch.clamp(kk, max=K - 1)
        c_me = torch.clamp(grp * K + kc, max=C - 1)
        live = [(kk < K) & (grp * K + kk < C) & (s0 + h < S)
                for h in range(2)]
        tag = torch.full((K * RST,), -1)
        for kq in range(K):
            if grp * K + kq < C:
                tag[kq * RST + qj] = (grp * K + kq) * QN + qj
        reads = tag[kc[:, None] * RST + qj[None, :]]
        lv = live[0] | live[1]
        assert torch.equal(reads[lv], c_me[lv, None] * QN + qj[None, :])
        for row in range(rows):
            tot = torch.zeros(2, len(slot), 6, dtype=dtype)
            for m in range(row, M, rows):
                for h in range(2):
                    L, c, s = live[h], c_me[live[h]], s0[live[h]] + h
                    o = (((c * S + s) * M + m) * 3)[:, None] + three
                    F1[o], F2[o] = F1c[c, s, m], F2c[c, s, m]
                    tot[h, L] += torch.cat([FDc[c, s, m], FIc[c, s, m]], 1)
            for h in range(2):
                L, c, s = live[h], c_me[live[h]], s0[live[h]] + h
                part[(((c * rows + row) * S + s) * 6)[:, None] + six] = \
                    tot[h, L]
    part = part.reshape(C, rows, S, 6)
    tot = part[:, 0]
    for g in range(1, rows):
        tot = tot + part[:, g]
    return (F1.reshape(C, S, M, 3), F2.reshape(C, S, M, 3), tot[..., :3],
            tot[..., 3:])


@pytest.mark.parametrize("C,S,M,N,stretching,K,n_pt", [
    (7, 75, 9, 8, "wheeler", 5, 1),   # groups of 5 and 2 cases, 3 rows
    (3, 13, 6, 5, "none", 27, 1),     # odd S: S2 = 14; one ragged group
    (2, 401, 5, 5, "none", 1, 2),     # a case past one tile: 2 phase tiles
])
def test_batch32_tile_emulation(C, S, M, N, stretching, K, n_pt):
    """The case-batched float32 instance's tile (which (case, phase) a
    thread owns, the per-case record offsets, the F1 / F2 and partial
    totals offsets, the rows' fixed-order sum), emulated on the CPU at
    ragged C and S, equals the batched plain version at 1e-12 and writes
    every output element."""
    args = _batch32_args(C, S, M, N)
    k = hk.batch_kernel_operands(*args, n_gauss=15, current_alpha=1.0 / 7.0)
    tl = hk.f32_batch_tiles(S, M, 15, N)
    assert (tl["K"], tl["n_pt"], tl["rows"]) == (K, n_pt, -(-M // 4))
    assert tl["bytes"] <= hk.F32B_SMEM
    out = _emulate_batch32(k, stretching == "wheeler")
    ref = morison_end_forces_batch(*args, current_alpha=1.0 / 7.0,
                                   stretching=stretching)
    for a, b in zip(out, ref):
        assert a.shape == b.shape and not torch.isnan(a).any()
        assert rel_err(a, b) < 1e-12


# ---- the pointwise kernel (csrc/morison_pointwise.cu) ----

LANES = 16   # a group of the pointwise kernel: one (phase, member)


def _lane_tree(x):
    """The pointwise kernel's sum over the points of dim -2: in each pass
    of 16 lanes the xor-shuffle tree (lane i adds lane i ^ 8, then i ^ 4,
    i ^ 2, i ^ 1), then the passes added in turn."""
    total = None
    for p in x.split(LANES, dim=-2):
        for h in (8, 4, 2, 1):
            p = p[..., :h, :] + p[..., h:2 * h, :]
        total = p[..., 0, :] if total is None else total + p[..., 0, :]
    return total


def _emulate_pointwise(k, accel, stretching, dt_fd, clamp_z, slam_cs):
    """csrc/morison_pointwise.cu in PyTorch (in the operands' dtype, the
    heights and the difference's angle step in float64 as the kernel
    forms them) on operands from ``kernel_operands``: a group per (phase,
    member), a lane per Gauss point of a pass of 16 (lanes past Q add
    zeros); one sincos a (phase, point) and the harmonics by angle
    addition; the first mode loop for the surface, its rise and its step
    to t + dt (alpha_j = cos j delta - 1, beta_j = sin j delta); the
    second at wet points with the profiles at the evaluation height
    (Wheeler, the clamp; the difference by expm1 of the height step); the
    point forces, the lane tree of each pass, the passes added in turn,
    and the members' partial totals in the totals pass's order.  Returns
    (F1, F2 [S, M, 3], total_drag, total_inertia [S, 3])."""
    T, f64 = k["coords"].dtype, torch.float64
    fd, wheeler = accel == "fd", stretching == "wheeler"
    coords, conn = k["coords"], k["conn"]
    M, N, Q = conn.shape[0], k["E"].shape[0], len(k["s"])
    P = -(-Q // LANES) * LANES                  # lanes of all passes

    def val(v, per_member=False):
        v = torch.as_tensor(v, dtype=T)
        return v[:, None] if per_member and v.ndim == 1 else v

    d, kk, om, Uc = k["d"], k["k"], k["omega"], k["Uc"]
    rho, Cd, Cm = val(k["rho"]), val(k["Cd"], True), val(k["Cm"], True)
    thw = (90.0 - val(k["wave_dir"])) * (math.pi / 180.0)
    thc = (90.0 - val(k["current_dir"])) * (math.pi / 180.0)
    cos_w, sin_w = torch.cos(thw), torch.sin(thw)
    cos_c, sin_c = torch.cos(thc), torch.sin(thc)
    live = torch.arange(P) < Q
    s, w = torch.zeros(P, dtype=T), torch.zeros(P, dtype=T)
    s[:Q], w[:Q] = torch.as_tensor(k["s"]), torch.as_tensor(k["w"])

    # the member and its points (a lane's registers)
    c1 = coords[conn[:, 0]]
    dL = coords[conn[:, 1]] - c1
    L = torch.sqrt((dL * dL).sum(-1))
    e = dL / L[:, None]
    x, y, z = (c1[:, None, c] + s * dL[:, None, c] for c in range(3))
    xw = x * cos_w + y * sin_w                               # [M, P]
    D = k["D"][:, None]
    Lw = L[:, None] * w
    cd = 0.5 * rho * Cd * D * Lw
    ci = rho * Cm * (math.pi * D * D / 4.0) * Lw
    ucp = (Uc if k["alpha"] is None else
           Uc * torch.clip((z + d) / d, 0.0, 1.0) ** val(k["alpha"]))
    ez = e[:, 2:3]
    zp_sq = torch.clamp(1.0 - ez * ez, min=0.0)
    zp = torch.stack([-ez * e[:, :1], -ez * e[:, 1:2], zp_sq], -1)
    slam_c = 0.5 * rho * slam_cs * D * Lw * torch.sqrt(zp_sq)

    j = torch.arange(1, N + 1, dtype=T)
    jk, jw = j * kk, j * om
    E, U, Ejw = k["E"], k["U"], k["E"] * j * om
    den = 1.0 + torch.exp(-2.0 * (jk * d))

    def profile(zz):   # C, S, P, Mn [..., N]
        A = jk * (zz[..., None] + d)
        Aa = torch.abs(A)
        scale = torch.exp(Aa - jk * d) / den
        e2 = torch.exp(-2.0 * Aa)
        pos = A >= 0
        return (scale * (1.0 + e2), torch.sign(A) * scale * (1.0 - e2),
                torch.where(pos, scale, scale * e2),
                torch.where(pos, scale * e2, scale))

    # a (phase, point): one sincos, the difference's angle step in f64
    ts = k["ts"][:, None, None]
    c1_, s1_ = torch.cos(kk * xw - om * ts), torch.sin(kk * xw - om * ts)
    zero = torch.zeros_like(c1_)
    a1 = b1 = zero
    if fd:
        kx, td = kk.to(f64) * xw.to(f64), ts.to(f64)
        dl = ((kx - om.to(f64) * (td + dt_fd)) - (kx - om.to(f64) * td)
              ).to(T)
        sh, ch = torch.sin(0.5 * dl), torch.cos(0.5 * dl)
        a1, b1 = -2.0 * sh * sh, 2.0 * sh * ch

    def modes(coef):
        """Walk the modes by angle addition: coef(i, c, s, dc, ds) adds
        mode i's terms."""
        c, sn, a, b = c1_, s1_, a1, b1
        for i in range(N):
            coef(i, c, sn, a * c - b * sn, a * sn + b * c)
            c, sn = c * c1_ - sn * s1_, sn * c1_ + c * s1_
            a, b = a + a1 + a * a1 - b * b1, b + b1 + b * a1 + a * b1

    acc = dict.fromkeys(("eta", "etad", "deta"), zero)

    def surface(i, c, sn, dc, ds):
        acc["eta"] = acc["eta"] + E[i] * c
        acc["etad"] = acc["etad"] + Ejw[i] * sn
        acc["deta"] = acc["deta"] + E[i] * dc
    modes(surface)
    eta, etad, deta = acc["eta"], acc["etad"], acc["deta"]
    wet0 = z <= eta
    wet1 = z <= eta + deta if fd else wet0

    def height(et):   # float64 evaluation height
        zd, dd = z.to(f64), d.to(f64)
        zs = (zd + dd) * dd / (dd + et) - dd if wheeler else zd
        if not clamp_z:
            return zs
        return torch.minimum(torch.clamp(zs + dd, min=0.01),
                             dd + et - 0.01) - dd
    ze0 = height(eta.to(f64))
    hdz = (height(eta.to(f64) + deta.to(f64)) - ze0).to(T) if fd else zero
    Cm0, Sm0, Ph, Mn = profile(ze0.to(T))
    accb = dict.fromkeys(("u", "w", "du", "dw"), zero)

    def loop_b(i, c, sn, dc, ds):
        uc, us = U[i] * Cm0[..., i], U[i] * Sm0[..., i]
        accb["u"] = accb["u"] + uc * c
        accb["w"] = accb["w"] + us * sn
        if fd:
            e1, em = torch.expm1(jk[i] * hdz), torch.expm1(-(jk[i] * hdz))
            dC = Ph[..., i] * e1 + Mn[..., i] * em
            dS = Ph[..., i] * e1 - Mn[..., i] * em
            accb["du"] = accb["du"] + U[i] * (Cm0[..., i] * dc
                                              + dC * (c + dc))
            accb["dw"] = accb["dw"] + U[i] * (Sm0[..., i] * ds
                                              + dS * (sn + ds))
        else:
            accb["du"] = accb["du"] + uc * jw[i] * sn
            accb["dw"] = accb["dw"] - us * jw[i] * c
    modes(loop_b)
    u, wv, du, dw = (torch.where(wet0 & live, accb[n], zero)
                     for n in ("u", "w", "du", "dw"))
    if fd:   # dry at t + dt: the difference to a zero velocity
        du = torch.where(wet1, du / dt_fd, -(u + Uc) / dt_fd)
        dw = torch.where(wet1, dw / dt_fd, -wv / dt_fd)

    # the point's forces, the lane tree, the members' totals in order
    Uv = torch.stack([u * cos_w + ucp * cos_c, u * sin_w + ucp * sin_c,
                      wv], -1)
    Av = torch.stack([du * cos_w, du * sin_w, dw], -1)
    eb = e[:, None, :]
    Up = Uv - (Uv * eb).sum(-1, keepdim=True) * eb
    Ap = Av - (Av * eb).sum(-1, keepdim=True) * eb
    Um = torch.sqrt((Up * Up).sum(-1))
    on = wet0 & live
    fdrag = torch.where((on & (Um > 1e-10))[..., None],
                        (cd * Um)[..., None] * Up, 0.0)
    fin = torch.where(on[..., None], ci[..., None] * Ap, 0.0)
    slam = live & (torch.abs(z - eta) <= D / 2.0) & (etad > 0.0)
    fdrag = fdrag + torch.where(slam, slam_c * etad * etad, 0.0)[
        ..., None] * zp
    f = fdrag + fin
    part = torch.cat([_lane_tree(fdrag), _lane_tree(fin)], -1)  # [S, M, 6]
    # the totals pass: run y adds members y, y + 8, ... in turn, then the
    # 8 runs meet in a fixed tree
    runs = []
    for y in range(8):
        acc = torch.zeros_like(part[:, 0])
        for m in range(y, M, 8):
            acc = acc + part[:, m]
        runs.append(acc)
    tot = (((runs[0] + runs[1]) + (runs[2] + runs[3]))
           + ((runs[4] + runs[5]) + (runs[6] + runs[7])))
    return (_lane_tree((1.0 - s)[:, None] * f), _lane_tree(s[:, None] * f),
            tot[:, :3], tot[:, 3:])


def _points(coords, conn, wave_dir, n_gauss=15):
    """x along the heading and z [M, n_gauss] of every Gauss point
    (f64)."""
    s = torch.as_tensor(pt.ops.morison.gauss_legendre_01(n_gauss)[0])
    c1 = coords[conn[:, 0]]
    pos = c1[:, None, :] + s[None, :, None] * (coords[conn[:, 1]]
                                                - c1)[:, None, :]
    th = math.radians(90.0 - wave_dir)
    return (pos[..., 0] * math.cos(th) + pos[..., 1] * math.sin(th),
            pos[..., 2])


def _band_times(wave, coords, conn, wave_dir, n_points: int = 4,
                n_gauss: int = 15):
    """Times at which ``n_points`` Gauss points (of distinct members, the
    nearest the mean water level) lie 5 mm below the surface, inside the
    1 cm clamp band: the first crossing of eta = z + 5 mm in a period,
    bisected in f64."""
    xw, z = _points(coords, conn, wave_dir, n_gauss)
    out = []
    for m in torch.argsort(z.abs().amin(dim=1))[:n_points].tolist():
        q = int(torch.argmin(z[m].abs()))

        def gap(t):
            return float(pt.surface_elevation(wave, xw[m, q], t)
                         - z[m, q] - 0.005)
        grid = np.linspace(0.0, float(wave.T), 257)
        vals = [gap(t) for t in grid]
        i = next(i for i in range(256) if vals[i] * vals[i + 1] < 0)
        lo, hi = grid[i], grid[i + 1]
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if gap(mid) * vals[i] > 0:
                lo = mid
            else:
                hi = mid
        out.append(0.5 * (lo + hi))
    return out


POINTWISE_WAVES = {   # (H, T, d, U_c, model, N)
    "airy": (9.5, 9.4, 50.0, 1.2, "airy", 1),
    "stokes": (12.0, 9.4, 50.0, 1.2, "stokes", 5),
    "fenton": (17.038, 9.4, 50.0, 1.7, "fenton", 12),
}


@functools.lru_cache(maxsize=None)
def _pointwise_wave(name):
    H, T, d, U_c, model, N = POINTWISE_WAVES[name]
    return pt.make_wave(H, T, d, U_c=U_c, model=model, N=N, device="cpu")


@pytest.mark.parametrize("name,accel,stretching,alpha,per_member,slam,q", [
    ("airy", "fd", "none", None, False, 0.0, 15),
    ("fenton", "fd", "none", None, False, 0.0, 15),
    ("stokes", "analytic", "wheeler", 1.0 / 7.0, True, 0.0, 15),
    ("fenton", "analytic", "none", None, True, float(np.pi), 15),
    ("fenton", "fd", "wheeler", 0.2, False, 5.15, 15),
    ("stokes", "analytic", "none", None, False, 5.15, 15),
    ("fenton", "fd", "none", None, True, 5.15, 20),
])
def test_pointwise_kernel_emulation(name, accel, stretching, alpha,
                                    per_member, slam, q):
    """The pointwise kernel's arithmetic, emulated on the CPU (102 members,
    ``q`` Gauss points: 20 takes two passes of 16 lanes; 24 phases of a
    period and 4 times that put a point inside the 1 cm clamp band),
    against ``morison_loads`` in f64 at 1e-12 (nodal sums and totals), and
    its f32 copy against the plain f64 version on the same f32-rounded
    operands at 1e-5 of the largest value, off the (phase, member) pairs
    with a point within 1e-4 m of a jump."""
    m = pt.refine_model(pt.default_3leg_jacket(device="cpu"), 2)
    wave = _pointwise_wave(name)
    M = m.n_members
    D = m.sections.D_outer[m.sect_id] / 1000.0
    Cd = (torch.tensor(np.random.default_rng(1).uniform(0.6, 1.1, M))
          if per_member else 0.7)
    ts = torch.cat([torch.arange(24, dtype=torch.float64) * wave.T / 24,
                    torch.tensor(_band_times(wave, m.coords, m.conn, 38.0,
                                             n_gauss=q))])
    args = (wave, m.coords, m.conn, D, 38.0, 120.0, Cd, 2.0, 1025.0, ts)
    kw = dict(n_gauss=q, accel=accel, stretching=stretching,
              current_alpha=alpha, slam_cs=slam)
    # wet points inside the clamp band, and inside the slam band
    xw, z = _points(m.coords, m.conn, 38.0, q)
    gap = z - pt.surface_elevation(wave, xw, ts[:, None, None])
    assert int(((gap > -0.01) & (gap <= 0.0)).sum()) >= 4
    assert int((gap.abs() <= D[:, None] / 2.0).sum()) > 100
    ref = pt.morison_loads(*args, **kw)
    k = hk.kernel_operands(*args[:10], q, alpha)
    out = _emulate_pointwise(k, accel, stretching, wave.dt_fd, wave.clamp_z,
                             slam)
    nodal = pt.ops.morison.nodal_scatter(out[0], out[1], m.conn, m.n_nodes)
    assert rel_err(nodal, ref.nodal_forces) <= 1e-12
    assert rel_err(out[2], ref.total_drag) <= 1e-12
    assert rel_err(out[3], ref.total_inertia) <= 1e-12

    f32 = hk.cast_operands(torch.float32, "cpu", args[0], args[1], *args[3:])
    a32 = (*f32[:2], m.conn, *f32[2:])
    a64 = hk.cast_operands(torch.float64, "cpu", *a32[:2]) + (
        m.conn,) + hk.cast_operands(torch.float64, "cpu", *a32[3:])
    ref64 = pt.ops.morison.morison_pointwise_end_forces(*a64, **kw)
    out32 = _emulate_pointwise(hk.kernel_operands(*a32, q, alpha), accel,
                               stretching, wave.dt_fd, wave.clamp_z, slam)
    far = ~hk.pointwise_band(wave, m.coords, m.conn, D, 38.0, a64[9], q,
                             slam=slam > 0, fd=accel == "fd")
    assert far.float().mean() > 0.8
    for a, b in zip(out32, ref64):
        keep = far if a.dim() == 3 else far.all(dim=1)
        assert a.dtype == torch.float32
        assert rel_err(a[keep], b[keep]) <= 1e-5


@pytest.mark.parametrize("accel,stretching,alpha,slam", [
    ("analytic", "none", None, 5.15),
    ("fd", "wheeler", 0.2, 5.15),
])
def test_pointwise_scan_route_matches_assembled_loads(accel, stretching,
                                                      alpha, slam):
    """``phase_scan_prepared(kinematics='pointwise')`` on the CPU, whose
    loads go through the pointwise wrapper's plain version into the chain
    layout, equals the route through the global load vector
    (``morison_loads``, ``assemble_loads``, read in the chain layout) at
    1e-12 (f64, n_seg 4, a Fenton storm, 36 phases, buoyancy and the
    custom self-weight)."""
    api = pt.api
    coarse = pt.default_3leg_jacket(device="cpu")
    refined = pt.refine_model(coarse, 4)
    prep = pt.prepare_condensed(coarse, refined, 4)
    wave = _pointwise_wave("fenton")
    case = pt.LoadCase(wave_dir_deg=38.0, current_dir_deg=38.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, buoyancy="sealed",
                       slam_cs=slam)
    kw = dict(accel=accel, stretching=stretching, current_alpha=alpha)
    new = pt.phase_scan_prepared(prep, wave, case, 36,
                                 kinematics="pointwise", **kw)
    case_l = case.cast(torch.float64, "cpu")
    ts = torch.arange(36, dtype=torch.float64) * wave.T / 36
    mor = api._pointwise_morison(refined, wave, case_l, ts, 15, accel,
                                 stretching, alpha)
    F_I, g = api._global_to_chain(
        api.assemble_loads(refined, case_l, mor.nodal_forces, prep.L_m),
        coarse, 4)
    old = api._prepared_results(prep, case_l, ts, F_I, g, mor.total_morison,
                                1)
    for f in ("U", "utilization", "reactions", "total_morison"):
        assert rel_err(getattr(new, f), getattr(old, f)) <= 1e-12, f


def test_pointwise_counters_on_cpu():
    """``launch_counts`` reports the pointwise kernel's launches and resets
    them; the wrapper on CPU tensors (the plain version) and the CPU scan
    leave them at 0; the launcher refuses CPU tensors."""
    m = pt.default_3leg_jacket(device="cpu")
    wave = _pointwise_wave("stokes")
    D = m.sections.D_outer[m.sect_id] / 1000.0
    ts = torch.arange(6, dtype=torch.float64) * wave.T / 6
    args = (wave, m.coords, m.conn, D, 38.0, 38.0, 0.7, 2.0, 1025.0, ts)
    hk.morison_pointwise_cuda.launches = 3
    n = hk.launch_counts(reset=True)
    assert n["pointwise"] == 3
    out = hk.morison_pointwise_end_forces_cuda(*args, slam_cs=5.15)
    ref = pt.ops.morison.morison_pointwise_end_forces(*args, slam_cs=5.15)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    pt.phase_scan_condensed(m, pt.refine_model(m, 2), 2, wave,
                            pt.LoadCase(slam_cs=5.15), n_steps=4,
                            n_gauss=17, kinematics="pointwise")
    n = hk.launch_counts()
    assert (n["pointwise"], n["k1"]) == (0, 0)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        hk.morison_pointwise_cuda(hk.kernel_operands(*args, 15, None),
                                  "fd", "none", 1e-3, True, 0.0)
