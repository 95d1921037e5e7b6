"""Plain reference of the jacket analysis, in plain PyTorch.

It imports nothing of the program and takes nothing the program made: the
model comes from the configuration file's node and member tables, the waves
from ``waves.py``.  The chain from loads to utilization is written out
directly:

- members refined into ``n_seg`` equal Timoshenko beam elements (12 DOF,
  local axes as the upstream tool's: a near-vertical member takes
  l_y = z x l_x, any other l_z = l_x x z), a dense global stiffness, every
  support node clamped;
- Morison loads at every Gauss point of every element, evaluated pointwise:
  the wave along its heading and the current on its own, dry points (above
  the instantaneous surface) carry nothing; drag 0.5 rho Cd D |u_n| u_n,
  inertia rho Cm pi D^2 / 4 a_n (analytic acceleration), optionally the
  splash-zone slamming load 0.5 rho Cs D v_n^2 of DNV-RP-C205 8.6 on points
  within D / 2 of a rising surface; each point's force split onto the
  element's ends by the lever rule;
- the pointwise path of the program clamps the evaluation height of
  Stokes and Fenton waves to z + d in [0.01, d + eta - 0.01]; its
  separable (phase-batch) path does not.  ``clamp`` selects which;
- topside loads shared by the top nodes, self-weight shared by every node;
- the free-free block solved by a Jacobi-scaled Cholesky factor with one
  round of iterative refinement;
- node-1 end forces of every element, von Mises at 8 points round the
  tube, utilization = von Mises / fy.

Units: geometry m, sections mm, forces N, moments N mm, stresses MPa.

``Precision`` sets the arithmetic: float64 for the reference, and the
controls of the benchmark's correctness check: float32, or TF32 (float32
with the operands of every product that a call computes anew rounded to
TF32's 10-bit mantissa: the Morison loads' sums over wave modes, the
recovery of end forces and the reactions).  The stiffness, its factor and
the solve stay in the dtype: a TF32 stiffness at 9,612 DOF is not positive
definite, and a control that crashes gives no reading.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

G = 9.81
STRESS_ANGLES = np.deg2rad(np.arange(8) * 45.0)


@dataclasses.dataclass(frozen=True)
class Precision:
    dtype: torch.dtype = torch.float64
    tf32: bool = False        # a call's products on TF32 operands

    def op(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as an operand of a call's product."""
        return to_tf32(x) if self.tf32 else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.op(a) @ self.op(b)

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """sum over the last axis of a b (a sum over wave modes)."""
        return (self.op(a) * self.op(b)).sum(-1)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest on TF32's 10-bit mantissa."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


# ----------------------------------------------------------------- model --

@dataclasses.dataclass
class Model:
    coords: torch.Tensor       # [n, 3] m
    conn: torch.Tensor         # [M, 2]
    D: torch.Tensor            # [M] outer diameter, mm
    t: torch.Tensor            # [M] wall, mm
    fixed: torch.Tensor        # [n] bool
    top: torch.Tensor          # [n] bool

    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]


def build(config: dict, n_seg: int, prec: Precision, device) -> Model:
    """The configuration's jacket, every member cut into ``n_seg``
    elements (interior nodes appended member by member)."""
    names = list(config["nodes"])
    index = {n: i for i, n in enumerate(names)}
    xyz = np.array([config["nodes"][n] for n in names], np.float64)
    xyz[:, 2] -= config["z_water_ref_m"]
    conn = np.array([[index[a], index[b]] for a, b, _ in config["members"]])
    sec = config["sections_mm"]
    Dt = np.array([sec["leg" if kind == "leg" else "brace"]
                   for _, _, kind in config["members"]], np.float64)
    fixed = np.isin(np.arange(len(names)),
                    [index[n] for n in config["supports"]])
    top = np.isin(np.arange(len(names)), [index[n] for n in config["top"]])
    n0, M = len(names), conn.shape[0]
    if n_seg > 1:
        s = np.arange(1, n_seg) / n_seg
        c1, c2 = xyz[conn[:, 0]], xyz[conn[:, 1]]
        inner = (c1[:, None] + (c2 - c1)[:, None] * s[None, :, None])
        ids = n0 + np.arange(M * (n_seg - 1)).reshape(M, n_seg - 1)
        chain = np.concatenate([conn[:, :1], ids, conn[:, 1:]], axis=1)
        conn = np.stack([chain[:, :-1], chain[:, 1:]], -1).reshape(-1, 2)
        xyz = np.concatenate([xyz, inner.reshape(-1, 3)])
        Dt = np.repeat(Dt, n_seg, axis=0)
        pad = np.zeros(M * (n_seg - 1), bool)
        fixed, top = np.concatenate([fixed, pad]), np.concatenate([top, pad])

    def f(a):
        return torch.as_tensor(a, dtype=prec.dtype, device=device)
    return Model(coords=f(xyz), conn=torch.as_tensor(conn, device=device),
                 D=f(Dt[:, 0]), t=f(Dt[:, 1]),
                 fixed=torch.as_tensor(fixed, device=device),
                 top=torch.as_tensor(top, device=device))


def section(m: Model):
    """(A, I, J, R) of the thin-wall tubes, mm units."""
    Di = m.D - 2.0 * m.t
    A = math.pi / 4.0 * (m.D**2 - Di**2)
    I = math.pi / 64.0 * (m.D**4 - Di**4)
    return A, I, 2.0 * I, m.D / 2.0


def rotations(m: Model):
    """[M, 3, 3] rows (l_x, l_y, l_z) and lengths [M] in m."""
    d = m.coords[m.conn[:, 1]] - m.coords[m.conn[:, 0]]
    L = torch.linalg.norm(d, dim=1)
    lx = d / L[:, None]
    z = torch.zeros_like(lx)
    z[:, 2] = 1.0
    ly_v = torch.linalg.cross(z, lx)
    n_v = torch.linalg.norm(ly_v, dim=1, keepdim=True)
    yhat = torch.zeros_like(lx)
    yhat[:, 1] = 1.0
    ly_v = torch.where(n_v > 1e-10, ly_v / n_v.clamp_min(1e-30), yhat)
    lz_v = torch.linalg.cross(lx, ly_v)
    lz_g = torch.linalg.cross(lx, z)
    lz_g = lz_g / torch.linalg.norm(lz_g, dim=1, keepdim=True).clamp_min(
        1e-30)
    ly_g = torch.linalg.cross(lz_g, lx)
    vert = (lx[:, 2].abs() > 0.999)[:, None]
    ly = torch.where(vert, ly_v, ly_g)
    lz = torch.where(vert, lz_v, lz_g)
    return torch.stack([lx, ly, lz], dim=1), L


def local_stiffness(m: Model, L_m, E: float, nu: float):
    """Timoshenko element stiffness [M, 12, 12] in local axes, N / mm."""
    A, I, J, _ = section(m)
    Gs = E / (2.0 * (1.0 + nu))
    L = L_m * 1000.0
    phi = 12.0 * E * I / (Gs * (A / 2.0) * L**2)
    b = E * I / ((1.0 + phi) * L**3)
    K = torch.zeros(L.shape[0], 12, 12, dtype=L.dtype, device=L.device)

    def put(i, j, v):
        K[:, i, j] = v
        K[:, j, i] = v
    ax, to = E * A / L, Gs * J / L
    put(0, 0, ax); put(6, 6, ax); put(0, 6, -ax)
    put(3, 3, to); put(9, 9, to); put(3, 9, -to)
    # bending about local z: v (1, 7) and theta_z (5, 11)
    put(1, 1, 12 * b); put(7, 7, 12 * b); put(1, 7, -12 * b)
    put(1, 5, 6 * b * L); put(1, 11, 6 * b * L)
    put(7, 5, -6 * b * L); put(7, 11, -6 * b * L)
    put(5, 5, (4 + phi) * b * L**2); put(11, 11, (4 + phi) * b * L**2)
    put(5, 11, (2 - phi) * b * L**2)
    # bending about local y: w (2, 8) and theta_y (4, 10)
    put(2, 2, 12 * b); put(8, 8, 12 * b); put(2, 8, -12 * b)
    put(2, 4, -6 * b * L); put(2, 10, -6 * b * L)
    put(8, 4, 6 * b * L); put(8, 10, 6 * b * L)
    put(4, 4, (4 + phi) * b * L**2); put(10, 10, (4 + phi) * b * L**2)
    put(4, 10, (2 - phi) * b * L**2)
    return K


def element_dofs(m: Model) -> torch.Tensor:
    """[M, 12] global DOF numbers of each element."""
    six = torch.arange(6, device=m.conn.device)
    return torch.cat([6 * m.conn[:, :1] + six, 6 * m.conn[:, 1:] + six], 1)


@dataclasses.dataclass
class System:
    model: Model
    K: torch.Tensor            # [n_dof, n_dof]
    KT: torch.Tensor           # [M, 12, 12] K_local T (recovery)
    free: torch.Tensor         # [n_free] DOF numbers
    Kff: torch.Tensor          # free-free block
    chol: torch.Tensor         # scaled Cholesky factor of K_ff
    scale: torch.Tensor        # [n_free] Jacobi scaling
    prec: Precision


def system(m: Model, E: float, nu: float, prec: Precision) -> System:
    """Assemble K, factor its free-free block."""
    R, L_m = rotations(m)
    Kl = local_stiffness(m, L_m, E, nu)
    T = torch.zeros_like(Kl)
    for b in range(4):
        T[:, 3 * b:3 * b + 3, 3 * b:3 * b + 3] = R
    KT = Kl @ T
    Kg = T.transpose(1, 2) @ KT
    n = 6 * m.n_nodes
    dofs = element_dofs(m)
    K = torch.zeros(n * n, dtype=prec.dtype, device=Kl.device)
    K.index_add_(0, (dofs[:, :, None] * n + dofs[:, None, :]).reshape(-1),
                 Kg.reshape(-1))
    K = K.reshape(n, n)
    free = torch.nonzero(~m.fixed.repeat_interleave(6)).reshape(-1)
    Kff = K[free][:, free]
    scale = 1.0 / torch.sqrt(torch.diagonal(Kff))
    chol, info = torch.linalg.cholesky_ex(Kff * scale[:, None]
                                          * scale[None, :])
    if int(info) != 0:              # not positive definite at this precision
        chol = torch.full_like(chol, float("nan"))
    return System(model=m, K=K, KT=KT, free=free, Kff=Kff,
                  chol=chol,
                  scale=scale, prec=prec)


def solve(sy: System, F: torch.Tensor) -> torch.Tensor:
    """U [S, n_dof] for loads F [S, n_dof]; one refinement round."""
    Ff = F[:, sy.free].T

    def once(r):
        y = torch.linalg.solve_triangular(sy.chol, sy.scale[:, None] * r,
                                          upper=False)
        y = torch.linalg.solve_triangular(sy.chol.T, y, upper=True)
        return sy.scale[:, None] * y
    Uf = once(Ff)
    Uf = Uf + once(Ff - sy.Kff @ Uf)
    U = torch.zeros_like(F)
    U[:, sy.free] = Uf.T
    return U


def utilization(sy: System, U: torch.Tensor, fy: float) -> torch.Tensor:
    """Max von Mises over 8 points at node 1 of every element / fy."""
    m = sy.model
    A, I, J, R = section(m)
    ue = U[:, element_dofs(m)]                            # [S, M, 12]
    F1 = -(sy.prec.mm(sy.KT[:, :6, :], ue.permute(1, 2, 0)))  # [M, 6, S]
    Fx, Fy, Fz, Mx, My, Mz = (F1[:, c, :].T for c in range(6))
    ang = torch.as_tensor(STRESS_ANGLES, dtype=U.dtype, device=U.device)
    y, z = R[:, None] * torch.cos(ang), R[:, None] * torch.sin(ang)
    sig = (Fx / A)[..., None] + (My / I)[..., None] * z + (Mz / I)[..., None] * y
    tau2 = (Mx * R / J) ** 2 + (Fy / (A / 2)) ** 2 + (Fz / (A / 2)) ** 2
    vm = torch.sqrt(sig**2 + 3.0 * tau2[..., None])
    return vm.amax(-1) / fy


def reactions(sy: System, U: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """K U - F at the support nodes: [S, n_supports, 6]."""
    m = sy.model
    fixed = torch.nonzero(m.fixed.repeat_interleave(6)).reshape(-1)
    R = sy.prec.mm(U, sy.K[:, fixed]) - F[:, fixed]
    return R.reshape(U.shape[0], -1, 6)


# ----------------------------------------------------------------- loads --

def gauss01(n: int):
    xi, w = np.polynomial.legendre.leggauss(n)
    return (xi + 1.0) / 2.0, w / 2.0


@dataclasses.dataclass(frozen=True)
class Case:
    """The load case shared by a batch (headings are per item)."""
    Cd: float
    Cm: float
    rho: float
    slam_cs: float
    F_axial_kN: float
    F_shear_kN: float
    sw_tonnes: float
    fy: float


def morison(m: Model, waves: dict, heading_deg, ts, case: Case,
            n_gauss: int, clamp: bool, band: float, chunk_elems: int,
            prec: Precision = Precision()):
    """Morison loads of a batch of B (wave, heading) items, each at its
    own phases ``ts`` [B, S]: element end forces summed onto the nodes
    [B S, n, 3], total Morison force [B S, 3], and a flag [B S] for
    phases with a Gauss point within ``band`` m of a jump in the loads
    (the wet / dry surface; with slamming, the edges of its D / 2 band).
    ``waves``: a batch of B waves (numpy float64, ``waves.py``); the sums
    over wave modes take their operands through ``prec``."""
    dt, dev = m.coords.dtype, m.coords.device

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dt,
                               device=dev)
    ts = np.asarray(ts, np.float64)
    B, S = ts.shape
    item = np.repeat(np.arange(B), S)

    def per_item(a):
        return f(np.asarray(a)[item])
    k, om, d, Uc = (per_item(waves[n])[:, None, None, None]
                    for n in ("k", "omega", "d", "U_c"))
    E, Uj = per_item(waves["E"]), per_item(waves["U"])         # [I, N]
    th = np.deg2rad(90.0 - np.asarray(heading_deg, np.float64))
    cw, sw = per_item(np.cos(th)), per_item(np.sin(th))         # [I]
    t_all = f(ts.reshape(-1))
    jn = torch.arange(1, E.shape[1] + 1, dtype=dt, device=dev)
    s_np, w_np = gauss01(n_gauss)
    s, w = f(s_np), f(w_np)
    c1 = m.coords[m.conn[:, 0]]
    dL = m.coords[m.conn[:, 1]] - c1
    L = torch.linalg.norm(dL, dim=1)
    e = dL / L[:, None]
    pos = c1[:, None, :] + s[None, :, None] * dL[:, None, :]   # [M, Q, 3]
    z = pos[..., 2]
    Dm = (m.D / 1000.0)[:, None]
    Lw = L[:, None] * w[None, :]
    ez = e[:, 2]
    zp = torch.stack([-ez * e[:, 0], -ez * e[:, 1], 1.0 - ez * ez], -1)
    zp_mag = torch.sqrt(torch.clamp(1.0 - ez * ez, min=0.0))
    eb = e[:, None, :]
    n = m.n_nodes
    step = max(1, chunk_elems // (z.numel() * E.shape[1]))
    nodal, total, flags = [], [], []
    for lo in range(0, B * S, step):
        sl = slice(lo, lo + step)
        c, si = cw[sl][:, None, None], sw[sl][:, None, None]
        xw = (pos[..., 0] * c + pos[..., 1] * si)[..., None]  # [i, M, Q, 1]
        t = t_all[sl][:, None, None, None]
        kk, oo, dd, uc = k[sl], om[sl], d[sl], Uc[sl]
        Ei, Ui = E[sl][:, None, None, :], Uj[sl][:, None, None, :]
        ph = jn * (kk * xw - oo * t)                          # [i,M,Q,N]
        cph, sph = torch.cos(ph), torch.sin(ph)
        eta = prec.dot(Ei, cph)                               # [i, M, Q]
        wet = ~(z > eta)
        ze = z.expand_as(eta)
        dd3 = dd[..., 0]
        if clamp:
            ze = torch.minimum(torch.clamp(z + dd3, min=0.01),
                               dd3 + eta - 0.01) - dd3
        ch_d = torch.cosh(jn * kk * dd)
        C = torch.cosh(jn * kk * (ze[..., None] + dd)) / ch_d
        Sh = torch.sinh(jn * kk * (ze[..., None] + dd)) / ch_d
        u = prec.dot(Ui * C, cph)
        wv = prec.dot(Ui * Sh, sph)
        du = prec.dot(Ui * C * jn * oo, sph)
        dw = -prec.dot(Ui * Sh * jn * oo, cph)
        wf = wet.to(dt)
        uc3 = uc[..., 0]
        V = torch.stack([(u + uc3) * c * wf, (u + uc3) * si * wf, wv * wf],
                        -1)
        Ac = torch.stack([du * c * wf, du * si * wf, dw * wf], -1)
        Vn = V - (V * eb).sum(-1, keepdim=True) * eb
        An = Ac - (Ac * eb).sum(-1, keepdim=True) * eb
        vmag = torch.linalg.norm(Vn, dim=-1)
        drag = (0.5 * case.rho * case.Cd * Dm * vmag * Lw
                * (vmag > 1e-10).to(dt))[..., None] * Vn
        iner = ((case.rho * case.Cm * math.pi * Dm**2 / 4.0 * Lw)[..., None]
                * An)
        fq = drag + iner
        gap = (z - eta).abs()
        near = gap < band
        if case.slam_cs:
            eta_dot = prec.dot(Ei * jn * oo, sph)
            hit = (gap <= Dm / 2.0) & (eta_dot > 0.0)
            vs = torch.where(hit, eta_dot, torch.zeros_like(eta_dot))
            fac = (0.5 * case.rho * case.slam_cs * Dm * vs**2 * Lw
                   * zp_mag[:, None])
            fq = fq + fac[..., None] * zp[:, None, :]
            near = near | ((gap - Dm / 2.0).abs() < band)
        F1 = ((1.0 - s)[:, None] * fq).sum(-2)                # [i, M, 3]
        F2 = (s[:, None] * fq).sum(-2)
        nod = torch.zeros(fq.shape[0], n, 3, dtype=dt, device=dev)
        nod.index_add_(1, m.conn[:, 0], F1)
        nod.index_add_(1, m.conn[:, 1], F2)
        nodal.append(nod)
        total.append(fq.sum(dim=(1, 2)))
        flags.append(near.flatten(1).any(1))
    return torch.cat(nodal), torch.cat(total), torch.cat(flags)


def load_vectors(m: Model, case: Case, heading_item: torch.Tensor,
                 nodal: torch.Tensor) -> torch.Tensor:
    """Global load vectors [I, n_dof]: Morison nodal forces, the topside
    shear (along each item's wave heading, ``heading_item`` [I] degrees)
    and axial load shared by the top nodes, the self-weight shared by
    every node."""
    I, n = nodal.shape[0], m.n_nodes
    F = torch.zeros(I, n, 6, dtype=nodal.dtype, device=nodal.device)
    F[..., :3] = nodal
    n_top = int(m.top.sum())
    th = torch.deg2rad(90.0 - heading_item)[:, None]
    sh = case.F_shear_kN * 1000.0 / n_top
    F[:, m.top, 0] += sh * torch.cos(th)
    F[:, m.top, 1] += sh * torch.sin(th)
    F[:, m.top, 2] -= case.F_axial_kN * 1000.0 / n_top
    F[..., 2] -= case.sw_tonnes * 1000.0 * G / n
    return F.reshape(I, -1)


def analysis(sy: System, waves: dict, heading_deg, ts, case: Case,
             n_gauss: int, clamp: bool, band: float,
             block: int = 1024, chunk_elems: int = 1 << 23) -> dict:
    """B (wave, heading) items, each at its phases ``ts`` [B, S]: numpy
    utilization [B, S, M], total Morison [B, S, 3], reactions
    [B, S, n_supports, 6] and band flags [B, S], in blocks of ``block``
    items a solve."""
    ts = np.asarray(ts, np.float64)
    B, S = ts.shape
    heading_deg = np.asarray(heading_deg, np.float64)
    per = max(1, block // S)
    out = {k: [] for k in ("utilization", "total_morison", "reactions",
                           "near")}
    for lo in range(0, B, per):
        sl = slice(lo, lo + per)
        wv = {k: v[sl] for k, v in waves.items()}
        nodal, total, near = morison(sy.model, wv, heading_deg[sl], ts[sl],
                                     case, n_gauss, clamp, band, chunk_elems,
                                     sy.prec)
        hi = torch.as_tensor(np.repeat(heading_deg[sl], S),
                             dtype=nodal.dtype, device=nodal.device)
        F = load_vectors(sy.model, case, hi, nodal)
        U = solve(sy, F)
        b = ts[sl].shape[0]
        for key, v in (("utilization", utilization(sy, U, case.fy)),
                       ("total_morison", total),
                       ("reactions", reactions(sy, U, F)), ("near", near)):
            out[key].append(v.reshape(b, S, *v.shape[1:]).cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}
